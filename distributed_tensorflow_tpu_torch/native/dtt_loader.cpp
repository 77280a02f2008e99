// Copied from distributed_tensorflow_tpu/native/dtt_loader.cpp (unchanged below this
// header): the host-side record loader of the PyTorch port, built by loader.py.
// Native host-side data loader: mmap'd fixed-size records, multithreaded
// shuffle + batch assembly, bounded prefetch ring.
//
// Role in the framework: the reference's input path is tf.data's C++ runtime
// (DistributedDataset auto-sharding over it — SURVEY.md §3.4) feeding the
// GPU workers.  On TPU the input pipeline is pure host work and is the usual
// scaling-efficiency killer at pod scale (SURVEY.md §8 "hard parts"), so it
// gets the same native treatment here: the hot loop (epoch shuffle, record
// gather, batch assembly) runs in C++ threads that never touch the GIL;
// Python only pops finished batches (ctypes, zero extra copy on the Python
// side — the copy into the caller's numpy buffer happens in C++).
//
// Sharding contract == tf.data AutoShardPolicy.DATA: records are striped
// record_index % shard_count == shard_index, so multi-host training reads
// disjoint slices with no coordination.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 dtt_loader.cpp -o libdtt_loader.so

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Batch {
  std::vector<uint8_t> data;
};

class Loader {
 public:
  Loader(const char* path, uint64_t record_bytes, uint64_t batch_size,
         uint64_t shuffle, uint64_t num_threads, uint64_t prefetch,
         uint64_t seed, uint64_t shard_index, uint64_t shard_count,
         uint64_t header_bytes)
      : header_bytes_(header_bytes),
        record_bytes_(record_bytes),
        batch_size_(batch_size),
        shuffle_(shuffle != 0),
        prefetch_(prefetch < 1 ? 1 : prefetch),
        seed_(seed),
        shard_index_(shard_index),
        shard_count_(shard_count < 1 ? 1 : shard_count) {
    fd_ = open(path, O_RDONLY);
    if (fd_ < 0) { ok_ = false; return; }
    struct stat st;
    if (fstat(fd_, &st) != 0 ||
        st.st_size <= static_cast<off_t>(header_bytes_)) {
      ok_ = false; return;
    }
    file_bytes_ = static_cast<uint64_t>(st.st_size);
    map_ = static_cast<const uint8_t*>(
        mmap(nullptr, file_bytes_, PROT_READ, MAP_PRIVATE, fd_, 0));
    if (map_ == MAP_FAILED) { map_ = nullptr; ok_ = false; return; }
    madvise(const_cast<uint8_t*>(map_), file_bytes_, MADV_WILLNEED);
    // Data starts past the schema header (validated Python-side); reject a
    // payload that is not a whole number of records — the symptom of a
    // schema/file mismatch.
    base_ = map_ + header_bytes_;
    uint64_t payload = file_bytes_ - header_bytes_;
    if (payload % record_bytes_ != 0) { ok_ = false; return; }
    total_records_ = payload / record_bytes_;
    // this shard's record ids: i with i % shard_count == shard_index
    for (uint64_t i = shard_index_; i < total_records_; i += shard_count_) {
      shard_records_.push_back(i);
    }
    if (shard_records_.empty()) { ok_ = false; return; }
    order_ = shard_records_;
    epoch_cursor_ = order_.size();  // force initial (re)shuffle
    epoch_rng_.seed(seed_ * 0x9E3779B97F4A7C15ull + 1);
    uint64_t n = num_threads < 1 ? 1 : num_threads;
    stop_.store(false);
    for (uint64_t t = 0; t < n; ++t) {
      threads_.emplace_back([this] { Produce(); });
    }
  }

  ~Loader() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_.store(true);
      cv_pop_.notify_all();
      cv_push_.notify_all();
    }
    for (auto& th : threads_) th.join();
    if (map_) munmap(const_cast<uint8_t*>(map_), file_bytes_);
    if (fd_ >= 0) close(fd_);
  }

  bool ok() const { return ok_; }
  uint64_t num_records() const { return shard_records_.size(); }

  // Blocks until a batch is ready; copies it into out (batch_size*record
  // bytes). Returns 0 on success, nonzero on shutdown/size mismatch.
  int Next(uint8_t* out, uint64_t out_bytes) {
    if (out_bytes != batch_size_ * record_bytes_) return 2;
    Batch b;
    {
      std::unique_lock<std::mutex> lk(mu_);
      cv_pop_.wait(lk, [this] { return stop_.load() || !queue_.empty(); });
      if (queue_.empty()) return 1;
      b = std::move(queue_.front());
      queue_.pop_front();
      cv_push_.notify_one();
    }
    std::memcpy(out, b.data.data(), out_bytes);
    return 0;
  }

 private:
  // Draw one batch worth of record ids from the SINGLE shared epoch
  // stream.  The shared cursor partitions each epoch's shuffled order
  // across producer threads, so every record appears exactly once per
  // epoch window regardless of num_threads — the tf.data DATA epoch
  // contract, and identical semantics to the single-stream numpy
  // fallback.  One mutex acquisition per batch, not per record; the
  // expensive part (record gather) stays outside the lock.
  void NextIds(std::vector<uint64_t>& ids) {
    ids.clear();
    std::unique_lock<std::mutex> lk(epoch_mu_);
    for (uint64_t i = 0; i < batch_size_; ++i) {
      if (epoch_cursor_ >= order_.size()) {
        if (shuffle_) std::shuffle(order_.begin(), order_.end(), epoch_rng_);
        epoch_cursor_ = 0;
      }
      ids.push_back(order_[epoch_cursor_++]);
    }
  }

  // Producer threads assemble full batches off-GIL from shared epoch ids.
  void Produce() {
    Batch b;
    std::vector<uint64_t> ids;
    while (!stop_.load()) {
      NextIds(ids);
      b.data.resize(batch_size_ * record_bytes_);
      for (uint64_t i = 0; i < batch_size_; ++i) {
        const uint8_t* src = base_ + ids[i] * record_bytes_;
        std::memcpy(b.data.data() + i * record_bytes_, src, record_bytes_);
      }
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_push_.wait(lk, [this] {
          return stop_.load() || queue_.size() < prefetch_;
        });
        if (stop_.load()) return;
        queue_.push_back(std::move(b));
        cv_pop_.notify_one();
      }
      b = Batch();
    }
  }

  int fd_ = -1;
  const uint8_t* map_ = nullptr;   // mmap base (whole file)
  const uint8_t* base_ = nullptr;  // first record (past header)
  uint64_t file_bytes_ = 0;
  uint64_t total_records_ = 0;
  uint64_t header_bytes_;
  uint64_t record_bytes_, batch_size_;
  bool shuffle_;
  uint64_t prefetch_, seed_, shard_index_, shard_count_;
  bool ok_ = true;
  std::vector<uint64_t> shard_records_;
  std::mutex epoch_mu_;
  std::vector<uint64_t> order_;
  size_t epoch_cursor_ = 0;
  std::mt19937_64 epoch_rng_;
  std::vector<std::thread> threads_;
  std::mutex mu_;
  std::condition_variable cv_pop_, cv_push_;
  std::deque<Batch> queue_;
  std::atomic<bool> stop_{false};
};

}  // namespace

extern "C" {

void* dtt_loader_create(const char* path, uint64_t record_bytes,
                        uint64_t batch_size, uint64_t shuffle,
                        uint64_t num_threads, uint64_t prefetch,
                        uint64_t seed, uint64_t shard_index,
                        uint64_t shard_count, uint64_t header_bytes) {
  Loader* l = new Loader(path, record_bytes, batch_size, shuffle, num_threads,
                         prefetch, seed, shard_index, shard_count,
                         header_bytes);
  if (!l->ok()) {
    delete l;
    return nullptr;
  }
  return l;
}

uint64_t dtt_loader_num_records(void* loader) {
  return static_cast<Loader*>(loader)->num_records();
}

int dtt_loader_next(void* loader, uint8_t* out, uint64_t out_bytes) {
  return static_cast<Loader*>(loader)->Next(out, out_bytes);
}

void dtt_loader_destroy(void* loader) { delete static_cast<Loader*>(loader); }

}  // extern "C"
