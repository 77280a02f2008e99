"""Inference engine of the PyTorch port: checkpoint -> parameters -> decode and classify.

Port of ``distributed_tensorflow_tpu/serve/engine.py``, its fixed-batch
parts: restore a checkpoint inference-only (``CheckpointManager.
restore_params``: no optimizer state is read), take this rank's parts of
the parameters on the mesh, and serve two paths:

- ``generate``: GPT-2 prefill and KV-cache decode (``models.gpt2``
  ``decode=True``) over a cache preallocated per (batch, total length),
  heads split over ``tensor`` (``gpt2_cache_rules``);
- ``classify``: one batched forward of MNIST, ResNet-50 (BatchNorm on its
  running statistics) or BERT (the NSP logits), under
  ``torch.inference_mode``.

The reference's jit program cache becomes one CUDA graph per decode-step
family, (batch, total length, sampling key), captured on the card the
first time the family runs (or when ``warm_decode`` builds it ahead of
traffic).  The family owns its static buffers (the cache, the step's token,
the output row, the step counter, the eos flags): prefill runs eagerly into
them, then each decode step replays the graph, which writes the chosen
token into the output at the step counter and advances the counter, so the
loop reads nothing from the card until an eos check or the end.  A capture
that fails raises; nothing falls back to eager.  ``cuda_graphs=False``, or a
CPU engine, runs the same step eagerly; the compile counters then count a
family's first use.  Every launch or replay takes ``_launch_lock``.

Token choice: greedy is an exact argmax.  Sampled rows draw by the Gumbel-max
trick from Philox-4x32-10 (``ops.flash_attention.philox4x32_10``) on the
card: the engine's rows are keyed by (base seed, step counter, row), a
seeded row of ``_select_next`` by (its seed, 0x5EED, its step), so its
stream depends only on its seed and history.  The draws are not
``jax.random``'s: parity with the reference is by distribution.

On a tensor mesh the logits are gathered over ``tensor`` and cut to the
vocabulary before any choice, so the zero-padded rows of a vocab-parallel
``wte`` (50257 over 2) never win, and an argmax over the whole row returns
the lowest index on ties, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from distributed_tensorflow_tpu_torch.checkpoint.manager import CheckpointManager
from distributed_tensorflow_tpu_torch.cluster.topology import MeshConfig, build_mesh
from distributed_tensorflow_tpu_torch.convert import shard_params as _local_parts
from distributed_tensorflow_tpu_torch.models import Workload, get_workload
from distributed_tensorflow_tpu_torch.models.layers import gather_last
from distributed_tensorflow_tpu_torch.obs import metrics as obs_metrics
from distributed_tensorflow_tpu_torch.ops.flash_attention import philox4x32_10
from distributed_tensorflow_tpu_torch.rng import fold_in
from distributed_tensorflow_tpu_torch.train_lib import resolve_device

logger = logging.getLogger(__name__)

# Process-wide launch serialisation, the reference's discipline: every
# launch or graph replay (and every hot-reload copy into the parameters)
# takes this lock, whatever thread it runs on.
_launch_lock = threading.Lock()

_MASK32 = 0xFFFFFFFF
_SEEDED = 0x5EED  # the seeded rows' key word, as the reference folds it in
_F32_MIN = torch.finfo(torch.float32).min


def _engine_instruments(registry=None):
    """The reference's engine families: one program-family event counter
    per kind, their total, the resident families, and host-side dispatch
    timing.  Host-side only: nothing enters the decode step."""
    r = registry or obs_metrics.default_registry()
    return {
        "compiles": r.counter(
            "dtt_serve_compile_events_total",
            "Program-cache misses by program kind", labelnames=("kind",)),
        "compile_total": r.counter(
            "dtt_serve_compile_total",
            "Serving program compiles (program-cache misses, all kinds) "
            "since engine start — flat after warmup is the no-recompile "
            "claim the bench A/B asserts under mixed sampling traffic"),
        "programs_cached": r.gauge(
            "dtt_serve_programs_cached",
            "Distinct compiled serving programs resident in the "
            "program caches — ONE set per (family, paged, K/k) "
            "regardless of the sampling parameter mix"),
        "prefill": r.histogram(
            "dtt_serve_prefill_seconds",
            "Host-side slot-prefill dispatch duration"),
        "decode_step": r.histogram(
            "dtt_serve_decode_step_seconds",
            "Host-side slot-decode dispatch duration"),
    }


# -- token choice ---------------------------------------------------------------

def _gumbel(shape: Tuple[int, int], key0, key1, row, step, domain: int,
            device) -> torch.Tensor:
    """(B, V) Gumbel noise from Philox-4x32-10: the draw of (row, vocab
    column) is word 0 at counter (column, row, step, domain) under key
    (key0, key1); ``row``, ``step`` and the keys broadcast as (B, 1) int64
    tensors or Python ints."""
    cols = torch.arange(shape[1], device=device, dtype=torch.int64)[None, :]
    word = philox4x32_10(cols, row, step, domain, key0, key1)[0]
    u = ((word >> 8).to(torch.float32) + 0.5) * 2.0 ** -24  # in (0, 1)
    return -torch.log(-torch.log(u))


def _shared_draw(scaled: torch.Tensor, base_seed: int, counter: torch.Tensor) -> torch.Tensor:
    """The batch's shared categorical draw at step ``counter``: each row a
    stream of its own under the engine's base seed."""
    B = scaled.shape[0]
    rows = torch.arange(B, device=scaled.device, dtype=torch.int64)[:, None]
    g = _gumbel(scaled.shape, base_seed & _MASK32, (base_seed >> 32) & _MASK32, rows,
                counter.to(torch.int64).reshape(-1, 1), 0, scaled.device)
    return (scaled + g).argmax(-1)


def _select_next_scalar(logits: torch.Tensor, base_seed: int, counter: torch.Tensor,
                        temperature: float, top_k: int) -> torch.Tensor:
    """The reference's scalar-config choice over (B, V) last-position
    logits, the fixed-batch ``generate`` family: ``temperature <= 0`` is
    the exact argmax; else temperature and top-k sampling keyed by the base
    seed and the step ``counter`` (a device tensor the step advances, so
    the loop splits no key on the host)."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    scaled = logits.float() / temperature
    if top_k:
        k = min(int(top_k), scaled.shape[-1])
        kth = scaled.sort(-1).values[:, -k][:, None]
        scaled = scaled.masked_fill(scaled < kth, _F32_MIN)
    return _shared_draw(scaled, base_seed, counter)


def _penalized(logits: torch.Tensor, sampling: Mapping[str, torch.Tensor],
               counts: torch.Tensor) -> torch.Tensor:
    """float32 logits less the presence and frequency penalties of the
    tokens each row emitted (exact no-ops at 0)."""
    counts_f = counts.float()
    return (logits.float() - sampling["presence"][:, None] * (counts_f > 0).float()
            - sampling["frequency"][:, None] * counts_f)


def sampling_logits(penalized: torch.Tensor, sampling: Mapping[str, torch.Tensor]
                    ) -> torch.Tensor:
    """The logits each sampled row of ``_select_next`` draws from: the
    penalised logits over the temperature, then per-row top-k (the k-th
    largest from one ascending sort; k <= 0 keeps all) and top-p (the
    smallest descending nucleus whose exclusive cumulative mass is below p,
    mapped back through the inverse permutation; p = 1 keeps all), masked
    columns at the float32 minimum: the reference's ``_mixed``."""
    temps = sampling["temperature"]
    scaled = penalized / torch.where(temps > 0.0, temps, torch.ones_like(temps))[:, None]
    vocab = scaled.shape[-1]
    srt = scaled.sort(-1).values  # ascending
    tk = sampling["top_k"].long().clamp(0, vocab)
    kth = srt.gather(-1, (vocab - tk).clamp(0, vocab - 1)[:, None])
    kth = torch.where(tk[:, None] > 0, kth, torch.full_like(kth, -math.inf))
    scaled = scaled.masked_fill(scaled < kth, _F32_MIN)
    order = torch.argsort(scaled, dim=-1, stable=True).flip(-1)  # descending, jnp's order
    sorted_probs = torch.softmax(scaled.gather(-1, order), dim=-1)
    exclusive_cum = torch.cumsum(sorted_probs, dim=-1) - sorted_probs
    keep = (exclusive_cum < sampling["top_p"][:, None]).gather(
        -1, torch.argsort(order, dim=-1))
    nucleus = (sampling["top_p"] < 1.0)[:, None] & ~keep
    return scaled.masked_fill(nucleus, _F32_MIN)


def _select_next(logits: torch.Tensor, base_seed: int, counter: torch.Tensor,
                 sampling: Mapping[str, torch.Tensor], counts: torch.Tensor) -> torch.Tensor:
    """The reference's vectorised per-row choice over (B, V) logits: one
    function for any mix of per-request configs (``serve.sampling.pack``'s
    vectors as tensors).  Greedy rows (``temperature <= 0``) take the
    penalised argmax; rows with ``seed < 0`` draw from the shared stream
    (base seed, ``counter``); seeded rows from (seed, 0x5EED, ``step``)
    alone, whatever the batch or the counter.  Every row's choice is
    computed and the greedy ones selected by ``torch.where``: no host branch,
    so the step stays capturable."""
    penalized = _penalized(logits, sampling, counts)
    scaled = sampling_logits(penalized, sampling)
    shared = _shared_draw(scaled, base_seed, counter)
    seeds = sampling["seed"].to(torch.int64)
    seeded = (scaled + _gumbel(scaled.shape, (seeds & _MASK32)[:, None], _SEEDED, 0,
                               sampling["step"].to(torch.int64)[:, None], 1,
                               scaled.device)).argmax(-1)
    sampled = torch.where(seeds >= 0, seeded, shared)
    return torch.where(sampling["temperature"] <= 0.0, penalized.argmax(-1), sampled)


def pad_rows(arr: np.ndarray, target: int) -> np.ndarray:
    """Pad the leading (batch) dim to ``target`` rows by repeating the last
    row — inert filler whose outputs the caller slices off."""
    n = arr.shape[0]
    if n == target:
        return arr
    if n > target:
        raise ValueError(f"batch {n} exceeds padded target {target}")
    pad = np.repeat(arr[-1:], target - n, axis=0)
    return np.concatenate([arr, pad], axis=0)


def _trim_at_eos(row: np.ndarray, eos_token: Optional[int]) -> np.ndarray:
    """Cut a generated row just past its first eos (inclusive); unchanged
    when ``eos_token`` is None or never emitted."""
    if eos_token is None:
        return row
    hits = np.flatnonzero(row == eos_token)
    return row if hits.size == 0 else row[: int(hits[0]) + 1]


@dataclasses.dataclass
class _Geometry:
    """The static buffers of one (batch, total length): the decode cache,
    the step's input token, the output rows (column = step), the step
    counter, the eos flags and token, and each sampling key's decode step
    (a captured graph's replay, or the eager step).  ``lock`` holds the
    buffers for one ``generate``."""

    cache: Any
    tokens: torch.Tensor
    out: torch.Tensor
    counter: torch.Tensor
    done: torch.Tensor
    eos: torch.Tensor
    steps: Dict[Tuple[float, int], Any] = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


class ServeEngine:
    """Checkpoint-backed inference on one device (or a tensor mesh of CPU
    ranks).  ``checkpoint_dir=None`` (or an empty directory) falls back to
    a fresh init of seed ``seed``."""

    def __init__(self, model: str = "gpt2", *, mesh=None, checkpoint_dir: Optional[str] = None,
                 checkpoint_step: Optional[int] = None, seed: int = 0, device="cuda",
                 cuda_graphs: bool = True, **workload_overrides):
        self.device = resolve_device(device) if isinstance(device, str) else torch.device(device)
        self.mesh = mesh if mesh is not None else build_mesh(MeshConfig())
        pipe = self.mesh.shape["pipe"]
        if pipe > 1 and model == "gpt2":
            raise ValueError(
                f"ServeEngine cannot serve model {model!r} on a mesh with a 'pipe' axis of size "
                f"{pipe}: KV-cache decode (decode=True) is unsupported under pipeline "
                f"parallelism — re-mesh without the pipe axis (TP/DP shardings apply) or "
                f"dedicate a pipe-free mesh slice to serving")
        if self.data_parallelism > 1:
            raise NotImplementedError(
                "serving with the batch split over --data/--fsdp comes with a later serving "
                "slice; serve on one rank or over --tensor")
        if self.mesh.size > 1 and self.device.type == "cuda":
            raise NotImplementedError(
                "serving on a multi-rank mesh on the card comes with a later serving slice "
                "(the decode graphs would capture its collectives); the CPU runs --tensor "
                "ranks over gloo")
        self.model = model
        self.workload: Workload = get_workload(model, mesh=self.mesh, device=self.device,
                                               **workload_overrides)
        self.module = self.workload.module
        self.use_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self._manager: Optional[CheckpointManager] = None
        self._obs = _engine_instruments()
        self._geometries: Dict[Tuple[int, int], _Geometry] = {}
        self._geometry_lock = threading.Lock()
        self.restored_step: Optional[int] = None
        # Base sampling seed (folded with a step counter inside the step,
        # never split on the host per token).
        self._sample_seed = fold_in(seed, 0x53)
        if seed and hasattr(self.module, "reset_parameters"):
            self.module.reset_parameters(seed)
        if checkpoint_dir:
            self._manager = CheckpointManager(checkpoint_dir)
            if self._manager.latest_step() is not None:
                params, model_state = self._manager.restore_params(checkpoint_step)
                self.install_params(self.shard_params({**params, **model_state}))
                self.restored_step = (checkpoint_step if checkpoint_step is not None
                                      else self._manager.latest_step())
                logger.info("serving checkpoint step %s from %s", self.restored_step,
                            checkpoint_dir)
            else:
                logger.warning("no checkpoint under %s — serving FRESH-INIT params",
                               checkpoint_dir)

    # -- shapes and counters ---------------------------------------------------

    @property
    def data_parallelism(self) -> int:
        return self.mesh.shape["data"] * self.mesh.shape["fsdp"]

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """The live parameters (this rank's parts), by the module's names."""
        return dict(self.module.named_parameters())

    def bucket_rows(self, n: int) -> int:
        """Smallest power-of-two multiple of the data-parallel extent that
        fits ``n`` rows — the padded batch shapes the decode families see."""
        b = max(1, self.data_parallelism)
        while b < n:
            b *= 2
        return b

    @staticmethod
    def canonical_scalar_key(temperature: float, top_k: int) -> Tuple[float, int]:
        """Canonical (temperature, top_k): every greedy config is (0.0, 0);
        sampled ones normalise representation only (negative top_k = 0)."""
        if temperature <= 0.0:
            return (0.0, 0)
        return (float(temperature), max(0, int(top_k)))

    def _note_compile(self, kind: str) -> None:
        """One new program family (a capture on the card, a first use on
        the CPU): the per-kind counter, the total and the resident gauge."""
        self._obs["compiles"].labels(kind=kind).inc()
        self._obs["compile_total"].inc()
        self._obs["programs_cached"].inc()

    def compile_stats(self) -> Dict[str, float]:
        """Program-family telemetry from the metrics alone (no lock)."""
        return {
            "programs_cached": self._obs["programs_cached"].value,
            "compile_total": self._obs["compile_total"].value,
        }

    # -- generate (GPT-2 KV-cache decode) ----------------------------------------

    def init_cache(self, batch: int, total_len: int):
        """A zeroed decode cache for ``batch`` rows of up to ``total_len``
        (prompt + generated) tokens, this rank's heads."""
        from distributed_tensorflow_tpu_torch.models.gpt2 import init_decode_cache

        with torch.inference_mode():
            return init_decode_cache(self.module.cfg, self.mesh, batch, total_len,
                                     device=self.device)

    @staticmethod
    def cache_hbm_bytes(cache) -> int:
        """Bytes of a decode cache on this rank."""
        return int(cache.nbytes())

    def _geometry(self, batch: int, total_len: int) -> _Geometry:
        key = (batch, total_len)
        with self._geometry_lock:
            geom = self._geometries.get(key)
            if geom is None:
                self._note_compile("cache_init")
                with torch.inference_mode():
                    def zeros(shape, dtype=torch.int64):
                        return torch.zeros(shape, dtype=dtype, device=self.device)

                    geom = _Geometry(
                        cache=self.init_cache(batch, total_len), tokens=zeros((batch, 1)),
                        out=zeros((batch, total_len)), counter=zeros(()),
                        done=zeros((batch,), torch.bool), eos=zeros(()) - 1)
                self._geometries[key] = geom
            return geom

    def _full_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """(B, V) float32 last-position logits over the whole vocabulary:
        on a tensor mesh gathered over ``tensor`` and cut to ``vocab_size``
        (the zero-padded rows of ``wte`` dropped)."""
        last = logits[:, -1]
        if self.mesh.shape["tensor"] > 1:
            last = gather_last(last.contiguous(), self.mesh)[:, : self.module.cfg.vocab_size]
        return last

    def _choose(self, geom: _Geometry, logits: torch.Tensor, key: Tuple[float, int]) -> None:
        """The step's tail, device ops only: the token of ``key``'s choice
        written at column ``counter`` of the output, the eos flags, the next
        step's input, the counter advanced."""
        tok = _select_next_scalar(self._full_logits(logits), self._sample_seed, geom.counter,
                                  *key)
        geom.out.index_copy_(1, geom.counter.reshape(1), tok[:, None])
        geom.done.logical_or_(tok == geom.eos)
        geom.tokens.copy_(tok[:, None])
        geom.counter.add_(1)

    def _decode_step(self, geom: _Geometry, key: Tuple[float, int]) -> None:
        logits = self.module(geom.tokens, decode=True, cache=geom.cache)
        self._choose(geom, logits, key)

    def _step_fn(self, geom: _Geometry, key: Tuple[float, int]):
        """The family's decode step: its captured graph's replay on the card
        (captured on first use), else the eager step (first use counted)."""
        fn = geom.steps.get(key)
        if fn is not None:
            return fn
        self._note_compile("decode_step")
        if not self.use_graphs:
            fn = lambda: self._decode_step(geom, key)  # noqa: E731
        else:
            fn = self._capture(geom, key).replay
        geom.steps[key] = fn
        return fn

    def _capture(self, geom: _Geometry, key: Tuple[float, int]):
        """Capture one decode step of ``geom`` under ``key``: two eager steps
        on a side stream first (library workspaces, lazy initialisation),
        then the capture.  The warm steps' writes are undone by the next
        prefill's rewind.  A failed capture raises."""
        geom.cache.reset()
        geom.counter.zero_()
        stream = torch.cuda.Stream(self.device)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(stream):
            for _ in range(2):
                self._decode_step(geom, key)
        torch.cuda.current_stream(self.device).wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self._decode_step(geom, key)
        return graph

    def warm_decode(self, batch: int, total_len: int, *, temperature: float = 0.0,
                    top_k: int = 0) -> None:
        """Build the decode family of (batch, total length, sampling key)
        ahead of traffic: on the card its graph is captured here, so a
        serving loop that warmed every family it serves builds nothing
        while clients wait."""
        key = self.canonical_scalar_key(temperature, top_k)
        geom = self._geometry(batch, total_len)
        with geom.lock, torch.inference_mode(), _launch_lock:
            self._step_fn(geom, key)

    def generate(self, prompts: np.ndarray, max_new_tokens: int, *,
                 eos_token: Optional[int] = None, eos_check_every: int = 8,
                 temperature: float = 0.0, top_k: int = 0) -> np.ndarray:
        """Decode: (B, T_prompt) int32 -> (B, n <= max_new_tokens) int32.

        One eager prefill over the whole prompt fills the cache and yields
        the first token; each further token is a (B, 1) step of the
        family's graph (or the eager step) against the cache.  Defaults are
        greedy argmax for the full horizon; ``temperature > 0`` (with
        ``top_k``) samples.  ``eos_token`` enables early exit: once every
        row has emitted it, decoding stops at the next host check, every
        ``eos_check_every`` steps, so the loop is not synced per token; rows
        that finished earlier carry (ignorable) tokens after their eos."""
        prompts = np.asarray(prompts, np.int32)
        if prompts.ndim != 2:
            raise ValueError(f"prompts must be (B, T), got {prompts.shape}")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        B, T = prompts.shape
        cfg = self.module.cfg
        total = T + max_new_tokens
        if total > cfg.n_positions:
            raise ValueError(f"prompt {T} + max_new_tokens {max_new_tokens} exceeds "
                             f"n_positions {cfg.n_positions}")
        key = self.canonical_scalar_key(temperature, top_k)
        geom = self._geometry(B, total)
        check_every = max(1, eos_check_every)
        with geom.lock, torch.inference_mode():
            t0 = time.perf_counter()
            with _launch_lock:
                step = self._step_fn(geom, key)
                geom.cache.reset()
                geom.counter.zero_()
                geom.done.zero_()
                geom.eos.fill_(-1 if eos_token is None else int(eos_token))
                tokens = torch.from_numpy(prompts).to(self.device, non_blocking=True)
                self._choose(geom, self.module(tokens, decode=True, cache=geom.cache), key)
            self._obs["prefill"].observe(time.perf_counter() - t0)
            n = 1
            for i in range(1, max_new_tokens):
                if eos_token is not None and i % check_every == 0:
                    with _launch_lock:
                        finished = bool(geom.done.all())
                    if finished:
                        break
                t0 = time.perf_counter()
                with _launch_lock:
                    step()
                self._obs["decode_step"].observe(time.perf_counter() - t0)
                n += 1
            with _launch_lock:
                out = geom.out[:, :n].to(torch.int32).cpu().numpy()
        return out

    def generate_batch(self, prompts: List[np.ndarray], max_new_tokens: int,
                       **gen_kwargs) -> List[np.ndarray]:
        """Batcher adapter: list of 1-D prompts -> list of generated 1-D
        token arrays.  Groups by prompt length and pads each group's batch
        dim to the bucketed shapes; with ``eos_token`` each row is trimmed
        just past its own first eos."""
        eos_token = gen_kwargs.get("eos_token")
        by_len: Dict[int, List[int]] = {}
        for i, p in enumerate(prompts):
            by_len.setdefault(len(p), []).append(i)
        results: List[Optional[np.ndarray]] = [None] * len(prompts)
        for _, idxs in by_len.items():
            stacked = np.stack([prompts[i] for i in idxs]).astype(np.int32)
            padded = pad_rows(stacked, self.bucket_rows(len(idxs)))
            gen = self.generate(padded, max_new_tokens, **gen_kwargs)
            for row, i in enumerate(idxs):
                results[i] = _trim_at_eos(gen[row], eos_token)
        return results  # type: ignore[return-value]

    # -- classify (MNIST / ResNet-50 / BERT) ---------------------------------------

    def _predict(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        if self.model == "resnet50":
            return self.module(batch["image"], train=False)
        if self.model == "mnist":
            return self.module(batch["image"])
        if self.model == "bert":
            # Sentence-level head: the NSP logits are the classify surface.
            _mlm, nsp = self.module(batch)
            return nsp
        raise NotImplementedError(f"no serve predict path for model {self.model!r}")

    def classify(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        """Batched deterministic forward -> host logits array."""
        with torch.inference_mode(), _launch_lock:
            dev = {k: torch.as_tensor(np.asarray(v)).to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            logits = self._predict(dev).float().cpu()
        return logits.numpy()

    def classify_batch(self, examples: List[Dict[str, np.ndarray]]) -> List[int]:
        """Batcher adapter: list of single examples -> list of class ids."""
        keys = examples[0].keys()
        stacked = {k: np.stack([np.asarray(e[k]) for e in examples]) for k in keys}
        target = self.bucket_rows(len(examples))
        padded = {k: pad_rows(v, target) for k, v in stacked.items()}
        logits = self.classify(padded)
        return [int(np.argmax(logits[i], axis=-1)) for i in range(len(examples))]

    # -- hot weight reload -------------------------------------------------------

    def shard_params(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """This rank's parts, on the engine's device, of a host state dict in
        the global layout (parameters and, for ResNet, the BatchNorm
        buffers) — the checkpoint restore's and the hot reload's path.  The
        result matches ``params`` in names and shapes, so installing it
        rebuilds no decode family."""
        plan = getattr(self.module, "plan", None)
        local = _local_parts(params, plan) if plan is not None else dict(params)
        return {k: v.to(self.device) for k, v in local.items()}

    def install_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """Swap the live weights (hot reload): each tensor is copied into the
        module's own, under the launch lock, so every captured step reads the
        new weights and no launch sees a half-installed set."""
        own = {**dict(self.module.named_parameters()), **dict(self.module.named_buffers())}
        unknown = set(params) - set(own)
        if unknown:
            raise KeyError(f"not tensors of the {self.model} module: {sorted(unknown)[:8]}")
        with _launch_lock, torch.no_grad():
            for name, value in params.items():
                own[name].copy_(value)

    # -- lifecycle ---------------------------------------------------------------

    def close(self) -> None:
        """Release the checkpoint manager and the decode families."""
        if self._manager is not None:
            self._manager.close()
            self._manager = None
        with self._geometry_lock:
            self._geometries.clear()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
