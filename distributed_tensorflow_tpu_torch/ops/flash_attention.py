"""Flash attention (forward + backward) as hand-written CUDA kernels.

Port of ``distributed_tensorflow_tpu/ops/flash_attention.py``.  The three
TPU kernels (forward, dQ, dK/dV) become CUDA kernels for Hopper in
``ops/csrc`` (built by ``ops/_build.py``), with two pre-passes that give
both backward kernels what each would otherwise recompute: Delta =
rowsum(dO * O) - g_lse, and the dropout mask's keep bits.  Each kernel has
a plain PyTorch version beside it in this module, which computes the same
function with dense (T, T) tensors.

- Layout: q/k/v are (B, T, H, D), read through their strides (no head
  transpose); lse is (B, H, T) float32.  D is 16, 32, 64 or 128; any T.
  bf16 and float32 inputs, float32 accumulation.  The kernels pick their
  design by dtype: bf16 runs its products on the tensor cores (wgmma, P
  and dS rounded to bf16 as operands), float32 on f32 FMAs.
- A wrapper takes the plain version only for tensors on the CPU.  On a CUDA
  tensor it launches its kernel or raises; there is no silent fallback.
  Each wrapper counts its launches in ``LAUNCHES``.
- Dropout (softmax-dropout, as on the TPU): l and lse use the undropped
  probabilities; only P.V, dV and dP see the keep mask.  The mask is
  Philox-4x32-10 keyed by the integer seed and counted by element position
  (b*H + h, query, key): word ``key % 4`` of the draw at counter
  ``(key // 4, query, b*H + h, 0)``.  Kernel and plain version build the
  identical mask.  It differs from the TPU PRNG's and ``jax.random``'s.
  The forward kernel draws it in place; the backward draws it once into
  bits (``flash_bwd_keep``) that dQ and dK/dV read.
- ``flash_attention_with_lse`` is differentiable in both outputs; the lse
  cotangent folds into Delta (dS = P (dP - Delta + g_lse) scale).
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from distributed_tensorflow_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNELS}
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_c_ptr, _c_int, _c_ll, _c_f, _c_u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_float, ctypes.c_uint)
# (dtype, head_dim, tensors..., B, H, T, 3 strides per tensor, then the
#  forward's scale, causal, seed_lo, seed_hi, thresh, drop_scale, drop_on,
#  stream, or the backward kernels' scale, causal, keep bits, drop_scale, stream)
_TAIL = [_c_f, _c_int, _c_u, _c_u, _c_u, _c_f, _c_int, _c_ptr]
_BWD_TAIL = [_c_f, _c_int, _c_ptr, _c_f, _c_ptr]
_ARGTYPES = {
    "flash_fwd": [_c_int, _c_int] + [_c_ptr] * 6 + [_c_int] * 3 + [_c_ll] * 12 + _TAIL,
    "flash_bwd_delta": [_c_int, _c_int] + [_c_ptr] * 4 + [_c_int] * 3 + [_c_ll] * 6 + [_c_ptr],
    "flash_bwd_keep": [_c_ptr] + [_c_int] * 4 + [_c_u] * 3 + [_c_ptr],
    "flash_bwd_dq": [_c_int, _c_int] + [_c_ptr] * 8 + [_c_int] * 3 + [_c_ll] * 15 + _BWD_TAIL,
    "flash_bwd_dkv": [_c_int, _c_int] + [_c_ptr] * 9 + [_c_int] * 3 + [_c_ll] * 18 + _BWD_TAIL,
}


# -- Philox-4x32-10 dropout mask (the plain version of the kernels') --------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of m * x for uint32 values held in int64."""
    ml, mh = m & 0xFFFF, m >> 16
    xl, xh = x & 0xFFFF, x >> 16
    p1 = mh * xl + ml * xh
    low = ml * xl + ((p1 & 0xFFFF) << 16)
    return (mh * xh + (p1 >> 16) + (low >> 32)) & _MASK32, low & _MASK32


def philox4x32_10(c0, c1, c2, c3, key0: int, key1: int):
    """Philox-4x32-10 on int64 tensors holding uint32 counters (broadcast
    together); returns the four output words."""
    for r in range(10):
        if r:
            key0 = (key0 + _PHILOX_W[0]) & _MASK32
            key1 = (key1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ key0, lo1, hi0 ^ c3 ^ key1, lo0
    return c0, c1, c2, c3


def _dropout_params(rate: float, seed: int) -> Tuple[int, int, int, float]:
    """(key0, key1, keep threshold, keep scale): keep iff draw >= thresh."""
    thresh = min(int(round(rate * 2.0 ** 32)), _MASK32)
    return seed & _MASK32, (seed >> 32) & _MASK32, thresh, 1.0 / (1.0 - rate)


def keep_bits(B: int, H: int, T: int, rate: float, seed: int, *, causal: bool,
              device=None) -> torch.Tensor:
    """The mask's keep bits as the backward kernels read them: (B*H, n, n,
    128) int32 words, n = ceil(T / 64).  Word 2r + w of tile (qt, kt) holds
    keys 64 kt + 32 w .. + 31 of query 64 qt + r (bit i: key 64 kt + 32 w + i,
    1 = kept); tiles a causal row does not reach are 0.  The plain version
    of the keep-bit pre-pass kernel."""
    n = -(-T // 64)
    keep = dropout_mask(B, H, n * 64, rate, seed, device=device) > 0
    keep = keep.view(B * H, n, 64, n, 2, 32)
    words = torch.zeros(keep.shape[:-1], dtype=torch.int64, device=device)
    for i in range(32):
        words |= keep[..., i].to(torch.int64) << i
    words = words.permute(0, 1, 3, 2, 4).reshape(B * H, n, n, 128)
    if causal:
        words = words * torch.ones(n, n, dtype=torch.int64, device=device).tril()[None, :, :, None]
    return (words - ((words >> 31) << 32)).to(torch.int32)  # the uint32 words' bits


def dropout_mask(B: int, H: int, T: int, rate: float, seed: int, *,
                 device=None, dtype=torch.float32) -> torch.Tensor:
    """(B, H, T, T) keep-scale (0 or 1/(1-rate)) the kernels apply."""
    key0, key1, thresh, scale = _dropout_params(rate, seed)
    i64 = dict(dtype=torch.int64, device=device)
    k4 = torch.arange((T + 3) // 4, **i64).view(1, 1, -1)
    q = torch.arange(T, **i64).view(1, -1, 1)
    bh = torch.arange(B * H, **i64).view(-1, 1, 1)
    zero = torch.zeros((), **i64)
    words = torch.stack(philox4x32_10(k4, q, bh, zero, key0, key1), dim=-1)
    words = words.reshape(B * H, T, -1)[..., :T]
    return ((words >= thresh).to(dtype) * scale).view(B, H, T, T)


# -- plain PyTorch versions ---------------------------------------------------

def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _masked_scores(q, k, *, causal, scale, kv_mask):
    """scale * Q K^T in the compute dtype, -inf where a key is masked."""
    ct = _compute_dtype(q)
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    T = q.shape[1]
    if causal:
        tril = torch.ones(T, T, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~tril, -math.inf)
    if kv_mask is not None:
        s = s.masked_fill(~(kv_mask > 0)[:, None, None, :], -math.inf)
    return s


def _dense_with_lse(q, k, v, *, causal, scale, kv_mask=None,
                    dropout_rate=0.0, dropout_rng=None):
    """(out, lse) with dense tensors: the plain version of the forward
    kernel.  lse: (B, H, T) in float32 (float64 for float64 inputs), -1e30
    for rows with no valid key.  ``dropout_rng`` is the integer seed."""
    s = _masked_scores(q, k, causal=causal, scale=scale, kv_mask=kv_mask)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    l_safe = l.clamp_min(1e-30)
    lse = torch.where(l > 0, m_safe + torch.log(l_safe), torch.full_like(l, -1e30))
    probs = p / l_safe[..., None]
    if dropout_rate > 0.0:
        B, T, H, _ = q.shape
        probs = probs * dropout_mask(B, H, T, dropout_rate, dropout_rng,
                                     device=q.device, dtype=probs.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(probs.dtype))
    return out.to(q.dtype), lse


def _dense(q, k, v, *, causal, scale, kv_mask=None, dropout_rate=0.0,
           dropout_rng=None):
    """Plain attention output (B, T, H, D) in the input dtype."""
    return _dense_with_lse(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask,
                           dropout_rate=dropout_rate, dropout_rng=dropout_rng)[0]


def _dense_grads(q, k, v, o, g, lse, g_lse, kv_mask, *, causal, scale,
                 dropout_rate, seed):
    """The backward kernels' arithmetic with dense tensors: (P*M, dS)."""
    s = _masked_scores(q, k, causal=causal, scale=scale, kv_mask=kv_mask)
    ct = s.dtype
    p = torch.exp(s - lse.to(ct)[..., None])
    delta = (g.to(ct) * o.to(ct)).sum(-1).permute(0, 2, 1)  # (B, H, T)
    if g_lse is not None:
        delta = delta - g_lse.to(ct)
    dp = torch.einsum("bqhd,bkhd->bhqk", g.to(ct), v.to(ct))
    pv = p
    if dropout_rate > 0.0:
        B, T, H, _ = q.shape
        keep = dropout_mask(B, H, T, dropout_rate, seed, device=q.device, dtype=ct)
        pv, dp = p * keep, dp * keep
    return pv, p * (dp - delta[..., None]) * scale


def _plain_bwd_delta(o, g, g_lse):
    """Delta = rowsum(dO * O) - g_lse, (B, H, T) in the compute dtype: the
    plain version of the pre-pass kernel (the term ``_dense_grads`` forms)."""
    ct = _compute_dtype(o)
    delta = (g.to(ct) * o.to(ct)).sum(-1).permute(0, 2, 1)
    return delta if g_lse is None else delta - g_lse.to(ct)


def _plain_bwd_dq(q, k, v, o, g, lse, g_lse, kv_mask, *, causal, scale,
                  dropout_rate, seed):
    _, ds = _dense_grads(q, k, v, o, g, lse, g_lse, kv_mask, causal=causal,
                         scale=scale, dropout_rate=dropout_rate, seed=seed)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.to(ds.dtype)).to(q.dtype)


def _plain_bwd_dkv(q, k, v, o, g, lse, g_lse, kv_mask, *, causal, scale,
                   dropout_rate, seed):
    pv, ds = _dense_grads(q, k, v, o, g, lse, g_lse, kv_mask, causal=causal,
                          scale=scale, dropout_rate=dropout_rate, seed=seed)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(ds.dtype))
    dv = torch.einsum("bhqk,bqhd->bkhd", pv, g.to(pv.dtype))
    return dk.to(k.dtype), dv.to(v.dtype)


# -- kernel wrappers ----------------------------------------------------------

def _on_cpu(*xs) -> bool:
    """True when every given tensor is on the CPU, False when all are on
    one CUDA device; raises otherwise (a kernel must not get a host or a
    foreign device's pointer)."""
    devices = {x.device for x in xs if x is not None}
    if len(devices) != 1 or next(iter(devices)).type not in ("cpu", "cuda"):
        raise ValueError("flash attention needs all inputs on one cpu/cuda device, got "
                         + ", ".join(sorted(map(str, devices))))
    return next(iter(devices)).type == "cpu"


def _check(q, *others):
    """Raise on inputs the CUDA kernels do not take."""
    if q.dim() != 4:
        raise ValueError(f"expected (B, T, H, D) inputs, got shape {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash kernels take float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash kernels take head_dim in {HEAD_DIMS}, got {q.shape[-1]}")
    for x in (q, *others):
        if x.shape != q.shape or x.dtype != q.dtype:
            raise ValueError("q, k, v (and o, dO) must share shape and dtype")
        if x.stride(-1) != 1:
            raise ValueError("flash kernels need a contiguous head dim (stride(-1) == 1)")


def _strides(x):
    return [x.stride(0), x.stride(1), x.stride(2)]


# The helpers below return the converted tensor with its pointer: callers
# hold the tensor until the launch has been enqueued.
def _mask_ptr(kv_mask, B, T):
    if kv_mask is None:
        return None, None
    m = (kv_mask > 0).to(torch.int32).contiguous()  # a key is real where kv_mask > 0
    if m.shape != (B, T):
        raise ValueError(f"kv_mask must be (B, T) = {(B, T)}, got {tuple(m.shape)}")
    return m, m.data_ptr()


def _f32_ptr(x, shape):
    if x is None:
        return None, None
    x = x.to(torch.float32).contiguous()
    if x.shape != shape:
        raise ValueError(f"expected a {shape} float32 row statistic, got {tuple(x.shape)}")
    return x, x.data_ptr()


def _aligned(x):
    """``x``, or a contiguous copy of it where the kernels' 16-byte loads
    could not read its rows in place."""
    per16 = 16 // x.element_size()
    if x.data_ptr() % 16 or any(st % per16 for st in x.stride()[:3]):
        return x.clone(memory_format=torch.contiguous_format)
    return x


def _keep_args(rate: float, keep: Optional[torch.Tensor], shape):
    """(keep bits pointer, drop_scale) for the backward kernels."""
    if rate <= 0.0:
        return [None, 1.0]
    B, T, H, _ = shape
    n = -(-T // 64)
    if (keep is None or keep.shape != (B * H, n, n, 128) or keep.dtype != torch.int32
            or not keep.is_contiguous()):
        raise ValueError(f"dropout needs the (B*H, {n}, {n}, 128) int32 keep bits of "
                         "flash_bwd_keep")
    return [keep.data_ptr(), 1.0 / (1.0 - rate)]


def _drop_args(rate: float, seed: Optional[int]):
    if rate <= 0.0:
        return [0, 0, 0, 1.0, 0]
    key0, key1, thresh, scale = _dropout_params(rate, seed)
    return [key0, key1, thresh, scale, 1]


def _launch(name: str, *args) -> None:
    lib = _build.load(name, _ARGTYPES[name])
    err = getattr(lib, f"dtt_{name}")(*args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
    LAUNCHES[name] += 1


def flash_fwd(q, k, v, kv_mask=None, *, causal, scale, dropout_rate=0.0,
              seed=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: (out (B, T, H, D), lse (B, H, T) float32)."""
    if _on_cpu(q, k, v, kv_mask):
        return _dense_with_lse(q, k, v, causal=causal, scale=scale, kv_mask=kv_mask,
                               dropout_rate=dropout_rate, dropout_rng=seed)
    _check(q, k, v)
    if q.dtype == torch.bfloat16 and not scale > 0.0:  # its row max is on the raw scores
        raise ValueError(f"the bf16 flash forward kernel takes a positive scale, got {scale}")
    B, T, H, D = q.shape
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    mask, mask_ptr = _mask_ptr(kv_mask, B, T)
    _launch("flash_fwd", _DTYPE_CODE[q.dtype], D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_ptr, out.data_ptr(), lse.data_ptr(),
            B, H, T, *_strides(q), *_strides(k), *_strides(v), *_strides(out),
            scale, int(causal), *_drop_args(dropout_rate, seed),
            torch.cuda.current_stream(q.device).cuda_stream)
    return out, lse


def flash_bwd_delta(o, g, g_lse=None) -> torch.Tensor:
    """Delta pre-pass kernel: rowsum(dO * O) - g_lse, (B, H, T) float32."""
    if _on_cpu(o, g, g_lse):
        return _plain_bwd_delta(o, g, g_lse)
    _check(o, g)
    B, T, H, D = o.shape
    o, g = _aligned(o), _aligned(g)
    g_lse, g_lse_ptr = _f32_ptr(g_lse, (B, H, T))
    delta = torch.empty((B, H, T), dtype=torch.float32, device=o.device)
    _launch("flash_bwd_delta", _DTYPE_CODE[o.dtype], D, o.data_ptr(), g.data_ptr(),
            g_lse_ptr, delta.data_ptr(), B, H, T, *_strides(o), *_strides(g),
            torch.cuda.current_stream(o.device).cuda_stream)
    return delta


def flash_bwd_keep(q, *, causal, dropout_rate, seed) -> torch.Tensor:
    """Keep-bit pre-pass kernel: the dropout mask of (dropout_rate, seed) for
    q's (B, T, H) as ``keep_bits`` lays it out, drawn once for both backward
    kernels."""
    B, T, H, _ = q.shape
    if _on_cpu(q):
        return keep_bits(B, H, T, dropout_rate, seed, causal=causal, device=q.device)
    n = -(-T // 64)
    bits = torch.empty((B * H, n, n, 128), dtype=torch.int32, device=q.device)
    key0, key1, thresh, _ = _dropout_params(dropout_rate, seed)
    _launch("flash_bwd_keep", bits.data_ptr(), B, H, T, int(causal), key0, key1, thresh,
            torch.cuda.current_stream(q.device).cuda_stream)
    return bits


def _bwd_operands(q, k, v, o, g, lse, g_lse, delta, keep, causal, dropout_rate, seed):
    """The backward kernels' inputs: aligned q/k/v/dO, float32 lse and Delta,
    and the keep bits under dropout (each from its pre-pass unless given)."""
    _check(q, k, v, o, g)
    B, T, H, _ = q.shape
    if delta is None:
        delta = flash_bwd_delta(o, g, g_lse)
    if dropout_rate > 0.0 and keep is None:
        keep = flash_bwd_keep(q, causal=causal, dropout_rate=dropout_rate, seed=seed)
    lse, lse_ptr = _f32_ptr(lse, (B, H, T))
    delta, delta_ptr = _f32_ptr(delta, (B, H, T))
    return ([_aligned(x) for x in (q, k, v, g)], (lse, lse_ptr), (delta, delta_ptr),
            (keep, _keep_args(dropout_rate, keep, q.shape)))


def _fold_delta(o, g, g_lse, delta):
    """The g_lse that makes the plain versions use ``delta`` as Delta (they
    form rowsum(dO * O) - g_lse themselves)."""
    return g_lse if delta is None else _plain_bwd_delta(o, g, None) - delta


def flash_bwd_dq(q, k, v, o, g, lse, g_lse=None, kv_mask=None, *, causal, scale,
                 dropout_rate=0.0, seed=None, delta=None, keep=None) -> torch.Tensor:
    """dQ kernel: (B, T, H, D) in the input dtype.  ``delta`` (B, H, T), when
    given, replaces rowsum(dO * O) - g_lse (``flash_bwd_delta``); ``keep``,
    when given, is the mask's bits (``flash_bwd_keep``) for (dropout_rate,
    seed), which the plain version draws itself."""
    if _on_cpu(q, k, v, o, g, lse, g_lse, kv_mask, delta, keep):
        return _plain_bwd_dq(q, k, v, o, g, lse, _fold_delta(o, g, g_lse, delta), kv_mask,
                             causal=causal, scale=scale, dropout_rate=dropout_rate, seed=seed)
    (q, k, v, g), (lse, lse_ptr), (delta, delta_ptr), (keep, keep_args) = _bwd_operands(
        q, k, v, o, g, lse, g_lse, delta, keep, causal, dropout_rate, seed)
    B, T, H, D = q.shape
    mask, mask_ptr = _mask_ptr(kv_mask, B, T)
    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch("flash_bwd_dq", _DTYPE_CODE[q.dtype], D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse_ptr, delta_ptr, mask_ptr, dq.data_ptr(), B, H, T,
            *_strides(q), *_strides(k), *_strides(v), *_strides(g),
            *_strides(dq), scale, int(causal), *keep_args,
            torch.cuda.current_stream(q.device).cuda_stream)
    return dq


def flash_bwd_dkv(q, k, v, o, g, lse, g_lse=None, kv_mask=None, *, causal, scale,
                  dropout_rate=0.0, seed=None, delta=None,
                  keep=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel: two (B, T, H, D) tensors in the input dtype.  ``delta``
    and ``keep`` as for ``flash_bwd_dq``."""
    if _on_cpu(q, k, v, o, g, lse, g_lse, kv_mask, delta, keep):
        return _plain_bwd_dkv(q, k, v, o, g, lse, _fold_delta(o, g, g_lse, delta), kv_mask,
                              causal=causal, scale=scale, dropout_rate=dropout_rate, seed=seed)
    (q, k, v, g), (lse, lse_ptr), (delta, delta_ptr), (keep, keep_args) = _bwd_operands(
        q, k, v, o, g, lse, g_lse, delta, keep, causal, dropout_rate, seed)
    B, T, H, D = q.shape
    mask, mask_ptr = _mask_ptr(kv_mask, B, T)
    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    _launch("flash_bwd_dkv", _DTYPE_CODE[q.dtype], D,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            lse_ptr, delta_ptr, mask_ptr, dk.data_ptr(), dv.data_ptr(), B, H, T,
            *_strides(q), *_strides(k), *_strides(v), *_strides(g),
            *_strides(dk), *_strides(dv), scale, int(causal), *keep_args,
            torch.cuda.current_stream(q.device).cuda_stream)
    return dk, dv


# -- autograd -----------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Replaces both custom VJPs of the reference, ``_flash`` and
    ``_flash_lse``: the forward always returns (out, lse), and an lse whose
    cotangent is unused arrives here as ``None`` (no g_lse term)."""

    @staticmethod
    def forward(ctx, q, k, v, kv_mask, seed, causal, scale, dropout_rate):
        out, lse = flash_fwd(q, k, v, kv_mask, causal=causal, scale=scale,
                             dropout_rate=dropout_rate, seed=seed)
        ctx.save_for_backward(q, k, v, out, lse, kv_mask)
        ctx.args = dict(causal=causal, scale=scale, dropout_rate=dropout_rate, seed=seed)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, g_lse):
        q, k, v, out, lse, kv_mask = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(out)
        elif g_out.stride(-1) != 1:
            g_out = g_out.contiguous()
        # Delta and the dropout bits once, for both kernels.
        pre = dict(delta=flash_bwd_delta(out, g_out, g_lse), **ctx.args)
        if ctx.args["dropout_rate"] > 0.0:
            pre["keep"] = flash_bwd_keep(q, causal=ctx.args["causal"],
                                         dropout_rate=ctx.args["dropout_rate"],
                                         seed=ctx.args["seed"])
        dq = flash_bwd_dq(q, k, v, out, g_out, lse, g_lse, kv_mask, **pre)
        dk, dv = flash_bwd_dkv(q, k, v, out, g_out, lse, g_lse, kv_mask, **pre)
        return dq, dk, dv, None, None, None, None, None


def _prepare(q, scale, dropout_rate, dropout_rng):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if dropout_rate > 0.0 and dropout_rng is None:
        raise ValueError("dropout_rate > 0 requires dropout_rng")
    return float(scale), (int(dropout_rng) if dropout_rate > 0.0 else None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    kv_mask: Optional[torch.Tensor] = None, dropout_rate: float = 0.0,
                    dropout_rng: Optional[int] = None) -> torch.Tensor:
    """Fused attention. q/k/v: (B, T, H, D) -> (B, T, H, D).

    ``kv_mask``: optional (B, T) key-validity mask (>0 = real token); it
    masks keys only.  ``dropout_rate``/``dropout_rng``: attention-
    probability dropout keyed by the integer seed ``dropout_rng`` (the
    Philox key), regenerated identically by the backward kernels.
    """
    scale, seed = _prepare(q, scale, dropout_rate, dropout_rng)
    out, _ = _FlashAttention.apply(q, k, v, kv_mask, seed, causal, scale, float(dropout_rate))
    return out


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                             causal: bool = True, scale: Optional[float] = None,
                             kv_mask: Optional[torch.Tensor] = None,
                             dropout_rate: float = 0.0,
                             dropout_rng: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused attention returning (out, lse), differentiable in both.

    out: (B, T, H, D); lse: (B, H, T) float32 logsumexp of the scaled
    scores.  Rows with no valid key give out = 0 and lse = -1e30.  l and lse
    use the undropped probabilities, so dropout composes exactly with ring
    attention's lse combine.
    """
    scale, seed = _prepare(q, scale, dropout_rate, dropout_rng)
    return _FlashAttention.apply(q, k, v, kv_mask, seed, causal, scale, float(dropout_rate))
