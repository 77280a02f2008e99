"""The port's flash attention against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; the
reference runs its Pallas kernels in the interpreter
(DTT_PALLAS_INTERPRET=1) with 128-blocks, so T=384 iterates over 3x3
tiles.  Inputs are made with numpy from a seed and fed to both.  The CUDA
kernels themselves are held against the same plain versions on the card by
chip_smoke.py.
"""

import ctypes
import importlib
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_faults  # noqa: E402
from distributed_tensorflow_tpu_torch.ops import flash_attention as tfa  # noqa: E402

# The reference's own tolerances for its interpreted kernels (f32).
FWD_TOL = 2e-5
BWD_TOL = 2e-4


def make_inputs(B=2, T=384, H=2, D=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(4)]


@pytest.fixture
def jfa(monkeypatch):
    """The reference module with its kernels interpreted on 128-blocks."""
    monkeypatch.setenv("DTT_PALLAS_INTERPRET", "1")
    mod = importlib.import_module("distributed_tensorflow_tpu.ops.flash_attention")
    monkeypatch.setattr(mod, "BLOCK_Q", 128)
    monkeypatch.setattr(mod, "BLOCK_K", 128)
    return mod


@pytest.mark.parametrize("causal,masked,with_lse", [
    (False, False, False),
    (True, False, False),
    (False, True, True),
    (True, True, True),
])
def test_forward_and_backward_match_interpreted_kernels(jfa, causal, masked, with_lse):
    """out (and lse), then dq/dk/dv through the autograd.Function, against
    jax.vjp of the interpreted kernels; with_lse adds an lse cotangent."""
    q, k, v, g = make_inputs(seed=3 + 2 * causal + masked)
    B, T, H, _ = q.shape
    rng = np.random.RandomState(11)
    g_lse = rng.randn(B, H, T).astype(np.float32)
    mask = None
    if masked:  # one length crosses a 128-block boundary
        mask = (np.arange(T)[None, :] < np.array([300, 100])[:, None]).astype(np.int32)

    def jfn(q_, k_, v_):
        kw = dict(causal=causal, kv_mask=None if mask is None else jnp.asarray(mask))
        if with_lse:
            return jfa.flash_attention_with_lse(q_, k_, v_, **kw)
        return jfa.flash_attention(q_, k_, v_, **kw)

    jout, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    jgrads = vjp((jnp.asarray(g), jnp.asarray(g_lse)) if with_lse else jnp.asarray(g))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kw = dict(causal=causal, kv_mask=None if mask is None else torch.from_numpy(mask))
    if with_lse:
        out, lse = tfa.flash_attention_with_lse(tq, tk, tv, **kw)
        np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jout[1]),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                    (torch.from_numpy(g), torch.from_numpy(g_lse)))
        jout = jout[0]
    else:
        out = tfa.flash_attention(tq, tk, tv, **kw)
        grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=BWD_TOL, atol=BWD_TOL,
                                   err_msg=name)


def test_plain_matches_reference_dense_on_ragged_shape(jfa):
    """T=200 (not a block multiple) falls back to the reference's dense
    path; the port takes any T."""
    q, k, v, _ = make_inputs(B=1, T=200, H=2, D=32, seed=5)
    want = jfa._dense(*map(jnp.asarray, (q, k, v)), causal=True, scale=1 / np.sqrt(32))
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL, atol=FWD_TOL)


def test_row_without_valid_key_gives_zero_out_and_floor_lse():
    q, k, v, _ = make_inputs(B=2, T=8, H=1, D=16, seed=6)
    mask = torch.tensor([[1] * 8, [0] * 8], dtype=torch.int32)
    out, lse = tfa.flash_attention_with_lse(*map(torch.from_numpy, (q, k, v)), causal=False,
                                            kv_mask=mask)
    assert torch.all(out[1] == 0)
    assert torch.all(lse[1] == -1e30)
    assert torch.all(torch.isfinite(lse[0]))


class TestPhilox:
    @pytest.mark.parametrize("counter,key,want", [
        (0, 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        (0xFFFFFFFF, 0xFFFFFFFF, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ])
    def test_known_answer(self, counter, key, want):
        """Random123's published philox4x32-10 vectors."""
        c = torch.tensor(counter, dtype=torch.int64)
        got = tfa.philox4x32_10(c, c, c, c, key, key)
        assert tuple(int(w) for w in got) == want

    def test_mask_depends_only_on_element_position(self):
        """A longer sequence's mask extends the shorter one's: the counter
        is (key // 4, query, b*H + h), not a tile index."""
        small = tfa.dropout_mask(2, 3, 10, 0.3, seed=99)
        big = tfa.dropout_mask(2, 3, 37, 0.3, seed=99)
        assert torch.equal(small, big[:, :, :10, :10])
        assert set(torch.unique(big).tolist()) == {0.0, float(np.float32(1 / 0.7))}

    def test_keep_rate(self):
        m = tfa.dropout_mask(4, 4, 128, 0.1, seed=5)
        keep = float((m > 0).float().mean())
        assert abs(keep - 0.9) < 0.005, keep


class TestDropout:
    def _qkv(self, seed, **kw):
        return [torch.from_numpy(x) for x in make_inputs(seed=seed, **kw)[:3]]

    def test_rate_zero_is_exact(self):
        q, k, v = self._qkv(11, T=64)
        base = tfa.flash_attention(q, k, v, causal=True)
        zero = tfa.flash_attention(q, k, v, causal=True, dropout_rate=0.0, dropout_rng=3)
        assert torch.equal(base, zero)

    def test_deterministic_per_seed_and_varies_across_seeds(self):
        q, k, v = self._qkv(12, T=64)
        a = tfa.flash_attention(q, k, v, causal=False, dropout_rate=0.3, dropout_rng=1)
        b = tfa.flash_attention(q, k, v, causal=False, dropout_rate=0.3, dropout_rng=1)
        c = tfa.flash_attention(q, k, v, causal=False, dropout_rate=0.3, dropout_rng=2)
        assert torch.equal(a, b)
        assert not torch.allclose(a, c)

    def test_dropout_is_unbiased(self):
        q, k, v = self._qkv(13, B=1, T=128, H=1, D=32)
        want = tfa.flash_attention(q, k, v, causal=False)
        n = 48
        acc = sum(tfa.flash_attention(q, k, v, causal=False, dropout_rate=0.25,
                                      dropout_rng=100 + s) for s in range(n))
        err = float((acc / n - want).abs().max() / want.abs().max())
        assert err < 0.15, f"dropout mean deviates {err:.3f} from undropped"

    def test_backward_matches_autograd_of_plain_forward(self):
        """The flash backward formulas (used on the CPU and by the kernels)
        equal torch.autograd through the dense forward under the same
        mask, in float64, with and without an lse cotangent."""
        rng = np.random.RandomState(14)
        q, k, v, g = (torch.from_numpy(rng.randn(2, 40, 2, 16)) for _ in range(4))
        g_lse = torch.from_numpy(rng.randn(2, 2, 40))
        mask = (torch.arange(40)[None, :] < torch.tensor([40, 23])[:, None]).int()
        kw = dict(causal=True, scale=0.25, kv_mask=mask, dropout_rate=0.2, dropout_rng=7)
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        got = torch.autograd.grad(tfa.flash_attention_with_lse(*xs, **kw), xs, (g, g_lse))
        ys = [x.clone().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(tfa._dense_with_lse(*ys, **kw), ys, (g, g_lse))
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10, msg=name)

    def test_requires_rng(self):
        q, k, v = self._qkv(15, T=16)
        with pytest.raises(ValueError):
            tfa.flash_attention(q, k, v, dropout_rate=0.5)


class TestWrapperChecks:
    def test_no_fallback_off_the_cpu(self):
        """A tensor that is not on the CPU never reaches the plain version."""
        q = torch.empty(1, 8, 1, 16, device="meta")
        with pytest.raises(ValueError, match="cpu/cuda"):
            tfa.flash_fwd(q, q, q, causal=True, scale=1.0)

    @pytest.mark.parametrize("which", ["lse", "g_lse"])
    def test_backward_checks_the_row_statistics_device(self, which):
        """lse and g_lse are passed to the kernels by pointer too: one on
        another device than q raises instead of reaching a kernel."""
        x = torch.zeros(1, 8, 1, 16)
        stats = {"lse": torch.zeros(1, 1, 8), "g_lse": torch.zeros(1, 1, 8)}
        stats[which] = stats[which].to("meta")
        for fn in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv):
            with pytest.raises(ValueError, match="cpu/cuda"):
                fn(x, x, x, x, x, stats["lse"], stats["g_lse"], causal=True, scale=1.0)

    @pytest.mark.parametrize("mask", [
        [[0.5, 0.0, 1.0, 2.0]],
        [[True, False, True, True]],
        [[1, 0, 3, 1]],
    ])
    def test_kernel_key_mask_keeps_keys_above_zero(self, mask):
        """The kernels' int32 mask keeps a key where kv_mask > 0, as the
        plain version does (a fractional mask is not truncated to 0)."""
        m, _ = tfa._mask_ptr(torch.tensor(mask), 1, 4)
        assert m.dtype == torch.int32
        assert m.tolist() == [[1, 0, 1, 1]]

    @pytest.mark.parametrize("shape,dtype,match", [
        ((1, 8, 1, 48), torch.float32, "head_dim"),
        ((1, 8, 1, 16), torch.float16, "float32 or bfloat16"),
        ((8, 1, 16), torch.float32, r"\(B, T, H, D\)"),
    ])
    def test_rejects_what_the_kernels_do_not_take(self, shape, dtype, match):
        with pytest.raises(ValueError, match=match):
            tfa._check(torch.zeros(shape, dtype=dtype))

    def test_rejects_strided_head_dim(self):
        x = torch.zeros(1, 8, 1, 32)[..., ::2]
        with pytest.raises(ValueError, match="contiguous head dim"):
            tfa._check(x)


class TestKeepBits:
    @pytest.mark.parametrize("causal", [False, True])
    def test_bits_are_the_dropout_mask(self, causal):
        """Bit i of word 2r + w of tile (qt, kt) keeps key 64kt + 32w + i of
        query 64qt + r, as dropout_mask draws it; a causal row's unreached
        tiles are 0."""
        B, H, T = 2, 3, 150
        words = tfa.flash_bwd_keep(torch.zeros(B, T, H, 16), causal=causal, dropout_rate=0.3,
                                   seed=99)
        n = 3
        assert words.shape == (B * H, n, n, 128) and words.dtype == torch.int32
        bits = (words.to(torch.int64) & 0xFFFFFFFF)[..., None] >> torch.arange(32) & 1
        bits = bits.view(B * H, n, n, 64, 2, 32).permute(0, 1, 3, 2, 4, 5)
        keep = bits.reshape(B * H, n * 64, n * 64)[:, :T, :T].bool()
        want = tfa.dropout_mask(B, H, T, 0.3, seed=99).view(B * H, T, T) > 0
        if causal:
            reached = torch.ones(n, n, dtype=torch.bool).tril()
            want = want & reached.repeat_interleave(64, 0).repeat_interleave(64, 1)[:T, :T]
        assert torch.equal(keep, want)

    def test_kernels_refuse_dropout_without_the_bits(self):
        with pytest.raises(ValueError, match="keep bits"):
            tfa._keep_args(0.1, None, (1, 64, 1, 16))
        assert tfa._keep_args(0.0, None, (1, 64, 1, 16)) == [None, 1.0]


class TestDeltaPrepass:
    def _inputs(self, seed=21, B=2, T=40, H=3, D=16):
        rng = np.random.RandomState(seed)
        o, g = (torch.from_numpy(rng.randn(B, T, H, D).astype(np.float32)) for _ in range(2))
        return o, g, torch.from_numpy(rng.randn(B, H, T).astype(np.float32))

    @pytest.mark.parametrize("with_glse", [False, True])
    def test_plain_delta_is_rowsum_of_do_times_o_minus_glse(self, with_glse):
        o, g, g_lse = self._inputs()
        got = tfa.flash_bwd_delta(o, g, g_lse if with_glse else None)
        want = np.einsum("bthd,bthd->bht", g.numpy().astype(np.float64),
                         o.numpy().astype(np.float64))
        if with_glse:
            want = want - g_lse.numpy()
        assert got.shape == (2, 3, 40) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    def test_backward_through_a_given_delta_equals_the_backward_without(self):
        """A precomputed Delta (what the autograd backward passes both
        kernels) gives the gradients of the path that forms it from dO, O
        and g_lse; a different Delta changes them, so it is really read."""
        rng = np.random.RandomState(22)
        q, k, v, g = (torch.from_numpy(rng.randn(2, 48, 2, 16)) for _ in range(4))
        g_lse = torch.from_numpy(rng.randn(2, 2, 48))
        kw = dict(causal=True, scale=0.25, dropout_rate=0.2, seed=9)
        o, lse = tfa._dense_with_lse(q, k, v, causal=True, scale=0.25, dropout_rate=0.2,
                                     dropout_rng=9)
        args = (q, k, v, o, g, lse, g_lse, None)
        delta = tfa.flash_bwd_delta(o, g, g_lse)
        want = (tfa.flash_bwd_dq(*args, **kw), *tfa.flash_bwd_dkv(*args, **kw))
        got = (tfa.flash_bwd_dq(*args, delta=delta, **kw),
               *tfa.flash_bwd_dkv(*args, delta=delta, **kw))
        other = tfa.flash_bwd_dq(*args, delta=delta + 1.0, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=name)
        assert not torch.allclose(other, want[0])


def _c_params(name):
    """The parameter list of ``extern "C" int dtt_<name>(...)`` in its source."""
    text = (Path(tfa.__file__).parent / "csrc" / f"{name}.cu").read_text()
    m = re.search(r'extern "C" int dtt_' + name + r"\(([^)]*)\)", text)
    assert m, f"no extern C entry dtt_{name} in {name}.cu"
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", tfa._build.KERNELS)
def test_ctypes_argtypes_match_the_c_entry(name):
    """ctypes passes exactly the C entry's parameters, each with its width:
    a mismatch would otherwise show only on the card, as a garbage pointer."""
    want = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint, "float": ctypes.c_float,
            "long long": ctypes.c_longlong}
    params = _c_params(name)
    assert len(params) == len(tfa._ARGTYPES[name])
    for param, argtype in zip(params, tfa._ARGTYPES[name]):
        ctype = param.rsplit(" ", 1)[0].replace("const ", "").strip()
        assert argtype == (ctypes.c_void_p if "*" in param else want[ctype]), param


@pytest.mark.parametrize("name", [n for n, f in chip_faults.FAULTS.items() if f[0]])
def test_planted_fault_applies_to_the_kernel_source(name):
    """chip_faults.py plants each fault by replacing text that must occur
    exactly once in its kernel source, so an edit of a kernel cannot
    silently turn a planted fault into no change."""
    src, old, new, must_fail = chip_faults.FAULTS[name]
    text = (Path(tfa.__file__).parent / "csrc" / src).read_text()
    assert text.count(old) == 1
    assert new != old and must_fail
