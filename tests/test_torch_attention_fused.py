"""The port's training attention (lightningdot_tpu_torch/ops/
attention_fused.py, attention.py's rate-0 Function and long sequences)
against the JAX package, on the same inputs.

Inputs come from numpy seeds. On the CPU the port takes its plain twins; the
JAX side runs the TPU kernels in interpret mode, as tests/test_attention_
fused.py runs them. Sizes: B 4, S 9 and 33, 3 heads, D 8 (S 192 and 256
for the long-sequence attention twin); in float32 also the shapes the CUDA
kernels' tiling must get right: S 104 with a ragged key bias, S 65 (one
query past a 64-row tile) and head dim 32. The CUDA kernels are held
against the same twins by the ``cuda``-marked test at the end and by
chip_smoke.py.

Tolerances, relative to the largest magnitude of the JAX result: float32
1e-5 (the same math summed in another order); bfloat16 2**-7, one bf16 ulp
at the peak (a probability that lands on the other side of a bf16 rounding
boundary when its float32 value differs in the last bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.ops import attention as jattn
from lightningdot_tpu.ops import fused as jfused
from lightningdot_tpu.ops.experimental import attention_fused as jaf
from lightningdot_tpu_torch.ops import attention, attention_fused as af
from lightningdot_tpu_torch.ops import launch_counts

B, NH, HD = 4, 3, 8
W = NH * HD
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7)}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _inputs(s, seed, n=4, hd=HD):
    """q, k, v (and more) [B, s, NH * hd] and a ragged [B, s] key bias."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((B, s, NH * hd)).astype(np.float32)
              for _ in range(n)]
    mask = np.ones((B, s), np.float32)
    for i in range(B):
        mask[i, rng.integers(1, s + 1):] = 0
    return arrays, (1.0 - mask) * -10000.0


def _both(a, dtype):
    tdt, jdt, _ = DTYPES[dtype]
    return (torch.from_numpy(a).to(tdt),
            jnp.asarray(a, jnp.float32).astype(jdt))


def _r4(x):
    return x.reshape(x.shape[0], x.shape[1], NH, -1)


SEED = torch.tensor([0x1234_5678_9ABC_DEF], dtype=torch.int64)


# ---------------------------------------------------------------------------
# Philox
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors of philox4x32-10."""
    words = af.philox4x32([torch.tensor(c) for c in counter],
                          [torch.tensor(k) for k in key])
    assert tuple(int(w) for w in words) == want


def test_philox_keep_statistics_and_seeds():
    """Keep fraction 0.9 +- 0.005 over 1.08e6 draws at rate 0.1; the keep
    rule of ``_keep_from_bits``; one seed one mask, another seed another;
    the seed's high word counts."""
    keep = af.philox_keep(SEED, 4, 3, 300, 300, 0.1)
    assert keep.shape == (4, 3, 300, 300) and keep.dtype == torch.bool
    assert abs(keep.float().mean().item() - 0.9) <= 0.005
    assert torch.equal(keep, af.philox_keep(SEED, 4, 3, 300, 300, 0.1))
    for other in (SEED + 1, SEED + (1 << 40)):
        assert not torch.equal(keep, af.philox_keep(other, 4, 3, 300, 300,
                                                    0.1))
    assert af.keep_threshold(0.1) == int(np.uint32(0.9 * 4294967296.0))
    assert af.keep_threshold(0.0) == 4294967295
    # element (b, h, i, j) is word j % 4 of philox((j // 4, i, h, b), seed)
    s = int(SEED)
    words = af.philox4x32([torch.tensor(x) for x in (7 // 4, 5, 2, 3)],
                          (torch.tensor(s & 0xFFFFFFFF),
                           torch.tensor(s >> 32)))
    assert bool(keep[3, 2, 5, 7]) == (int(words[7 % 4])
                                      < af.keep_threshold(0.1))


def test_philox_keep_is_grid_independent():
    """The mask is a function of each element's coordinates: a smaller
    mask is a corner of a larger one, whatever the blocking of columns
    into fours."""
    big = af.philox_keep(SEED, 5, 4, 40, 43, 0.3)
    assert torch.equal(af.philox_keep(SEED, 3, 2, 33, 9, 0.3),
                       big[:3, :2, :33, :9])


def test_site_seeds_are_a_function_of_the_host_seed():
    a = af.site_seeds(12345, 12, torch.device("cpu"))
    assert a.dtype == torch.int64 and a.shape == (12,)
    assert torch.equal(a, af.site_seeds(12345, 12, torch.device("cpu")))
    assert len(set(a.tolist())) == 12
    assert not torch.equal(a, af.site_seeds(12346, 12, torch.device("cpu")))
    assert torch.equal(a[:3], af.site_seeds(12345, 3, torch.device("cpu")))


# ---------------------------------------------------------------------------
# The twins against the TPU kernels (interpret mode) and the composition
# ---------------------------------------------------------------------------

# the twins against the TPU kernels in interpret mode: float32 within 1e-5;
# bfloat16 bit for bit at these inputs (the rounding points are the same,
# and the float32 sums, ordered differently, differ below every bf16
# rounding they feed)
RATE0_TOL = {"float32": 1e-5, "bfloat16": 0.0}


# (dtype, S, head dim): S 9 and 33 in both dtypes; in float32 the shapes
# the CUDA kernels' tiles must get right: S 104 (ragged key bias), S 65 (one
# query past a 64-row tile) and head dim 32
TWIN_CASES = [pytest.param(dt, s, HD, id=f"{dt}-{s}")
              for dt in ("float32", "bfloat16") for s in (9, 33)] + [
    pytest.param("float32", 104, HD, id="float32-104"),
    pytest.param("float32", 65, HD, id="float32-65"),
    pytest.param("float32", 65, 32, id="float32-65-hd32")]


@pytest.mark.parametrize("dtype,s,hd", TWIN_CASES)
def test_fwd_twin_matches_jax_kernel_rate0(dtype, s, hd):
    (q, k, v, _), bias2d = _inputs(s, seed=1, hd=hd)
    (qt, qj), (kt, kj), (vt, vj) = (_both(a, dtype) for a in (q, k, v))
    got = af._fused_attn_fwd_math(qt, kt, vt, torch.from_numpy(bias2d),
                                  SEED, NH, 0.0, hd ** -0.5)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = jaf.fused_attention_train(qj, kj, vj, jnp.asarray(bias2d), None,
                                     nh=NH, rate=0.0, interpret=True)
    assert _rel(_np(got), np.asarray(want, np.float32)) <= RATE0_TOL[dtype]


@pytest.mark.parametrize("dtype,s,hd", TWIN_CASES)
def test_bwd_twin_matches_jax_kernel_rate0(dtype, s, hd):
    (q, k, v, g), bias2d = _inputs(s, seed=2, hd=hd)
    pairs = [_both(a, dtype) for a in (q, k, v, g)]
    got = af._fused_attn_bwd_math(*(p[0] for p in pairs[:3]),
                                  torch.from_numpy(bias2d), SEED,
                                  pairs[3][0], NH, 0.0, hd ** -0.5)
    qj, kj, vj, gj = (_r4(p[1]) for p in pairs)
    want = jaf._call(jaf._bwd_kernel, 3, qj, kj, vj, jnp.asarray(bias2d),
                     jnp.zeros((1,), jnp.int32), nh=NH, rate=0.0,
                     scale=hd ** -0.5, interpret=True, extra=(gj,))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == pairs[0][0].dtype
        err = _rel(_np(a), np.asarray(w, np.float32).reshape(B, s, -1))
        assert err <= RATE0_TOL[dtype], f"{name}: {err}"


def _core_inputs(s, seed, rate, hd=HD):
    (q, k, v, g), bias2d = _inputs(s, seed, hd=hd)
    keep = af.philox_keep(SEED, B, NH, s, s, rate)
    return q, k, v, g, bias2d, keep


# (S, head dim, rate): rate 0.3 at S 9 and 33; the training rate 0.1 at the
# float32 kernels' tiling shapes (TWIN_CASES)
CORE_CASES = [pytest.param(s, HD, 0.3, id=str(s)) for s in (9, 33)] + [
    pytest.param(104, HD, 0.1, id="104-rate0.1"),
    pytest.param(65, HD, 0.1, id="65-rate0.1"),
    pytest.param(65, 32, 0.1, id="65-hd32-rate0.1")]


@pytest.mark.parametrize("s,hd,rate", CORE_CASES)
def test_twins_match_attn_core_with_the_philox_mask(s, hd, rate):
    """float32, the Philox mask injected into JAX's default composition:
    the forward twin equals ``_attn_core``, the backward twin ``jax.vjp``
    of it (within 1e-5)."""
    q, k, v, g, bias2d, keep = _core_inputs(s, 3, rate, hd)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    out = af._fused_attn_fwd_math(*args, torch.from_numpy(bias2d), SEED, NH,
                                  rate, hd ** -0.5)
    grads = af._fused_attn_bwd_math(*args, torch.from_numpy(bias2d), SEED,
                                    torch.from_numpy(g), NH, rate,
                                    hd ** -0.5)

    def jf(q_, k_, v_):
        o = jfused._attn_core(_r4(q_), _r4(k_), _r4(v_),
                              jnp.asarray(bias2d)[:, None, None, :],
                              jnp.asarray(keep.numpy()), rate, hd ** -0.5,
                              jax.lax.Precision.HIGHEST)
        return o.reshape(B, s, -1)

    want, vjp = jax.vjp(jf, *map(jnp.asarray, (q, k, v)))
    assert _rel(_np(out), np.asarray(want)) <= 1e-5
    for name, a, w in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(g))):
        assert _rel(_np(a), np.asarray(w)) <= 1e-5, name
    # the mask is live: about a share ``rate`` of the probabilities is
    # dropped
    assert abs(keep.float().mean().item() - (1.0 - rate)) < 0.1
    assert not np.allclose(_np(out), _np(af._fused_attn_fwd_math(
        *args, torch.from_numpy(bias2d), SEED, NH, 0.0, hd ** -0.5)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_function_gradients_are_the_bwd_twin(dtype):
    """Autograd through ``fused_attention_train`` at rate 0.3 gives the
    forward twin's output and the backward twin's gradients, bit for bit,
    and launches no kernel on the CPU."""
    tdt = DTYPES[dtype][0]
    rate = 0.3
    q, k, v, g, bias2d, _ = _core_inputs(33, 4, rate)
    ins = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    bias = torch.from_numpy(bias2d)
    gt = torch.from_numpy(g).to(tdt)
    out = af.fused_attention_train(*ins, bias, SEED, nh=NH, rate=rate)
    out.backward(gt)
    plain = [t.detach() for t in ins]
    assert torch.equal(out, af._fused_attn_fwd_math(*plain, bias, SEED, NH,
                                                    rate, HD ** -0.5))
    want = af._fused_attn_bwd_math(*plain, bias, SEED, gt, NH, rate,
                                   HD ** -0.5)
    for t, w in zip(ins, want):
        assert t.grad.dtype == tdt and torch.equal(t.grad, w)
    assert launch_counts()["attention_train_fwd"] == 0
    assert launch_counts()["attention_train_bwd"] == 0


# ---------------------------------------------------------------------------
# Part 1 repairs: attention up to S 256, the rate-0 training Function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [192, 256])
@pytest.mark.parametrize("dtype,defer", [("float32", None),
                                         ("bfloat16", None),
                                         ("bfloat16", False)])
def test_attention_twin_long_sequences_match_jax(s, dtype, defer):
    """B2's twin at the caption buckets above 128, both numeric paths
    (bfloat16 defers by default)."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, s, 2, HD)).astype(np.float32)
               for _ in range(3))
    bias = np.zeros((2, 1, 1, s), np.float32)
    bias[1, ..., s // 3:] = -10000.0
    (qt, qj), (kt, kj), (vt, vj) = (_both(a, dtype) for a in (q, k, v))
    got = attention._attention_math(qt, kt, vt, torch.from_numpy(bias),
                                    HD ** -0.5, defer=defer)
    want = jattn._attention_math(qj, kj, vj, jnp.asarray(bias), HD ** -0.5,
                                 defer=defer)
    assert got.dtype == qt.dtype
    assert _rel(_np(got), np.asarray(want, np.float32)) <= DTYPES[dtype][2]
    if defer is None:
        assert attention.MAX_SEQ >= s
        assert torch.equal(attention.multi_head_attention(
            qt, kt, vt, torch.from_numpy(bias)), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_nodrop_matches_jax(dtype):
    """The rate-0 training Function against JAX's training attention at
    dropout 0 (``multi_head_attention(deterministic=False)``, i.e.
    ``_attention_nodrop``): the deferred forward in bfloat16, the
    normalized recompute in the backward; value and ``jax.vjp``."""
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(6)
    q, k, v, g = (rng.standard_normal((B, 33, NH, HD)).astype(np.float32)
                  for _ in range(4))
    bias = np.zeros((B, 1, 1, 33), np.float32)
    bias[0, ..., 20:] = -10000.0

    def jf(q_, k_, v_):
        return jattn.multi_head_attention(q_, k_, v_, jnp.asarray(bias),
                                          dropout_rate=0.0,
                                          deterministic=False)

    jins = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    want, vjp = jax.vjp(jf, *jins)
    want_grads = vjp(jnp.asarray(g).astype(jdt))
    ins = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = attention.attention_nodrop(*ins, torch.from_numpy(bias))
    out.backward(torch.from_numpy(g).to(tdt))
    assert out.dtype == tdt
    assert torch.equal(out.detach(), attention.multi_head_attention(
        *(t.detach() for t in ins), torch.from_numpy(bias)))
    assert _rel(_np(out), np.asarray(want, np.float32)) <= tol
    for name, t, w in zip(("dq", "dk", "dv"), ins, want_grads):
        err = _rel(_np(t.grad), np.asarray(w, np.float32))
        assert t.grad.dtype == tdt and err <= tol, f"{name}: {err}"


def test_cuda_wrappers_refuse_cpu_tensors():
    (q, k, v, g), bias2d = _inputs(9, seed=7)
    q, k, v, g = map(torch.from_numpy, (q, k, v, g))
    bias = torch.from_numpy(bias2d)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        af.attention_train_fwd(q, k, v, bias, SEED, nh=NH, rate=0.1,
                               scale=0.3)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        af.attention_train_bwd(q, k, v, bias, SEED, g, nh=NH, rate=0.1,
                               scale=0.3)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_kernels_match_twins_on_card(dtype):
    """Both kernels within the kernels' tolerance of their twins at rate
    0.1 (float32: bit for bit, and the same bits on a second launch) at
    training shapes and at the shapes the tiles must get right: a ragged S
    37 at head dim 32, S 104 with a ragged key bias, S 65 (one query past a
    64-row tile) at head dims 64 and 32, S 128 and 256 (32-row tiles); and
    the forward kernel's mask (read with q = k = 0 and v = I) equal to
    ``philox_keep``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt = DTYPES[dtype][0]
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}[tdt]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    seed = SEED.to(dev)
    for b, s, nh, d in ((8, 64, 12, 64), (3, 37, 12, 32), (4, 104, 12, 64),
                        (4, 65, 12, 64), (4, 65, 12, 32), (4, 128, 12, 64),
                        (2, 256, 12, 64)):
        q, k, v, g = (torch.randn((b, s, nh * d), device=dev, generator=gen)
                      .to(tdt) for _ in range(4))
        lens = torch.randint(1, s + 1, (b,), device=dev, generator=gen)
        bias = ((torch.arange(s, device=dev)[None, :] >= lens[:, None])
                .float() * -10000.0)
        kw = dict(nh=nh, rate=0.1, scale=d ** -0.5)
        got = [af.attention_train_fwd(q, k, v, bias, seed, **kw),
               *af.attention_train_bwd(q, k, v, bias, seed, g, **kw)]
        want = [af._fused_attn_fwd_math(q, k, v, bias, seed, nh, 0.1,
                                        d ** -0.5),
                *af._fused_attn_bwd_math(q, k, v, bias, seed, g, nh, 0.1,
                                         d ** -0.5)]
        again = [af.attention_train_fwd(q, k, v, bias, seed, **kw),
                 *af.attention_train_bwd(q, k, v, bias, seed, g, **kw)]
        for a, w, a2 in zip(got, want, again):
            assert _rel(_np(a.cpu()), _np(w.cpu())) <= tol
            if tdt == torch.float32:
                assert torch.equal(a, w), (b, s, d)
                assert torch.equal(a, a2), (b, s, d)
    b, s, nh, d = 8, 64, 12, 64
    kw = dict(nh=nh, rate=0.1, scale=0.125)
    bias = torch.zeros((b, s), device=dev)
    zeros = torch.zeros((b, s, nh * d), device=dev, dtype=tdt)
    eye = torch.eye(s, device=dev, dtype=tdt)[None, :, None, :].expand(
        b, s, nh, d).reshape(b, s, nh * d).contiguous()
    got = af.attention_train_fwd(zeros, zeros, eye, torch.zeros_like(bias),
                                 seed, **kw)
    got = got.view(b, s, nh, d).permute(0, 2, 1, 3) != 0
    assert torch.equal(got, af.philox_keep(seed, b, nh, s, s, 0.1))
