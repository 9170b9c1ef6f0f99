"""The padding rule of the bfloat16 tensor-core attention kernels (the
forward, ``lightningdot_tpu_torch/csrc/attention_mma.cu``, and the training
backward, ``attention_mma_bwd.cu``), held on the CPU through the twins: the
kernels pad the keys to a multiple of 16 (a -inf key bias, zero K and V
rows; the backward also zero query and G rows) and each head row to 64
(zeros), and must give the unpadded result. The kernels themselves run
only on the card (chip_smoke.py and the ``cuda``-marked tests); here the
twins, fed the padded operands, show that the rule is exact, and the
unpadded twins are held against JAX's ``_attention_math`` at those
lengths.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.ops import attention as jattn
from lightningdot_tpu_torch.ops import attention, attention_fused as af

B, NH, D, D_PAD = 2, 3, 48, 64
LENGTHS = [37, 65, 104, 105, 200]
SCALE = D ** -0.5
SEED = torch.tensor([0x0DDB_A115_EED], dtype=torch.int64)
# the twins against JAX, as in test_torch_ops.py
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}
# padded against unpadded: float32 summation noise at most (a CPU product
# over another length may block its sums otherwise)
PAD_REL_L2 = 1e-6


def _inputs(s, seed):
    """q, k, v [B, s, NH, D] and a ragged [B, s] key bias, from a seed."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, s, NH, D)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, s), np.float32)
    for i in range(B):
        mask[i, rng.integers(1, s + 1):] = 0
    return q, k, v, (1.0 - mask) * -10000.0


def _torch(arrays, dtype):
    tdt = DTYPES[dtype][0]
    return [torch.from_numpy(a).to(tdt) for a in arrays]


def _pad(q, k, v, bias2d, v_fill=0.0):
    """The kernel's staging of [B, S, NH, D] operands: keys to a multiple
    of 16 (K rows 0, V rows ``v_fill``, bias -inf), head rows to D_PAD
    (zeros). Query rows are not padded: the kernel does not store them."""
    s = k.shape[1]
    extra = -s % 16
    f = torch.nn.functional
    q, k, v = (f.pad(x, (0, D_PAD - D)) for x in (q, k, v))
    k = f.pad(k, (0, 0, 0, 0, 0, extra))
    v = f.pad(v, (0, 0, 0, 0, 0, extra), value=v_fill)
    return q, k, v, f.pad(bias2d, (0, extra), value=-float("inf"))


def _rel_l2(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("defer", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", LENGTHS)
def test_attention_twin_is_padding_invariant(s, dtype, defer):
    """``_attention_math``, deferred and normalized (float32 always
    normalizes), on the kernel's padded operands gives the unpadded
    result."""
    arrays = _inputs(s, seed=s)
    q, k, v = _torch(arrays[:3], dtype)
    bias = torch.from_numpy(arrays[3])
    want = attention._attention_math(q, k, v, bias[:, None, None, :], SCALE,
                                     defer=defer)
    qp, kp, vp, bp = _pad(q, k, v, bias)
    assert kp.shape[1] % 16 == 0 and kp.shape[-1] == D_PAD
    got = attention._attention_math(qp, kp, vp, bp[:, None, None, :], SCALE,
                                    defer=defer)
    assert got.dtype == want.dtype
    assert torch.isfinite(got).all()
    assert _rel_l2(got[..., :D], want) <= PAD_REL_L2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", LENGTHS)
def test_fused_fwd_twin_is_padding_invariant(s, dtype):
    """``_fused_attn_fwd_math`` at rate 0.1 on the padded operands gives
    the unpadded result: the Philox mask is a function of each element's
    coordinates, so the padded grid draws the unpadded mask in its corner,
    and a padded key's probability, 0, stays 0 whatever its draw."""
    arrays = _inputs(s, seed=s + 1)
    q, k, v = _torch(arrays[:3], dtype)
    bias = torch.from_numpy(arrays[3])

    def flat(x):
        return x.reshape(x.shape[0], x.shape[1], -1)

    want = af._fused_attn_fwd_math(flat(q), flat(k), flat(v), bias, SEED, NH,
                                   0.1, SCALE)
    qp, kp, vp, bp = _pad(q, k, v, bias)
    got = af._fused_attn_fwd_math(flat(qp), flat(kp), flat(vp), bp, SEED, NH,
                                  0.1, SCALE)
    got = got.view(B, s, NH, D_PAD)[..., :D]
    assert got.dtype == want.dtype
    assert _rel_l2(got, want.view(B, s, NH, D)) <= PAD_REL_L2
    # the mask is live: the result differs from rate 0
    assert not torch.equal(want, af._fused_attn_fwd_math(
        flat(q), flat(k), flat(v), bias, SEED, NH, 0.0, SCALE))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", LENGTHS)
def test_fused_bwd_twin_is_padding_invariant(s, dtype):
    """``_fused_attn_bwd_math`` at rate 0.1 on the tensor-core backward's
    padded operands (``csrc/attention_mma_bwd.cu``) gives the unpadded dq,
    dk and dv: keys padded to a multiple of 16 with a -inf bias and zero K
    and V rows, query rows zero-filled with zero G rows, head rows padded to
    64. A padded key's probability is exactly 0, and a padded query row's
    zero G makes its dp, its ds and its dV terms exactly 0, so no padded
    element reaches a real one."""
    arrays = _inputs(s, seed=s + 3)
    q, k, v = _torch(arrays[:3], dtype)
    bias = torch.from_numpy(arrays[3])
    g = _torch([np.random.default_rng(s + 4).standard_normal(
        (B, s, NH, D)).astype(np.float32)], dtype)[0]

    def flat(x):
        return x.reshape(x.shape[0], x.shape[1], -1)

    want = af._fused_attn_bwd_math(flat(q), flat(k), flat(v), bias, SEED,
                                   flat(g), NH, 0.1, SCALE)
    # one sequence axis: queries and keys pad together, G rows with zeros
    qp, kp, vp, bp = _pad(q, k, v, bias)
    extra = kp.shape[1] - s
    f = torch.nn.functional
    qp = f.pad(qp, (0, 0, 0, 0, 0, extra))
    gp = f.pad(g, (0, D_PAD - D, 0, 0, 0, extra))
    got = af._fused_attn_bwd_math(flat(qp), flat(kp), flat(vp), bp, SEED,
                                  flat(gp), NH, 0.1, SCALE)
    for x, w in zip(got, want):
        x = x.view(B, s + extra, NH, D_PAD)
        assert x.dtype == w.dtype and torch.isfinite(x).all()
        assert _rel_l2(x[:, :s, :, :D], w.view(B, s, NH, D)) <= PAD_REL_L2
    # the mask is live: the result differs from rate 0
    assert not torch.equal(want[2], af._fused_attn_bwd_math(
        flat(q), flat(k), flat(v), bias, SEED, flat(g), NH, 0.0, SCALE)[2])


@pytest.mark.parametrize("defer", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", LENGTHS)
def test_attention_twin_matches_jax_at_ragged_lengths(s, dtype, defer):
    tdt, jdt, tol = DTYPES[dtype]
    q, k, v, bias2d = _inputs(s, seed=s + 2)
    bias = bias2d[:, None, None, :]
    got = attention._attention_math(*_torch((q, k, v), dtype),
                                    torch.from_numpy(bias), SCALE,
                                    defer=defer)
    want = jattn._attention_math(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(bias),
        SCALE, defer=defer)
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nan_pad_rows_of_v_poison_the_output(dtype):
    """The trap the kernel's zero fill avoids: a padded key's probability
    is exactly 0, but 0 x NaN = NaN, so V pad rows left as whatever shared
    memory held (NaN here) turn every output element to NaN."""
    arrays = _inputs(37, seed=9)
    q, k, v = _torch(arrays[:3], dtype)
    bias = torch.from_numpy(arrays[3])
    qp, kp, vp, bp = _pad(q, k, v, bias, v_fill=float("nan"))
    out = attention._attention_math(qp, kp, vp, bp[:, None, None, :], SCALE)
    assert torch.isnan(out).all()
    qp, kp, vp, bp = _pad(q, k, v, bias)
    out = attention._attention_math(qp, kp, vp, bp[:, None, None, :], SCALE)
    assert torch.isfinite(out).all()


def test_ptxas_report_reads_registers_and_spills(tmp_path, monkeypatch):
    """The build keeps ptxas's report per source; chip_smoke.py prints the
    tensor-core attention's registers and spills from it."""
    from lightningdot_tpu_torch.ops import _build

    (tmp_path / "attention_mma.log").write_text(
        "ptxas info    : Compiling entry function '_Z1kILi16ELi0EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kILi16ELi0EEv\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill "
        "loads\n"
        "ptxas info    : Used 189 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_Z1kILi2ELi1EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Used 66 registers, used 1 barriers\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert _build.ptxas_report("attention_mma") == {
        "_Z1kILi16ELi0EEv": (189, 8, 12), "_Z1kILi2ELi1EEv": (66, 0, 0)}


def test_tensor_core_operands_need_whole_16_byte_chunks():
    """The bfloat16 kernel copies each head row in 16-byte chunks: the
    wrappers refuse a head_dim that is not a multiple of 8, or an operand
    that does not start on 16 bytes, before any launch."""
    x = torch.zeros(4, 4, 2, 72, dtype=torch.bfloat16)
    attention.check_tensor_core_operands("k", 64, x, x, x)
    with pytest.raises(ValueError, match="head_dim % 8"):
        attention.check_tensor_core_operands("k", 36, x, x, x)
    shifted = x.reshape(-1)[1:]                     # 2 bytes past a chunk
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention.check_tensor_core_operands("k", 64, x, shifted, x)
