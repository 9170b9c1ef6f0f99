"""The port's ops (lightningdot_tpu_torch.ops) against the JAX package's.

Inputs come from a numpy seed and go through both packages. On the CPU the
port's ops take their plain twins; the CUDA kernels are held against the
same twins by the ``cuda``-marked test at the end (and by chip_smoke.py).
Tolerances: float32 1e-5 (same math, another summation order); bfloat16
2e-2 (a few bf16 ulps: the two frameworks round at slightly different
points, e.g. JAX rounds the constant of ``x * 2**-0.5`` to bf16 and torch
does not).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.ops import attention as jattn
from lightningdot_tpu.ops import ffn as jffn
from lightningdot_tpu.ops import layernorm as jln
from lightningdot_tpu.ops.activations import gelu as jgelu
from lightningdot_tpu_torch.ops import (attention, attention_fused, ffn,
                                        ffn_dh1, ffn_int8, gemm,
                                        launch_counts, layernorm)
from lightningdot_tpu_torch.ops.activations import gelu

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _both(a: np.ndarray, dtype: str):
    """The same numpy array as a torch tensor and a jax array of dtype."""
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jnp.float32).astype(jdt)


def _close(got: torch.Tensor, want, tol: float):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_matches_jax(dtype):
    """float32 within 1e-5; bfloat16 bit for bit: both round the constant
    2**-0.5 to bf16 (JAX by weak typing, the port by ``weak_const``) and
    every op's result to bf16."""
    x = np.random.default_rng(0).standard_normal(4001).astype(np.float32) * 4
    xt, xj = _both(x, dtype)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(gelu(xt).float().numpy(),
                                      np.asarray(jgelu(xj), np.float32))
    else:
        _close(gelu(xt), jgelu(xj), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7, 32), (5, 1536)])
def test_layer_norm_matches_jax(dtype, shape):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    xt, xj = _both(x, dtype)
    got = layernorm.layer_norm(xt, torch.from_numpy(scale),
                               torch.from_numpy(bias))
    assert got.dtype == xt.dtype and got.shape == xt.shape
    want = jln.layer_norm(xj, jnp.asarray(scale), jnp.asarray(bias))
    _close(got, want, DTYPES[dtype][2])
    # the twin itself is the JAX package's _ln_math
    twin = layernorm._ln_math(torch.from_numpy(x), torch.from_numpy(scale),
                              torch.from_numpy(bias), 1e-12)
    _close(twin, jln._ln_math(jnp.asarray(x), scale, bias, 1e-12), 1e-5)


def _attention_inputs(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((b, s), np.float32)
    for i in range(b):                      # ragged key masks
        mask[i, rng.integers(1, s + 1):] = 0
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :]
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 16, 4, 8), (3, 12, 2, 16)])
def test_attention_matches_jax(dtype, shape):
    """float32: the normalized path; bfloat16: the deferred-normalization
    path, the default of both packages."""
    q, k, v, bias = _attention_inputs(*shape, seed=2)
    (qt, qj), (kt, kj), (vt, vj) = (_both(a, dtype) for a in (q, k, v))
    got = attention.multi_head_attention(qt, kt, vt, torch.from_numpy(bias))
    assert got.dtype == qt.dtype and got.shape == qt.shape
    want = jattn.multi_head_attention(qj, kj, vj, jnp.asarray(bias))
    _close(got, want, DTYPES[dtype][2])


def test_attention_bf16_normalized_path_matches_jax():
    q, k, v, bias = _attention_inputs(2, 16, 4, 8, seed=3)
    (qt, qj), (kt, kj), (vt, vj) = (_both(a, "bfloat16") for a in (q, k, v))
    scale = 8 ** -0.5
    got = attention._attention_math(qt, kt, vt, torch.from_numpy(bias),
                                    scale, defer=False)
    want = jattn._attention_math(qj, kj, vj, jnp.asarray(bias), scale,
                                 defer=False)
    _close(got, want, 2e-2)


def _ffn_inputs(rows, h=64, inter=256, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, h)).astype(np.float32),
            (0.05 * rng.standard_normal((h, inter))).astype(np.float32),
            (0.01 * rng.standard_normal(inter)).astype(np.float32),
            (0.05 * rng.standard_normal((inter, h))).astype(np.float32),
            (0.01 * rng.standard_normal(h)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [16, 130])
def test_ffn_matches_jax(dtype, rows):
    x, w1, b1, w2, b2 = _ffn_inputs(rows)
    (xt, xj), (w1t, w1j), (w2t, w2j) = (_both(a, dtype) for a in (x, w1, w2))
    b1t, b2t = torch.from_numpy(b1), torch.from_numpy(b2)
    out, h1 = ffn._ffn_math(xt, w1t, b1t, w2t, b2t)
    want_out, want_h1 = jffn._ffn_math(xj, w1j, jnp.asarray(b1), w2j,
                                       jnp.asarray(b2))
    tol = DTYPES[dtype][2]
    _close(out, want_out, tol)
    _close(h1, want_h1, tol)
    # the public op on [..., H] input, against the JAX op on f32 masters
    got = ffn.ffn_gelu(xt.reshape(2, rows // 2, -1), w1t, b1t, w2t, b2t)
    want = jffn.ffn_gelu(xj.reshape(2, rows // 2, -1),
                         {"kernel": jnp.asarray(w1), "bias": b1},
                         {"kernel": jnp.asarray(w2), "bias": b2},
                         DTYPES[dtype][1])
    _close(got, want, tol)


@pytest.mark.parametrize("rows", [128, 130])   # 130: ragged last block
def test_ffn_matches_pallas_kernel_interpret(rows):
    """The TPU kernel itself, run in interpret mode as tests/test_ffn.py
    runs it; its erf polynomial (A&S 7.1.26) sets the tolerance."""
    x, w1, b1, w2, b2 = _ffn_inputs(rows, seed=5)
    want, _, _ = jffn._ffn_pallas(*(jnp.asarray(a) for a in
                                    (x, w1, b1, w2, b2)),
                                  with_h1=False, interpret=True)
    got, _ = ffn._ffn_math(*(torch.from_numpy(a) for a in
                             (x, w1, b1, w2, b2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=3e-5,
                               atol=3e-6)


# fc1 and fc2 of the FFN at its row counts; dh1 = g W2^T
# (ops/ffn_dh1.py::ffn_dh1_mma_cuda), fc1's shape with W2 as B, at the
# training rows and a split (256) and ragged (130) count; the float32 GEMM
# (csrc/ffn.cu, never split) at its rows from one to the KD teacher's
# 106,880, the re-ranking block's 21,504 among them, and its dh1 epilogue
# (ops/ffn_dh1.py::ffn_dh1_fma_cuda, fc1's shape) at the narrow tiles'
# rows, the dist ranks' 1,024, the float32 step's 2,048 and 4,096 and the
# pre-training update's 13,312
@pytest.mark.parametrize("rows,n,k,f32", [
    pytest.param(rows, n, k, False, id=f"{rows}-{n}-{k}")
    for rows in (32, 256, 2048, 4096, 13312, 1, 31, 130, 257)
    for n, k in ((3072, 768), (768, 3072))] + [
    pytest.param(rows, 3072, 768, False, id=f"{rows}-dh1")
    for rows in (130, 256, 2048, 4096)] + [
    pytest.param(rows, n, k, True, id=f"f32-{rows}-{n}-{k}")
    for rows in (1, 31, 32, 130, 256, 2048, 21504, 106880)
    for n, k in ((3072, 768), (768, 3072))] + [
    pytest.param(rows, 3072, 768, True, id=f"f32-dh1-{rows}")
    for rows in (1, 16, 130, 1024, 2048, 4096, 13312)])
def test_ffn_gemm_plan_covers_every_tile_and_k_slice_once(rows, n, k, f32):
    """The FFN's GEMM plans (blocks as the kernels read their block index):
    every output tile and every k tile is reduced by exactly one block, no
    split is empty, the ranges stop at the matrix's edges, and the kernels'
    plan checks hold. In bfloat16 (csrc/ffn_mma.cu, 128 x 128 tiles) few
    rows split the reduction to cover the card. In float32 (csrc/ffn.cu)
    one block reduces all of k for each output, so each row's sums run
    over k in order whatever the tile and the number of rows; the narrow
    tiles take the rows for which 128 x 128 tiles leave more than half the
    SMs without a block, and launch more blocks than those would."""
    if f32:
        tile_r, tile_c = gemm.f32_gemm_tile(rows, n, 132)
        k_tile = k
        plan = gemm.GemmPlan(-(-rows // tile_r), -(-n // tile_c), 1, 1)
        wide = -(-rows // 128) * -(-n // 128)
        assert ((tile_r, tile_c) == gemm.F32_WIDE) == (wide >= 132 // 2)
        assert plan.row_tiles * plan.col_tiles >= wide
        assert (tile_r, tile_c) in (gemm.F32_WIDE, *gemm.F32_NARROW)
        # one output a thread while the outputs are few
        one = rows * n <= gemm.F32_ONE_OUTPUT_MAX and wide < 132 // 2
        assert ((tile_r, tile_c) == gemm.F32_NARROW[0]) == one
    else:
        tile_r = tile_c = gemm.GEMM_TILE
        k_tile = gemm.GEMM_K_TILE
        plan = gemm.gemm_plan(rows, n, k, 132, k_tile=k_tile)
    k_tiles = -(-k // k_tile)
    assert (plan.splits - 1) * plan.per < k_tiles <= plan.splits * plan.per
    count = np.zeros((plan.row_tiles, plan.col_tiles, k_tiles), np.int64)
    row_ends, col_ends = set(), set()
    for z, r, c, kr in gemm.gemm_blocks(plan, rows, n, k, k_tile=k_tile,
                                        row_tile=tile_r, col_tile=tile_c):
        assert len(r) and len(c) and len(kr)
        assert len(r) <= tile_r and len(c) <= tile_c
        assert r.start % tile_r == 0 and c.start % tile_c == 0
        assert kr.start == z * plan.per * k_tile
        count[r.start // tile_r, c.start // tile_c,
              kr.start // k_tile:-(-kr.stop // k_tile)] += 1
        row_ends.add(r.stop)
        col_ends.add(c.stop)
    assert (count == 1).all()
    assert max(row_ends) == rows and max(col_ends) == n
    if f32:                        # one block sums all of k for an output
        assert plan.splits == 1 and kr == range(k)
    elif rows * n <= 256 * 3072:   # few tiles: the reduction is split
        assert plan.splits > 1     # to about one block per SM
        assert plan.row_tiles * plan.col_tiles * plan.splits >= 132 // 2


def test_float32_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """``ffn_fma_cuda`` and ``attention_cuda`` check dtype, shape and range
    before the device: each refusal below is the kernel's, on CPU tensors.
    The float32 FFN takes H and I multiples of 4 (a width past the earlier
    kernel's 1,024 and an I off its multiples of 32 reach the device
    check); the attention takes S <= 256 and head_dim <= 64."""
    def ffn_args(rows, h, inter, dt=torch.float32, bias_dt=torch.float32):
        return (torch.zeros(rows, h, dtype=dt),
                torch.zeros(h, inter, dtype=dt),
                torch.zeros(inter, dtype=bias_dt),
                torch.zeros(inter, h, dtype=dt),
                torch.zeros(h, dtype=bias_dt))

    with pytest.raises(TypeError, match="takes torch.float32"):
        ffn.ffn_fma_cuda(*ffn_args(4, 32, 64, dt=torch.bfloat16))
    with pytest.raises(TypeError, match="biases must be float32"):
        ffn.ffn_fma_cuda(*ffn_args(4, 32, 64, bias_dt=torch.float64))
    x, w1, b1, w2, b2 = ffn_args(4, 32, 64)
    with pytest.raises(ValueError, match="do not form an FFN"):
        ffn.ffn_fma_cuda(x, w1, b1, w2.t(), b2)
    for h, inter in ((30, 64), (32, 66)):
        with pytest.raises(ValueError, match="multiples of 4"):
            ffn.ffn_fma_cuda(*ffn_args(4, h, inter))
    for h, inter in ((1028, 64), (32, 36), (768, 3072)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            ffn.ffn_fma_cuda(*ffn_args(3, h, inter), with_h1=True)
    # a weight view that starts off 16 bytes is copied, an aligned one not
    w = torch.zeros(65 * 32)
    assert ffn._aligned16(w[32:].view(64, 32)).data_ptr() % 16 == 0
    assert ffn._aligned16(w).data_ptr() == w.data_ptr()

    bias = torch.zeros(2, 16)
    q = torch.zeros(2, 16, 3, 8)
    with pytest.raises(TypeError, match="unsupported dtype"):
        attention.attention_cuda(q.double(), q.double(), q.double(), bias,
                                 0.3, False)
    with pytest.raises(TypeError, match="dtypes differ"):
        attention.attention_cuda(q, q.to(torch.bfloat16), q, bias, 0.3,
                                 False)
    with pytest.raises(ValueError, match="share one"):
        attention.attention_cuda(q, q[:, :8], q, bias, 0.3, False)
    with pytest.raises(ValueError, match="key bias"):
        attention.attention_cuda(q, q, q, bias[:, :8], 0.3, False)
    for s, d in ((257, 64), (16, 65)):
        t = torch.zeros(1, s, 2, d)
        with pytest.raises(ValueError, match="not supported"):
            attention.attention_cuda(t, t, t, torch.zeros(1, s), 0.3, False)
    for s, d in ((256, 64), (167, 64), (37, 30)):
        t = torch.zeros(1, s, 2, d)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            attention.attention_cuda(t, t, t, torch.zeros(1, s), 0.3, False)
    assert launch_counts()["ffn"] == launch_counts()["attention"] == 0


def test_float32_dh1_wrapper_refuses_what_the_kernel_does_not_take():
    """``ffn_dh1_fma_cuda`` (csrc/ffn.cu's GEMM with its dh1 epilogue)
    checks dtype, shape and range before the device: H and I multiples of
    4 (whole 16-byte chunks of g's rows, h1 read and dh1 written four
    floats at a time; the earlier kernel took H in multiples of 32) and
    16-byte aligned operands; a CPU tensor it would take is refused for
    its device. No refusal launches anything."""
    def dh1_args(rows, h, inter, dt=torch.float32):
        return (torch.zeros(rows, h, dtype=dt),
                torch.zeros(rows, inter, dtype=dt),
                torch.zeros(inter, h, dtype=dt))

    fma = ffn_dh1.ffn_dh1_fma_cuda
    with pytest.raises(TypeError, match="must be torch.float32"):
        fma(*dh1_args(4, 32, 64, dt=torch.bfloat16))
    g, h1, w2 = dh1_args(4, 32, 64)
    with pytest.raises(ValueError, match="do not match"):
        fma(g, h1, w2.t())
    with pytest.raises(ValueError, match="do not match"):
        fma(g, h1[:3], w2)
    for h, inter in ((30, 64), (32, 66), (770, 3072), (768, 3074)):
        with pytest.raises(ValueError, match="multiples of 4"):
            fma(*dh1_args(4, h, inter))
    for i in range(3):                # each operand 4 bytes off 16
        args = list(dh1_args(4, 32, 64))
        args[i] = args[i].reshape(-1).repeat(2)[1:1 + args[i].numel()] \
            .view(args[i].shape)
        assert args[i].data_ptr() % 16 == 4
        with pytest.raises(ValueError, match="16-byte aligned"):
            fma(*args)
    # what the kernel takes reaches the device check: widths past the
    # earlier kernel's multiples of 32, and the float32 step's
    for rows, h, inter in ((3, 36, 68), (130, 768, 3072), (1, 4, 4)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fma(*dh1_args(rows, h, inter))
    counts = launch_counts()
    assert counts["ffn_dh1"] == counts["ffn_dh1_mma"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        layernorm.layer_norm_cuda(x, torch.ones(32), torch.zeros(32), 1e-12)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        layernorm.layer_norm_bwd_cuda(x, torch.ones(32), x, 1e-12)
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        attention.attention_cuda(q, q, q, torch.zeros(1, 4), 0.3, False)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ffn.ffn_cuda(x, torch.zeros(32, 64), torch.zeros(64),
                     torch.zeros(64, 32), torch.zeros(32))
    w = torch.zeros(64, 64, dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ffn_int8.ffn_int8_cuda(x.to(torch.bfloat16), w, torch.ones(64),
                               torch.zeros(64), w, torch.ones(64),
                               torch.zeros(64))
    # the dtype-split wrappers: the tensor-core FFN and backward (bf16),
    # the FMA backward (f32), each refusing a CPU tensor before any launch
    xb, w1b, w2b = (t.to(torch.bfloat16) for t in (x, torch.zeros(32, 64),
                                                   torch.zeros(64, 32)))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ffn.ffn_mma_cuda(xb, w1b, torch.zeros(64), w2b, torch.zeros(32))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ffn.ffn_cuda(xb, w1b, torch.zeros(64), w2b, torch.zeros(32),
                     with_h1=True)
    # dh1: g [4, 32], h1 [4, 64], w2 [64, 32], on the tensor cores (bf16),
    # on FMA units (f32) and through the dtype dispatch
    for fn, dt in ((ffn_dh1.ffn_dh1_mma_cuda, torch.bfloat16),
                   (ffn_dh1.ffn_dh1_fma_cuda, torch.float32),
                   (ffn_dh1.ffn_dh1_cuda, torch.bfloat16),
                   (ffn_dh1.ffn_dh1_cuda, torch.float32)):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(x.to(dt), torch.zeros(4, 64, dtype=dt),
               torch.zeros(64, 32, dtype=dt))
    qkv = torch.zeros(1, 4, 16)
    for fn, dt in ((attention_fused.attention_train_bwd_fma, torch.float32),
                   (attention_fused.attention_train_bwd_mma, torch.bfloat16),
                   (attention_fused.attention_train_bwd, torch.bfloat16)):
        t = qkv.to(dt)
        with pytest.raises(ValueError, match="CUDA tensors only"):
            fn(t, t, t, torch.zeros(1, 4), torch.zeros(1, dtype=torch.int64),
               t, nh=2, rate=0.1, scale=0.35)
    # their operand checks: whole 16-byte chunks (a width or head dim that
    # is a multiple of 8) and 16-byte aligned operands
    ffn.check_mma_operands("k", 768, 3072, xb, w1b, w2b)
    for h, inter in ((36, 3072), (768, 3076)):
        with pytest.raises(ValueError, match="multiples of 8"):
            ffn.check_mma_operands("k", h, inter, xb, w1b, w2b)
    shifted = w1b.reshape(-1)[1:]                   # 2 bytes past a chunk
    with pytest.raises(ValueError, match="16-byte aligned"):
        ffn.check_mma_operands("k", 768, 3072, xb, shifted, w2b)
    # the int8 GEMM copies 16 int8 values a chunk
    gemm.check_mma_operands("k", 768, 3072, xb, multiple=16)
    with pytest.raises(ValueError, match="multiples of 16"):
        gemm.check_mma_operands("k", 776, 3072, xb, multiple=16)
    g = torch.zeros(4, 4, 2 * 72, dtype=torch.bfloat16)
    attention.check_tensor_core_operands("k", 72, g, g, g, g)
    with pytest.raises(ValueError, match="head_dim % 8"):
        attention.check_tensor_core_operands("k", 36, g, g, g, g)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention.check_tensor_core_operands("k", 64, g, g, g,
                                             g.reshape(-1)[1:])
    assert launch_counts() == {"layernorm": 0, "layernorm_bwd": 0,
                               "attention": 0, "ffn": 0,
                               "ffn_mma": 0, "ffn_int8": 0, "ffn_dh1": 0,
                               "ffn_dh1_mma": 0,
                               "adamw": 0, "attention_train_fwd": 0,
                               "attention_train_bwd": 0,
                               "attention_train_bwd_mma": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_twins_on_card(dtype):
    """Each CUDA kernel against its twin on the card, at a path shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tdt, _, tol = DTYPES[dtype]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((64, 768)).astype(np.float32))
    scale, bias = torch.ones(768, device=dev), torch.zeros(768, device=dev)
    xd = x.to(dev).to(tdt)
    _close(layernorm.layer_norm(xd, scale, bias).cpu(),
           layernorm._ln_math(xd.float(), scale, bias, 1e-12).cpu(), tol)
    # a query bucket, and a ragged one: keys padded to 48, head rows to 64
    for shape in ((4, 32, 12, 64), (3, 37, 12, 32)):
        q, k, v, b = (torch.from_numpy(a).to(dev)
                      for a in _attention_inputs(*shape, seed=7))
        q, k, v = (t.to(tdt) for t in (q, k, v))
        _close(attention.multi_head_attention(q, k, v, b).cpu(),
               attention._attention_math(q, k, v, b,
                                         shape[-1] ** -0.5).cpu(), tol)
    args = [torch.from_numpy(a).to(dev)
            for a in _ffn_inputs(32, h=768, inter=3072)]
    for i in (0, 1, 3):
        args[i] = args[i].to(tdt)
    _close(ffn.ffn_gelu(*args).cpu(), ffn._ffn_math(*args)[0].cpu(), tol)
    # dh1 (bf16 on the tensor cores, f32 on FMA units) at a ragged row
    # count that splits the reduction over H
    g, h1 = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             .to(dev).to(tdt) for s in ((130, 768), (130, 3072)))
    w2 = args[3]
    _close(ffn_dh1.ffn_dh1(g, h1, w2).cpu(),
           ffn_dh1._dh1_math(g, h1, w2).cpu(), tol)


def test_kernel_build_rebuilds_only_when_a_source_is_newer(tmp_path,
                                                           monkeypatch):
    import os

    from lightningdot_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    (csrc / "bin").mkdir(parents=True)
    src, header = csrc / "k.cu", csrc / "common.cuh"
    src.write_text("")
    header.write_text("")
    lib = csrc / "build" / "libldot_kernels.so"
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "LIB_PATH", lib)
    assert _build._stale()                      # nothing built yet
    lib.parent.mkdir()
    lib.write_bytes(b"")
    for path, t in ((src, 100), (header, 100), (lib, 200)):
        os.utime(path, (t, t))
    assert not _build._stale()
    os.utime(header, (300, 300))                # a header changed
    assert _build._stale()
    # CUDA_HOME names the toolkit first
    (csrc / "bin" / "nvcc").write_text("")
    monkeypatch.setenv("CUDA_HOME", str(csrc))
    assert _build._nvcc() == str(csrc / "bin" / "nvcc")
