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


@pytest.mark.parametrize("rows,inter,sms,expect", [
    (32, 3072, 132, 96), (2048, 3072, 132, 3), (16384, 3072, 132, 1),
    (16, 3072, 132, 96), (256, 3072, 132, 16)])
def test_ffn_splits_cover_the_card_without_empty_splits(rows, inter, sms,
                                                        expect):
    splits = ffn.ffn_splits(rows, inter, sms)
    assert splits == expect
    n_chunks = inter // 32
    per = -(-n_chunks // splits)
    assert per * (splits - 1) < n_chunks <= per * splits


# fc1 and fc2 of the FFN at its row counts; dh1 = g W2^T
# (ops/ffn_dh1.py::ffn_dh1_mma_cuda), fc1's shape with W2 as B, at the
# training rows and a split (256) and ragged (130) count
@pytest.mark.parametrize("rows,n,k", [
    pytest.param(rows, n, k, id=f"{rows}-{n}-{k}")
    for rows in (32, 256, 2048, 4096, 13312, 1, 31, 130, 257)
    for n, k in ((3072, 768), (768, 3072))] + [
    pytest.param(rows, 3072, 768, id=f"{rows}-dh1")
    for rows in (130, 256, 2048, 4096)])
def test_ffn_gemm_plan_covers_every_tile_and_k_slice_once(rows, n, k):
    """The tensor-core FFN's GEMM plan (csrc/ffn_mma.cu, blocks as the
    kernel reads its block index): every 128 x 128 output tile and every k
    tile of 64 is reduced by exactly one block, no split is empty, the
    ranges stop at the matrix's edges, and the kernel's plan check
    (``plan_ok``) holds. Few rows split the reduction to cover the card."""
    k_tile = gemm.GEMM_K_TILE
    plan = gemm.gemm_plan(rows, n, k, 132, k_tile=k_tile)
    k_tiles = -(-k // k_tile)
    tile = gemm.GEMM_TILE
    assert (plan.splits - 1) * plan.per < k_tiles <= plan.splits * plan.per
    count = np.zeros((plan.row_tiles, plan.col_tiles, k_tiles), np.int64)
    row_ends, col_ends = set(), set()
    for z, r, c, kr in gemm.gemm_blocks(plan, rows, n, k, k_tile=k_tile):
        assert len(r) and len(c) and len(kr)
        assert len(r) <= tile and len(c) <= tile
        assert r.start % tile == 0 and c.start % tile == 0
        assert kr.start == z * plan.per * k_tile
        count[r.start // tile, c.start // tile,
              kr.start // k_tile:-(-kr.stop // k_tile)] += 1
        row_ends.add(r.stop)
        col_ends.add(c.stop)
    assert (count == 1).all()
    assert max(row_ends) == rows and max(col_ends) == n
    if rows * n <= 256 * 3072:     # few tiles: the reduction is split
        assert plan.splits > 1     # to about one block per SM
        assert plan.row_tiles * plan.col_tiles * plan.splits >= 132 // 2


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
