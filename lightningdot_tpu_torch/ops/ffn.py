"""Fused FFN (dense -> erf GELU -> dense) with its gradient: CUDA kernels
and their plain PyTorch twin.

Counterpart of lightningdot_tpu/ops/ffn.py (``_ffn_math``, ``_ffn`` and its
custom VJP ``_ffn_fwd``/``_ffn_bwd``, :193-241). The kernels replace the TPU
kernel ``_ffn_kernel`` (lightningdot_tpu/ops/ffn.py:77, launched by
``_ffn_pallas``), split by dtype in :func:`ffn_cuda`: bfloat16 runs on the
tensor cores (``csrc/ffn_mma.cu``, :func:`ffn_mma_cuda`), float32 on the
FMA units (``csrc/ffn.cu``, :func:`ffn_fma_cuda`: a tiled float32 GEMM with
register microtiles, the float32 cross-encoder teacher's FFN in KD and
re-ranking). Both are two launches of one GEMM, fc1 with the bias-GELU
epilogue and fc2: bfloat16 tiled as
:func:`~lightningdot_tpu_torch.ops.gemm.gemm_plan` says, its reduction
split at few rows; float32 never split, in the output tile that
:func:`~lightningdot_tpu_torch.ops.gemm.f32_gemm_tile` picks, so that a
row's bits depend neither on the tile nor on how many rows share the
launch. Both keep the twin's rounding points and sum in float32 in
another order, so they are held within a tolerance of the twin rather
than bit for bit. Without a
gradient they write the output (and the intermediate, which fc2 reads);
under autograd also h1 (``with_h1``/``with_inter`` under the default
"store" policy, :176-181). The backward's dh1 goes through
``ops/ffn_dh1.py``'s kernel; its three weight products are plain
float32-accumulated products, as JAX leaves them to XLA. The TPU dispatch
gates (rows >= 256 and the VMEM fit) are not carried over: every CUDA call
takes a kernel.

Weights are in the JAX package's [in, out] layout: w1 [H, I], w2 [I, H].
"""
from __future__ import annotations

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.ops.activations import gelu
from lightningdot_tpu_torch.ops.ffn_dh1 import ffn_dh1
from lightningdot_tpu_torch.ops.gemm import (check_mma_operands,
                                             f32_gemm_tile, gemm_plan)
from lightningdot_tpu_torch.ops.matmul import mm_f32
from lightningdot_tpu_torch.utils import tracing


def _ffn_math(x, w1, b1, w2, b2):
    """The plain twin: identical math to encoder._dense + gelu
    (lightningdot_tpu/ops/ffn.py:47-52). Returns (out, h1)."""
    h1 = (mm_f32(x, w1) + b1).to(x.dtype)
    inter = gelu(h1)
    return (mm_f32(inter, w2) + b2).to(x.dtype), h1


def _check_ffn(what, x2d, w1, b1, w2, b2, dtype):
    """The operands' dtypes and shapes; the wrappers check the device after
    their ranges, so that a CPU tensor of a shape the kernel refuses is
    refused for its shape."""
    if x2d.dtype != dtype:
        raise TypeError(f"{what}: takes {dtype}, got {x2d.dtype}")
    rows, h = x2d.shape
    inter = w1.shape[1]
    if w1.dtype != x2d.dtype or w2.dtype != x2d.dtype:
        raise TypeError(f"{what}: weights must be {x2d.dtype}")
    if (w1.shape != (h, inter) or w2.shape != (inter, h)
            or b1.shape != (inter,) or b2.shape != (h,)):
        raise ValueError(f"{what}: shapes x {tuple(x2d.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not "
                         f"form an FFN")
    if b1.dtype != torch.float32 or b2.dtype != torch.float32:
        raise TypeError(f"{what}: biases must be float32")
    return rows, h, inter


def _aligned16(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on 16 bytes (a view
    at an odd offset): the float32 GEMM copies its operands in whole
    16-byte chunks."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def ffn_fma_cuda(x2d: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, *,
                 with_h1: bool = False):
    """Launch the float32 FFN (``csrc/ffn.cu``: fc1 with the bias-GELU
    epilogue, then fc2, each in the output tile :func:`f32_gemm_tile`
    picks) on a [rows, H] CUDA tensor -> out, or with ``with_h1`` (out, h1,
    gelu(h1)), the last two [rows, I]. H and I must be multiples of 4
    (whole 16-byte chunks of the weights' rows)."""
    what = "ffn kernel"
    rows, h, inter = _check_ffn(what, x2d, w1, b1, w2, b2, torch.float32)
    if h % 4 or inter % 4:
        raise ValueError(f"{what}: needs H and I multiples of 4, got H={h}, "
                         f"I={inter}")
    _build.require_cuda(what, x2d, w1, b1, w2, b2)
    x2d, w1, w2 = _aligned16(x2d), _aligned16(w1), _aligned16(w2)
    sms = _build.num_sms(x2d.device)
    tile1, tile2 = (f32_gemm_tile(rows, n, sms) for n in (inter, h))
    out = torch.empty_like(x2d)
    inter_out = x2d.new_empty((rows, inter))
    h1 = x2d.new_empty((rows, inter)) if with_h1 else None
    with torch.cuda.device(x2d.device):
        _build.check(_build.lib().ldot_ffn(
            x2d.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(),
            h1.data_ptr() if with_h1 else None, inter_out.data_ptr(),
            rows, h, inter, *tile1, *tile2, _build.stream_ptr(x2d)), what)
    tracing.launched("ffn")
    return (out, h1, inter_out) if with_h1 else out


def ffn_mma_cuda(x2d: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, *,
                 with_h1: bool = False):
    """Launch the bfloat16 tensor-core FFN (``csrc/ffn_mma.cu``: fc1 with
    the bias-GELU epilogue, then fc2, each split as :func:`gemm_plan` says)
    on a [rows, H] CUDA tensor -> out, or with ``with_h1`` (out, h1,
    gelu(h1)). H and I must be multiples of 8 and x, w1, w2 16-byte
    aligned (the kernel copies whole 16-byte chunks)."""
    what = "ffn tensor-core kernel"
    rows, h, inter = _check_ffn(what, x2d, w1, b1, w2, b2, torch.bfloat16)
    check_mma_operands(what, h, inter, x2d, w1, w2)
    _build.require_cuda(what, x2d, w1, b1, w2, b2)
    sms = _build.num_sms(x2d.device)
    fc1, fc2 = gemm_plan(rows, inter, h, sms), gemm_plan(rows, h, inter, sms)
    out = torch.empty_like(x2d)
    inter_out = x2d.new_empty((rows, inter))
    h1 = x2d.new_empty((rows, inter)) if with_h1 else None
    ws = max(fc1.splits * rows * inter if fc1.splits > 1 else 0,
             fc2.splits * rows * h if fc2.splits > 1 else 0)
    workspace = (torch.empty(ws, dtype=torch.float32, device=x2d.device)
                 if ws else None)
    with torch.cuda.device(x2d.device):
        _build.check(_build.lib().ldot_ffn_mma(
            x2d.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
            b2.data_ptr(), out.data_ptr(),
            h1.data_ptr() if with_h1 else None, inter_out.data_ptr(),
            workspace.data_ptr() if workspace is not None else None,
            rows, h, inter, fc1.splits, fc1.per, fc2.splits, fc2.per,
            _build.stream_ptr(x2d)), what)
    tracing.launched("ffn_mma")
    return (out, h1, inter_out) if with_h1 else out


def ffn_cuda(x2d: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor, *, with_h1: bool = False):
    """The FFN kernel of x's dtype on a [rows, H] CUDA tensor: bfloat16 on
    the tensor cores (:func:`ffn_mma_cuda`), float32 on FMA units
    (:func:`ffn_fma_cuda`). -> out, or with ``with_h1`` (out, h1,
    gelu(h1))."""
    if x2d.dtype == torch.bfloat16:
        return ffn_mma_cuda(x2d, w1, b1, w2, b2, with_h1=with_h1)
    return ffn_fma_cuda(x2d, w1, b1, w2, b2, with_h1=with_h1)


def ffn_bwd(g, x2d, w1, w2, h1, inter):
    """``_ffn_bwd`` (lightningdot_tpu/ops/ffn.py:220-241), default branch:
    g rounded to the compute dtype; dW2 = inter^T g and db2 = sum g in
    float32; dh1 through :func:`ffn_dh1`; dW1 = x^T dh1, db1 = sum dh1 and
    dx = dh1 W1^T. dx, dW1 and dW2 are rounded to the compute dtype."""
    g = g.to(x2d.dtype)
    dw2 = mm_f32(inter.t(), g).to(w2.dtype)
    db2 = g.float().sum(0)
    dh1 = ffn_dh1(g, h1, w2)
    dw1 = mm_f32(x2d.t(), dh1).to(w1.dtype)
    db1 = dh1.float().sum(0)
    dx = mm_f32(dh1, w1.t()).to(x2d.dtype)
    return dx, dw1, db1, dw2, db2


class _FFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w1, b1, w2, b2):
        if x2d.is_cuda:
            out, h1, inter = ffn_cuda(x2d, w1, b1, w2, b2, with_h1=True)
        else:
            out, h1 = _ffn_math(x2d, w1, b1, w2, b2)
            inter = gelu(h1)
        ctx.save_for_backward(x2d, w1, w2, h1, inter)
        return out

    @staticmethod
    def backward(ctx, g):
        return ffn_bwd(g.contiguous(), *ctx.saved_tensors)


def ffn_gelu(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
             w2: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """dense(H->I) -> erf GELU -> dense(I->H) on [..., H] input.

    ``x``, ``w1`` [H, I] and ``w2`` [I, H] in the compute dtype, ``b1`` and
    ``b2`` float32 (lightningdot_tpu/ops/ffn.py:247-265 casts the float32
    masters to that form on every call). Where a gradient is needed the
    forward also keeps h1 and gelu(h1), and the backward is
    :func:`ffn_bwd`.
    """
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if x.is_cuda:
        x2d = x2d.contiguous()
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, w1, b1, w2, b2)):
        out = _FFN.apply(x2d, w1, b1, w2, b2)
    elif x.is_cuda:
        out = ffn_cuda(x2d, w1, b1, w2, b2)
    else:
        out, _ = _ffn_math(x2d, w1, b1, w2, b2)
    return out.reshape(shape)
