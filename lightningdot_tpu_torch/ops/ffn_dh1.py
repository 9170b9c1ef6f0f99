"""The FFN backward through the GELU, ``dh1 = (g W2^T -> compute dtype) *
gelu'(h1)``: CUDA kernels and their plain PyTorch twin.

Counterpart of the default branch of ``_ffn_bwd``
(lightningdot_tpu/ops/ffn.py:236-237, with ``_gelu_grad`` at :204-209).
The kernels replace the TPU kernel ``_dh1_kernel``
(lightningdot_tpu/ops/experimental/ffn_dh1.py:28, launched by
``dh1_pallas`` at :37-58), with exact erf where the TPU kernel used a
polynomial, split by dtype in :func:`ffn_dh1_cuda`: bfloat16 runs on the
tensor cores, as an epilogue of the FFN's GEMM (``csrc/ffn_mma.cu``,
:func:`ffn_dh1_mma_cuda`: the twin's rounding points, float32 sums in
another order, so within a bf16 ulp of the twin), float32 on FMA units, as
the third epilogue of the float32 FFN's GEMM (``csrc/ffn.cu``,
:func:`ffn_dh1_fma_cuda`: every FFN layer's backward when training with
``--compute_dtype f32``; W2 transposed into a workspace first, so that the
GEMM reads it as fc1 reads W1; each output one FMA chain over H in order,
in the tile :func:`~lightningdot_tpu_torch.ops.gemm.f32_gemm_tile` picks,
so a row's bits depend neither on the tile nor on how many rows share the
launch; within 1e-5 of the twin, whose product is cuBLAS's). Shapes:
g [rows, H], h1 [rows, I], w2 [I, H] in the JAX package's [in, out] layout;
float32 or bfloat16, all one dtype.
"""
from __future__ import annotations

import math

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.ops.activations import SQRT_HALF, weak_const
from lightningdot_tpu_torch.ops.gemm import (check_mma_operands,
                                             f32_gemm_tile, gemm_plan)
from lightningdot_tpu_torch.ops.matmul import mm_f32
from lightningdot_tpu_torch.utils import tracing


def _gelu_grad(h1: torch.Tensor) -> torch.Tensor:
    """d/dx [x * 0.5 * (1 + erf(x / sqrt 2))] in h1's dtype, each op
    rounded to it (``_gelu_grad``; the kernel's ``gelu_grad_rounded``),
    both constants rounded to it first, as JAX's weak typing rounds
    ``2 ** -0.5`` and the code casts the pdf constant."""
    cdf = 0.5 * (1.0 + torch.erf(h1 * weak_const(SQRT_HALF, h1.dtype)))
    pdf = torch.tensor((2.0 * math.pi) ** -0.5, dtype=h1.dtype) * torch.exp(
        -0.5 * h1.square())
    return cdf + h1 * pdf


def _dh1_math(g, h1, w2):
    """The plain twin: float32-accumulated g W2^T rounded to the compute
    dtype, times gelu'(h1)."""
    return mm_f32(g, w2.t()).to(g.dtype) * _gelu_grad(h1)


def _check_dh1(what, g, h1, w2, dtype):
    """The operands' dtypes and shapes; the wrappers check the device after
    their ranges, so that a CPU tensor of a shape the kernel refuses is
    refused for its shape."""
    if g.dtype != dtype or h1.dtype != dtype or w2.dtype != dtype:
        raise TypeError(f"{what}: g, h1 and w2 must be {dtype}, got "
                        f"{g.dtype}, {h1.dtype}, {w2.dtype}")
    rows, h = g.shape
    inter = w2.shape[0]
    if h1.shape != (rows, inter) or w2.shape != (inter, h):
        raise ValueError(f"{what}: shapes g {tuple(g.shape)}, h1 "
                         f"{tuple(h1.shape)}, w2 {tuple(w2.shape)} do not "
                         f"match")
    return rows, h, inter


def ffn_dh1_fma_cuda(g: torch.Tensor, h1: torch.Tensor,
                     w2: torch.Tensor) -> torch.Tensor:
    """Launch the float32 dh1 on FMA units (``csrc/ffn.cu``: W2 transposed
    into a workspace, then the float32 GEMM with the gelu' epilogue, in the
    output tile :func:`f32_gemm_tile` picks for fc1's shape, never split)
    on CUDA tensors g [rows, H], h1 [rows, I], w2 [I, H]. H and I must be
    multiples of 4 and every operand 16-byte aligned (the kernel copies
    rows in whole 16-byte chunks and reads h1 and writes dh1 four floats at
    a time)."""
    what = "ffn_dh1 kernel"
    rows, h, inter = _check_dh1(what, g, h1, w2, torch.float32)
    check_mma_operands(what, h, inter, g, h1, w2, multiple=4)
    _build.require_cuda(what, g, h1, w2)
    tile = f32_gemm_tile(rows, inter, _build.num_sms(g.device))
    w2t = w2.new_empty((h, inter))
    dh1 = torch.empty_like(h1)
    with torch.cuda.device(g.device):
        _build.check(_build.lib().ldot_ffn_dh1(
            g.data_ptr(), h1.data_ptr(), w2.data_ptr(), w2t.data_ptr(),
            dh1.data_ptr(), rows, h, inter, *tile, _build.stream_ptr(g)),
            what)
    tracing.launched("ffn_dh1")
    return dh1


def ffn_dh1_mma_cuda(g: torch.Tensor, h1: torch.Tensor,
                     w2: torch.Tensor) -> torch.Tensor:
    """Launch the bfloat16 dh1 on the tensor cores (``csrc/ffn_mma.cu``'s
    GEMM with W2 read as stored, [I, H], and the gelu' epilogue; the
    reduction over H split as :func:`gemm_plan` says) on CUDA tensors g
    [rows, H], h1 [rows, I], w2 [I, H]. H and I must be multiples of 8 and
    every operand 16-byte aligned (the kernel copies whole 16-byte
    chunks)."""
    what = "ffn_dh1 tensor-core kernel"
    rows, h, inter = _check_dh1(what, g, h1, w2, torch.bfloat16)
    check_mma_operands(what, h, inter, g, h1, w2)
    _build.require_cuda(what, g, h1, w2)
    plan = gemm_plan(rows, inter, h, _build.num_sms(g.device))
    dh1 = torch.empty_like(h1)
    workspace = (torch.empty(plan.splits * rows * inter, dtype=torch.float32,
                             device=g.device) if plan.splits > 1 else None)
    with torch.cuda.device(g.device):
        _build.check(_build.lib().ldot_ffn_dh1_mma(
            g.data_ptr(), h1.data_ptr(), w2.data_ptr(), dh1.data_ptr(),
            workspace.data_ptr() if workspace is not None else None,
            rows, h, inter, plan.splits, plan.per, _build.stream_ptr(g)),
            what)
    tracing.launched("ffn_dh1_mma")
    return dh1


def ffn_dh1_cuda(g: torch.Tensor, h1: torch.Tensor,
                 w2: torch.Tensor) -> torch.Tensor:
    """The dh1 kernel of g's dtype on CUDA tensors: bfloat16 on the tensor
    cores (:func:`ffn_dh1_mma_cuda`), float32 on FMA units
    (:func:`ffn_dh1_fma_cuda`)."""
    if g.dtype == torch.bfloat16:
        return ffn_dh1_mma_cuda(g, h1, w2)
    return ffn_dh1_fma_cuda(g, h1, w2)


def ffn_dh1(g: torch.Tensor, h1: torch.Tensor,
            w2: torch.Tensor) -> torch.Tensor:
    """dh1 for 2-D g and h1: the kernel on CUDA (or it raises), the twin on
    the CPU."""
    if g.is_cuda:
        return ffn_dh1_cuda(g.contiguous(), h1.contiguous(), w2.contiguous())
    return _dh1_math(g, h1, w2)
