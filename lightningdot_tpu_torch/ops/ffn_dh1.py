"""The FFN backward through the GELU, ``dh1 = (g W2^T -> compute dtype) *
gelu'(h1)``: a CUDA kernel and its plain PyTorch twin.

Counterpart of the default branch of ``_ffn_bwd``
(lightningdot_tpu/ops/ffn.py:236-237, with ``_gelu_grad`` at :204-209).
The kernel (``csrc/ffn_dh1.cu``) replaces the TPU kernel ``_dh1_kernel``
(lightningdot_tpu/ops/experimental/ffn_dh1.py:28, launched by
``dh1_pallas`` at :37-58), with exact erf where the TPU kernel used a
polynomial. Shapes: g [rows, H], h1 [rows, I], w2 [I, H] in the JAX
package's [in, out] layout; float32 or bfloat16, all one dtype.
"""
from __future__ import annotations

import math

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.ops.activations import SQRT_HALF, weak_const
from lightningdot_tpu_torch.ops.matmul import mm_f32

_DEPTH = 32   # csrc/ffn_dh1.cu stages H in slices of 32


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


def ffn_dh1_cuda(g: torch.Tensor, h1: torch.Tensor,
                 w2: torch.Tensor) -> torch.Tensor:
    """Launch the dh1 kernel on CUDA tensors g [rows, H], h1 [rows, I],
    w2 [I, H]."""
    what = "ffn_dh1 kernel"
    _build.require_cuda(what, g, h1, w2)
    code = _build.dtype_code(g, what)
    rows, h = g.shape
    inter = w2.shape[0]
    if h1.dtype != g.dtype or w2.dtype != g.dtype:
        raise TypeError(f"{what}: g, h1 and w2 must share one dtype, got "
                        f"{g.dtype}, {h1.dtype}, {w2.dtype}")
    if h1.shape != (rows, inter) or w2.shape != (inter, h):
        raise ValueError(f"{what}: shapes g {tuple(g.shape)}, h1 "
                         f"{tuple(h1.shape)}, w2 {tuple(w2.shape)} do not "
                         f"match")
    if h % _DEPTH:
        raise ValueError(f"{what}: needs H % {_DEPTH} == 0, got H={h}")
    dh1 = torch.empty_like(h1)
    with torch.cuda.device(g.device):
        _build.check(_build.lib().ldot_ffn_dh1(
            g.data_ptr(), h1.data_ptr(), w2.data_ptr(), dh1.data_ptr(),
            rows, h, inter, code, _build.stream_ptr(g)), what)
    ffn_dh1_cuda.launches += 1
    return dh1


ffn_dh1_cuda.launches = 0


def ffn_dh1(g: torch.Tensor, h1: torch.Tensor,
            w2: torch.Tensor) -> torch.Tensor:
    """dh1 for 2-D g and h1: the kernel on CUDA (or it raises), the twin on
    the CPU."""
    if g.is_cuda:
        return ffn_dh1_cuda(g.contiguous(), h1.contiguous(), w2.contiguous())
    return _dh1_math(g, h1, w2)
