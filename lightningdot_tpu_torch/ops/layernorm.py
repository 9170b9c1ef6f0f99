"""LayerNorm: a CUDA kernel and its plain PyTorch twin.

Counterpart of lightningdot_tpu/ops/layernorm.py. The kernel
(``csrc/layernorm.cu``) replaces the TPU kernel ``_ln_kernel``
(lightningdot_tpu/ops/layernorm.py:30, launched by ``_ln_pallas``). eps is
1e-12 everywhere in the reference.
"""
from __future__ import annotations

import torch

from lightningdot_tpu_torch.ops import _build

DEFAULT_EPS = 1e-12
MAX_HIDDEN = 1536


def _ln_math(x, scale, bias, eps):
    """The plain twin: float32 statistics over the last axis."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * scale + bias


def layer_norm_cuda(x2d: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the LayerNorm kernel on a [rows, hidden] CUDA tensor."""
    what = "layer_norm kernel"
    _build.require_cuda(what, x2d, scale, bias)
    code = _build.dtype_code(x2d, what)
    rows, hidden = x2d.shape
    if hidden > MAX_HIDDEN:
        raise ValueError(f"{what}: hidden {hidden} > {MAX_HIDDEN}")
    if (scale.dtype != torch.float32 or bias.dtype != torch.float32
            or scale.shape != (hidden,) or bias.shape != (hidden,)):
        raise ValueError(f"{what}: scale and bias must be float32 "
                         f"[{hidden}]")
    out = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        _build.check(_build.lib().ldot_layernorm(
            x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), rows, hidden, eps, code,
            _build.stream_ptr(x2d)), what)
    layer_norm_cuda.launches += 1
    return out


layer_norm_cuda.launches = 0


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = DEFAULT_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with a learned float32 affine.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    the twin, in float32, cast back to x's dtype.
    """
    if x.is_cuda:
        shape = x.shape
        return layer_norm_cuda(x.reshape(-1, shape[-1]), scale, bias,
                               eps).reshape(shape)
    return _ln_math(x.float(), scale, bias, eps).to(x.dtype)
