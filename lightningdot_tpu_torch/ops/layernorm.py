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


def _ln_forward(x, scale, bias, eps):
    if x.is_cuda:
        shape = x.shape
        return layer_norm_cuda(x.reshape(-1, shape[-1]).contiguous(), scale,
                               bias, eps).reshape(shape)
    return _ln_math(x.float(), scale, bias, eps).to(x.dtype)


def layer_norm_bwd(x, scale, g, eps):
    """``_layer_norm_bwd`` (lightningdot_tpu/ops/layernorm.py:74-95): the
    plain formula in float32; dx cast to x's dtype, dscale and dbias
    float32. JAX computes it in jnp, so plain torch is its counterpart."""
    xf, gf = x.float(), g.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = xc.square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    xhat = xc * inv
    dscale = (gf * xhat).reshape(-1, x.shape[-1]).sum(0)
    dbias = gf.reshape(-1, x.shape[-1]).sum(0)
    gs = gf * scale.float()
    dx = inv * (gs - gs.mean(dim=-1, keepdim=True)
                - xhat * (gs * xhat).mean(dim=-1, keepdim=True))
    return dx.to(x.dtype), dscale, dbias


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _ln_forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x, scale, g, ctx.eps)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = DEFAULT_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with a learned float32 affine.

    A CUDA tensor goes through the kernel (or raises); a CPU tensor through
    the twin, in float32, cast back to x's dtype. Where a gradient is
    needed, the forward is the same and the backward is
    :func:`layer_norm_bwd`.
    """
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _ln_forward(x, scale, bias, eps)
