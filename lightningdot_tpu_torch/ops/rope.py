"""Rotary position embedding in DeepSeek-V3's layout: a CUDA kernel
(``csrc/rope.cu``) and its plain PyTorch twin.

No TPU counterpart: the JAX package's towers have learned positions. The
Moonlight tower (``models/moonlight.py``) rotates the 64 RoPE dims of each
query head and of the one shared key head. Pairs (x[2i], x[2i + 1]) are
read and the result is written de-interleaved (``apply_rotary_pos_emb`` of
modeling_deepseek.py: a view-transpose, then ``rotate_half``), at the
positions 0 ... S - 1 of each sequence.
"""
from __future__ import annotations

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.utils import tracing


def rope_angles(s: int, dim: int, theta: float, device=None):
    """float32 (cos, sin) [s, dim / 2]: position p times 1 / theta^(2i /
    dim)."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=device) / dim))
    ang = torch.arange(s, dtype=torch.float32, device=device)[:, None] * inv
    return torch.cos(ang), torch.sin(ang)


def rope_math(x: torch.Tensor, theta: float,
              inverse: bool = False) -> torch.Tensor:
    """The kernel's twin on x [B, S, heads, dim]: float32, cast back to x's
    dtype. ``inverse`` applies the transpose (the backward)."""
    b, s, h, d = x.shape
    cos, sin = rope_angles(s, d, theta, x.device)
    cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    xf = x.float()
    if not inverse:
        a, c = xf[..., 0::2], xf[..., 1::2]
        out = torch.cat([a * cos - c * sin, c * cos + a * sin], dim=-1)
    else:
        a, c = xf[..., :d // 2], xf[..., d // 2:]
        out = torch.stack([a * cos + c * sin, c * cos - a * sin],
                          dim=-1).flatten(-2)
    return out.to(x.dtype)


def rope_cuda(x: torch.Tensor, theta: float,
              inverse: bool = False) -> torch.Tensor:
    """Launch the kernel on a contiguous CUDA tensor [B, S, heads, dim]."""
    what = "rope kernel"
    code = _build.dtype_code(x, what)
    if x.dim() != 4 or x.shape[-1] % 2:
        raise ValueError(f"{what}: takes [B, S, heads, dim], dim even; got "
                         f"{tuple(x.shape)}")
    _build.require_cuda(what, x)
    b, s, h, d = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.check(_build.lib().ldot_rope(
            x.data_ptr(), out.data_ptr(), b * s, h, s, d, float(theta),
            int(inverse), code, _build.stream_ptr(x)), what)
    tracing.launched("rope")
    return out


def _rope(x, theta, inverse):
    if not x.is_cuda:
        return rope_math(x, theta, inverse)
    return rope_cuda(x.contiguous(), theta, inverse)


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, theta):
        ctx.theta = theta
        return _rope(x, theta, False)

    @staticmethod
    def backward(ctx, g):
        return _rope(g, ctx.theta, True), None


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """RoPE of x [B, S, heads, dim] at positions 0 ... S - 1: the kernel on
    a CUDA tensor, :func:`rope_math` on a CPU tensor; its gradient is the
    inverse rotation."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rope.apply(x, theta)
    return _rope(x, theta, False)
