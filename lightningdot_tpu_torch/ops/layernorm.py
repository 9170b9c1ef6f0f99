"""LayerNorm: CUDA kernels and their plain PyTorch twins.

Counterpart of lightningdot_tpu/ops/layernorm.py and of the add-and-LayerNorm
of lightningdot_tpu/ops/fused.py. ``csrc/layernorm.cu`` holds

* the forward, which replaces the TPU kernel ``_ln_kernel``
  (lightningdot_tpu/ops/layernorm.py:30, launched by ``_ln_pallas``), with
  an optional prologue ``u = dropout(x) + res`` (``fused._dal_math``,
  :93-96), so that ``dropout_add_ln`` is one launch;
* the backward, the card's counterpart of what XLA fuses on the TPU: the
  jnp VJP ``_layer_norm_bwd`` (layernorm.py:74-95) and ``fused._dal_bwd``
  (:114-126), which recomputes u: one launch for du (and dx under a mask)
  and the blocks' partial sums of dscale and dbias, one more that sums
  them in a fixed order.

The twins :func:`ln_fwd_math` and :func:`ln_bwd_math` are the kernels' spec
and the CPU path. eps is 1e-12 everywhere in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.utils import tracing

DEFAULT_EPS = 1e-12
# the kernels' widest row: the towers' rows are 768-1,536 wide, the VQA
# head's 3,072 (6,144 with its intersection input)
MAX_HIDDEN = 6144
# rows above this width take one row a block (csrc/layernorm.cu)
WIDE_HIDDEN = 1536
# the kernels move 16-byte vectors: every tensor starts on a 16-byte
# boundary and a row holds a multiple of 8 elements
ALIGN = 16
# backward blocks per SM, each a partial row of dscale and dbias (of 1-4,
# 2 was the fastest on an H100 at 2,048 and 4,096 rows:
# scripts/perf_torch_layernorm.py)
BWD_BLOCKS_PER_SM = 2


def apply_keep(x: torch.Tensor, keep: torch.Tensor, rate: float
               ) -> torch.Tensor:
    """Inverted dropout given the keep mask: ``x * keep * scale`` in x's
    dtype, the scale ``1 / (1 - rate)`` rounded to that dtype
    (``_apply_keep``, lightningdot_tpu/ops/fused.py:74-77)."""
    return x * keep.to(x.dtype) * torch.tensor(1.0 / (1.0 - rate),
                                               dtype=x.dtype)


def dal_input(x, res=None, keep=None, rate=0.0):
    """u = dropout(x) + res, rounded in x's dtype op by op: ``x * keep``,
    then ``* s``, then ``+ res`` (either part may be absent)."""
    u = x if keep is None else apply_keep(x, keep, rate)
    return u if res is None else u + res


def _ln_math(x, scale, bias, eps):
    """The LayerNorm formula: float32 statistics over the last axis."""
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return (x - mean) * inv * scale + bias


def ln_fwd_math(x, scale, bias, eps, res=None, keep=None, rate=0.0):
    """The forward kernel's twin: ``LayerNorm(dropout(x) + res)`` in float32,
    cast back to u's dtype (x's, where res has it too)."""
    u = dal_input(x, res, keep, rate)
    return _ln_math(u.float(), scale, bias, eps).to(u.dtype)


def layer_norm_bwd(x, scale, g, eps):
    """``_layer_norm_bwd`` (lightningdot_tpu/ops/layernorm.py:74-95): the
    plain formula in float32; dx cast to x's dtype, dscale and dbias
    float32."""
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


def ln_bwd_math(x, scale, g, eps, res=None, keep=None, rate=0.0):
    """The backward kernel's twin: (dx, dres, dscale, dbias) of
    :func:`ln_fwd_math` at cotangent g. u is recomputed; du = dres is
    :func:`layer_norm_bwd` of u, dx = ``apply_keep(du)`` under a mask (else
    du); dscale and dbias float32 sums over all rows."""
    u = dal_input(x, res, keep, rate)
    du, dscale, dbias = layer_norm_bwd(u, scale, g, eps)
    dx = du if keep is None else apply_keep(du, keep, rate)
    return dx, du, dscale, dbias


def _check(what, x2d, params, like, keep) -> int:
    """Shapes, dtypes and alignment of a kernel call, then the device; the
    dtype code. ``params``: float32 [hidden]; ``like``: of x2d's shape and
    dtype; ``keep``: bool of x2d's shape, or None."""
    code = _build.dtype_code(x2d, what)
    hidden = x2d.shape[-1]
    if x2d.dim() != 2 or hidden > MAX_HIDDEN or hidden % 8:
        raise ValueError(f"{what}: shape {tuple(x2d.shape)}: the kernel "
                         f"takes [rows, hidden], hidden a multiple of 8 up "
                         f"to {MAX_HIDDEN}")
    for p in params:
        if p.dtype != torch.float32 or p.shape != (hidden,):
            raise ValueError(f"{what}: scale and bias must be float32 "
                             f"[{hidden}]")
    for t in like:
        if t.shape != x2d.shape or t.dtype != x2d.dtype:
            raise ValueError(f"{what}: {t.dtype}{tuple(t.shape)} beside x "
                             f"{x2d.dtype}{tuple(x2d.shape)}")
    tensors = [x2d, *params, *like]
    if keep is not None:
        if keep.dtype != torch.bool or keep.shape != x2d.shape:
            raise ValueError(f"{what}: keep must be bool "
                             f"{tuple(x2d.shape)}")
        tensors.append(keep)
    for t in tensors:
        if t.data_ptr() % ALIGN:
            raise ValueError(f"{what}: a tensor at {t.data_ptr():#x} is not "
                             f"{ALIGN}-byte aligned")
    _build.require_cuda(what, *tensors)
    return code


def _keep_scale(what, x2d, res, keep, rate) -> float:
    """The mask's scale ``1 / (1 - rate)`` rounded to x's dtype, as
    :func:`apply_keep` rounds it (1.0 without a mask)."""
    if keep is None:
        return 1.0
    if res is None or not 0.0 < rate < 1.0:
        raise ValueError(f"{what}: a keep mask needs a residual and "
                         f"0 < rate < 1")
    return torch.tensor(1.0 / (1.0 - rate), dtype=x2d.dtype).item()


def layer_norm_cuda(x2d: torch.Tensor, scale: torch.Tensor,
                    bias: torch.Tensor, eps: float,
                    res: Optional[torch.Tensor] = None,
                    keep: Optional[torch.Tensor] = None,
                    rate: float = 0.0) -> torch.Tensor:
    """Launch the forward kernel on [rows, hidden] CUDA tensors: the
    LayerNorm of ``dropout(x2d) + res`` (:func:`ln_fwd_math`)."""
    what = "layer_norm kernel"
    code = _check(what, x2d, (scale, bias), [] if res is None else [res],
                  keep)
    keep_scale = _keep_scale(what, x2d, res, keep, rate)
    rows, hidden = x2d.shape
    out = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        _build.check(_build.lib().ldot_layernorm(
            x2d.data_ptr(), None if res is None else res.data_ptr(),
            None if keep is None else keep.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), out.data_ptr(), rows, hidden, eps, keep_scale,
            code, _build.stream_ptr(x2d)), what)
    tracing.launched("layernorm")
    return out


def layer_norm_bwd_cuda(x2d: torch.Tensor, scale: torch.Tensor,
                        g2d: torch.Tensor, eps: float,
                        res: Optional[torch.Tensor] = None,
                        keep: Optional[torch.Tensor] = None,
                        rate: float = 0.0):
    """Launch the backward kernel (and its summing pass) on [rows, hidden]
    CUDA tensors: (dx, dres, dscale, dbias) as :func:`ln_bwd_math` returns
    them; without a mask dx and dres are one tensor."""
    what = "layer_norm backward kernel"
    code = _check(what, x2d, (scale,),
                  [g2d] + ([] if res is None else [res]), keep)
    keep_scale = _keep_scale(what, x2d, res, keep, rate)
    rows, hidden = x2d.shape
    du = torch.empty_like(x2d)
    dx = du if keep is None else torch.empty_like(x2d)
    # a wide row is a block's work alone: one block per row, up to the
    # same cap (the head's 64-256 rows would otherwise sit on 16-64 SMs)
    per_block = 1 if hidden > WIDE_HIDDEN else 4
    blocks = min(-(-rows // per_block),
                 BWD_BLOCKS_PER_SM * _build.num_sms(x2d.device))
    partial = torch.empty(blocks, 2 * hidden, dtype=torch.float32,
                          device=x2d.device)
    dscale = torch.empty(hidden, dtype=torch.float32, device=x2d.device)
    dbias = torch.empty_like(dscale)
    with torch.cuda.device(x2d.device):
        _build.check(_build.lib().ldot_layernorm_bwd(
            x2d.data_ptr(), None if res is None else res.data_ptr(),
            None if keep is None else keep.data_ptr(), scale.data_ptr(),
            g2d.data_ptr(), du.data_ptr(),
            None if keep is None else dx.data_ptr(), partial.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), rows, hidden, blocks, eps,
            keep_scale, code, _build.stream_ptr(x2d)), what)
    tracing.launched("layernorm_bwd")
    return dx, du, dscale, dbias


def _rows(t: Optional[torch.Tensor], hidden: int):
    return None if t is None else t.reshape(-1, hidden).contiguous()


def _ln_forward(x, scale, bias, eps, res=None, keep=None, rate=0.0):
    """:func:`ln_fwd_math` through the kernel on a CUDA tensor (or an
    exception), through the twin on a CPU tensor."""
    if not x.is_cuda:
        return ln_fwd_math(x, scale, bias, eps, res, keep, rate)
    h = x.shape[-1]
    return layer_norm_cuda(_rows(x, h), scale, bias, eps, _rows(res, h),
                           _rows(keep, h), rate).reshape(x.shape)


def _ln_backward(x, scale, g, eps, res=None, keep=None, rate=0.0):
    """:func:`ln_bwd_math` through the kernel on a CUDA tensor (or an
    exception), through the twin on a CPU tensor."""
    if not x.is_cuda:
        return ln_bwd_math(x, scale, g, eps, res, keep, rate)
    h = x.shape[-1]
    dx, du, dscale, dbias = layer_norm_bwd_cuda(
        _rows(x, h), scale, _rows(g, h), eps, _rows(res, h), _rows(keep, h),
        rate)
    return dx.reshape(x.shape), du.reshape(x.shape), dscale, dbias


class _LayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _ln_forward(x, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, _, dscale, dbias = _ln_backward(x, scale, g, ctx.eps)
        return dx, dscale, dbias, None


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = DEFAULT_EPS) -> torch.Tensor:
    """LayerNorm over the last axis with a learned float32 affine.

    A CUDA tensor goes through the kernels (or raises); a CPU tensor through
    the twins, in float32, cast back to x's dtype. Where a gradient is
    needed, the backward is the backward kernel (:func:`ln_bwd_math` on the
    CPU).
    """
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad
                                    or bias.requires_grad):
        return _LayerNorm.apply(x, scale, bias, eps)
    return _ln_forward(x, scale, bias, eps)
