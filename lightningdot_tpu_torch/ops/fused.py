"""The two training compositions of a BertLayer, with their gradients
(counterpart of lightningdot_tpu/ops/fused.py).

* :func:`dropout_add_ln` -- ``LayerNorm(dropout(x) + res)``
  (``dropout_add_ln``, :93-148): one launch of the LayerNorm kernel with its
  mask-and-add prologue forward, one of the backward kernel (and its
  summing pass) backward, which recomputes the LayerNorm input
  (``_dal_bwd``, :114-126) and keeps only the keep mask, JAX's default
  "store" policy (:59-66). Twins: ``ops/layernorm.py``'s
  ``ln_fwd_math``/``ln_bwd_math``.
* :func:`attention_prob_dropout` -- attention with dropout on the
  probabilities (``attention_prob_dropout``, :173-291): normalized float32
  softmax, probabilities rounded to the compute dtype before the mask
  (``_attn_core``, :197-208); the backward recomputes scores and softmax
  (``_attn_drop_bwd``, :238-280, :func:`attention_vjp`). Plain torch, as
  the JAX default computes it in jnp. It is the spec of JAX's default
  training path; the port's towers train through the fused kernel of
  ``ops/attention_fused.py`` (JAX's ``LDOT_ATTN_KERNEL=1`` branch) instead,
  and through ``attention_vjp`` at dropout 0.

Each takes its keep mask as an input, drawn by :func:`keep_mask` from an
explicit ``torch.Generator``, so a test can inject the mask that
``jax.random.bernoulli`` drew. ``keep=None`` means no dropout.
"""
from __future__ import annotations

from typing import Optional

import torch

from lightningdot_tpu_torch.ops.layernorm import (_ln_backward, _ln_forward,
                                                  apply_keep)


def keep_mask(shape, rate: float, generator: torch.Generator
              ) -> torch.Tensor:
    """A bool keep mask, True with probability ``1 - rate``, drawn on the
    generator's device."""
    return torch.rand(shape, generator=generator,
                      device=generator.device) < 1.0 - rate


class _DropoutAddLN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, res, scale, bias, keep, rate, eps):
        ctx.save_for_backward(x, res, scale, keep)
        ctx.rate, ctx.eps = rate, eps
        return _ln_forward(x, scale, bias, eps, res, keep, rate)

    @staticmethod
    def backward(ctx, g):
        x, res, scale, keep = ctx.saved_tensors      # u is recomputed
        dx, dres, dscale, dbias = _ln_backward(x, scale, g, ctx.eps, res,
                                               keep, ctx.rate)
        return dx, dres, dscale, dbias, None, None, None


def dropout_add_ln(x: torch.Tensor, res: torch.Tensor, scale: torch.Tensor,
                   bias: torch.Tensor, keep: Optional[torch.Tensor], *,
                   rate: float, eps: float) -> torch.Tensor:
    """``LayerNorm(dropout(x) + res)`` with float32 statistics, cast back to
    x's dtype, in one launch of the LayerNorm kernel on the card. Without a
    gradient and without a mask it is ``layer_norm(x + res)``, the inference
    path (the int8 tower's too)."""
    if keep is not None and rate <= 0.0:
        raise ValueError("dropout_add_ln: a keep mask needs rate > 0")
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, res, scale, bias))
    if not needs_grad:
        return _ln_forward(x, scale, bias, eps, res, keep, rate)
    return _DropoutAddLN.apply(x, res, scale, bias, keep, rate, eps)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> float32 [B, H, S, D] (bfloat16 -> float32 is exact,
    so the products below accumulate exact products in float32)."""
    return t.float().permute(0, 2, 1, 3)


def _attn_probs(qf, kf, bias, scale):
    scores = qf @ kf.transpose(-1, -2) * scale + bias.float()
    return torch.softmax(scores, dim=-1)


def attention_vjp(q, k, v, bias, keep, rate, scale, g):
    """(dq, dk, dv) of the attention composition by recompute
    (``_attn_drop_bwd``, :238-280): scores and the float32 softmax again,
    the probabilities rounded to the compute dtype (then the mask), the
    cotangent of the rounded probabilities rounded to it too, the float32
    softmax VJP. With ``keep=None`` this is also the vjp of the normalized
    ``_attention_math(defer=False)`` (lightningdot_tpu/ops/attention.py:
    149-160), the backward of ``ops.attention.attention_nodrop``."""
    qf, kf, vf = _heads_first(q), _heads_first(k), _heads_first(v)
    probs = _attn_probs(qf, kf, bias, scale)          # recomputed
    dropped = probs.to(v.dtype)
    if keep is not None:
        dropped = apply_keep(dropped, keep, rate)
    gf = _heads_first(g)
    dv = (dropped.float().transpose(-1, -2) @ gf).to(v.dtype)
    d_dropped = (gf @ vf.transpose(-1, -2)).to(v.dtype)
    if keep is not None:
        d_dropped = apply_keep(d_dropped, keep, rate)
    dp = d_dropped.float()
    ds = probs * (dp - (dp * probs).sum(dim=-1, keepdim=True)) * scale
    dq = (ds @ kf).to(q.dtype)
    dk = (ds.transpose(-1, -2) @ qf).to(k.dtype)
    return (dq.permute(0, 2, 1, 3), dk.permute(0, 2, 1, 3),
            dv.permute(0, 2, 1, 3))


class _AttnProbDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, keep, rate, scale):
        ctx.save_for_backward(q, k, v, bias, keep)
        ctx.rate, ctx.scale = rate, scale
        probs = _attn_probs(_heads_first(q), _heads_first(k), bias, scale)
        dropped = probs.to(v.dtype)
        if keep is not None:
            dropped = apply_keep(dropped, keep, rate)
        out = dropped.float() @ _heads_first(v)
        return out.permute(0, 2, 1, 3).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias, keep = ctx.saved_tensors
        return attention_vjp(q, k, v, bias, keep, ctx.rate, ctx.scale,
                             g) + (None, None, None, None)


def attention_prob_dropout(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, bias: torch.Tensor,
                           keep: Optional[torch.Tensor], *, rate: float,
                           scale: float) -> torch.Tensor:
    """Attention on [B, S, heads, D] q, k, v with an additive key bias
    (broadcast to [B, heads, S, S]) and dropout on the probabilities by the
    bool ``keep`` [B, heads, S, S] (None: no dropout). Returns [B, S, heads,
    D] in v's dtype; the backward recomputes the probabilities."""
    if keep is not None and rate <= 0.0:
        raise ValueError("attention_prob_dropout: a keep mask needs rate > 0")
    return _AttnProbDropout.apply(q, k, v, bias, keep, rate, scale)
