"""Multi-head latent attention's attention core with a causal mask: a CUDA
kernel (``csrc/mla_attention.cu``, forward and backward) and its plain
PyTorch twin.

No TPU counterpart: the JAX package's attention (``ops/attention.py``)
takes one head width of at most 64 and a key-only bias. The Moonlight tower
(``models/moonlight.py``) scores q and k of 192 dims (128 without RoPE and
64 with it) and sums v of 128 dims, causally, with pad keys masked:

    s = q k^T * scale over keys j with key_ok[j] and j <= i
    p = softmax(s), o = p v   (float32 arithmetic, o rounded to q's dtype)

for each real query i; a padding query (key_ok 0) reads nothing: its o is
0 (lse +inf), so the kernels' work follows the real tokens.
"""
from __future__ import annotations

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.utils import tracing

MAX_SEQ = 64       # the kernels hold a head's S x S scores in shared memory
MAX_HEAD_DIM = 256


def _allowed(key_ok: torch.Tensor, s: int, causal: bool) -> torch.Tensor:
    """bool [B, 1, S, S]: query i may read key j."""
    ok = (key_ok > 0)[:, None, None, :]
    if causal:
        ok = ok & torch.ones(s, s, dtype=torch.bool,
                             device=key_ok.device).tril()[None, None]
    return ok


def mla_attention_math(q, k, v, key_ok, scale: float, causal: bool = True):
    """The kernels' twin: q, k [B, S, heads, dqk], v [B, S, heads, dv],
    key_ok float32 [B, S] -> (o [B, S, heads, dv] in q's dtype, lse float32
    [B, heads, S])."""
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s = (qf @ kf.transpose(-1, -2)) * scale
    s = s.masked_fill(~_allowed(key_ok, q.shape[1], causal), float("-inf"))
    real = (key_ok > 0)[:, None, :]                      # [B, 1, S] queries
    lse = torch.where(real, torch.logsumexp(s, dim=-1),
                      torch.full_like(s[..., 0], float("inf")))
    p = torch.exp(s - lse[..., None])
    o = (p @ vf).transpose(1, 2).to(q.dtype)
    return o, lse


def mla_attention_bwd_math(q, k, v, o, g, key_ok, lse, scale: float,
                           causal: bool = True):
    """(dq, dk, dv) of :func:`mla_attention_math` at cotangent g, from the
    forward's o and lse, in float32, cast to the inputs' dtype."""
    qf, kf, vf, of, gf = (t.float().transpose(1, 2) for t in (q, k, v, o, g))
    s = (qf @ kf.transpose(-1, -2)) * scale
    ok = _allowed(key_ok, q.shape[1], causal)
    p = torch.where(ok, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dv = p.transpose(-1, -2) @ gf
    dp = gf @ vf.transpose(-1, -2)
    di = (gf * of).sum(-1, keepdim=True)
    ds = p * (dp - di)
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    return tuple(t.transpose(1, 2).to(q.dtype) for t in (dq, dk, dv))


def _check(what, q, k, v, key_ok):
    code = _build.dtype_code(q, what)
    b, s, nh, dqk = q.shape
    dv = v.shape[-1]
    if (k.shape != q.shape or v.shape[:3] != q.shape[:3]
            or key_ok.shape != (b, s) or key_ok.dtype != torch.float32
            or k.dtype != q.dtype or v.dtype != q.dtype):
        raise ValueError(f"{what}: q, k {tuple(q.shape)}, v "
                         f"{tuple(v.shape)}, key_ok {tuple(key_ok.shape)}")
    if s > MAX_SEQ or dqk > MAX_HEAD_DIM or dv > MAX_HEAD_DIM:
        raise ValueError(f"{what}: takes S <= {MAX_SEQ} and head widths <= "
                         f"{MAX_HEAD_DIM}; got S={s}, dqk={dqk}, dv={dv}")
    _build.require_cuda(what, q, k, v, key_ok)
    return code, b, s, nh, dqk, dv


def mla_attention_cuda(q, k, v, key_ok, scale: float, causal: bool = True):
    """Launch the forward kernel: (o, lse) as :func:`mla_attention_math`."""
    what = "mla_attention kernel"
    code, b, s, nh, dqk, dv = _check(what, q, k, v, key_ok)
    o = torch.empty(b, s, nh, dv, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, nh, s, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _build.check(_build.lib().ldot_mla_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_ok.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, s, nh, dqk, dv, float(scale),
            int(causal), code, _build.stream_ptr(q)), what)
    tracing.launched("mla_attention")
    return o, lse


def mla_attention_bwd_cuda(q, k, v, o, g, key_ok, lse, scale: float,
                           causal: bool = True):
    """Launch the backward kernel: (dq, dk, dv)."""
    what = "mla_attention backward kernel"
    code, b, s, nh, dqk, dv = _check(what, q, k, v, key_ok)
    _build.require_cuda(what, o, g, lse)
    dq, dk = torch.empty_like(q), torch.empty_like(k)
    dvt = torch.empty_like(v)
    with torch.cuda.device(q.device):
        _build.check(_build.lib().ldot_mla_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            g.data_ptr(), key_ok.data_ptr(), lse.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dvt.data_ptr(), b, s, nh, dqk, dv, float(scale),
            int(causal), code, _build.stream_ptr(q)), what)
    tracing.launched("mla_attention_bwd")
    return dq, dk, dvt


class _MlaAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_ok, scale, causal):
        fn = mla_attention_cuda if q.is_cuda else mla_attention_math
        with tracing.span("mla.attention"):
            o, lse = fn(q, k, v, key_ok, scale, causal)
        ctx.save_for_backward(q, k, v, o, key_ok, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, key_ok, lse = ctx.saved_tensors
        fn = mla_attention_bwd_cuda if q.is_cuda else mla_attention_bwd_math
        with tracing.span("mla.attention"):
            dq, dk, dv = fn(q, k, v, o, g.contiguous(), key_ok, lse,
                            ctx.scale, ctx.causal)
        return dq, dk, dv, None, None, None


def mla_attention(q, k, v, key_ok, scale: float, causal: bool = True):
    """o [B, S, heads, dv] of q, k [B, S, heads, dqk] and v [B, S, heads,
    dv] (contiguous), key_ok float32 [B, S]: the kernels on CUDA tensors
    (or an exception outside their ranges), the twins on CPU tensors."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _MlaAttention.apply(q, k, v, key_ok, scale, causal)
    fn = mla_attention_cuda if q.is_cuda else mla_attention_math
    with tracing.span("mla.attention"):
        return fn(q, k, v, key_ok, scale, causal)[0]
