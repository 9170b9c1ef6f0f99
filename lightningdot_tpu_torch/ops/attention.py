"""Multi-head self-attention: a CUDA kernel and its plain PyTorch twin.

Counterpart of lightningdot_tpu/ops/attention.py, deterministic (no
dropout) and in the projection-native ``bshd`` layout only: q, k, v are
[batch, seq, heads, head_dim]. The kernels replace the TPU kernel
``_attn_kernel`` (lightningdot_tpu/ops/attention.py:87, launched by
``_attention_pallas``), split by dtype in the C entry point: bfloat16 runs
on the tensor cores (``csrc/attention_mma.cu``: the twin's rounding points,
float32 sums in another order, so within a bf16 ulp of the twin rather than
bit-equal), float32 on FMA units (``csrc/attention.cu``: register
microtiles, 64 queries a block, bit-equal to the twin; the float32
cross-encoder teacher's attention in KD and re-ranking). Unlike the TPU
dispatch, which sent only batch * heads <= 128 to the kernel, every CUDA
call takes a kernel.
:func:`attention_nodrop` adds the gradient of ``_attention_nodrop``
(:136-163) for training at dropout 0 and in eval mode under autograd.

Math parity with the reference's attention (uniter_model/model/layer.py:
75-101): scores = q k^T / sqrt(d) + additive key bias (0 keep, -10000
masked), row softmax, probs @ v.
"""
from __future__ import annotations

from typing import Optional

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.ops.fused import attention_vjp
from lightningdot_tpu_torch.utils import tracing

# both kernels hold one head's k and v in shared memory (csrc/attention.cu
# 156 KB in float32 at S = 256, D = 64, K^T and V in turn; csrc/
# attention_mma.cu 73 KB in bfloat16); CAP_LEN_BUCKETS (const.py) reach 256
MAX_SEQ = 256
MAX_HEAD_DIM = 64


def check_tensor_core_operands(what: str, head_dim: int,
                               *tensors: torch.Tensor) -> None:
    """The bfloat16 kernel (``csrc/attention_mma.cu``) stages each head
    row in 16-byte copies: head_dim must be a multiple of 8 and every
    operand 16-byte aligned."""
    if head_dim % 8 or any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: bfloat16 needs head_dim % 8 == 0 (got "
                         f"{head_dim}) and 16-byte aligned q, k, v")


def _warp_order_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in the order of the kernel's warp reduction
    (csrc/common.cuh ``warp_sum``): lane l adds elements l, l + 32, ... in
    turn, then the 32 partials meet in a butterfly (16, 8, 4, 2, 1). The
    same float32 sum as ``x.sum(-1)`` up to rounding order, so the deferred
    path's denominators, and the kernel's output, agree bit for bit."""
    s = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, -s % 32))        # + 0.0 is exact
    chunks = x.unflatten(-1, (-1, 32)).unbind(-2)
    part = chunks[0]
    for c in chunks[1:]:
        part = part + c
    off = 16
    while off:
        part = part[..., :off] + part[..., off:2 * off]
        off //= 2
    return part[..., 0]


def _attention_math(q, k, v, bias, scale, defer: Optional[bool] = None):
    """The plain twin, with both numeric paths of the reference's
    ``_attention_math`` (lightningdot_tpu/ops/attention.py:41-84).

    ``bias`` broadcasts to [B, H, Sq, Sk]. Normalized path: float32
    softmax, probabilities cast to v's dtype before probs @ v. Deferred
    path: un-normalized exp(s - max) cast to v's dtype, float32 row sums,
    division after probs @ v. ``defer=None`` takes the deferred path for
    bfloat16 and the normalized one for float32, as the JAX package does
    by default; float32 never defers.
    """
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    scores = scores + bias.float()
    if q.dtype == torch.float32 or defer is False:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                           v.float())
        return out.to(v.dtype)
    m = scores.amax(dim=-1, keepdim=True)
    ex = torch.exp(scores - m)
    denom = _warp_order_sum(ex)                         # [B, H, Sq]
    e = ex.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", e.float(), v.float())
    out = out / denom.transpose(1, 2)[..., None]
    return out.to(v.dtype)


def attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_bias: torch.Tensor, scale: float,
                   defer: bool) -> torch.Tensor:
    """Launch the attention kernel of q's dtype.

    q, k, v: contiguous [B, S, H, D] CUDA tensors of one dtype (bfloat16:
    D a multiple of 8, 16-byte aligned); key_bias: float32 [B, S], added to
    every query row's scores.
    """
    what = "attention kernel"
    code = _build.dtype_code(q, what)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"{what}: q, k, v must share one [B,S,H,D] shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: q, k, v dtypes differ")
    b, s, h, d = q.shape
    if s > MAX_SEQ or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: seq {s} > {MAX_SEQ} or head_dim {d} > "
                         f"{MAX_HEAD_DIM} is not supported")
    if key_bias.dtype != torch.float32 or key_bias.shape != (b, s):
        raise ValueError(f"{what}: key bias must be float32 [{b}, {s}], got "
                         f"{key_bias.dtype} {tuple(key_bias.shape)}")
    _build.require_cuda(what, q, k, v, key_bias)
    if q.dtype == torch.bfloat16:
        check_tensor_core_operands(what, d, q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.check(_build.lib().ldot_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(),
            out.data_ptr(), b, s, h, d, scale, int(defer), code,
            _build.stream_ptr(q)), what)
    tracing.launched("attention")
    return out


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention, deterministic, ``bshd`` layout.

    Args:
      q, k, v: [batch, seq, heads, head_dim].
      bias: additive mask broadcastable to [batch, heads, seq, seq]; on
        CUDA it must be a key-only bias, [batch, 1, 1, seq] (as
        ``models.encoder.attention_bias`` makes) or [batch, seq].

    bfloat16 takes the deferred-normalization path, float32 the normalized
    one (``_attention_math``).
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    if not q.is_cuda:
        return _attention_math(q, k, v, bias, scale)
    b, s = q.shape[0], q.shape[1]
    if bias.shape not in ((b, 1, 1, s), (b, s)):
        raise ValueError(f"attention kernel: bias {tuple(bias.shape)} is not "
                         f"a key-only bias [{b}, 1, 1, {s}]")
    return attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                          bias.reshape(b, s).float().contiguous(), scale,
                          defer=q.dtype != torch.float32)


class _AttentionNoDrop(torch.autograd.Function):
    """``_attention_nodrop`` (lightningdot_tpu/ops/attention.py:136-163):
    the forward is :func:`multi_head_attention` (the kernel on CUDA, the
    deferred normalization in bfloat16); the backward recomputes the
    normalized form, the vjp of ``_attention_math(defer=False)``."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return multi_head_attention(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias = ctx.saved_tensors
        dq, dk, dv = attention_vjp(q, k, v, bias, None, 0.0,
                                   q.shape[-1] ** -0.5, g)
        return dq, dk, dv, None


def attention_nodrop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    """:func:`multi_head_attention` with a gradient w.r.t. q, k and v: the
    training path at dropout 0 and the eval path under autograd."""
    return _AttentionNoDrop.apply(q, k, v, bias)
