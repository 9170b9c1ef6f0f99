"""Training attention with dropout on the probabilities: two CUDA kernels
(forward, backward) and their plain PyTorch twins.

Counterpart of lightningdot_tpu/ops/experimental/attention_fused.py. The
kernels (``csrc/attention_fused.cu``) replace the TPU kernels
``_fwd_kernel`` (:117) and ``_bwd_kernel`` (:136), launched by ``_call``
(:221) from ``fused_attention_train`` (:283-308), JAX's training attention
under ``LDOT_ATTN_KERNEL=1`` (lightningdot_tpu/models/encoder.py:308-324).
bfloat16 runs on the tensor cores: the forward in ``csrc/attention_mma.cu``
(the kernel of bfloat16 ``multi_head_attention`` with a normalize-and-drop
epilogue), the backward in ``csrc/attention_mma_bwd.cu``; both keep the
twins' rounding points and sum in float32 in another order. float32
(training with ``--compute_dtype f32``) runs on the FMA units, bit-equal
to the twins: the forward is ``csrc/attention.cu``'s register-blocked
kernel with a dropout pass, the backward two register-blocked kernels in
``csrc/attention_fused.cu``. In the port it is the training attention of
every tower at a dropout rate above 0, on both devices: the kernels on
CUDA, the twins on the CPU.

q, k and v are the raw projections, [B, S, H*D]; the head split is done by
strides. The keep mask comes from counter-based Philox4x32-10
(:func:`philox_keep`) keyed on a 64-bit seed and on (batch item, head, row,
column), so the backward regenerates the forward's mask from the seed
alone, on the card and on the CPU alike. The TPU kernels drew from the
Mosaic per-core PRNG, a different stream: the port's masks are its own,
with the same keep rule (``bits < (1 - rate) * 2**32``, ``_keep_from_bits``,
:66-72).

The twins follow the TPU kernels' rounding points step for step, which are
not those of JAX's default composition (``ops/fused.py``): see
:func:`_fused_attn_fwd_math` and :func:`_fused_attn_bwd_math`.
"""
from __future__ import annotations

from typing import Optional

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.ops.activations import weak_const
from lightningdot_tpu_torch.ops.attention import (_warp_order_sum,
                                                  check_tensor_core_operands)
from lightningdot_tpu_torch.utils import tracing

# the float32 backward (csrc/attention_fused.cu) keeps one head's K (or Q
# and G) and a tile of 32 or 64 rows in shared memory: up to 155 KB at S
# 256, D 64 (csrc/attention_mma_bwd.cu 81 KB in bfloat16)
MAX_SEQ = 256
MAX_HEAD_DIM = 64

_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_GOLDEN = 0x9E3779B97F4A7C15


def _mulhilo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of a * b for a constant ``a`` < 2**32 and an
    int64 tensor ``b`` of values < 2**32, without leaving int64: the
    product is taken in 16-bit halves of ``a``."""
    p1 = b * (a & 0xFFFF)                       # < 2**48
    p2 = b * (a >> 16)                          # < 2**48
    s = p1 + ((p2 & 0xFFFF) << 16)              # < 2**49
    return (p2 >> 16) + (s >> 32), s & _M32


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11; Random123's ``philox4x32``) on
    int64 tensors holding 32-bit words: ``counter`` four words, ``key``
    two, all broadcast together. Returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """Keep iff the 32 random bits are below this (``_keep_from_bits``)."""
    return int(min((1.0 - rate) * 4294967296.0, 4294967295.0))


def philox_keep(seed: torch.Tensor, b: int, h: int, s: int, t: int,
                rate: float) -> torch.Tensor:
    """The bool keep mask [b, h, s, t] of seed (an int64 tensor of one
    element, on any device): element (i, n, r, c) is word ``c % 4`` of
    ``philox4x32((c // 4, r, n, i), (seed lo, seed hi))``, kept iff below
    :func:`keep_threshold`. The kernels draw the same words."""
    seed = seed.reshape(())
    dev = seed.device

    def axis(n, dim):
        shape = [1, 1, 1, 1]
        shape[dim] = n
        return torch.arange(n, dtype=torch.int64, device=dev).view(shape)

    words = philox4x32(
        (axis((t + 3) // 4, 3), axis(s, 2), axis(h, 1), axis(b, 0)),
        (seed & _M32, (seed >> 32) & _M32))
    words = [w.expand(b, h, s, (t + 3) // 4) for w in words]
    bits = torch.stack(words, dim=-1).reshape(b, h, s, -1)[..., :t]
    return bits < keep_threshold(rate)


def _splitmix64(x: int) -> int:
    x = (x + _GOLDEN) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def site_seeds(base: int, n: int, device: torch.device) -> torch.Tensor:
    """int64 [n] seeds of ``n`` dropout sites (the layers of a tower) from
    one host seed: splitmix64 of ``base`` and the site's index. A function
    of the host seed alone, so a generator seeded alike gives the same
    masks on the card and on the CPU; on CUDA the seeds travel in one
    non-blocking copy from pinned memory, without a device sync."""
    vals = [_splitmix64((base + i * _GOLDEN) & 0xFFFFFFFFFFFFFFFF)
            for i in range(n)]
    seeds = torch.tensor([v - (1 << 64) if v >= 1 << 63 else v
                          for v in vals], dtype=torch.int64)
    if device.type != "cuda":
        return seeds.to(device)
    return seeds.pin_memory().to(device, non_blocking=True)


def _heads(x: torch.Tensor, nh: int) -> torch.Tensor:
    """[B, S, H*D] -> float32 [B, H, S, D] (bfloat16 -> float32 is exact)."""
    b, s, w = x.shape
    return x.float().view(b, s, nh, w // nh).permute(0, 2, 1, 3)


def _merge(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 [B, H, S, D] -> [B, S, H*D] in ``dtype``."""
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d).to(dtype)


def _probs(qf, kf, bias2d, scale):
    """``_softmax_all`` (:106-114): float32 scores * scale + key bias, e /
    sum(e), the sum in the kernels' warp order."""
    scores = (qf @ kf.transpose(-1, -2)) * scale
    scores = scores + bias2d.float()[:, None, None, :]
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    return e / _warp_order_sum(e)[..., None]


def _keep(seed, shape, rate):
    b, h, s, t = shape
    return philox_keep(seed, b, h, s, t, rate)


def _fused_attn_fwd_math(q, k, v, bias2d, seed, nh: int, rate: float,
                         scale: float) -> torch.Tensor:
    """The forward twin, ``_fwd_kernel`` step for step: float32 softmax,
    probabilities rounded to the compute dtype, then ``* keep * (1/(1-rate)
    in the compute dtype)``, then probs . v accumulated in float32."""
    dtype = q.dtype
    qf, kf, vf = _heads(q, nh), _heads(k, nh), _heads(v, nh)
    probs = _probs(qf, kf, bias2d, scale).to(dtype)
    if rate > 0.0:
        keep = _keep(seed, probs.shape, rate)
        probs = probs * keep.to(dtype) * weak_const(1.0 / (1.0 - rate),
                                                    dtype)
    return _merge(probs.float() @ vf, dtype)


def _fused_attn_bwd_math(q, k, v, bias2d, seed, g, nh: int, rate: float,
                         scale: float):
    """The backward twin, ``_bwd_kernel`` step for step: the forward
    recomputed; dv = dropped^T g; d(dropped) = g v^T left in float32, times
    keep and 1/(1-rate) in float32; the float32 softmax VJP; ds * scale
    rounded to the compute dtype (:171) before dq and dk. Returns (dq, dk,
    dv), [B, S, H*D] each."""
    dtype = q.dtype
    qf, kf, vf, gf = (_heads(x, nh) for x in (q, k, v, g))
    probs = _probs(qf, kf, bias2d, scale)
    dropped = probs.to(dtype)
    dp = gf @ vf.transpose(-1, -2)
    if rate > 0.0:
        keep = _keep(seed, probs.shape, rate)
        dropped = dropped * keep.to(dtype) * weak_const(1.0 / (1.0 - rate),
                                                        dtype)
        dp = dp * keep.float() * weak_const(1.0 / (1.0 - rate),
                                            torch.float32)
    dv = dropped.float().transpose(-1, -2) @ gf
    ds = probs * (dp - _warp_order_sum(dp * probs)[..., None])
    ds = (ds * scale).to(dtype).float()
    return (_merge(ds @ kf, dtype), _merge(ds.transpose(-1, -2) @ qf, dtype),
            _merge(dv, dtype))


def _check(what, tensors, seed, bias2d, nh):
    _build.require_cuda(what, *tensors, bias2d, seed)
    code = _build.dtype_code(tensors[0], what)
    q = tensors[0]
    if q.dim() != 3 or any(t.shape != q.shape for t in tensors):
        shapes = [tuple(t.shape) for t in tensors]
        raise ValueError(f"{what}: q, k, v (and g) must share one [B, S, "
                         f"H*D] shape, got {shapes}")
    if any(t.dtype != q.dtype for t in tensors):
        raise TypeError(f"{what}: q, k, v (and g) dtypes differ")
    b, s, w = q.shape
    if w % nh or s > MAX_SEQ or w // nh > MAX_HEAD_DIM:
        raise ValueError(f"{what}: seq {s} > {MAX_SEQ}, or width {w} not "
                         f"{nh} heads of head_dim <= {MAX_HEAD_DIM}")
    if bias2d.dtype != torch.float32 or bias2d.shape != (b, s):
        raise ValueError(f"{what}: key bias must be float32 [{b}, {s}], got "
                         f"{bias2d.dtype} {tuple(bias2d.shape)}")
    if seed.dtype != torch.int64 or seed.numel() != 1:
        raise ValueError(f"{what}: seed must be one int64, got {seed.dtype} "
                         f"{tuple(seed.shape)}")
    return code, b, s, w // nh


def attention_train_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias2d: torch.Tensor, seed: torch.Tensor, *, nh: int,
                        rate: float, scale: float) -> torch.Tensor:
    """Launch the forward kernel of q's dtype on contiguous CUDA tensors:
    q, k, v [B, S, H*D] of one dtype (bfloat16: head_dim a multiple of 8,
    16-byte aligned), ``bias2d`` float32 [B, S], ``seed`` int64 [1]."""
    what = "attention_train_fwd kernel"
    code, b, s, d = _check(what, (q, k, v), seed, bias2d, nh)
    if q.dtype == torch.bfloat16:
        check_tensor_core_operands(what, d, q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.check(_build.lib().ldot_attention_train_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias2d.data_ptr(),
            seed.data_ptr(), out.data_ptr(), b, s, nh, d, scale,
            weak_const(1.0 / (1.0 - rate), q.dtype) if rate > 0 else 1.0,
            keep_threshold(rate), int(rate > 0), code,
            _build.stream_ptr(q)), what)
    tracing.launched("attention_train_fwd")
    return out


def _launch_bwd(what, dtype, q, k, v, bias2d, seed, g, nh, rate, scale):
    code, b, s, d = _check(what, (q, k, v, g), seed, bias2d, nh)
    if q.dtype != dtype:
        raise TypeError(f"{what}: takes {dtype}, got {q.dtype}")
    if dtype == torch.bfloat16:
        check_tensor_core_operands(what, d, q, k, v, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    stats = torch.empty((3, b * nh, s), dtype=torch.float32, device=q.device)
    inv = 1.0 / (1.0 - rate) if rate > 0 else 1.0
    with torch.cuda.device(q.device):
        _build.check(_build.lib().ldot_attention_train_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias2d.data_ptr(),
            seed.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), b, s, nh, d, scale,
            weak_const(inv, q.dtype), inv, keep_threshold(rate),
            int(rate > 0), code, _build.stream_ptr(q)), what)
    return dq, dk, dv


def attention_train_bwd_fma(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias2d: torch.Tensor,
                            seed: torch.Tensor, g: torch.Tensor, *, nh: int,
                            rate: float, scale: float):
    """Launch the float32 backward kernels (``csrc/attention_fused.cu``: dq
    with the per-row statistics by query tiles, then dk and dv by key
    tiles) on contiguous CUDA tensors
    as :func:`attention_train_fwd` takes them, ``g`` the output's
    cotangent. Returns (dq, dk, dv)."""
    grads = _launch_bwd("attention_train_bwd kernel", torch.float32, q, k,
                        v, bias2d, seed, g, nh, rate, scale)
    tracing.launched("attention_train_bwd")
    return grads


def attention_train_bwd_mma(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias2d: torch.Tensor,
                            seed: torch.Tensor, g: torch.Tensor, *, nh: int,
                            rate: float, scale: float):
    """Launch the bfloat16 backward on the tensor cores
    (``csrc/attention_mma_bwd.cu``: a dq kernel with the per-row
    statistics, then a dk/dv kernel) on contiguous CUDA tensors: head_dim a
    multiple of 8, q, k, v and g 16-byte aligned. Returns (dq, dk, dv)."""
    grads = _launch_bwd("attention_train_bwd tensor-core kernel",
                        torch.bfloat16, q, k, v, bias2d, seed, g, nh, rate,
                        scale)
    tracing.launched("attention_train_bwd_mma")
    return grads


def attention_train_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias2d: torch.Tensor, seed: torch.Tensor,
                        g: torch.Tensor, *, nh: int, rate: float,
                        scale: float):
    """The backward kernels of q's dtype: bfloat16 on the tensor cores
    (:func:`attention_train_bwd_mma`), float32 on FMA units
    (:func:`attention_train_bwd_fma`). Returns (dq, dk, dv)."""
    launch = (attention_train_bwd_mma if q.dtype == torch.bfloat16
              else attention_train_bwd_fma)
    return launch(q, k, v, bias2d, seed, g, nh=nh, rate=rate, scale=scale)


class _FusedAttention(torch.autograd.Function):
    """``_attn`` (:233-253): the forward kernel, and a backward that
    recomputes from q, k, v, the bias and the seed alone."""

    @staticmethod
    def forward(ctx, q, k, v, bias2d, seed, nh, rate):
        ctx.save_for_backward(q, k, v, bias2d, seed)
        ctx.nh, ctx.rate = nh, rate
        scale = (q.shape[-1] // nh) ** -0.5
        if q.is_cuda:
            return attention_train_fwd(q, k, v, bias2d, seed, nh=nh,
                                       rate=rate, scale=scale)
        return _fused_attn_fwd_math(q, k, v, bias2d, seed, nh, rate, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v, bias2d, seed = ctx.saved_tensors
        nh, rate = ctx.nh, ctx.rate
        scale = (q.shape[-1] // nh) ** -0.5
        g = g.contiguous()
        if q.is_cuda:
            grads = attention_train_bwd(q, k, v, bias2d, seed, g, nh=nh,
                                        rate=rate, scale=scale)
        else:
            grads = _fused_attn_bwd_math(q, k, v, bias2d, seed, g, nh, rate,
                                         scale)
        return grads + (None, None, None, None)


def fused_attention_train(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, bias2d: torch.Tensor,
                          seed: Optional[torch.Tensor], *, nh: int,
                          rate: float) -> torch.Tensor:
    """Attention with dropout ``rate`` on the probabilities
    (``fused_attention_train``, :283-308).

    Args:
      q, k, v: the raw projections [B, S, nh * head_dim], one dtype.
      bias2d: [B, S] additive key bias (0 keep, -10000 masked).
      seed: int64 [1] on q's device (``site_seeds``); None draws seed 0, as
        JAX's ``rng=None``.
    Returns the context [B, S, nh * head_dim] in q's dtype, differentiable
    w.r.t. q, k and v.
    """
    if seed is None:
        seed = torch.zeros(1, dtype=torch.int64, device=q.device)
    return _FusedAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(),
                                 bias2d.float().contiguous(), seed, int(nh),
                                 float(rate))

