"""The AdamW update of every parameter at once: a CUDA multi-tensor kernel
and its plain PyTorch twin.

Counterpart of the leaf update of ``FusedAdamW.apply``
(lightningdot_tpu/training/optim.py:261-275). The kernel
(``csrc/adamw.cu``) replaces the TPU kernel ``_adamw_kernel``
(lightningdot_tpu/ops/experimental/adamw_pallas.py:27, launched by
``adamw_leaf_pallas`` at :46-76), one launch for all tensors where the TPU
kernel took one eligible leaf per call. p, g and v are float32; m is
float32 or bfloat16; p, m and v are updated in place. Each tensor has a
decay ``wd`` and a learning-rate factor ``lr_mul`` (the VQA head's
``--vqa_lr_mul``, lightningdot_tpu/cli/train_vqa.py:131-149): its step size
is ``step_size * lr_mul`` and its decay ``(lr * lr_mul) * wd``. The twin
performs the kernel's operations in the kernel's order (no fused
multiply-add), so the two agree bit for bit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.utils import tracing

CHUNK = 1 << 15   # csrc/adamw.cu: elements per block


def _adamw_math(p, g, m, v, scale, *, step_size, lr, b1, b2, eps, wd,
                lr_mul=1.0):
    """The plain twin for one tensor -> (p', m', v'), m' in m's dtype.
    ``g`` None counts as zeros; ``scale`` is the clip scale (a float32
    tensor); ``step_size`` and ``lr`` are float32 values; ``wd`` the
    tensor's decay (0 for none) and ``lr_mul`` its learning-rate factor."""
    f32 = np.float32
    step = float(f32(step_size) * f32(lr_mul))
    g = torch.zeros_like(p) if g is None else g * scale
    m2 = b1 * m.float() + (1.0 - b1) * g
    v2 = b2 * v + (1.0 - b2) * (g * g)
    p2 = p - step * m2 / (torch.sqrt(v2) + eps)
    if wd:
        p2 = p2 - float(f32(f32(lr) * f32(lr_mul)) * f32(wd)) * p2
    return p2, m2.to(m.dtype), v2


def _table(params, grads, ms, vs, wds, lr_muls=None) -> np.ndarray:
    """int64 [n_tensors * 6 + n_chunks]: the kernel's Entry rows (p, g, m,
    v, numel, then wd and lr_mul as two float32), then its (tensor, chunk)
    pairs as int32 pairs. ``lr_muls`` None: 1 for every tensor."""
    n = len(params)
    if lr_muls is None:
        lr_muls = [1.0] * n
    rows = np.zeros((n, 6), np.int64)
    rows[:, 0] = [t.data_ptr() for t in params]
    rows[:, 1] = [0 if t is None else t.data_ptr() for t in grads]
    rows[:, 2] = [t.data_ptr() for t in ms]
    rows[:, 3] = [t.data_ptr() for t in vs]
    numel = np.array([t.numel() for t in params], np.int64)
    rows[:, 4] = numel
    rows[:, 5] = np.stack([np.asarray(wds, np.float32),
                           np.asarray(lr_muls, np.float32)],
                          axis=1).view(np.int64)[:, 0]
    per = -(-numel // CHUNK)
    chunks = np.zeros((int(per.sum()), 2), np.int32)
    chunks[:, 0] = np.repeat(np.arange(n, dtype=np.int32), per)
    starts = np.cumsum(per) - per
    chunks[:, 1] = np.arange(len(chunks)) - np.repeat(starts, per)
    return np.concatenate([rows.ravel(), chunks.view(np.int64).ravel()])


def adamw_cuda(params: Sequence[torch.Tensor],
               grads: Sequence[Optional[torch.Tensor]],
               ms: Sequence[torch.Tensor], vs: Sequence[torch.Tensor],
               wds: Sequence[float], clip_scale: torch.Tensor, *,
               step_size: float, lr: float, b1: float, b2: float,
               eps: float, lr_muls: Optional[Sequence[float]] = None) -> None:
    """One launch of the AdamW kernel over every tensor, in place."""
    what = "adamw kernel"
    grads = [None if g is None else g.contiguous() for g in grads]
    tensors = [*params, *ms, *vs, clip_scale,
               *(g for g in grads if g is not None)]
    _build.require_cuda(what, *tensors)
    m_dtype = ms[0].dtype
    if m_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: m must be float32 or bfloat16")
    for p, g, m, v in zip(params, grads, ms, vs):
        if (p.dtype != torch.float32 or v.dtype != torch.float32
                or (g is not None and g.dtype != torch.float32)
                or m.dtype != m_dtype):
            raise TypeError(f"{what}: p, g, v must be float32 and every m "
                            f"{m_dtype}")
        if not (p.shape == m.shape == v.shape
                and (g is None or g.shape == p.shape)):
            raise ValueError(f"{what}: shapes differ for a tensor of shape "
                             f"{tuple(p.shape)}")
    if clip_scale.dtype != torch.float32 or clip_scale.numel() != 1:
        raise ValueError(f"{what}: clip_scale must be one float32 value")
    n = len(params)
    host = torch.from_numpy(_table(params, grads, ms, vs, wds, lr_muls))
    dev = host.pin_memory().to(params[0].device, non_blocking=True)
    n_chunks = host.numel() - 6 * n
    with torch.cuda.device(dev.device):
        _build.check(_build.lib().ldot_adamw(
            dev.data_ptr(), dev.data_ptr() + 48 * n, n_chunks,
            clip_scale.data_ptr(), step_size, lr, b1, 1.0 - b1, b2,
            1.0 - b2, eps, int(m_dtype == torch.bfloat16),
            _build.stream_ptr(dev)), what)
    tracing.launched("adamw")


@torch.no_grad()
def adamw_(params, grads, ms, vs, wds, clip_scale, *, step_size, lr, b1, b2,
           eps, lr_muls=None) -> None:
    """Update every (p, m, v) in place: the kernel for CUDA tensors (or it
    raises), the twin tensor by tensor on the CPU. ``lr_muls``: each
    tensor's learning-rate factor (None: 1 for every tensor)."""
    if lr_muls is None:
        lr_muls = [1.0] * len(params)
    if params[0].is_cuda:
        adamw_cuda(params, grads, ms, vs, wds, clip_scale,
                   step_size=step_size, lr=lr, b1=b1, b2=b2, eps=eps,
                   lr_muls=lr_muls)
        return
    for p, g, m, v, wd, mul in zip(params, grads, ms, vs, wds, lr_muls):
        p2, m2, v2 = _adamw_math(p, g, m, v, clip_scale, step_size=step_size,
                                 lr=lr, b1=b1, b2=b2, eps=eps, wd=wd,
                                 lr_mul=mul)
        p.copy_(p2)
        m.copy_(m2)
        v.copy_(v2)
