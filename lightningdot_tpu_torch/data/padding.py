"""Padding to a fixed ladder of lengths (the port's copy of
lightningdot_tpu/data/padding.py:142-204).

Batches are padded up a bucket ladder (:mod:`lightningdot_tpu_torch.const`)
instead of to each batch's own maximum (dvl/data/itm.py:231-252): padding
is fully masked, so the math is the same, and a run meets a bounded set of
shapes. The JAX module's buffer pool is not carried over.
"""
from __future__ import annotations

import logging
from typing import List, Sequence

import numpy as np

logger = logging.getLogger(__name__)
_CLAMP_WARNED: set = set()


def bucket_len(n: int, buckets: Sequence[int]) -> int:
    """The first bucket >= n; above the top bucket, the top bucket (the
    padders then truncate), with one warning per ladder."""
    for b in buckets:
        if n <= b:
            return b
    key = tuple(buckets)
    if key not in _CLAMP_WARNED:
        _CLAMP_WARNED.add(key)
        logger.warning(
            "sequence length %d exceeds the top bucket %d and will be "
            "truncated (ladder %s); raise the ladder or pre-truncate "
            "upstream if this is corpus data", n, buckets[-1], buckets)
    return buckets[-1]


def pad_ids(seqs: List[Sequence[int]], length: int, pad: int = 0
            ) -> np.ndarray:
    out = np.full((len(seqs), length), pad, np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), length)
        out[i, :n] = np.asarray(s[:n], np.int32)
    return out


def pad_mask(lens: Sequence[int], length: int) -> np.ndarray:
    out = np.zeros((len(lens), length), np.int32)
    for i, n in enumerate(lens):
        out[i, :min(n, length)] = 1
    return out


def pad_feats(feats: List[np.ndarray], length: int,
              dtype=None) -> np.ndarray:
    """B x [T_i, D] -> [B, length, D] zero-padded (data.py:270-283). Keeps
    the source dtype when it is uniform (float16 region features stay
    float16; the model casts on the device); mixed dtypes promote to
    float32; ``dtype`` forces one."""
    d = feats[0].shape[-1]
    if dtype is None:
        dtype = feats[0].dtype
        if any(f.dtype != dtype for f in feats):
            dtype = np.float32
    out = np.zeros((len(feats), length, d), dtype)
    for i, f in enumerate(feats):
        n = min(f.shape[0], length)
        out[i, :n] = f[:n]
    return out


def position_ids(batch: int, length: int) -> np.ndarray:
    return np.broadcast_to(np.arange(length, dtype=np.int32),
                           (batch, length)).copy()
