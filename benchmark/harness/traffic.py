"""The one traffic generator: every traffic file's parameters are read here.

A traffic file (``benchmark/traffic/<name>.json``) gives the sizes of what
users send as distributions, and the pools that hold them. Sizes are drawn
on a fixed grid of quantiles, so that every seed gives the same multiset of
caption lengths and region counts, and the seed decides only their order
and the contents (token ids, region features, boxes). A seed thus changes
which batches meet which sizes, not the work a run holds.

Region features are float16 on the host, as the feature DBs hold them,
nonnegative as a detector's pooled features are; their normal draws are
made on the run's device and copied to the host.
"""
from __future__ import annotations

from statistics import NormalDist
from typing import List, Sequence, Tuple

import numpy as np

CLS_ID, SEP_ID = 101, 102   # BERT cased: [CLS], [SEP]
CHUNK = 256                 # images drawn at once


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for one stream of a run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed),
                                                         *stream]))


def grid(spec: dict, n: int) -> np.ndarray:
    """int64 [n]: the distribution ``spec`` at the quantiles (i + 1/2) / n.

    ``{"dist": "uniform_int", "min", "max"}``: integers min..max alike;
    ``{"dist": "lognormal_int", "median", "sigma", "min", "max"}``: the
    rounded lognormal, clipped to [min, max]."""
    u = (np.arange(n) + 0.5) / n
    kind = spec["dist"]
    if kind == "uniform_int":
        lo, hi = int(spec["min"]), int(spec["max"])
        return lo + np.minimum((u * (hi - lo + 1)).astype(np.int64), hi - lo)
    if kind == "lognormal_int":
        z = np.array([NormalDist().inv_cdf(x) for x in u])
        v = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
        return np.clip(v, spec["min"], spec["max"]).astype(np.int64)
    raise ValueError(f"unknown distribution {kind!r}")


def sizes(spec: dict, n: int, gen: np.random.Generator) -> np.ndarray:
    """The grid of ``spec`` in the order of ``gen``."""
    return gen.permutation(grid(spec, n))


def captions(lengths: Sequence[int], vocab: int,
             gen: np.random.Generator) -> List[np.ndarray]:
    """Token id arrays [CLS] ... [SEP] of the given lengths (both counted),
    the ids between drawn uniformly above the special ids."""
    low = min(999, vocab // 2)
    body = gen.integers(low, vocab, int(sum(lengths)), dtype=np.int32)
    out, at = [], 0
    for n in lengths:
        ids = np.empty(int(n), np.int32)
        ids[0], ids[-1] = CLS_ID, SEP_ID
        ids[1:-1] = body[at:at + n - 2]
        at += n
        out.append(ids)
    return out


def regions(counts: Sequence[int], img_dim: int, gen: np.random.Generator,
            image_share: float = 0.0, device="cpu"
            ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(features [n, img_dim] float16, boxes [n, 7] float16) per image, as
    views of two host blocks. A region's features are |image_share x its
    image's draw + (1 - image_share) x its own draw|, so that the regions
    of one image share a part, as a detector's regions of one scene do.
    The normal draws are made on ``device`` by a generator seeded from
    ``gen``, a few large calls, and copied to the host."""
    import torch
    tgen = torch.Generator(device=device)
    tgen.manual_seed(int(gen.integers(0, 2 ** 63 - 1)))
    counts = np.asarray(counts, np.int64)
    ends = np.cumsum(counts)
    feats = np.empty((int(ends[-1]), img_dim), np.float16)
    for lo in range(0, len(counts), CHUNK):
        part = torch.as_tensor(counts[lo:lo + CHUNK], device=device)
        a, b = int(ends[lo] - counts[lo]), int(ends[lo + len(part) - 1])
        own = torch.randn((b - a, img_dim), generator=tgen, device=device)
        own.mul_(1.0 - image_share)
        shared = torch.randn((len(part), img_dim), generator=tgen,
                             device=device)
        own.add_(shared.mul_(image_share).repeat_interleave(part, dim=0))
        feats[a:b] = own.abs_().to(torch.float16).cpu().numpy()
    total = feats.shape[0]
    x1y1 = gen.uniform(0.0, 0.9, (total, 2))
    wh = gen.uniform(0.05, 1.0, (total, 2)) * (1.0 - x1y1)
    boxes = np.concatenate([x1y1, x1y1 + wh, wh, wh[:, :1] * wh[:, 1:]],
                           axis=1).astype(np.float16)
    out, at = [], 0
    for n in counts:
        out.append((feats[at:at + n], boxes[at:at + n]))
        at += n
    return out


def bucket(n: int, ladder: Sequence[int]) -> int:
    """The first length of ``ladder`` that holds ``n`` (the top one if
    none does)."""
    for b in ladder:
        if n <= b:
            return int(b)
    return int(ladder[-1])


def first_of_each_bucket(items: Sequence, ladder: Sequence[int]) -> dict:
    """{padded length: the index of the first item of ``items`` (sequences)
    that pads to it on ``ladder``}: one item for each shape a mix can
    give, for the warm-up."""
    out = {}
    for i, item in enumerate(items):
        out.setdefault(bucket(len(item), ladder), i)
    return out
