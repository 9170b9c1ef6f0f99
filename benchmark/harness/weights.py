"""Random weights from a run's seed, made on the device in one draw.

The benchmark makes the weights and hands the same to the program and to
the plain reference. The layout (names and shapes, the reference
checkpoints' state-dict keys) comes from the reference; the rule is the
JAX package's and the port's initialisation: every matrix and embedding
table normal(0, initializer_range), the padding id's word vector zero,
biases zero, LayerNorm scales one. Every matrix comes from one
``torch.randn`` over their total size on the device, so one seed gives the
same bits every time it is made.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

Layout = List[Tuple[str, Tuple[int, ...]]]


def _is_matrix(name: str, shape) -> bool:
    return name.endswith("weight") and len(shape) == 2


def make_state(layout: Layout, seed: int, device, std: float
               ) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for ``layout``."""
    device = torch.device(device)
    wseed = int(np.random.SeedSequence([int(seed), 1]).generate_state(
        1, np.uint64)[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(wseed)
    total = sum(math.prod(s) for n, s in layout if _is_matrix(n, s))
    flat = torch.randn(total, generator=gen, device=device)
    flat.mul_(std)
    state, at = {}, 0
    for name, shape in layout:
        if _is_matrix(name, shape):
            n = math.prod(shape)
            state[name] = flat[at:at + n].view(shape)
            at += n
        elif name.endswith("bias"):
            state[name] = torch.zeros(shape, device=device)
        else:
            state[name] = torch.ones(shape, device=device)
        if name.endswith("word_embeddings.weight"):
            state[name][0].zero_()
    return state
