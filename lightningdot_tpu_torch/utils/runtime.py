"""Process-level runtime set-up shared by the drivers (counterpart of
lightningdot_tpu/utils/runtime.py).

The JAX ``setup_runtime`` turns on XLA's persistent compile cache and picks
the kernel backend; the port's kernels are built once per checkout
(``ops/_build.py``) and chosen by the tensors' device, and importing the
package sets the product precision (``ops/matmul.py``), so here it seeds
the host's generators. ``dropout_key`` becomes :func:`step_generator`: a
CPU ``torch.Generator`` per global step, derived from the run's seed, as
the JAX driver folds the step into its key (``jax.random.fold_in(rng,
global_step)``, cli/train_itm.py:250), so a repeated or resumed run draws
the same dropout masks at the same step.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def setup_runtime(args=None) -> None:
    """Seed Python's, NumPy's and torch's global generators with
    ``args.seed``."""
    if args is None:
        return
    seed = getattr(args, "seed", None)
    if seed is not None:
        random.seed(seed)
        np.random.seed(seed)
        torch.manual_seed(seed)


def step_generator(seed: int, global_step: int,
                   rank: int = 0) -> torch.Generator:
    """The CPU generator that seeds the dropout masks of one training step:
    a function of (seed, global_step) only, and of ``rank`` across
    processes, so that every rank draws its own masks (the attention's
    Philox masks, keyed on the generator's seed, included); rank 0 draws
    what one process draws."""
    entropy = [int(seed) & 0xFFFFFFFF, int(global_step)]
    if rank:
        entropy.append(int(rank))
    state = np.random.SeedSequence(entropy).generate_state(2)
    return torch.Generator().manual_seed(
        int(state[0]) << 31 | int(state[1]) >> 1)
