"""Model and process utilities (the port's counterpart of
lightningdot_tpu/utils/misc.py; reference dvl/utils.py:26-111,172-189)."""
from __future__ import annotations

import hashlib
from typing import Any, List, Mapping

import numpy as np
import torch
import torch.distributed as dist

from lightningdot_tpu_torch.parallel.mesh import in_group


def num_of_parameters(model: torch.nn.Module) -> int:
    """Total parameter count of a model (dvl/utils.py:34-38)."""
    return sum(p.numel() for p in model.parameters())


def compare_models(state_1: Mapping[str, Any], state_2: Mapping[str, Any],
                   verbose: bool = True) -> int:
    """Count mismatching entries between two state dicts
    (dvl/utils.py:172-184); raises where their names differ."""
    if list(state_1) != list(state_2):
        raise ValueError(f"state dicts differ in structure: "
                         f"{sorted(set(state_1) ^ set(state_2))[:5]}")
    models_differ = 0
    for name in state_1:
        a, b = (np.asarray(torch.as_tensor(s[name]).detach().cpu())
                for s in (state_1, state_2))
        if not np.array_equal(a, b):
            models_differ += 1
            if verbose:
                print("Mismatch found at", name)
    if models_differ == 0 and verbose:
        print("Models match perfectly! :)")
    return models_differ


def host_all_gather(data: Any) -> List[Any]:
    """Every process's ``data`` (any picklable object), in rank order
    (replaces the pickle-based ``all_gather_list``, dvl/utils.py:51-111);
    one process gets ``[data]``."""
    if not in_group():
        return [data]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, data)
    return out


def state_digest(model: torch.nn.Module) -> str:
    """Order-stable sha256 over a model's state dict, names and bytes: the
    value that ranks compare to hold the same weights."""
    h = hashlib.sha256()
    for name, t in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()
