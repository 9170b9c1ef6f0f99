"""Where the port's entry points run: the card unless the caller asks for
another device."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` means ``cuda``, and raises where no CUDA device is present;
    anything else (``"cpu"``, as the tests pass) is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card by default; pass "
                "device='cpu' to run its plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
