"""Activation functions (counterpart of lightningdot_tpu/ops/activations.py).

The reference uses the exact erf GELU everywhere
(uniter_model/model/layer.py:31-37).
"""
import torch


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU: x * 0.5 * (1 + erf(x / sqrt(2))), in x's dtype."""
    return x * 0.5 * (1.0 + torch.erf(x * (2 ** -0.5)))
