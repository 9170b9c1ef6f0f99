"""Activation functions (counterpart of lightningdot_tpu/ops/activations.py).

The reference uses the exact erf GELU everywhere
(uniter_model/model/layer.py:31-37).
"""
import torch

SQRT_HALF = 2 ** -0.5


def weak_const(c: float, dtype: torch.dtype) -> float:
    """A Python constant as JAX multiplies it into an array of ``dtype``:
    weak typing rounds it to that dtype first (``x * 2**-0.5`` on a bf16
    array multiplies by 0.70703125). torch keeps a Python scalar in float32
    inside a bf16 op, so the port passes the rounded value."""
    return float(torch.tensor(c, dtype=dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU: x * 0.5 * (1 + erf(x / sqrt(2))), in x's dtype."""
    return x * 0.5 * (1.0 + torch.erf(x * weak_const(SQRT_HALF, x.dtype)))
