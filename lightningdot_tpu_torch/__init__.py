"""lightningdot_tpu_torch: the PyTorch/CUDA port of lightningdot_tpu.

The JAX package (``lightningdot_tpu``) is the reference; this package runs
the same models on an NVIDIA H100 through hand-written CUDA kernels, each
with a plain PyTorch twin that the CPU takes. It imports torch and never
jax; it reuses the JAX-free modules of ``lightningdot_tpu`` (config,
tokenizer, padding, the serving frontends).

Exports are lazy, so importing the package loads nothing heavy.
"""
import importlib

_EXPORTS = {
    "BiEncoder": "lightningdot_tpu_torch.models.bi_encoder",
    "TextEncoder": "lightningdot_tpu_torch.models.encoder",
    "ImageEncoder": "lightningdot_tpu_torch.models.encoder",
    "QuantizedTextEncoder": "lightningdot_tpu_torch.models.quantized",
    "BatchEncoder": "lightningdot_tpu_torch.training.evaluator",
    "Retriever": "lightningdot_tpu_torch.serving",
    "get_model_encoded_vecs": "lightningdot_tpu_torch.serving",
    "ranking_equivalent": "lightningdot_tpu_torch.serving",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
