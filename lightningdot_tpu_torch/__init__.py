"""lightningdot_tpu_torch: the PyTorch/CUDA port of lightningdot_tpu.

The JAX package (``lightningdot_tpu``) is the reference; this package runs
the same models on an NVIDIA H100 through hand-written CUDA kernels, each
with a plain PyTorch twin that the CPU takes. It imports torch and nothing
of ``jax`` or ``lightningdot_tpu``: what it needs of the JAX package's
JAX-free modules (the config, the data readers and loaders, the tokenizer,
the metrics, the HNSW index, the serving front ends) it keeps as its own
copies, each naming its counterpart. Its entry points run on the card unless the
caller passes ``device="cpu"``.

Importing the package imports ``ops/matmul.py``, which sets how the
process's products sum (float32 in true float32, bfloat16 summed in float32
and rounded once); the exports below are lazy.
"""
import importlib

from lightningdot_tpu_torch.ops import matmul  # noqa: F401  (the product rule)

_EXPORTS = {
    "BiEncoder": "lightningdot_tpu_torch.models.bi_encoder",
    "TextEncoder": "lightningdot_tpu_torch.models.encoder",
    "ImageEncoder": "lightningdot_tpu_torch.models.encoder",
    "QuantizedTextEncoder": "lightningdot_tpu_torch.models.quantized",
    "BatchEncoder": "lightningdot_tpu_torch.training.evaluator",
    "FusedAdamW": "lightningdot_tpu_torch.training.optim",
    "make_itm_train_step": "lightningdot_tpu_torch.training.itm_step",
    "Retriever": "lightningdot_tpu_torch.serving",
    "BatchingFrontend": "lightningdot_tpu_torch.serving_frontend",
    "RetrievalServer": "lightningdot_tpu_torch.serving_http",
    "DenseFlatIndex": "lightningdot_tpu_torch.index",
    "get_model_encoded_vecs": "lightningdot_tpu_torch.serving",
    "ranking_equivalent": "lightningdot_tpu_torch.serving",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
