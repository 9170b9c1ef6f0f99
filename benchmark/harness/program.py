"""The program's models as the benchmark builds them: constructed on the
device and given the weights the benchmark made from the seed
(``harness/weights.py``), the same the reference gets."""
from __future__ import annotations

import gc

import torch

from harness import weights
from reference import bi_encoder as ref_bi
from reference import cross_encoder as ref_cross

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _encoder_config(d: dict, project_dim: int = 0):
    from lightningdot_tpu_torch.config import EncoderConfig
    return EncoderConfig.from_dict(dict(d, project_dim=project_dim))


def _load(model, layout, config_std: float, seed: int, device):
    state = weights.make_state(layout, seed, device, config_std)
    model.load_state_dict(state, strict=True)
    del state
    return model


def bi_encoder(cfg: dict, dtype: str, seed: int, device):
    """``models/bi_encoder.py::BiEncoder`` of ``cfg``, computing in
    ``dtype`` (``f32`` or ``bf16``) over float32 weights, in eval mode."""
    from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
    pd = cfg["project_dim"]
    with torch.device(device):
        model = BiEncoder(_encoder_config(cfg["text"], pd),
                          _encoder_config(cfg["image"], pd),
                          compute_dtype=DTYPES[dtype])
    return _load(model, ref_bi.layout(cfg), cfg["text"]["initializer_range"],
                 seed, device)


def cross_encoder(cfg: dict, dtype: str, seed: int, device):
    """``models/cross_encoder.py::CrossEncoder`` of ``cfg``, in eval
    mode."""
    from lightningdot_tpu_torch.models.cross_encoder import CrossEncoder
    with torch.device(device):
        model = CrossEncoder(_encoder_config(cfg["model"]),
                             compute_dtype=DTYPES[dtype])
    return _load(model, ref_cross.layout(cfg),
                 cfg["model"]["initializer_range"], seed, device)


def release(device) -> None:
    """Give back the memory of what the caller dropped."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
