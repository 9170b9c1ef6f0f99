"""Model construction from run args (counterpart of
lightningdot_tpu/models/factory.py:23-153; the BiEncoder.__init__ logic of
dvl/models/bi_encoder.py:199-229 and load_biencoder_checkpoint, :737-752).

Named configs are the constants of :mod:`lightningdot_tpu_torch.config`;
anything else is a config JSON path (``configs/img_base.json``). Weights are
random from a seed, then overlaid with the reference's torch state dicts
(``.pt``) through :func:`~lightningdot_tpu_torch.models.weights.
load_tower_`, or loaded from a training driver's checkpoint, the port's
or the JAX package's (``training/checkpoints.py``).
:func:`load_cross_encoder` reads a cross-encoder teacher (factory.py:41-87).
"""
from __future__ import annotations

import os
from typing import Any, Mapping, Optional

import torch

from lightningdot_tpu_torch.config import (BERT_BASE_CASED, BERT_BASE_UNCASED,
                                           MOONLIGHT_16B_A3B, EncoderConfig,
                                           MoonlightConfig)
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
from lightningdot_tpu_torch.models.cross_encoder import (CrossEncoder,
                                                         init_cross_encoder_)
from lightningdot_tpu_torch.models.encoder import init_tower_
from lightningdot_tpu_torch.models.moonlight import (MoonlightTextEncoder,
                                                     init_moonlight_)
from lightningdot_tpu_torch.models.weights import (cross_encoder_keys,
                                                   load_torch_state_dict,
                                                   load_tower_, normalize_keys,
                                                   tower_keys)
from lightningdot_tpu_torch.utils.logging import LOGGER

_NAMED_CONFIGS = {
    "bert-base-cased": BERT_BASE_CASED,
    "bert-base-uncased": BERT_BASE_UNCASED,
    "bert-base": BERT_BASE_CASED,
}


def resolve_encoder_config(name_or_path: str, *, project_dim: int = 0,
                           dropout: Optional[float] = None) -> EncoderConfig:
    """HF-style name or a config JSON path -> EncoderConfig
    (factory.py:23-40)."""
    if name_or_path in _NAMED_CONFIGS:
        d = _NAMED_CONFIGS[name_or_path].to_dict()
    elif os.path.exists(name_or_path):
        d = EncoderConfig.from_json_file(name_or_path).to_dict()
    else:
        raise ValueError(f"unknown model config: {name_or_path!r}")
    d["project_dim"] = project_dim
    if dropout is not None:
        # init_encoder overrides both dropouts (bi_encoder.py:96-99)
        d["hidden_dropout_prob"] = dropout
        d["attention_probs_dropout_prob"] = dropout
    return EncoderConfig.from_dict(d)


def resolve_moonlight_config(name_or_path: str, *,
                             project_dim: int = 0) -> MoonlightConfig:
    """``moonlight-16b-a3b`` (the published config.json) or a JSON path
    holding its keys (``configs/moonlight_16b_a3b_card.json``: one card's
    cut) -> MoonlightConfig with the projection head's width."""
    if name_or_path == "moonlight-16b-a3b":
        d = MOONLIGHT_16B_A3B.to_dict()
    elif os.path.exists(name_or_path):
        d = MoonlightConfig.from_json_file(name_or_path).to_dict()
    else:
        raise ValueError(f"unknown decoder tower config: {name_or_path!r}")
    d["project_dim"] = project_dim
    return MoonlightConfig.from_dict(d)


def _overlay(tower: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    """Load a tower checkpoint over the tower's own weights, keeping what
    the checkpoint lacks (a fresh projection head when loading bert-base
    or uniter-base into a project_dim model, as the reference does;
    factory.py:130-149) and ignoring keys that are not the tower's (an MLM
    head), as ``map_tower`` does."""
    loaded = tower_keys(sd)
    own = tower.state_dict()
    load_tower_(tower, {k: loaded.get(k, v) for k, v in own.items()})


def _maybe(path):
    return path if path and str(path).lower() != "none" else None


def build_biencoder(args, *, seed: int = 0) -> BiEncoder:
    """Construct the model and load checkpoints per ``args``
    (factory.py:90-153). Random weights come from ``seed`` (the JAX
    package's ``model.init(PRNGKey(seed))``; the two draw different
    numbers). The model's weights are its own: there is no separate
    ``params``. It is returned on the CPU, in eval mode."""
    if args.img_model_type != "uniter-base":
        raise ValueError(
            f"image encoder does not support {args.img_model_type}")
    if args.txt_model_type not in ("bert-base", "uniter-base",
                                   "moonlight-16b-a3b"):
        raise ValueError(f"txt encoder does not support {args.txt_model_type}")

    project_dim = getattr(args, "project_dim", 0)
    decoder = args.txt_model_type == "moonlight-16b-a3b"
    if decoder:
        # the Moonlight tower (models/moonlight.py); its config names it
        txt_cfg = resolve_moonlight_config(args.txt_model_config,
                                           project_dim=project_dim)
    else:
        txt_cfg = resolve_encoder_config(args.txt_model_config,
                                         project_dim=project_dim)
    img_cfg = resolve_encoder_config(args.img_model_config,
                                     project_dim=project_dim)
    dtype = (torch.bfloat16 if getattr(args, "compute_dtype", "bf16") == "bf16"
             else torch.float32)
    model = BiEncoder(
        txt_cfg, img_cfg, compute_dtype=dtype,
        fix_txt_encoder=getattr(args, "fix_txt_encoder", False),
        fix_img_encoder=getattr(args, "fix_img_encoder", False))
    gen = torch.Generator().manual_seed(seed)
    if isinstance(model.txt_model, MoonlightTextEncoder):
        init_moonlight_(model.txt_model, gen)
    else:
        init_tower_(model.txt_model, gen)
    init_tower_(model.img_model, gen)

    txt_ckpt = _maybe(getattr(args, "txt_checkpoint", None))
    if txt_ckpt and decoder:
        raise ValueError("--txt_checkpoint takes BERT tower state dicts; "
                         "the Moonlight tower loads through "
                         "--biencoder_checkpoint")
    if txt_ckpt:
        _overlay(model.txt_model, load_torch_state_dict(txt_ckpt))
    img_ckpt = _maybe(getattr(args, "img_checkpoint", None))
    if img_ckpt:
        _overlay(model.img_model, load_torch_state_dict(img_ckpt))

    bi_ckpt = _maybe(getattr(args, "biencoder_checkpoint", None))
    if bi_ckpt and bi_ckpt.endswith(".pt"):
        sd = normalize_keys(load_torch_state_dict(bi_ckpt))
        LOGGER.info("loaded %d tensors from %s", len(sd), bi_ckpt)
        for name, tower in (("txt_model", model.txt_model),
                            ("img_model", model.img_model)):
            prefix = name + "."
            part = {k[len(prefix):]: v for k, v in sd.items()
                    if k.startswith(prefix)}
            if not part:
                raise ValueError(f"{bi_ckpt}: no {prefix}* weights")
            load_tower_(tower, part)
    elif bi_ckpt:
        # a training driver's checkpoint: the port's <path>.pt or the JAX
        # package's <path>.npz, each beside <path>.json
        from lightningdot_tpu_torch.training.checkpoints import (
            load_state_dict_strict, read_checkpoint)

        if not os.path.exists(bi_ckpt + ".json"):
            raise ValueError(
                f"{bi_ckpt}: no checkpoint there; the port reads the "
                f"reference's torch state dicts (.pt) and the training "
                f"drivers' checkpoints (<path>.json beside the port's "
                f"<path>.pt or the JAX package's <path>.npz)")
        sd, _, meta = read_checkpoint(bi_ckpt)
        load_state_dict_strict(model, sd)
        LOGGER.info("loaded %s (step %s)", bi_ckpt, meta.get("step"))
    return model.eval()



def load_cross_encoder_weights_(model: torch.nn.Module,
                                sd: Mapping[str, Any]) -> None:
    """Load a teacher or UNITER state dict into a cross-encoder through
    :func:`~lightningdot_tpu_torch.models.weights.cross_encoder_keys`:
    every tower parameter must be there and no unknown key may be; heads
    the file lacks keep the model's own (``init.update(params)``,
    factory.py:75-77)."""
    from lightningdot_tpu_torch.training.checkpoints import (
        load_state_dict_strict)

    loaded = cross_encoder_keys(sd)
    own = model.state_dict()
    heads = ("itm_output.", "rank_output.")
    missing = sorted(k for k in own if k not in loaded
                     and not k.startswith(heads))
    if missing:
        raise KeyError(f"cross-encoder checkpoint lacks {len(missing)} "
                       f"parameters: {missing[:5]}")
    load_state_dict_strict(model, {k: loaded.get(k, v)
                                   for k, v in own.items()} | {
        k: v for k, v in loaded.items() if k not in own})


def load_cross_encoder(checkpoint: str, *, model_config: Optional[str] = None,
                       margin: float = 0.2,
                       compute_dtype: torch.dtype = torch.float32,
                       device=None) -> CrossEncoder:
    """A :class:`CrossEncoder` from a teacher directory (``config.json`` +
    ``model.pt``, or the JAX package's ``model.npz`` + ``model.json``) or a
    bare ``.pt`` with ``model_config`` (``load_cross_encoder``,
    factory.py:41-87). ``rank_output`` is seeded from the itm head only
    where the file has none. The model is returned on ``device`` (None:
    the card, raising where there is none) in eval mode."""
    device = resolve_device(device)
    if os.path.isdir(checkpoint):
        cfg_path = os.path.join(checkpoint, "config.json")
        if not os.path.exists(cfg_path):
            cfg_path = model_config
        pt = os.path.join(checkpoint, "model.pt")
        ckpt_path = pt if os.path.exists(pt) else os.path.join(checkpoint,
                                                               "model")
    else:
        cfg_path, ckpt_path = model_config, checkpoint
    if cfg_path is None:
        raise ValueError("cross-encoder config not found; pass model_config")
    model = CrossEncoder(resolve_encoder_config(cfg_path), margin=margin,
                         compute_dtype=compute_dtype)
    init_cross_encoder_(model, torch.Generator().manual_seed(0))
    if ckpt_path.endswith(".pt"):
        load_cross_encoder_weights_(model, load_torch_state_dict(ckpt_path))
    else:
        from lightningdot_tpu_torch.training.checkpoints import (
            load_state_dict_strict, read_checkpoint)

        sd, _, _ = read_checkpoint(ckpt_path)
        load_state_dict_strict(model, sd)
    LOGGER.info("loaded cross-encoder %s", checkpoint)
    return model.to(device).eval()
