"""Carry weights into the port (numpy only; counterpart of the loading and
export parts of lightningdot_tpu/models/checkpoint_torch.py).

:func:`tower_state_dict_from_jax` turns a JAX tower pytree (numpy or array
leaves, layers stacked on axis 0) into the port's state dict, as
``checkpoint_torch.export_tower`` does; :func:`biencoder_state_dict_from_jax`
and :func:`pretrain_state_dict_from_jax` do so for a whole bi-encoder and
for ``BiEncoderForPretraining`` with its heads (``export_bi_encoder``, and
the inverse of ``map_pretrain_model``, checkpoint_torch.py:271), and
:func:`unflatten_jax` rebuilds a JAX tree from the flattened keys of the JAX
package's ``.npz`` checkpoints (``training/checkpoints.py::flatten_tree``).
:func:`load_torch_state_dict` and :func:`normalize_keys` read the
reference's released ``.pt`` files; :func:`pretrain_keys` puts a
reference pre-training state dict under the port's names.

The cross-encoders: :func:`cross_encoder_state_dict_from_jax`,
:func:`cross_encoder_fast_state_dict_from_jax` and
:func:`uniter_pretrain_state_dict_from_jax` are the inverses of
``map_cross_encoder``, ``map_cross_encoder_fast`` and the one-tower
teacher's load (checkpoint_torch.py:318-362, cli/pretrain.py:298-305);
:func:`cross_encoder_keys` filters a teacher or ``uniter-base.pt`` state
dict to the joint model's names and seeds ``rank_output`` from the itm
head where the file has none (``_rank_head``).

VQA: :func:`vqa_state_dict_from_jax` turns the JAX ``BiEncoderForVQA``
tree ({biencoder, vqa_output/{fc1, ln, fc2}}) into the port's names
(``biencoder.*`` and the reference's ``vqa_output.{0,2,3}``).
"""
from __future__ import annotations

import logging
import pickle
from typing import Any, Dict, Mapping

import numpy as np
import torch

logger = logging.getLogger(__name__)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Read a .pt file into a flat {key: float32 np.ndarray} dict; a
    fine-tune ``CheckpointState`` is unwrapped from ``model_dict``."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # older artifacts pickle argparse Namespaces beside the tensors:
        # full unpickling runs pickle code, so only for files you trust
        logger.warning("%s is not loadable with weights_only=True; "
                       "falling back to full unpickling", path)
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "model_dict" in sd:
        sd = sd["model_dict"]
    return {k: v.float().numpy() for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def normalize_keys(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Strip the ``module.`` wrapper prefix and rename gamma/beta to
    weight/bias."""
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        k = k.replace(".gamma", ".weight").replace(".beta", ".bias")
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().float().numpy()
        out[k] = np.asarray(v)
    return out


def _lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.asarray(p["scale"])
    sd[f"{prefix}.bias"] = np.asarray(p["bias"])


def tower_state_dict_from_jax(tree: Mapping[str, Any]
                              ) -> Dict[str, np.ndarray]:
    """JAX tower pytree -> the port's state dict (torch layout: linear
    weights [out, in]). Mirrors ``checkpoint_torch.export_tower``: a tree
    with ``img_embeddings`` is an image tower (``with_img=True``)."""
    sd: Dict[str, np.ndarray] = {}
    emb = tree["embeddings"]
    sd["bert.embeddings.word_embeddings.weight"] = np.asarray(emb["word"])
    sd["bert.embeddings.position_embeddings.weight"] = np.asarray(
        emb["position"])
    sd["bert.embeddings.token_type_embeddings.weight"] = np.asarray(
        emb["token_type"])
    _ln(sd, "bert.embeddings.LayerNorm", emb["ln"])

    layers = tree["layers"]
    attn, mlp = layers["attn"], layers["mlp"]
    num_layers = np.asarray(attn["query"]["kernel"]).shape[0]

    def at(p, i):
        return {k: np.asarray(v)[i] for k, v in p.items()}

    for i in range(num_layers):
        p = f"bert.encoder.layer.{i}"
        _lin(sd, f"{p}.attention.self.query", at(attn["query"], i))
        _lin(sd, f"{p}.attention.self.key", at(attn["key"], i))
        _lin(sd, f"{p}.attention.self.value", at(attn["value"], i))
        _lin(sd, f"{p}.attention.output.dense", at(attn["output"], i))
        _ln(sd, f"{p}.attention.output.LayerNorm", at(attn["ln"], i))
        _lin(sd, f"{p}.intermediate.dense", at(mlp["intermediate"], i))
        _lin(sd, f"{p}.output.dense", at(mlp["output"], i))
        _ln(sd, f"{p}.output.LayerNorm", at(mlp["ln"], i))

    if "pooler" in tree:
        _lin(sd, "bert.pooler.dense", tree["pooler"])
    if "img_embeddings" in tree:
        ie, p = tree["img_embeddings"], "bert.img_embeddings"
        _lin(sd, f"{p}.img_linear", ie["img_linear"])
        _ln(sd, f"{p}.img_layer_norm", ie["img_ln"])
        _lin(sd, f"{p}.pos_linear", ie["pos_linear"])
        _ln(sd, f"{p}.pos_layer_norm", ie["pos_ln"])
        sd[f"{p}.mask_embedding.weight"] = np.asarray(ie["mask_embedding"])
        _ln(sd, f"{p}.LayerNorm", ie["ln"])
    if "proj" in tree:
        _lin(sd, "encode_proj.0", tree["proj"]["fc1"])
        _ln(sd, "encode_proj.2", tree["proj"]["ln"])
        _lin(sd, "encode_proj.3", tree["proj"]["fc2"])
    return sd


def load_tower_(tower: torch.nn.Module, sd: Mapping[str, Any]) -> None:
    """Copy a tower state dict (numpy or tensors, reference key names) into
    the port's :class:`~lightningdot_tpu_torch.models.encoder.TextEncoder`
    or :class:`~lightningdot_tpu_torch.models.encoder.ImageEncoder`,
    strictly: a missing or unexpected key raises. The index buffers that HF
    ``BertModel`` serializes (``*.position_ids``) are dropped."""
    tower.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in tower_keys(sd).items()})


def tower_keys(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A tower state dict under the port's key names, as
    :func:`load_tower_` reads it: :func:`normalize_keys`, the serialized
    index buffers dropped, and ``bert.`` put in front of a bare
    ``BertModel``'s keys."""
    sd = {k: v for k, v in normalize_keys(sd).items()
          if not k.endswith((".position_ids", ".token_type_ids"))}
    if not any(k.startswith("bert.") for k in sd):
        sd = {f"bert.{k}": v for k, v in sd.items()
              if not k.startswith("encode_proj.")} | {
            k: v for k, v in sd.items() if k.startswith("encode_proj.")}
    return sd


def unflatten_jax(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """{"txt_model/layers/attn/query/kernel": array, ...} -> nested dicts
    (the inverse of the JAX package's ``flatten_tree`` over dict trees)."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split(sep)
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return tree


def biencoder_state_dict_from_jax(tree: Mapping[str, Any]
                                  ) -> Dict[str, np.ndarray]:
    """JAX ``BiEncoder`` params {txt_model, img_model} -> the port's
    ``BiEncoder`` state dict (``txt_model.*``/``img_model.*``), as
    ``checkpoint_torch.export_bi_encoder`` writes it."""
    return {f"{name}.{k}": v for name in ("txt_model", "img_model")
            for k, v in tower_state_dict_from_jax(tree[name]).items()}


def pretrain_state_dict_from_jax(tree: Mapping[str, Any]
                                 ) -> Dict[str, np.ndarray]:
    """JAX ``BiEncoderForPretraining`` params {bert, heads} -> the port's
    state dict: ``bert.txt_model.*``, ``bert.img_model.*`` and the heads
    under the reference's names (``cls.predictions.*``,
    ``feat_regress.*``, ``region_classifier.*``, ``itm_output.*``). The
    tied weights (the MLM decoder, the feature regression's weight) are
    the towers' own and appear once."""
    sd = {f"bert.{k}": v
          for k, v in biencoder_state_dict_from_jax(tree["bert"]).items()}
    sd.update(_pretrain_heads_from_jax(tree["heads"]))
    return sd


def _pretrain_heads_from_jax(heads: Mapping[str, Any]
                             ) -> Dict[str, np.ndarray]:
    """The pre-training heads of a JAX tree under the reference's names."""
    sd: Dict[str, np.ndarray] = {}
    if "mlm" in heads:
        mlm = heads["mlm"]
        _lin(sd, "cls.predictions.transform.dense", mlm["transform"]["dense"])
        _ln(sd, "cls.predictions.transform.LayerNorm", mlm["transform"]["ln"])
        sd["cls.predictions.bias"] = np.asarray(mlm["bias"])
    if "feat_regress" in heads:
        fr = heads["feat_regress"]
        _lin(sd, "feat_regress.net.0", fr["dense"])
        _ln(sd, "feat_regress.net.2", fr["ln"])
        sd["feat_regress.bias"] = np.asarray(fr["bias"])
    if "region_classifier" in heads:
        rc = heads["region_classifier"]
        _lin(sd, "region_classifier.net.0", rc["dense"])
        _ln(sd, "region_classifier.net.2", rc["ln"])
        _lin(sd, "region_classifier.net.3", rc["out"])
    if "itm_output" in heads:
        _lin(sd, "itm_output", heads["itm_output"])
    return sd


# keys of a reference pre-training state dict that no port module holds:
# the tied duplicates (the MLM decoder is the image tower's word table,
# layer.py:212-215; feat_regress.weight is img_linear's, model.py:390-397),
# BERT's NSP head, and the mrm-nce heads of the reference's dead branch
# (checkpoint_torch.py:41-59, map_pretrain_model's skip list)
_PRETRAIN_SKIP_EXACT = ("cls.predictions.decoder.weight",
                        "feat_regress.weight")
_PRETRAIN_SKIP_PREFIXES = ("cls.seq_relationship.", "nce_output.",
                           "nce_norm.")


def pretrain_keys(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A reference ``BiEncoderForPretraining`` state dict under the port's
    names: :func:`normalize_keys`, the serialized index buffers, the tied
    duplicates and the heads no port module holds dropped (the skip list
    of ``map_pretrain_model``)."""
    return {k: v for k, v in normalize_keys(sd).items()
            if k not in _PRETRAIN_SKIP_EXACT
            and not k.startswith(_PRETRAIN_SKIP_PREFIXES)
            and not k.endswith((".position_ids", ".token_type_ids"))}


def _heads(sd: Dict[str, np.ndarray], tree: Mapping[str, Any]) -> None:
    for head in ("itm_output", "rank_output"):
        if head in tree:
            _lin(sd, head, tree[head])


def cross_encoder_state_dict_from_jax(tree: Mapping[str, Any]
                                      ) -> Dict[str, np.ndarray]:
    """JAX ``CrossEncoder`` params {uniter, itm_output, rank_output} -> the
    port's state dict (``bert.*``, ``itm_output.*``, ``rank_output.*``),
    as ``checkpoint_torch.export_cross_encoder`` writes it."""
    sd = tower_state_dict_from_jax(tree["uniter"])
    _heads(sd, tree)
    return sd


def cross_encoder_fast_state_dict_from_jax(tree: Mapping[str, Any]
                                           ) -> Dict[str, np.ndarray]:
    """JAX ``CrossEncoderFast`` params {bert, img_bert, itm_output,
    rank_output} -> ``bert.*``, ``img_bert.*`` and the heads (the inverse
    of ``map_cross_encoder_fast``)."""
    sd = tower_state_dict_from_jax(tree["bert"])
    for k, v in tower_state_dict_from_jax(tree["img_bert"]).items():
        sd["img_bert." + k[len("bert."):]] = v
    _heads(sd, tree)
    return sd


def uniter_pretrain_state_dict_from_jax(tree: Mapping[str, Any]
                                        ) -> Dict[str, np.ndarray]:
    """JAX ``UniterForPretraining`` params {uniter, heads} -> ``bert.*``
    and the pre-training heads under the reference's names."""
    sd = tower_state_dict_from_jax(tree["uniter"])
    sd.update(_pretrain_heads_from_jax(tree["heads"]))
    return sd


# the pre-training heads and the tied duplicates that ride along in a
# ``uniter-base.pt`` warm start and that the cross-encoder does not hold
# (checkpoint_torch.py:41-59, the skip lists of map_tower)
_UNITER_HEAD_PREFIXES = ("cls.", "feat_regress.", "region_classifier.",
                         "nce_output.", "nce_norm.")


def cross_encoder_keys(sd: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """A teacher or UNITER state dict under the joint cross-encoder's names
    (``map_cross_encoder``, checkpoint_torch.py:336-345): normalized, the
    serialized index buffers and the pre-training heads dropped, ``bert.``
    put in front of a bare UniterModel's keys, and ``rank_output`` seeded
    from ``itm_output``'s row 1 only where the file has no rank head
    (``_rank_head``, :318-329). The Fast teacher's ``img_bert.*`` pass
    through."""
    sd = {k: v for k, v in normalize_keys(sd).items()
          if not k.endswith((".position_ids", ".token_type_ids"))
          and not k.startswith(_UNITER_HEAD_PREFIXES)
          and not k.startswith(tuple("bert." + p
                                     for p in _UNITER_HEAD_PREFIXES))}
    own = ("bert.", "img_bert.", "itm_output.", "rank_output.")
    if not any(k.startswith("bert.") for k in sd):
        sd = {(k if k.startswith(own) else f"bert.{k}"): v
              for k, v in sd.items()}
    if "rank_output.weight" not in sd and "itm_output.weight" in sd:
        sd["rank_output.weight"] = np.array(sd["itm_output.weight"][1:2])
        sd["rank_output.bias"] = np.array(sd["itm_output.bias"][1:2])
    return sd


def vqa_state_dict_from_jax(tree: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """JAX ``BiEncoderForVQA`` params {biencoder, vqa_output} -> the port's
    ``BiEncoderForVQA`` state dict: ``biencoder.txt_model.*``,
    ``biencoder.img_model.*``, and the head under the reference's
    ``nn.Sequential`` indices (fc1 ``vqa_output.0``, the LayerNorm
    ``vqa_output.2``, fc2 ``vqa_output.3``; bi_encoder.py:683-734)."""
    sd = {f"biencoder.{k}": v for k, v in
          biencoder_state_dict_from_jax(tree["biencoder"]).items()}
    head = tree["vqa_output"]
    _lin(sd, "vqa_output.0", head["fc1"])
    _ln(sd, "vqa_output.2", head["ln"])
    _lin(sd, "vqa_output.3", head["fc2"])
    return sd

