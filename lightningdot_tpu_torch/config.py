"""The transformer architecture configuration (the port's copy of
``EncoderConfig``, lightningdot_tpu/config.py:24-70).

It accepts the same JSON schema as the reference's ``config/img_base.json``
and ``config/bert_base.json`` and HF bert configs (UniterConfig,
uniter_model/model/model.py:23-115). The CLI option groups of the JAX
module come with the command-line programs that use them.
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class EncoderConfig:
    """Transformer architecture hyper-parameters (UniterConfig-compatible)."""

    vocab_size: int = 28996
    hidden_size: int = 768
    num_hidden_layers: int = 12
    # image-stream depth of the two-stream 'Fast' cross-encoder
    # (UniterConfig num_hidden_layers_img, uniter_model/model/model.py:30)
    num_hidden_layers_img: int = 1
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    # image-region front end (the image tower only)
    img_dim: int = 2048
    pos_dim: int = 7
    # projection head output dim; 0 disables the head
    # (dvl/models/bi_encoder.py:82-90)
    project_dim: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "EncoderConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json_file(cls, path: str) -> "EncoderConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def head_dim(self) -> int:
        if self.hidden_size % self.num_attention_heads:
            raise ValueError(
                f"hidden size ({self.hidden_size}) is not a multiple of "
                f"attention heads ({self.num_attention_heads})")
        return self.hidden_size // self.num_attention_heads

    @property
    def out_size(self) -> int:
        """Embedding dim a tower produces (bi_encoder.py:125-128,193-196)."""
        return self.project_dim if self.project_dim > 0 else self.hidden_size
