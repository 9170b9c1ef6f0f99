"""Configuration (the port's copy of lightningdot_tpu/config.py:24-247).

Two layers, mirroring the reference:

  * :class:`EncoderConfig`: the transformer architecture config, accepting
    the same JSON schema as the reference's ``config/img_base.json`` and
    ``config/bert_base.json`` and HF bert configs (UniterConfig,
    uniter_model/model/model.py:23-115).
  * argparse param groups + JSON overlay where CLI flags win: the
    semantics of ``parse_with_config`` (dvl/options.py:96-109) and the
    grouped registrars ``default_params`` / ``add_itm_params`` /
    ``add_logging_params`` / ``add_kd_params`` (dvl/options.py:15-93).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Any, Optional, Sequence


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


BERT_BASE_UNCASED = EncoderConfig(vocab_size=30522)
BERT_BASE_CASED = EncoderConfig(vocab_size=28996)


@dataclasses.dataclass
class MoonlightConfig:
    """A DeepSeek-V3 decoder used as a text tower (Moonlight-16B-A3B's
    published config.json, ``model_type`` deepseek_v3): RMSNorm, multi-head
    latent attention with RoPE, one dense SwiGLU layer, then DeepSeekMoE
    layers with sigmoid routing (``noaux_tc``) and shared experts.

    A card holds ``n_routed_experts`` of each layer's ``router_experts``
    experts, from ``first_held_expert`` on: the router scores all of them
    and the layer computes only its own (``models/moonlight.py``).
    ``layer_norm_eps`` is the projection head's LayerNorm's (BERT's).
    :meth:`check` refuses sizes outside the card kernels' ranges (ROADMAP
    §C) before any launch."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    router_experts: int = 0            # 0: n_routed_experts
    first_held_expert: int = 0
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 50000.0
    rms_norm_eps: float = 1e-5
    hidden_act: str = "silu"
    initializer_range: float = 0.006
    layer_norm_eps: float = 1e-12
    project_dim: int = 0

    # the kernels' ranges (ROADMAP §C): RMS mode of csrc/layernorm.cu,
    # csrc/mla_attention.cu, csrc/moe_gemm.cu
    MAX_NORM_WIDTH = 6144
    MAX_HEAD_WIDTH = 256
    MAX_HELD_EXPERTS = 64

    @classmethod
    def from_dict(cls, d: dict) -> "MoonlightConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in d.items() if k in known})
        cfg.check()
        return cfg

    @classmethod
    def from_json_file(cls, path: str) -> "MoonlightConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def n_router(self) -> int:
        return self.router_experts or self.n_routed_experts

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def out_size(self) -> int:
        return self.project_dim if self.project_dim > 0 else self.hidden_size

    def check(self) -> None:
        """Raise on what the tower or its kernels do not take."""
        bad = []
        if self.q_lora_rank is not None:
            bad.append("q_lora_rank (query compression is not built)")
        if (self.scoring_func, self.topk_method, self.hidden_act) != (
                "sigmoid", "noaux_tc", "silu"):
            bad.append("routing other than sigmoid/noaux_tc with silu")
        if self.n_group != 1 or self.topk_group != 1:
            bad.append("group-limited routing (n_group, topk_group)")
        for name in ("hidden_size", "kv_lora_rank"):
            v = getattr(self, name)
            if v % 8 or v > self.MAX_NORM_WIDTH:
                bad.append(f"{name} {v}: a multiple of 8 up to "
                           f"{self.MAX_NORM_WIDTH}")
        for name in ("intermediate_size", "moe_intermediate_size"):
            if getattr(self, name) % 8:
                bad.append(f"{name}: a multiple of 8")
        if (self.qk_head_dim > self.MAX_HEAD_WIDTH
                or self.v_head_dim > self.MAX_HEAD_WIDTH
                or self.qk_rope_head_dim % 2):
            bad.append("head widths up to 256, an even RoPE width")
        if not 0 < self.n_routed_experts <= self.MAX_HELD_EXPERTS:
            bad.append(f"n_routed_experts held: 1 to "
                       f"{self.MAX_HELD_EXPERTS}")
        if (self.first_held_expert < 0 or self.first_held_expert
                + self.n_routed_experts > self.n_router
                or self.num_experts_per_tok > self.n_router):
            bad.append("held experts outside the router's")
        if bad:
            raise ValueError("MoonlightConfig outside the port's ranges: "
                             + "; ".join(bad))


MOONLIGHT_16B_A3B = MoonlightConfig()


# ---------------------------------------------------------------------------
# Run options: argparse groups + JSON overlay (dvl/options.py parity)
# ---------------------------------------------------------------------------

def default_params(parser: argparse.ArgumentParser) -> None:
    """Core flags shared by the drivers (dvl/options.py:15-47), with the
    JAX package's defaults. Its TPU knob (``--kernel_backend``) is not
    registered, and the mesh size (``--dp_size``) only by the drivers that
    train across processes (:func:`add_dist_params`); a config JSON that
    holds them loads all the same, since :func:`parse_with_config` sets
    every key it holds."""
    parser.add_argument("--txt_model_type", default="bert-base", type=str)
    parser.add_argument("--txt_model_config", default="bert-base-cased", type=str)
    parser.add_argument("--txt_checkpoint", default=None, type=str)
    parser.add_argument("--img_model_type", default="uniter-base", type=str)
    parser.add_argument("--img_model_config", default="./configs/img_base.json", type=str)
    parser.add_argument("--img_checkpoint", default=None, type=str)
    parser.add_argument("--biencoder_checkpoint", default=None, type=str)

    parser.add_argument("--train_batch_size", default=80, type=int)
    parser.add_argument("--valid_batch_size", default=80, type=int)
    parser.add_argument("--gradient_accumulation_steps", default=1, type=int)
    parser.add_argument("--learning_rate", default=1e-5, type=float)
    parser.add_argument("--max_grad_norm", default=2.0, type=float)
    parser.add_argument("--loader_workers", default=4, type=int,
                        help="parallel whole-batch collate threads for the "
                        "loaders (order-preserving)")
    parser.add_argument("--optim_state_dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="AdamW first-moment storage dtype (the second "
                        "moment stays float32)")
    parser.add_argument("--warmup_steps", default=500, type=int)
    parser.add_argument("--valid_steps", default=500, type=int)
    parser.add_argument("--num_train_steps", default=5000, type=int)
    parser.add_argument("--num_train_epochs", default=0, type=int)

    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--output_dir", default="./", type=str)
    parser.add_argument("--max_txt_len", default=64, type=int)
    parser.add_argument("--config", default=None, type=str)
    parser.add_argument("--itm_global_file", default=None, type=str)
    parser.add_argument("--hnsw_index", action="store_true")
    parser.add_argument("--compute_dtype", default="bf16",
                        choices=["bf16", "f32"])


def add_dist_params(parser: argparse.ArgumentParser,
                    dp_size: bool = True) -> None:
    """The flags of a driver that trains across processes under
    ``torchrun``: the device (default: the card of ``LOCAL_RANK``), the
    backend of the process group (default: NCCL on a card, gloo on the
    CPU; gloo lets two ranks share one card) and, with ``dp_size``, the
    JAX package's mesh size (config.py:136-137): the number of processes,
    0 = the launcher's."""
    parser.add_argument("--device", default=None, type=str,
                        help="default: the CUDA card (of LOCAL_RANK under "
                             "torchrun; raises without one); 'cpu' runs "
                             "the plain PyTorch path")
    parser.add_argument("--dist_backend", default=None,
                        choices=["nccl", "gloo"],
                        help="process group backend under torchrun "
                             "(default nccl on cuda, gloo on cpu)")
    if dp_size:
        parser.add_argument("--dp_size", default=0, type=int,
                            help="data-parallel processes (torchrun "
                                 "--nproc_per_node); 0 = the launcher's")


def add_itm_params(parser: argparse.ArgumentParser) -> None:
    """ITM / retrieval flags (dvl/options.py:50-81), with the path
    remapping of :func:`map_db_dirs`."""
    parser.add_argument("--conf_th", default=0.2, type=float)
    parser.add_argument("--caption_score_weight", default=0.0, type=float)
    parser.add_argument("--num_hard_negatives", default=0, type=int)
    parser.add_argument("--sample_init_hard_negatives", action="store_true")
    parser.add_argument("--hard_negatives_sampling", default="none", type=str,
                        choices=["none", "random", "top", "top-random",
                                 "10-20", "20-30"])
    parser.add_argument("--max_bb", default=100, type=int)
    parser.add_argument("--min_bb", default=10, type=int)
    parser.add_argument("--num_bb", default=36, type=int)
    parser.add_argument("--train_txt_dbs", default=None, type=str)
    parser.add_argument("--train_img_dbs", default=None, type=str)
    parser.add_argument("--txt_db_mapping", default=None, type=str)
    parser.add_argument("--img_db_mapping", default=None, type=str)
    parser.add_argument("--pretrain_mapping", default=None, type=str)
    parser.add_argument("--val_txt_db", default=None, type=str)
    parser.add_argument("--val_img_db", default=None, type=str)
    parser.add_argument("--test_txt_db", default=None, type=str)
    parser.add_argument("--test_img_db", default=None, type=str)
    parser.add_argument("--inf_minibatch_size", default=400, type=int)
    parser.add_argument("--project_dim", default=0, type=int)
    parser.add_argument("--cls_concat", default="", type=str)
    parser.add_argument("--fix_txt_encoder", action="store_true")
    parser.add_argument("--fix_img_encoder", action="store_true")
    parser.add_argument("--retrieval_mode", default="both",
                        choices=["img_only", "txt_only", "both"], type=str)


def add_logging_params(parser: argparse.ArgumentParser) -> None:
    """Logging flags (dvl/options.py:83-88)."""
    parser.add_argument("--log_result_step", default=4, type=int)
    parser.add_argument("--save_all_epochs", action="store_true")
    parser.add_argument("--sim_preempt_step", type=int, default=None,
                        help="fault injection: act as if SIGTERM arrived "
                             "at this global step (preemption-path tests)")
    parser.add_argument("--preempt_check_steps", type=int, default=25,
                        help="cadence of the preemption OR-reduce across "
                             "processes (rounded up to a multiple of the "
                             "accumulation window); one process never "
                             "pays a collective")


def add_kd_params(parser: argparse.ArgumentParser) -> None:
    """Knowledge-distillation flags (dvl/options.py:90-93): the
    cross-encoder teacher, the temperature and the KD loss weight."""
    parser.add_argument("--teacher_checkpoint", default=None, type=str)
    parser.add_argument("--T", default=1.0, type=float)
    parser.add_argument("--kd_loss_weight", default=1.0, type=float)


def parse_with_config(parser: argparse.ArgumentParser,
                      cmds: Optional[Sequence[str]] = None) -> argparse.Namespace:
    """Parse CLI args, overlay a JSON config; CLI flags win.

    Semantics of dvl/options.py:96-109: any key present in the JSON config is
    applied unless the same flag was explicitly given on the command line.
    """
    argv = list(sys.argv[1:]) if cmds is None else list(cmds)
    args = parser.parse_args(argv)
    if args.config is not None:
        with open(args.config) as f:
            config_args = json.load(f)
        override_keys = {arg[2:].split("=")[0] for arg in argv
                         if arg.startswith("--")}
        for k, v in config_args.items():
            if k not in override_keys:
                setattr(args, k, v)
    return args


def map_db_dirs(args: argparse.Namespace) -> None:
    """Container path remapping (dvl/options.py:112-132): rewrite
    /pretrain, /db and /img prefixes via the *_mapping flags."""
    for k, v in list(vars(args).items()):
        if not isinstance(v, str):
            continue
        if v.startswith("/pretrain") and getattr(args, "pretrain_mapping",
                                                 None):
            setattr(args, k, v.replace("/pretrain", args.pretrain_mapping, 1))
        if v.startswith("/db") and getattr(args, "txt_db_mapping", None):
            setattr(args, k, v.replace("/db", args.txt_db_mapping, 1))
        if v.startswith("/img") and getattr(args, "img_db_mapping", None):
            setattr(args, k, v.replace("/img", args.img_db_mapping, 1))
    if getattr(args, "img_db_mapping", None) and \
            isinstance(getattr(args, "train_img_dbs", None), list):
        args.train_img_dbs = [
            p.replace("/img", args.img_db_mapping, 1)
            if p.startswith("/img") else p for p in args.train_img_dbs]
    if getattr(args, "txt_db_mapping", None) and \
            isinstance(getattr(args, "train_txt_dbs", None), list):
        args.train_txt_dbs = [
            p.replace("/db", args.txt_db_mapping, 1)
            if p.startswith("/db") else p for p in args.train_txt_dbs]


def print_args(args: Any, log=print) -> None:
    """Configuration banner (dvl/options.py:137-142)."""
    log(" **************** CONFIGURATION **************** ")
    for key, val in sorted(vars(args).items()):
        log(f"{key:<30} -->   {val}")
    log(" **************** END CONFIGURATION **************** ")
