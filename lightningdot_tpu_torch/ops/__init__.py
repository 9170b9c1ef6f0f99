"""Ops of the port: hand-written CUDA kernels with plain PyTorch twins.

Counterpart of lightningdot_tpu/ops. Each op takes its kernel for a CUDA
tensor (raising on a shape or dtype the kernel does not take) and its twin
for a CPU tensor. Each kernel wrapper counts its launches through
``utils/tracing.py`` (:func:`~lightningdot_tpu_torch.utils.tracing.launched`);
:func:`launch_counts` reads them for every kernel. Where a dtype
has a kernel of its own (the FFN, its backward's dh1 and the training
attention's backward: bfloat16 on the tensor cores, float32 on FMA units),
each has its own wrapper and count ("ffn" / "ffn_mma", "ffn_dh1" /
"ffn_dh1_mma", "attention_train_bwd" / "attention_train_bwd_mma"). The
Moonlight tower's kernels (``layernorm.rms_norm``, ``mla_attention``,
``rope``, ``moe``) are imported from their modules.
"""
from lightningdot_tpu_torch.ops.activations import gelu  # noqa: F401
from lightningdot_tpu_torch.ops.adamw import adamw_, adamw_cuda  # noqa: F401
from lightningdot_tpu_torch.ops.attention import (  # noqa: F401
    attention_cuda, attention_nodrop, multi_head_attention)
from lightningdot_tpu_torch.ops.attention_fused import (  # noqa: F401
    attention_train_bwd, attention_train_bwd_fma, attention_train_bwd_mma,
    attention_train_fwd, fused_attention_train)
from lightningdot_tpu_torch.ops.ffn import (  # noqa: F401
    ffn_cuda, ffn_fma_cuda, ffn_gelu, ffn_mma_cuda)
from lightningdot_tpu_torch.ops.ffn_dh1 import (  # noqa: F401
    ffn_dh1_cuda, ffn_dh1_fma_cuda, ffn_dh1_mma_cuda)
from lightningdot_tpu_torch.ops.ffn_int8 import (  # noqa: F401
    ffn_gelu_int8, ffn_int8_cuda)
from lightningdot_tpu_torch.ops.layernorm import (  # noqa: F401
    layer_norm, layer_norm_bwd_cuda, layer_norm_cuda)
from lightningdot_tpu_torch.ops.matmul import mm_f32, mm_int8  # noqa: F401
from lightningdot_tpu_torch.utils import tracing

KERNELS = ("layernorm", "layernorm_bwd", "attention", "ffn", "ffn_mma",
           "ffn_int8", "ffn_dh1", "ffn_dh1_mma", "adamw",
           "attention_train_fwd", "attention_train_bwd",
           "attention_train_bwd_mma", "rmsnorm", "rmsnorm_bwd",
           "mla_attention", "mla_attention_bwd", "rope", "moe_gemm",
           "moe_combine", "moe_scatter_rows", "moe_route_grad")


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}, every kernel."""
    counts = tracing.launch_counts()
    return {name: counts.get(name, 0) for name in KERNELS}


def reset_launch_counts() -> None:
    tracing.reset_launch_counts()
