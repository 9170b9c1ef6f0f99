"""Fused int8 FFN of the int8 serving tower: a CUDA kernel and its plain
PyTorch twin.

Counterpart of lightningdot_tpu/ops/ffn_int8.py (``_quant_rows``,
``_ffn_int8_math`` with ``erf="exact"``, ``ffn_gelu_int8``). The kernel
(``csrc/ffn_int8.cu``) replaces the TPU kernel ``_ffn_int8_kernel``
(lightningdot_tpu/ops/experimental/ffn_int8_pallas.py:24, launched by
``ffn_int8_pallas``). The JAX package's ``LDOT_INT8_FFN`` gate is not carried
over: every CUDA call takes the kernel.

Quantized kernels are in the JAX package's [in, out] layout, w1 [H, I] and
w2 [I, H], given as transposes of contiguous out-major int8 tensors (the
torch Linear layout, as ``models.quantized.QuantizedDense`` holds them).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from lightningdot_tpu_torch.ops import _build
from lightningdot_tpu_torch.ops.activations import gelu
from lightningdot_tpu_torch.ops.gemm import (GEMM_TILE, INT8_K_TILE,
                                             INT8_ROW_TILE, GemmPlan,
                                             check_mma_operands, gemm_plan)
from lightningdot_tpu_torch.ops.matmul import mm_int8
from lightningdot_tpu_torch.utils import tracing

# csrc/ffn_int8.cu: fc1 keeps all of H's k tiles of its rows in shared
# memory
MAX_HIDDEN = 2048


# "/ 127" as the served JAX package computes it: under jit XLA turns the
# division by a constant into a multiply by its float32 reciprocal (torch on
# CUDA does the same for a scalar divisor, torch on the CPU does not), so
# the port writes the multiply, on every device and in the kernels
INV_127 = 1.0 / 127.0


def _quant_rows(xf: torch.Tensor):
    """Per-row symmetric int8: scale max(max|x|, 1e-8) / 127, values
    round(x / scale) (a true division) clipped to +-127
    (lightningdot_tpu/ops/ffn_int8.py:46). ``xf`` float32 [..., n] ->
    (int8 [..., n], float32 scale [..., 1])."""
    xs = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) * INV_127
    xq = torch.round(xf / xs).clamp(-127, 127).to(torch.int8)
    return xq, xs


def _ffn_int8_math(x2d, w1, s1, b1, w2, s2, b2):
    """The plain twin: the serving composition ``_dense_int8`` -> exact erf
    GELU in bfloat16 -> ``_dense_int8`` (lightningdot_tpu/ops/ffn_int8.py:
    58-72). ``x2d`` [rows, H] bfloat16 -> bfloat16 [rows, H]."""
    xq, xs = _quant_rows(x2d.float())
    h1 = (mm_int8(xq, w1).float() * xs * s1 + b1).to(torch.bfloat16)
    inter = gelu(h1)
    iq, is_ = _quant_rows(inter.float())
    return (mm_int8(iq, w2).float() * is_ * s2 + b2).to(torch.bfloat16)


class Int8Plan(NamedTuple):
    """The launches of ``csrc/ffn_int8.cu`` (64 x 128 output tiles, k tiles
    of 128 int8 values): fc1 over [rows, I], unsplit, each block taking
    ``fc1_cols`` column tiles of one row tile; fc2 over [rows, H]."""
    fc1: GemmPlan
    fc1_cols: int
    fc2: GemmPlan


def ffn_int8_plan(rows: int, hidden: int, inter: int,
                  num_sms: int) -> Int8Plan:
    """fc1 never splits its reduction over H (its GELU epilogue and the row
    maxima need whole sums); its blocks quantize their rows of x once and
    keep them in shared memory for a group of column tiles, as many as
    leave about two blocks per SM (one tile each at few rows). fc2 splits
    its reduction over I as :func:`gemm_plan` says, into int32 partials
    that a second pass sums."""
    fc1 = GemmPlan(-(-rows // INT8_ROW_TILE), -(-inter // GEMM_TILE), 1,
                   -(-hidden // INT8_K_TILE))
    cols = max(1, round(fc1.row_tiles * fc1.col_tiles / (2 * num_sms)))
    cols = -(-fc1.col_tiles // -(-fc1.col_tiles // cols))   # evened out
    return Int8Plan(fc1, cols, gemm_plan(
        rows, hidden, inter, num_sms, k_tile=INT8_K_TILE,
        row_tile=INT8_ROW_TILE))


def _out_major(w: torch.Tensor, what: str, name: str) -> None:
    if w.dtype != torch.int8 or w.dim() != 2 or not w.t().is_contiguous():
        raise ValueError(f"{what}: {name} must be an int8 [in, out] view of "
                         f"a contiguous [out, in] tensor, got {w.dtype} "
                         f"{tuple(w.shape)} strides {w.stride()}")


def ffn_int8_cuda(x2d: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                  b2: torch.Tensor) -> torch.Tensor:
    """Launch the int8 FFN on the tensor cores (``csrc/ffn_int8.cu``: fc1
    with the dequant-GELU epilogue, then fc2, split as
    :func:`ffn_int8_plan` says) on a [rows, H] bfloat16 CUDA tensor. H and I
    must be multiples of 16, x and the weights 16-byte aligned."""
    what = "ffn_int8 kernel"
    _build.require_cuda(what, x2d, w1.t(), s1, b1, w2.t(), s2, b2)
    if x2d.dtype != torch.bfloat16 or x2d.dim() != 2:
        raise TypeError(f"{what}: x must be bfloat16 [rows, H], got "
                        f"{x2d.dtype} {tuple(x2d.shape)}")
    _out_major(w1, what, "w1")
    _out_major(w2, what, "w2")
    rows, h = x2d.shape
    inter = w1.shape[1]
    if w1.shape != (h, inter) or w2.shape != (inter, h):
        raise ValueError(f"{what}: shapes x {tuple(x2d.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)} do not "
                         f"form an FFN")
    for name, t, n in (("s1", s1, inter), ("b1", b1, inter), ("s2", s2, h),
                       ("b2", b2, h)):
        if t.dtype != torch.float32 or t.shape != (n,):
            raise ValueError(f"{what}: {name} must be float32 [{n}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    check_mma_operands(what, h, inter, x2d, w1, w2, multiple=16)
    if h > MAX_HIDDEN:
        raise ValueError(f"{what}: needs H <= {MAX_HIDDEN}, got H={h}")
    dev = x2d.device
    fc1, cols, fc2 = ffn_int8_plan(rows, h, inter, _build.num_sms(dev))
    out = torch.empty_like(x2d)
    # one allocation for the scratch: the bf16 intermediate [rows, I], fc1's
    # row maxima per column tile [rows, I / 128], the row scales [rows]
    # (float32) and the int32 partials [splits, rows, H] when fc2 splits
    split = fc2.splits > 1
    parts = (2 * rows * inter, 4 * rows * fc1.col_tiles, 4 * rows,
             4 * fc2.splits * rows * h if split else 0)
    starts = [0]
    for n in parts[:-1]:
        starts.append(starts[-1] + -(-n // 256) * 256)
    scratch = torch.empty(starts[-1] + parts[-1], dtype=torch.uint8,
                          device=dev)
    ptrs = [scratch.data_ptr() + at for at in starts]
    with torch.cuda.device(dev):
        _build.check(_build.lib().ldot_ffn_int8(
            x2d.data_ptr(), w1.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            ptrs[0], ptrs[1], ptrs[2], ptrs[3] if split else None,
            rows, h, inter, cols, fc2.splits, fc2.per,
            _build.stream_ptr(x2d)),
            what)
    tracing.launched("ffn_int8")
    return out


def ffn_gelu_int8(x: torch.Tensor, w1: torch.Tensor, s1: torch.Tensor,
                  b1: torch.Tensor, w2: torch.Tensor, s2: torch.Tensor,
                  b2: torch.Tensor) -> torch.Tensor:
    """int8 dense(H->I) -> erf GELU -> int8 dense(I->H) on [..., H]
    bfloat16 input: the kernel for a CUDA tensor (or it raises), the twin
    for a CPU tensor. ``w1``/``w2`` int8 [in, out] with float32 per-channel
    scales ``s1``/``s2`` and biases ``b1``/``b2``."""
    shape = x.shape
    x2d = x.reshape(-1, shape[-1])
    if x.is_cuda:
        out = ffn_int8_cuda(x2d.contiguous(), w1, s1, b1, w2, s2, b2)
    else:
        out = _ffn_int8_math(x2d, w1, s1, b1, w2, s2, b2)
    return out.reshape(shape)
