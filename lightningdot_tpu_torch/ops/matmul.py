"""Matrix products with float32 accumulation, and the port's one rule for
how its products sum.

The JAX package writes ``jnp.dot(a, b, preferred_element_type=float32)``
for every dense layer and for the corpus scores. ``torch.matmul`` of two
bfloat16 tensors instead returns bfloat16, rounding before the bias is
added; :func:`mm_f32` keeps the float32 result. Where a layer rounds that
result (with its bias added) to bfloat16 at once, as ``encoder._dense``
does, :func:`mm_round` writes the rounded result without a float32 copy.

Importing this module sets cuBLAS's and cuDNN's precision flags for the
process (below); the package's ``__init__`` imports it, so every entry
point runs under them. No other module of the port sets or reads them:
a float32 step checks them through :func:`require_full_f32`, and code that
must hold them against a caller who turned TF32 back on wraps its
products in :func:`full_f32`.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from lightningdot_tpu_torch.utils import tracing

# The port's contract, as the JAX package's products are: float32 products
# in true float32 (no TF32, in cuBLAS or in cuDNN), and bfloat16 products
# summed in float32 and rounded once (no split-k partials summed in
# bfloat16). Set once for the process, never around a product: autograd's
# device thread runs the backward's products while the caller's thread
# waits, so a flag restored in one thread could race a product in the other.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def require_full_f32(device: torch.device, dtype: torch.dtype) -> None:
    """Raise if float32 compute on a CUDA ``device`` would run TF32
    products: a caller turned ``allow_tf32`` back on after import."""
    if (device.type == "cuda" and dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("float32 training with TF32 products on: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


@contextlib.contextmanager
def full_f32():
    """float32 products in full precision on the card (no TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# corpus columns per CPU block: bounds the float32 copy that the CPU path
# makes of a bfloat16 operand
_CPU_BLOCK = 16384


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda:
        if a.dtype == torch.float32 and b.dtype == torch.float32:
            return torch.mm(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)
    af = a.float()
    if b.shape[1] <= _CPU_BLOCK:
        return af @ b.float()
    out = torch.empty((a.shape[0], b.shape[1]), dtype=torch.float32)
    for j in range(0, b.shape[1], _CPU_BLOCK):
        out[:, j:j + _CPU_BLOCK] = af @ b[:, j:j + _CPU_BLOCK].float()
    return out


class _MatmulF32(torch.autograd.Function):
    """The gradient of ``jnp.dot(a, b, preferred_element_type=float32)``:
    the float32 cotangent is rounded to the operands' dtype (what the TPU's
    default precision does to a float32 operand of a bfloat16 product; an
    identity in float32), each operand's gradient is a float32-accumulated
    product rounded to that operand's dtype (``_dot_general_transpose_*``
    converts back to the primal dtype)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[0]:
            da = _mm_f32(g.to(b.dtype), b.t()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = _mm_f32(a.t(), g.to(a.dtype)).to(b.dtype)
        return da, db


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for 2-D float32 or bfloat16 operands, accumulated and
    returned in float32.

    On CUDA, bfloat16 operands go to ``torch.mm(..., out_dtype=float32)``
    and float32 operands to ``torch.mm`` (true float32 under this module's
    flags). On the CPU the operands are upcast first: a product of two
    bfloat16 values is exact in float32, so this is float32 accumulation
    too. Under autograd the gradient is :class:`_MatmulF32`'s.
    """
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _MatmulF32.apply(a, b)
    return _mm_f32(a, b)


def _mm_round(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` summed in float32 and rounded once to the operands'
    dtype: on CUDA one cuBLAS product that writes that dtype (summed in
    float32 under this module's flags); on the CPU the float32 product, then
    one rounding."""
    if a.is_cuda:
        return torch.mm(a, b)
    return _mm_f32(a, b).to(a.dtype)


class _MatmulRound(torch.autograd.Function):
    """:class:`_MatmulF32`'s gradient with the rounding after the product
    (and the bias) taken in: the cotangent arrives in the operands' dtype
    and each operand's gradient is one rounded product; the bias's is the
    cotangent summed over the rows in float32. ``spans``: the forward's
    thread's open spans, which autograd's device thread counts on."""

    @staticmethod
    def forward(ctx, a, b, bias):
        ctx.save_for_backward(a, b)
        ctx.spans = tracing.open_spans()
        return _round_forward(a, b, bias)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        tracing.count("rounded_products", 1, ctx.spans)
        da = db = dbias = None
        if ctx.needs_input_grad[0]:
            da = _mm_round(g, b.t())
        if ctx.needs_input_grad[1]:
            db = _mm_round(a.t(), g)
        if ctx.needs_input_grad[2]:
            dbias = g.sum(0, dtype=torch.float32)
        return da, db, dbias


def _round_forward(a, b, bias):
    tracing.count("rounded_products", 1)
    if bias is None:
        return _mm_round(a, b)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype,
                      device=a.device)
    return torch.add(_mm_f32(a, b), bias, out=out)


def mm_round(a: torch.Tensor, b: torch.Tensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``round(a @ b + bias)`` for 2-D bfloat16 ``a`` [m, k] and ``b``
    [k, n] and an optional float32 ``bias`` [n]: float32 sums, one rounding
    to bfloat16, the numbers of ``mm_f32(a, b)`` (``+ bias``) then
    ``.to(bfloat16)`` (bit for bit on the CPU; on the card cuBLAS may sum
    in another order, within a bfloat16 ulp of the float32 product).

    Without a bias, one cuBLAS product that writes bfloat16 (on the CPU
    the float32 product and one rounding); with one, the float32 product
    and one pass that adds the float32 bias and rounds on store. Under
    autograd (:class:`_MatmulRound`) the bfloat16 cotangent is taken as it
    comes and each operand's gradient is one product rounded the same way.
    Each call, and each backward, counts once in the counter
    ``rounded_products`` of the open span (``utils/tracing.py``).
    """
    if torch.is_grad_enabled() and (
            a.requires_grad or b.requires_grad
            or (bias is not None and bias.requires_grad)):
        return _MatmulRound.apply(a, b, bias)
    return _round_forward(a, b, bias)


# torch._int_mm on CUDA takes only more than 16 rows
_INT_MM_MIN_ROWS = 17


def mm_int8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for int8 ``a`` [m, k] and ``b`` [k, n], exact in int32.

    The JAX package writes ``jnp.dot(..., preferred_element_type=int32)``
    outside any Pallas kernel; this is its counterpart, ``torch._int_mm``
    (cuBLASLt's int8 path on CUDA, an int32-accumulating loop on the CPU).
    On CUDA it needs k and n multiples of 8 and more than 16 rows: fewer
    rows are padded with zero rows here, never sent to a float product.
    Give ``b`` as the transpose of a contiguous [n, k] tensor (the torch
    Linear layout), the layout cuBLASLt's int8 kernels take.
    """
    m = a.shape[0]
    if a.is_cuda and m < _INT_MM_MIN_ROWS:
        padded = a.new_zeros((_INT_MM_MIN_ROWS, a.shape[1]))
        padded[:m] = a
        return torch._int_mm(padded, b)[:m]
    return torch._int_mm(a, b)
