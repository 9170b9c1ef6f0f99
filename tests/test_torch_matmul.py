"""``ops.matmul.mm_round`` against the chain it replaces below float32:
``mm_f32(a, b)`` (``+ bias``) then ``.to(bfloat16)``, through
``_MatmulF32``'s backward; the float32 path of ``Dense``, with and without
a bias, which does not call it; and the product rule that importing the
package sets, which only ``ops/matmul.py`` names.

On the CPU both compute the float32 product of the upcast operands and
round once, so values and the operands' gradients agree bit for bit; the
bias gradient sums the same float32 values in another order (1e-6 of the
summed magnitudes).
"""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import lightningdot_tpu_torch
from lightningdot_tpu_torch.models.encoder import Dense
from lightningdot_tpu_torch.ops.matmul import (mm_f32, mm_round,
                                               require_full_f32)
from lightningdot_tpu_torch.utils import tracing

BF16 = torch.bfloat16
SHAPES = [(1, 1, 1), (5, 7, 3), (37, 24, 16), (130, 64, 96), (64, 300, 8)]
FLAGS = ("torch.backends.cuda.matmul.allow_tf32",
         "torch.backends.cudnn.allow_tf32",
         "torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction")


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _rounded(recs, name="count"):
    """The ``rounded_products`` counted on the spans named ``name``."""
    return sum(r.counts.get("rounded_products", 0) for r in recs
               if r.name == name)


def _inputs(m, k, n, seed):
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=gen).to(BF16)
    w = torch.randn(n, k, generator=gen) * 0.3          # a float32 master
    bias = torch.randn(n, generator=gen) * 0.5
    g = torch.randn(m, n, generator=gen).to(BF16)
    return a, w, bias, g


def _old_chain(a, b, bias):
    y = mm_f32(a, b)
    return (y if bias is None else y + bias).to(BF16)


def _bias_close(got, want, g):
    tol = 1e-6 * float(g.float().abs().sum(0).max())
    assert float((got - want).abs().max()) <= tol


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_values_and_gradients_equal_the_float32_chain(shape, with_bias):
    a0, w0, bias0, g = _inputs(*shape, seed=sum(shape))
    got, want = {}, {}
    with tracing.recording():
        for name, fn, out in (("new", mm_round, got),
                              ("old", _old_chain, want)):
            a = a0.clone().requires_grad_(True)
            w = w0.clone().requires_grad_(True)
            bias = bias0.clone().requires_grad_(True) if with_bias else None
            # the weight as Dense passes it under autograd: the master cast
            # in the graph, transposed
            with tracing.span("count"):
                y = fn(a, w.to(BF16).t(), bias)
            y.backward(g)
            out.update(y=y.detach(), da=a.grad, dw=w.grad,
                       dbias=None if bias is None else bias.grad)
    assert _rounded(tracing.records()) == 1
    assert got["y"].dtype == BF16 and got["da"].dtype == BF16
    for key in ("y", "da", "dw"):
        assert torch.equal(got[key], want[key]), key
    if with_bias:
        assert got["dbias"].dtype == torch.float32
        _bias_close(got["dbias"], want["dbias"], g)


@pytest.mark.parametrize("with_bias", [False, True])
def test_only_the_needed_gradients_are_made(with_bias):
    a, w, bias, g = _inputs(9, 12, 5, seed=3)
    b = w.to(BF16).t().requires_grad_(True)
    bias = bias.requires_grad_(True) if with_bias else None
    with tracing.recording(), tracing.span("count"):
        y = mm_round(a, b, bias)                    # the input needs none
        with torch.no_grad():
            assert not mm_round(a, b, bias).requires_grad
    y.backward(g)
    assert a.grad is None
    assert torch.equal(b.grad, mm_f32(a.t(), g).to(BF16))
    if with_bias:
        _bias_close(bias.grad, g.float().sum(0), g)
    assert _rounded(tracing.records()) == 2


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_dense_and_weight_keep_their_numbers(dtype, bias):
    """Float32 runs today's lines (the op's counter stays 0); below it the
    layer, with its bias (BERT's) or without (MLA's), equals the chain, in
    inference and under autograd."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, 11, 24, generator=gen)
    dense = Dense(24, 16, bias=bias)
    assert (dense.bias is not None) == bias
    for p in dense.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    x2 = x.reshape(-1, 24).to(dtype)
    want = mm_f32(x2, dense.weight.to(dtype).t())
    want = (want + dense.bias if bias else want).to(dtype).reshape(3, 11, 16)
    with tracing.recording(), tracing.span("count"):
        with torch.no_grad():
            assert torch.equal(dense(x, dtype), want.detach())
        got = dense(x, dtype)                       # in the graph
    assert got.dtype == dtype and got.requires_grad
    assert torch.equal(got.detach(), want.detach())
    assert _rounded(tracing.records()) == (0 if dtype == torch.float32
                                           else 2)


def test_forward_and_backward_count_on_the_spans_open_around_them():
    a, w, bias, g = _inputs(6, 8, 4, seed=9)
    b = w.to(BF16).t().requires_grad_(True)
    with tracing.recording():
        with tracing.span("forward"):
            y = mm_round(a, b, bias)
            y2 = mm_round(a, b)
        with tracing.span("backward"):
            (y.float() * g.float() + y2.float()).sum().backward()
    recs = {r.name: r.counts for r in tracing.records()}
    assert recs["forward"] == {"rounded_products": 2}
    assert recs["backward"] == {"rounded_products": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
def test_rounded_product_on_card_is_within_a_bf16_ulp(with_bias):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (cuBLAS's bf16 output)")
    a, w, bias, g = (t.cuda() for t in _inputs(1031, 768, 640, seed=11))
    b = w.to(BF16).t()
    with tracing.recording(), tracing.span("count"):
        got = mm_round(a, b, bias if with_bias else None)
    want32 = mm_f32(a, b) + (bias if with_bias else 0)
    assert bool(((got.float() - want32).abs() <= bf16_ulp(want32)).all())
    assert _rounded(tracing.records()) == 1


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at each of ``x``'s magnitudes (8
    significant bits)."""
    exponent = torch.frexp(x.to(BF16).float()).exponent
    return torch.ldexp(torch.ones_like(x), exponent - 8)


@pytest.mark.parametrize("device, dtype, raises", [
    ("cuda", torch.float32, True), ("cpu", torch.float32, False),
    ("cuda", BF16, False)])
def test_require_full_f32_refuses_tf32_on_the_card_only(device, dtype,
                                                        raises):
    """With TF32 turned back on, float32 compute on a CUDA device raises;
    the CPU and bf16 do not (no card needed: the device is only a name)."""
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        if raises:
            with pytest.raises(RuntimeError, match="TF32 products on"):
                require_full_f32(torch.device(device), dtype)
        else:
            require_full_f32(torch.device(device), dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def test_importing_the_package_turns_the_precision_flags_off():
    """A fresh process: ``import lightningdot_tpu_torch`` alone, no step
    built, leaves TF32 (cuBLAS and cuDNN) and cuBLAS's bf16 split-k
    reduction off."""
    code = f"import torch, lightningdot_tpu_torch; print({', '.join(FLAGS)})"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.split() == ["False"] * 3, out.stdout


def test_only_ops_matmul_names_the_precision_flags():
    """The product rule lives in one module of the package."""
    root = Path(lightningdot_tpu_torch.__file__).parent
    names = [f.rsplit(".", 1)[1] for f in FLAGS]
    hits = sorted({str(p.relative_to(root)) for p in root.rglob("*.py")
                   if any(n in p.read_text() for n in names)})
    assert hits == ["ops/matmul.py"], hits
