"""``ops.matmul.mm_round`` against the chain it replaces below float32:
``mm_f32(a, b)`` (``+ bias``) then ``.to(bfloat16)``, through
``_MatmulF32``'s backward; and the float32 paths of ``Dense`` and
``Weight``, which do not call it.

On the CPU both compute the float32 product of the upcast operands and
round once, so values and the operands' gradients agree bit for bit; the
bias gradient sums the same float32 values in another order (1e-6 of the
summed magnitudes).
"""
import pytest
import torch

from lightningdot_tpu_torch.models.encoder import Dense
from lightningdot_tpu_torch.models.moonlight import Weight
from lightningdot_tpu_torch.ops import matmul
from lightningdot_tpu_torch.ops.matmul import mm_f32, mm_round
from lightningdot_tpu_torch.utils import tracing

BF16 = torch.bfloat16
SHAPES = [(1, 1, 1), (5, 7, 3), (37, 24, 16), (130, 64, 96), (64, 300, 8)]


@pytest.fixture(autouse=True)
def fresh():
    matmul.reset_rounded_products()
    tracing.clear()
    yield
    tracing.clear()


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
    for name, fn, out in (("new", mm_round, got), ("old", _old_chain, want)):
        a = a0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        bias = bias0.clone().requires_grad_(True) if with_bias else None
        # the weight as Dense and Weight pass it: the master cast in the
        # graph, transposed
        y = fn(a, w.to(BF16).t(), bias)
        y.backward(g)
        out.update(y=y.detach(), da=a.grad, dw=w.grad,
                   dbias=None if bias is None else bias.grad)
    assert matmul.rounded_products() == 1
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
    y = mm_round(a, b, bias)                    # the input needs none
    y.backward(g)
    assert a.grad is None
    assert torch.equal(b.grad, mm_f32(a.t(), g).to(BF16))
    if with_bias:
        _bias_close(bias.grad, g.float().sum(0), g)
    with torch.no_grad():
        assert not mm_round(a, b, bias).requires_grad
    assert matmul.rounded_products() == 2


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
def test_dense_and_weight_keep_their_numbers(dtype):
    """Float32 runs today's lines (the op's counter stays 0); below it the
    two layers equal the chain, in inference and under autograd."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(3, 11, 24, generator=gen)
    dense, weight = Dense(24, 16), Weight(16, 24)
    for p in (dense.weight, dense.bias, weight.weight):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    x2 = x.reshape(-1, 24).to(dtype)
    want_dense = (mm_f32(x2, dense.weight.to(dtype).t()) + dense.bias
                  ).to(dtype).reshape(3, 11, 16)
    want_weight = mm_f32(x2, weight.weight.to(dtype).t()).to(
        dtype).reshape(3, 11, 16)
    with torch.no_grad():
        assert torch.equal(dense(x, dtype), want_dense.detach())
        assert torch.equal(weight(x, dtype), want_weight.detach())
    got = dense(x, dtype), weight(x, dtype)       # in the graph
    assert all(t.dtype == dtype and t.requires_grad for t in got)
    assert torch.equal(got[0].detach(), want_dense.detach())
    assert torch.equal(got[1].detach(), want_weight.detach())
    assert matmul.rounded_products() == (0 if dtype == torch.float32 else 4)


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
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        a, w, bias, g = (t.cuda() for t in _inputs(1031, 768, 640, seed=11))
        b = w.to(BF16).t()
        got = mm_round(a, b, bias if with_bias else None)
        want32 = mm_f32(a, b) + (bias if with_bias else 0)
        assert bool(((got.float() - want32).abs()
                     <= bf16_ulp(want32)).all())
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag
    assert matmul.rounded_products() == 1


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bfloat16 values at each of ``x``'s magnitudes (8
    significant bits)."""
    exponent = torch.frexp(x.to(BF16).float()).exponent
    return torch.ldexp(torch.ones_like(x), exponent - 8)
