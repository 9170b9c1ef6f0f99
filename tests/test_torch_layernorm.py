"""The port's LayerNorm twins (lightningdot_tpu_torch/ops/layernorm.py)
against the JAX package's ``layer_norm`` and ``dropout_add_ln``.

``ln_fwd_math`` and ``ln_bwd_math`` are the specs of the forward kernel
(with its mask-and-add prologue) and of the backward kernel; on the CPU the
autograd Functions run them. Inputs come from numpy seeds; the keep mask is
the one ``jax.random.bernoulli`` draws inside ``dropout_add_ln``, injected
into the port. Tolerances, relative to the largest magnitude of the JAX
result: float32 1e-6 forward and 1e-5 gradients (the same math summed in
another order); bfloat16 one bf16 ulp at that magnitude, 2**-7, for the
bf16 outputs (both packages round u op by op at the same points and the
LayerNorm once; a float32 sum in another order may move a rounding by one
ulp: measured 2.7e-3 at most, in one forward, and bit-equal gradients) and
1e-5 for the float32 dscale and dbias (measured 2.9e-7 at most).
The kernels themselves run only on the card (``cuda``-marked tests at the
end, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.ops import fused as jfused
from lightningdot_tpu.ops import layernorm as jln
from lightningdot_tpu_torch.ops import fused, launch_counts, layernorm

EPS = 1e-12
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# (forward, gradients in the activation dtype); dscale and dbias: 1e-5
TOL = {"float32": (1e-6, 1e-5), "bfloat16": (2.0 ** -7, 2.0 ** -7)}
PARAM_TOL = 1e-5


def _rel(got, want) -> float:
    """max |got - want| over max |want|, in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    peak = np.abs(want).max()
    err = np.abs(got - want).max()
    return err if peak == 0 else err / peak


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(t, np.float32)


def _inputs(hidden, dtype, seed):
    """x, res, g [3, 5, hidden] rounded to dtype, scale and bias float32,
    as numpy float32 arrays."""
    rng = np.random.default_rng(seed)
    tdt = DTYPES[dtype][0]

    def act(a):
        return torch.from_numpy(a.astype(np.float32)).to(tdt).float().numpy()

    x = act(rng.standard_normal((3, 5, hidden)) * 3 + 1)
    res = act(rng.standard_normal((3, 5, hidden)))
    g = act(rng.standard_normal((3, 5, hidden)))
    scale = (rng.random(hidden) + 0.5).astype(np.float32)
    bias = rng.standard_normal(hidden).astype(np.float32)
    return x, res, g, scale, bias


def _jax_keep(seed, rate, shape):
    """The key and the keep mask ``dropout_add_ln`` draws from it."""
    key = jax.random.PRNGKey(seed)
    keydata, impl = jfused.key_data_of(key)
    return key, np.asarray(jfused._keep_mask(keydata, rate, shape, impl))


def _t(a, dtype):
    return torch.from_numpy(np.array(a)).to(DTYPES[dtype][0])


def _j(a, dtype=None):
    arr = jnp.asarray(np.array(a, np.float32))
    return arr if dtype is None else arr.astype(DTYPES[dtype][1])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 768])
def test_twins_match_jax_dropout_add_ln(hidden, dtype, rate):
    """ln_fwd_math / ln_bwd_math with res and the JAX-drawn keep mask
    against ``dropout_add_ln`` and its vjp (dx, dres, dscale, dbias)."""
    x, res, g, scale, bias = _inputs(hidden, dtype, seed=hidden + 1)
    key, keep = (_jax_keep(17, rate, x.shape) if rate else (None, None))

    def jf(x_, res_, scale_, bias_):
        return jfused.dropout_add_ln(x_, res_, scale_, bias_, key, rate=rate,
                                     eps=EPS)

    out_j, vjp = jax.vjp(jf, _j(x, dtype), _j(res, dtype), _j(scale),
                         _j(bias))
    grads_j = vjp(_j(g, dtype))
    keep_t = None if keep is None else torch.from_numpy(keep)
    xt, rt, gt = _t(x, dtype), _t(res, dtype), _t(g, dtype)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    out = layernorm.ln_fwd_math(xt, st, bt, EPS, rt, keep_t, rate)
    assert out.dtype == xt.dtype and out.shape == xt.shape
    fwd_tol, grad_tol = TOL[dtype]
    assert _rel(_np(out), _np(out_j)) <= fwd_tol
    got = layernorm.ln_bwd_math(xt, st, gt, EPS, rt, keep_t, rate)
    for name, t, want, tol in zip(("dx", "dres", "dscale", "dbias"), got,
                                  grads_j, (grad_tol, grad_tol, PARAM_TOL,
                                            PARAM_TOL)):
        assert t.dtype == (xt.dtype if name in ("dx", "dres")
                           else torch.float32)
        err = _rel(_np(t), _np(want))
        assert err <= tol, f"{name}: {err}"
    if keep is not None:     # a dropped element passes no gradient
        assert (_np(got[0])[~keep] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 768])
def test_twins_match_jax_layer_norm(hidden, dtype):
    """ln_fwd_math / ln_bwd_math without res and mask against
    ``layer_norm`` and its custom vjp (``_layer_norm_bwd``)."""
    x, _, g, scale, bias = _inputs(hidden, dtype, seed=hidden + 2)
    out_j, vjp = jax.vjp(lambda a, s, b: jln.layer_norm(a, s, b, EPS),
                         _j(x, dtype), _j(scale), _j(bias))
    grads_j = vjp(_j(g, dtype))
    xt, gt = _t(x, dtype), _t(g, dtype)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    fwd_tol, grad_tol = TOL[dtype]
    assert _rel(_np(layernorm.ln_fwd_math(xt, st, bt, EPS)),
                _np(out_j)) <= fwd_tol
    dx, dres, dscale, dbias = layernorm.ln_bwd_math(xt, st, gt, EPS)
    assert dres is dx
    for name, t, want, tol in zip(("dx", "dscale", "dbias"),
                                  (dx, dscale, dbias), grads_j,
                                  (grad_tol, PARAM_TOL, PARAM_TOL)):
        err = _rel(_np(t), _np(want))
        assert err <= tol, f"{name}: {err}"


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [32, 768])
def test_twins_equal_the_autograd_compositions(hidden, dtype, rate):
    """On the CPU the twins give the bits of the compositions the autograd
    Functions computed before the kernels took the backward: u rounded op
    by op in x's dtype, the float32 LayerNorm cast back, the float32
    ``layer_norm_bwd`` of the recomputed u, du masked by ``apply_keep``;
    and the Functions themselves (``dropout_add_ln``, ``layer_norm``) run
    the twins."""
    x, res, g, scale, bias = _inputs(hidden, dtype, seed=hidden + 3)
    tdt = DTYPES[dtype][0]
    xt, rt, gt = _t(x, dtype), _t(res, dtype), _t(g, dtype)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    keep = (torch.from_numpy(np.random.default_rng(9).random(x.shape) > rate)
            if rate else None)
    s = torch.tensor(1.0 / (1.0 - rate), dtype=tdt)

    # the compositions, spelled out
    u = xt if keep is None else xt * keep.to(tdt) * s
    u = u + rt
    out = layernorm._ln_math(u.float(), st, bt, EPS).to(tdt)
    du, dscale, dbias = layernorm.layer_norm_bwd(u, st, gt, EPS)
    dx = du if keep is None else du * keep.to(tdt) * s

    assert torch.equal(layernorm.ln_fwd_math(xt, st, bt, EPS, rt, keep,
                                             rate), out)
    for got, want in zip(layernorm.ln_bwd_math(xt, st, gt, EPS, rt, keep,
                                               rate),
                         (dx, du, dscale, dbias)):
        assert torch.equal(got, want)

    ins = [t.clone().requires_grad_() for t in (xt, rt, st, bt)]
    y = fused.dropout_add_ln(*ins, keep, rate=rate, eps=EPS)
    y.backward(gt)
    assert torch.equal(y, out)
    for t, want in zip(ins, (dx, du, dscale, dbias)):
        assert torch.equal(t.grad, want)

    ins = [t.clone().requires_grad_() for t in (xt, st, bt)]
    y = layernorm.layer_norm(*ins, EPS)
    y.backward(gt)
    assert torch.equal(y, layernorm._ln_math(xt.float(), st, bt, EPS).to(tdt))
    for t, want in zip(ins, layernorm.layer_norm_bwd(xt, st, gt, EPS)):
        assert torch.equal(t.grad, want)


@pytest.mark.parametrize("wrapper", ["forward", "backward"])
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(wrapper):
    """CPU tensors, a width that is not a multiple of 8 or above 6,144, a
    tensor off a 16-byte boundary, a mask that is not bool: each raises
    before any launch. The VQA head's widths, 3,072 and 6,144, pass the
    shape check and reach the device check."""
    def call(x, res=None, keep=None):
        h = x.shape[-1]
        scale = torch.ones(h)
        if wrapper == "forward":
            return layernorm.layer_norm_cuda(x, scale, torch.zeros(h), EPS,
                                             res, keep, 0.1)
        return layernorm.layer_norm_bwd_cuda(x, scale, torch.ones_like(x),
                                             EPS, res, keep, 0.1)

    for dt in (torch.float32, torch.bfloat16):
        x = torch.zeros(4, 32, dtype=dt)
        keep = torch.ones(4, 32, dtype=torch.bool)
        for args in ((x,), (x, x), (x, x, keep)):
            with pytest.raises(ValueError, match="CUDA tensors only"):
                call(*args)
        for h in (36, 6152):
            with pytest.raises(ValueError, match="multiple of 8"):
                call(torch.zeros(4, h, dtype=dt))
        for h in (1544, 3072, 6144):
            with pytest.raises(ValueError, match="CUDA tensors only"):
                call(torch.zeros(4, h, dtype=dt))
        shifted = torch.zeros(4 * 32 + 2, dtype=dt)[2:].view(4, 32)
        with pytest.raises(ValueError, match="16-byte aligned"):
            call(shifted)
        with pytest.raises(ValueError, match="16-byte aligned"):
            call(x, shifted)
        with pytest.raises(ValueError, match="keep must be bool"):
            call(x, x, keep.to(dt))
        with pytest.raises(ValueError, match="beside x"):
            call(x, x.float() if dt == torch.bfloat16 else x.double())
    with pytest.raises(TypeError, match="unsupported dtype"):
        call(torch.zeros(4, 32, dtype=torch.float16))
    counts = launch_counts()
    assert counts["layernorm"] == counts["layernorm_bwd"] == 0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prologue_equals_the_kernel_on_the_twins_u(dtype):
    """With res and a rate-0.1 mask, the forward kernel gives the bits of
    the kernel run on the twin's u, and is within the rows' tolerance of
    the twin (float32 1e-5, bfloat16 2**-7, of max(1, peak))."""
    dev = _card()
    tdt = DTYPES[dtype][0]
    gen = torch.Generator(device=dev).manual_seed(3)
    for rows in (32, 300, 4096):
        x, res = (torch.randn(rows, 768, device=dev, generator=gen)
                  .to(tdt) for _ in range(2))
        keep = torch.rand(rows, 768, device=dev, generator=gen) < 0.9
        scale = torch.rand(768, device=dev, generator=gen) + 0.5
        bias = torch.randn(768, device=dev, generator=gen)
        got = layernorm.layer_norm_cuda(x, scale, bias, EPS, res, keep, 0.1)
        u = layernorm.dal_input(x, res, keep, 0.1)
        assert torch.equal(got, layernorm.layer_norm_cuda(u, scale, bias,
                                                          EPS))
        want = layernorm.ln_fwd_math(x, scale, bias, EPS, res, keep, 0.1)
        tol = (1e-5 if dtype == "float32" else 2.0 ** -7) * max(
            1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_its_twin(dtype):
    """dx and dres within the rows' tolerance of ln_bwd_math, dscale and
    dbias within 1e-5 of their peak, and the same bits on a second
    launch."""
    dev = _card()
    tdt = DTYPES[dtype][0]
    gen = torch.Generator(device=dev).manual_seed(4)
    for rows, masked in ((130, True), (2048, False), (4096, True)):
        x, res, g = (torch.randn(rows, 768, device=dev, generator=gen)
                     .to(tdt) for _ in range(3))
        keep = (torch.rand(rows, 768, device=dev, generator=gen) < 0.9
                if masked else None)
        scale = torch.rand(768, device=dev, generator=gen) + 0.5
        args = (x, scale, g, EPS, res, keep, 0.1 if masked else 0.0)
        got = layernorm.layer_norm_bwd_cuda(*args)
        again = layernorm.layer_norm_bwd_cuda(*args)
        want = layernorm.ln_bwd_math(*args)
        for i, (a, b, w) in enumerate(zip(got, again, want)):
            assert torch.equal(a, b)
            peak = w.float().abs().max().item()
            tol = (PARAM_TOL * peak if i >= 2 else
                   (1e-5 if dtype == "float32" else 2.0 ** -7)
                   * max(1.0, peak))
            assert (a.float() - w.float()).abs().max().item() <= tol
