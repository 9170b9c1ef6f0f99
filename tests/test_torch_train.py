"""The port's training path (lightningdot_tpu_torch) against the JAX
package's, on the same inputs.

Inputs come from numpy seeds and go through both packages; on the CPU the
port's ops take their plain twins (the CUDA kernels are held against the
same twins on the card by the ``cuda``-marked test at the end and by
chip_smoke.py). Sizes: the SMALL config of tests/test_train_parity.py
(hidden 32, 2 layers, 4 heads, intermediate 64, vocab 99) and IMG_DIM 16.

Tolerances, each relative to the largest magnitude of the JAX result
unless stated: float32 1e-5 (the same math summed in another order);
bfloat16 2e-2 (a few bf16 ulps: the frameworks round at slightly other
points, e.g. the bf16 dense cotangent; ROADMAP C).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.config import EncoderConfig as JEncoderConfig
from lightningdot_tpu.models.bi_encoder import BiEncoder as JBiEncoder
from lightningdot_tpu.ops import ffn as jffn
from lightningdot_tpu.ops import fused as jfused
from lightningdot_tpu.ops import layernorm as jln
from lightningdot_tpu.training import itm_step as jstep
from lightningdot_tpu.training import optim as joptim
from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.models import (BiEncoder, load_tower_,
                                           tower_state_dict_from_jax)
from lightningdot_tpu_torch.ops import adamw as padamw
from lightningdot_tpu_torch.ops import ffn as pffn
from lightningdot_tpu_torch.ops import ffn_dh1, fused, layernorm
from lightningdot_tpu_torch.training import itm_step, optim

SMALL = dict(vocab_size=99, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=48, type_vocab_size=2)
IMG_DIM = 16
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _rel(got, want) -> float:
    """max |got - want| over max(|want|), as float64 numpy."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    peak = np.abs(want).max()
    err = np.abs(got - want).max()
    return err if peak == 0 else err / peak


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _j(a: np.ndarray, dtype=jnp.float32):
    return jnp.asarray(np.array(a, np.float32)).astype(dtype)


def _t(a: np.ndarray, dtype=torch.float32, grad=False):
    t = torch.from_numpy(np.array(a, np.float32)).to(dtype)
    return t.requires_grad_(grad)


# ---------------------------------------------------------------------------
# dh1: kernel B6's twin
# ---------------------------------------------------------------------------

def _dh1_inputs(rows, h, inter, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((rows, h)).astype(np.float32),
            (rng.standard_normal((rows, inter)) * 2).astype(np.float32),
            (rng.standard_normal((inter, h)) * 0.05).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dh1_twin_matches_jax_ffn_bwd(dtype):
    """The twin against ``_ffn_bwd``'s default branch (ffn.py:236-237)."""
    tdt, jdt, tol = DTYPES[dtype]
    g, h1, w2 = _dh1_inputs(96, 32, 128, seed=1)
    got = ffn_dh1.ffn_dh1(_t(g, tdt), _t(h1, tdt), _t(w2, tdt))
    assert got.dtype == tdt and got.shape == h1.shape
    gj, h1j, w2j = _j(g, jdt), _j(h1, jdt), _j(w2, jdt)
    want = (jffn._dot(gj, w2j.T, jffn._precision(jdt)).astype(jdt)
            * jffn._gelu_grad(h1j))
    assert _rel(_np(got), np.asarray(want, np.float32)) <= tol


def test_dh1_twin_matches_dh1_pallas_interpret(monkeypatch):
    """The twin against the TPU kernel itself in interpret mode, f32, at a
    ragged row count; the kernel's A&S erf polynomial bounds the tolerance
    (tests/test_ffn.py:112)."""
    monkeypatch.setenv("LDOT_FFN_BLOCK", "64")
    from lightningdot_tpu.ops.experimental.ffn_dh1 import dh1_pallas

    g, h1, w2 = _dh1_inputs(130, 64, 256, seed=2)
    got = ffn_dh1.ffn_dh1(_t(g), _t(h1), _t(w2))
    want = dh1_pallas(_j(g), _j(h1), _j(w2), interpret=True)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=3e-5,
                               atol=3e-6)


# ---------------------------------------------------------------------------
# FFN and LayerNorm gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_grads_match_jax(dtype):
    """All five gradients of the FFN (w.r.t. x and the float32 masters)
    against ``jax.vjp`` of ``ffn_gelu``. bfloat16: 2e-2 of each gradient's
    peak (dW1 and dW2 are rounded to bf16 on both sides, after sums of 40
    rows of bf16 products)."""
    tdt, jdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((5, 8, 32)).astype(np.float32)
    w1 = (rng.standard_normal((32, 64)) * 0.2).astype(np.float32)
    b1 = (rng.standard_normal(64) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((64, 32)) * 0.2).astype(np.float32)
    b2 = (rng.standard_normal(32) * 0.1).astype(np.float32)
    g = rng.standard_normal((5, 8, 32)).astype(np.float32)

    def jf(x_, w1_, b1_, w2_, b2_):
        return jffn.ffn_gelu(x_, {"kernel": w1_, "bias": b1_},
                             {"kernel": w2_, "bias": b2_}, jdt)

    out_j, vjp = jax.vjp(jf, *map(_j, (x, w1, b1, w2, b2)))
    grads_j = vjp(_j(g, jdt))

    masters = [_t(a, grad=True) for a in (x, w1, b1, w2, b2)]
    xt, w1t, b1t, w2t, b2t = masters
    out = pffn.ffn_gelu(xt.to(tdt), w1t.to(tdt), b1t, w2t.to(tdt), b2t)
    assert out.dtype == tdt
    out.backward(_t(g, tdt))
    assert _rel(_np(out), np.asarray(out_j, np.float32)) <= tol
    for name, t, want in zip(("x", "w1", "b1", "w2", "b2"), masters,
                             grads_j):
        err = _rel(_np(t.grad), np.asarray(want, np.float32))
        assert err <= tol, f"d{name}: {err}"


@pytest.mark.parametrize("shape", [(3, 7, 32), (5, 768)])
def test_layer_norm_grads_match_jax(shape):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = (rng.random(shape[-1]) + 0.5).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, s, b: jln.layer_norm(a, s, b),
                     _j(x), _j(scale), _j(bias))
    want = vjp(_j(g))
    ins = [_t(a, grad=True) for a in (x, scale, bias)]
    layernorm.layer_norm(*ins).backward(_t(g))
    for t, w in zip(ins, want):
        assert _rel(_np(t.grad), np.asarray(w)) <= 1e-5


# ---------------------------------------------------------------------------
# The fused training compositions, with the JAX-drawn keep mask injected
# ---------------------------------------------------------------------------

def _jax_keep(seed, rate, shape):
    key = jax.random.PRNGKey(seed)
    keydata, impl = jfused.key_data_of(key)
    return key, np.asarray(jfused._keep_mask(keydata, rate, shape, impl))


@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_dropout_add_ln_matches_jax(rate):
    """Forward within 1e-6, gradients within 1e-5 of ``dropout_add_ln``."""
    rng = np.random.default_rng(5)
    x, res, g = (rng.standard_normal((4, 6, 32)).astype(np.float32)
                 for _ in range(3))
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    key, keep = _jax_keep(11, rate, x.shape) if rate else (None, None)

    def jf(x_, res_, scale_, bias_):
        return jfused.dropout_add_ln(x_, res_, scale_, bias_, key,
                                     rate=rate, eps=1e-12)

    out_j, vjp = jax.vjp(jf, *map(_j, (x, res, scale, bias)))
    grads_j = vjp(_j(g))
    ins = [_t(a, grad=True) for a in (x, res, scale, bias)]
    out = fused.dropout_add_ln(
        *ins, None if keep is None else torch.from_numpy(keep), rate=rate,
        eps=1e-12)
    out.backward(_t(g))
    assert _rel(_np(out), np.asarray(out_j)) <= 1e-6
    for t, w in zip(ins, grads_j):
        assert _rel(_np(t.grad), np.asarray(w)) <= 1e-5
    if keep is not None:     # a dropped element passes no gradient
        assert (_np(ins[0].grad)[~keep] == 0).all()


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_prob_dropout_matches_jax(rate):
    b, s, h, d = 2, 6, 4, 8
    rng = np.random.default_rng(6)
    q, k, v, g = (rng.standard_normal((b, s, h, d)).astype(np.float32)
                  for _ in range(4))
    bias = np.zeros((b, 1, 1, s), np.float32)
    bias[0, :, :, 4:] = -10000.0
    key, keep = _jax_keep(13, rate, (b, h, s, s)) if rate else (None, None)

    def jf(q_, k_, v_):
        if key is None:
            return jfused._attn_core(q_, k_, v_, _j(bias),
                                     jnp.ones((b, h, s, s), bool), 0.0,
                                     d ** -0.5, jax.lax.Precision.HIGHEST)
        return jfused.attention_prob_dropout(
            q_, k_, v_, _j(bias), key, rate=rate, scale=d ** -0.5,
            prec=jax.lax.Precision.HIGHEST)

    out_j, vjp = jax.vjp(jf, _j(q), _j(k), _j(v))
    grads_j = vjp(_j(g))
    ins = [_t(a, grad=True) for a in (q, k, v)]
    out = fused.attention_prob_dropout(
        *ins, _t(bias), None if keep is None else torch.from_numpy(keep),
        rate=rate, scale=d ** -0.5)
    out.backward(_t(g))
    assert _rel(_np(out), np.asarray(out_j)) <= 1e-6
    for t, w in zip(ins, grads_j):
        assert _rel(_np(t.grad), np.asarray(w)) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_statistics(dtype):
    """Keep fraction 0.9 +- 0.005 over 1e6 draws; the scale exactly
    1/(1-rate) in the compute dtype; one seed, one mask."""
    tdt = DTYPES[dtype][0]
    rate = 0.1
    keep = fused.keep_mask((1000, 1000), rate,
                           torch.Generator().manual_seed(0))
    assert abs(keep.float().mean().item() - 0.9) <= 0.005
    same = fused.keep_mask((1000, 1000), rate,
                           torch.Generator().manual_seed(0))
    other = fused.keep_mask((1000, 1000), rate,
                            torch.Generator().manual_seed(1))
    assert torch.equal(keep, same) and not torch.equal(keep, other)
    out = fused.apply_keep(torch.ones((1000, 1000), dtype=tdt), keep, rate)
    assert out.dtype == tdt
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=tdt)
    assert torch.equal(out[keep], scale.expand(int(keep.sum())))
    assert (out[~keep] == 0).all()
    want = np.asarray(jnp.asarray(1.0 / (1.0 - rate),
                                  DTYPES[dtype][1]).astype(jnp.float32))
    assert scale.float().item() == float(want)


# ---------------------------------------------------------------------------
# AdamW: the optimizer against JAX's, the kernel's twin against the TPU
# kernel, the decay mask
# ---------------------------------------------------------------------------

def _pair(seed=0, project_dim=24, noise=0.02, dropout=NO_DROPOUT):
    """A JAX BiEncoder with seeded weights (numpy noise on every leaf, so
    biases and LayerNorm affines are not trivial) and the port's BiEncoder
    holding the same weights."""
    kw = dict(SMALL, **dropout, project_dim=project_dim)
    jmodel = JBiEncoder(JEncoderConfig(**kw),
                        JEncoderConfig(**kw, img_dim=IMG_DIM),
                        compute_dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + noise * rng.standard_normal(x.shape)
                   ).astype(np.float32), jmodel.init(jax.random.PRNGKey(seed)))
    model = BiEncoder(EncoderConfig(**kw),
                      EncoderConfig(**kw, img_dim=IMG_DIM))
    load_tower_(model.txt_model, tower_state_dict_from_jax(
        params["txt_model"]))
    load_tower_(model.img_model, tower_state_dict_from_jax(
        params["img_model"]))
    return jmodel, jax.tree.map(jnp.asarray, params), model


def _to_port(tree) -> dict:
    """A JAX {'txt_model', 'img_model'} tree of arrays -> {port name:
    array} (kernels transposed, layers unstacked)."""
    out = {}
    for tower in ("txt_model", "img_model"):
        sd = tower_state_dict_from_jax(jax.tree.map(np.asarray,
                                                    tree[tower]))
        out.update({f"{tower}.{k}": v for k, v in sd.items()})
    return out


def _assert_trees_close(model_values: dict, jax_tree, tol, what,
                        floor=0.0):
    """Every leaf within ``tol`` of max(its own peak, ``floor`` x the
    largest peak of any leaf)."""
    want = _to_port(jax_tree)
    assert set(want) == set(model_values), what
    top = max(np.abs(np.asarray(w, np.float64)).max() for w in want.values())
    worst = max((np.abs(np.asarray(model_values[n], np.float64)
                        - np.asarray(w, np.float64)).max()
                 / max(np.abs(np.asarray(w, np.float64)).max(), floor * top,
                       1e-30), n)
                for n, w in want.items())
    assert worst[0] <= tol, f"{what}: {worst}"


@pytest.mark.parametrize("case", [
    dict(kind="optimizer", first_lr_step=0),
    dict(kind="optimizer", first_lr_step=1),
    dict(kind="fused", first_lr_step=0),
    dict(kind="fused", first_lr_step=1, state_dtype="bfloat16"),
])
def test_adamw_matches_jax_optimizers(case):
    """Five steps of the port's FusedAdamW on the same synthetic gradients
    as JAX's make_optimizer / make_fused_adamw: clip active (norm ~10 >
    0.5), weight decay 0.01 under the decay mask, both schedule
    conventions, a bf16 first moment. float32: every leaf within 1e-6 of
    its peak. A bf16 first moment: the two global norms differ in the last
    bit, so now and then an m that sits within an f32 ulp of a bf16
    rounding boundary rounds the other way (one bf16 ulp, 2**-8 of the
    leaf's peak), and that element's next update moves by ~2**-8 of one
    step (lr / peak ~1e-2): parameters within 2e-4 of their peak."""
    jmodel, params, model = _pair(seed=1)
    sched_kw = dict(weight_decay=0.01, betas=(0.9, 0.98), max_grad_norm=0.5,
                    first_lr_step=case["first_lr_step"])
    state_dtype = case.get("state_dtype")
    if case["kind"] == "optimizer":
        tx = joptim.make_optimizer(joptim.schedule_linear(1e-3, 2, 10),
                                   **sched_kw)
    else:
        tx = joptim.make_fused_adamw(
            joptim.schedule_linear(1e-3, 2, 10), **sched_kw,
            state_dtype=jnp.bfloat16 if state_dtype else None)
    opt = optim.make_fused_adamw(
        model, optim.schedule_linear(1e-3, 2, 10), **sched_kw,
        state_dtype=torch.bfloat16 if state_dtype else torch.float32)
    named = dict(model.named_parameters())
    j_params, j_state = params, tx.init(params)
    rng = np.random.default_rng(7)
    for _ in range(5):
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape) * 0.05,
                                  jnp.float32), params)
        for name, gv in _to_port(grads).items():
            named[name].grad = torch.from_numpy(np.array(gv, np.float32))
        norm = opt.step()
        if case["kind"] == "optimizer":
            import optax
            updates, j_state = tx.update(grads, j_state, j_params)
            j_params = optax.apply_updates(j_params, updates)
            j_norm = joptim.grad_norm_from_opt_state(j_state)
        else:
            j_params, j_state = tx.apply(grads, j_state, j_params)
            j_norm = j_state.grad_norm
        assert _rel(norm.item(), float(j_norm)) <= 1e-6
    _assert_trees_close({n: _np(p) for n, p in named.items()}, j_params,
                        2e-4 if state_dtype else 1e-6, "params after 5 steps")
    if case["kind"] == "fused":
        m = {n: _np(t) for n, t in zip(opt.names, opt.m)}
        _assert_trees_close(m, j_state.mu, 2.0 ** -8 if state_dtype else 1e-6,
                            "first moment")


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_twin_matches_adamw_leaf_pallas(wd):
    """The kernel's twin against the TPU kernel in interpret mode on one
    f32 leaf (its operation order differs in one product: 1e-6)."""
    from lightningdot_tpu.ops.experimental.adamw_pallas import \
        adamw_leaf_pallas

    rng = np.random.default_rng(3)
    shape = (24, 128)
    p, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    m = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    v = (rng.random(shape) * 0.01).astype(np.float32)
    b1, b2, eps = 0.9, 0.98, 1e-8
    lr = np.float32(1e-3)
    step_size = float(lr * np.sqrt(np.float32(1 - b2 ** 3))
                      / np.float32(1 - b1 ** 3))
    scalars = jnp.asarray([0.7, step_size, lr, 0.0], jnp.float32)
    want = adamw_leaf_pallas(*map(_j, (p, g, m, v)), scalars, b1=b1, b2=b2,
                             eps=eps, wd=wd, interpret=True)
    got = padamw._adamw_math(_t(p), _t(g), _t(m), _t(v), torch.tensor(0.7),
                             step_size=step_size, lr=float(lr), b1=b1,
                             b2=b2, eps=eps, wd=wd)
    for a, w in zip(got, want):
        assert _rel(_np(a), np.asarray(w)) <= 1e-6


def test_adamw_in_place_update_matches_twin():
    """``adamw_`` (the CPU branch of the kernel's wrapper) updates every
    tensor in place exactly as the twin computes it, a missing gradient
    counting as zeros, and ``_table`` lays out the kernel's chunks."""
    rng = np.random.default_rng(8)
    shapes = [(3, 5), (70000,), (7,)]
    ps = [_t(rng.standard_normal(s)) for s in shapes]
    gs = [_t(rng.standard_normal(shapes[0])), None,
          _t(rng.standard_normal(shapes[2]))]
    ms = [torch.zeros(s, dtype=torch.bfloat16) for s in shapes]
    vs = [torch.zeros(s) for s in shapes]
    wds = [0.01, 0.0, 0.01]
    kw = dict(step_size=1e-3, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    scale = torch.tensor(0.5)
    want = [padamw._adamw_math(p.clone(), g, m.clone(), v.clone(), scale,
                               wd=wd, **kw)
            for p, g, m, v, wd in zip(ps, gs, ms, vs, wds)]
    padamw.adamw_(ps, gs, ms, vs, wds, scale, **kw)
    for (p2, m2, v2), p, m, v in zip(want, ps, ms, vs):
        assert torch.equal(p, p2) and torch.equal(m, m2)
        assert torch.equal(v, v2)
    table = padamw._table(ps, gs, ms, vs, wds)
    rows = table[:18].reshape(3, 6)
    assert list(rows[:, 4]) == [15, 70000, 7] and rows[1, 1] == 0
    chunks = table[18:].view(np.int32).reshape(-1, 2)
    assert chunks.tolist() == [[0, 0], [1, 0], [1, 1], [1, 2], [2, 0]]


def test_decay_mask_matches_jax():
    """Leaf for leaf through the weight mapping, projection head included."""
    _, params, model = _pair()
    flags = jax.tree.map(lambda flag, p: np.full(p.shape, flag),
                         joptim.decay_mask(params), params)
    want = {n: bool(v.all()) for n, v in _to_port(flags).items()}
    assert all(v.all() or not v.any() for v in _to_port(flags).values())
    assert optim.decay_mask(model) == want
    got = optim.decay_mask(model)
    assert not got["img_model.bert.img_embeddings.img_layer_norm.weight"]
    assert not got["txt_model.encode_proj.2.weight"]
    assert got["txt_model.bert.embeddings.word_embeddings.weight"]


def test_schedule_linear_matches_jax():
    for first in (0, 1):
        jf = joptim.schedule_linear(2e-5, 3, 12)
        pf = optim.schedule_linear(2e-5, 3, 12)
        for step in range(15):
            assert pf(step + first) == float(jf(step + first))


# ---------------------------------------------------------------------------
# The whole ITM step
# ---------------------------------------------------------------------------

def _itm_batch(bs, negs, seed, padded=0):
    """A collated-layout batch: bs positives then bs * negs negatives on
    both sides, ragged text masks; the last ``padded`` items padding."""
    rng = np.random.default_rng(seed)
    n, s, r = bs * (1 + negs), 12, 5
    tmask = np.ones((n, s), np.int32)
    for i in range(n):
        tmask[i, rng.integers(4, s + 1):] = 0
    imask = np.ones((n, 1 + r), np.int32)
    imask[1, 4:] = 0
    return {
        "txts": {"input_ids": rng.integers(1, SMALL["vocab_size"], (n, s)
                                           ).astype(np.int32),
                 "attention_mask": tmask,
                 "position_ids": np.tile(np.arange(s, dtype=np.int32),
                                         (n, 1))},
        "imgs": {"input_ids": np.full((n, 1), 42, np.int32),
                 "attention_mask": imask,
                 "img_feat": rng.standard_normal((n, r, IMG_DIM)).astype(
                     np.float32),
                 "img_pos_feat": rng.random((n, r, 7)).astype(np.float32)},
        "caps": None,
        "valid_mask": (np.arange(bs) < bs - padded).astype(np.float32),
    }


def _jax_batch(batch):
    return {k: (jax.tree.map(jnp.asarray, v) if v is not None else None)
            for k, v in batch.items()}


@pytest.mark.parametrize("negs,padded", [(0, 0), (1, 1)])
def test_itm_step_matches_jax(negs, padded):
    """Dropout off, f32, both towers with a projection head: the loss, acc
    and every gradient leaf of ``itm_loss_fn``; then five steps of
    ``make_itm_train_step`` at the fine-tuning lr of configs/coco_ft.json
    (2e-5; clip, AdamW with decay, linear warmup): the loss curve, grad
    norms and final parameters. All within 1e-5 relative: the curve against
    its peak, every gradient and parameter leaf against the largest
    magnitude in the model's gradients (parameters). Not against each
    leaf's own peak: some leaves' exact gradients cancel (the attention key
    biases to 0, the text projection's last bias to ~1e-6 of the largest
    gradient, as softmax rows sum to 1), so their computed values are
    float32 noise, which Adam normalizes into steps of lr size (ROADMAP
    C)."""
    bs = 4
    jmodel, params, model = _pair(seed=2)
    batch = _itm_batch(bs, negs, seed=20, padded=padded)

    def jloss(p):
        return jstep.itm_loss_fn(jmodel, p, _jax_batch(batch), None,
                                 num_hard_negatives=negs)

    (loss_j, (metrics_j, _)), grads_j = jax.value_and_grad(
        jloss, has_aux=True)(params)
    model.train()
    loss, metrics, _ = itm_step.itm_loss_fn(
        model, itm_step.batch_to_device(batch, torch.device("cpu")),
        num_hard_negatives=negs)
    loss.backward()
    assert _rel(loss.item(), float(loss_j)) <= 1e-5
    assert metrics["acc"].item() == pytest.approx(float(metrics_j["acc"]))
    _assert_trees_close(
        {n: (_np(p.grad) if p.grad is not None else np.zeros(p.shape))
         for n, p in model.named_parameters()}, grads_j, 1e-5, "gradients",
        floor=1.0)

    _, params, model = _pair(seed=2)
    kw = dict(weight_decay=0.01, max_grad_norm=2.0)
    tx = joptim.make_fused_adamw(joptim.schedule_linear(2e-5, 2, 10), **kw)
    jtrain = jax.jit(jstep.make_itm_train_step(jmodel, tx,
                                               num_hard_negatives=negs))
    state = jstep.create_train_state(params, tx)
    model.train()
    step = itm_step.make_itm_train_step(
        model, optim.make_fused_adamw(model, optim.schedule_linear(
            2e-5, 2, 10), **kw), num_hard_negatives=negs, device="cpu")
    batches = [_itm_batch(bs, negs, seed=30 + i, padded=padded)
               for i in range(3)]
    curve, jcurve = [], []
    for i in range(5):
        b = batches[i % 3]
        metrics = step(b)
        state, jm = jtrain(state, _jax_batch(b), jax.random.PRNGKey(0))
        curve.append([metrics["loss"].item(), metrics["grad_norm"].item()])
        jcurve.append([float(jm["loss"]), float(jm["grad_norm"])])
    assert _rel(curve, jcurve) <= 1e-5, (curve, jcurve)
    _assert_trees_close({n: _np(p) for n, p in model.named_parameters()},
                        state.params, 1e-5, "params after 5 steps",
                        floor=1.0)


def test_attention_dropout_model_matches_the_composition(monkeypatch):
    """float32, attention dropout 0.1, hidden dropout 0: the BiEncoder in
    training mode (fused training attention, ops/attention_fused.py) gives
    the loss and every gradient of the same model whose attention is JAX's
    default composition (``fused.attention_prob_dropout``) fed the
    ``philox_keep`` masks of the same seeds, within 1e-5 of the largest
    gradient; and another step seed gives another loss."""
    from lightningdot_tpu_torch.models import encoder
    from lightningdot_tpu_torch.ops import attention_fused

    dropout = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.1)
    batch = itm_step.batch_to_device(_itm_batch(4, 0, seed=60),
                                     torch.device("cpu"))

    def run(seed):
        _, _, model = _pair(seed=5, dropout=dropout)
        model.train()
        gens = [torch.Generator().manual_seed(seed + i) for i in range(3)]
        loss = itm_step.itm_loss_fn(model, batch, gens)[0]
        loss.backward()
        return loss.item(), {n: _np(p.grad) for n, p in
                             model.named_parameters() if p.grad is not None}

    loss, grads = run(70)
    calls = []

    def composed(q, k, v, bias2d, seed, *, nh, rate):
        calls.append(seed)
        b, s, w = q.shape
        keep = attention_fused.philox_keep(seed, b, nh, s, s, rate)
        heads = [t.view(b, s, nh, w // nh) for t in (q, k, v)]
        return fused.attention_prob_dropout(
            *heads, bias2d[:, None, None, :], keep, rate=rate,
            scale=(w // nh) ** -0.5).reshape(b, s, w)

    monkeypatch.setattr(encoder, "fused_attention_train", composed)
    want_loss, want = run(70)
    assert len(calls) == 2 * SMALL["num_hidden_layers"]
    assert len({int(s) for s in calls}) == len(calls)
    assert _rel(loss, want_loss) <= 1e-5
    assert set(grads) == set(want)
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        assert np.abs(grads[name] - w).max() <= 1e-5 * top, name
    monkeypatch.undo()
    assert run(71)[0] != loss


def test_train_step_seeds_and_kd():
    """With dropout on, one generator seed gives one step and another seed
    another; a KD term (``kd_fn``) is called on the device batch and the
    embeddings, and joins the loss times ``kd_loss_weight``."""
    dropout = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)

    def run(seed):
        _, _, model = _pair(seed=3, dropout=dropout)
        model.train()
        step = itm_step.make_itm_train_step(
            model, optim.make_fused_adamw(model, 1e-3), device="cpu")
        loss = step(_itm_batch(4, 0, seed=40),
                    torch.Generator().manual_seed(seed))["loss"].item()
        return loss, _np(model.txt_model.encode_proj[3].weight)

    (l0, p0), (l0b, p0b), (l1, p1) = run(0), run(0), run(1)
    assert l0 == l0b and np.array_equal(p0, p0b)
    assert l0 != l1 and not np.array_equal(p0, p1)
    seen = []

    def kd_fn(batch, embs):
        seen.append((sorted(batch), [e is None for e in embs]))
        return embs[0].float().pow(2).mean()

    losses = []
    for kd, weight in ((None, 1.0), (kd_fn, 0.5)):
        _, _, model = _pair(seed=3)
        step = itm_step.make_itm_train_step(
            model, optim.make_fused_adamw(model, 1.0), kd_fn=kd,
            kd_loss_weight=weight, device="cpu")
        losses.append(step(_itm_batch(4, 0, seed=41)))
    base, with_kd = losses
    assert seen == [(["caps", "imgs", "teacher", "txts", "valid_mask"],
                     [False, False, True])]
    assert "kd_loss" in with_kd and "kd_loss" not in base
    assert with_kd["loss"].item() == pytest.approx(
        base["loss"].item() + 0.5 * with_kd["kd_loss"].item(), rel=1e-6)
    _, _, model = _pair(seed=3, dropout=dropout)
    model.train()
    with pytest.raises(ValueError, match="Generator"):
        model.encode_txt({k: torch.from_numpy(v) for k, v in
                          _itm_batch(2, 0, seed=1)["txts"].items()})


def test_eval_after_step_serves_new_weights():
    """After an optimizer step, the eval-mode text tower (its cached bf16
    casts warmed before the step) equals a fresh model loaded with the
    updated state dict: the step moves the parameters' version counters."""
    _, _, model = _pair(seed=4)
    model.compute_dtype = torch.bfloat16
    txts = {k: torch.from_numpy(v.astype(np.int64)) for k, v in
            _itm_batch(4, 0, seed=50)["txts"].items()}
    with torch.no_grad():
        before = model.encode_txt(txts)
    versions = [p._version for p in model.parameters()]
    model.train()
    step = itm_step.make_itm_train_step(
        model, optim.make_fused_adamw(model, 1e-2), device="cpu")
    step(_itm_batch(4, 0, seed=51))
    assert all(p._version > v for p, v in zip(model.parameters(), versions))
    model.eval()
    fresh = BiEncoder(model.txt_cfg, model.img_cfg,
                      compute_dtype=torch.bfloat16)
    fresh.load_state_dict(model.state_dict())
    with torch.no_grad():
        after = model.encode_txt(txts)
        want = fresh.encode_txt(txts)
    assert torch.equal(after, want) and not torch.equal(after, before)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_training_kernels_match_twins_on_card(dtype):
    """dh1 within the kernels' tolerance of its twin, the FFN's h1 and
    gelu(h1) outputs equal to the twin's, AdamW bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    tdt, _, _ = DTYPES[dtype]
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}[tdt]
    dev = torch.device("cuda")
    g, h1, w2 = (torch.from_numpy(a).to(dev).to(tdt)
                 for a in _dh1_inputs(300, 768, 3072, seed=9))
    got = ffn_dh1.ffn_dh1(g, h1, w2)
    want = ffn_dh1._dh1_math(g, h1, w2)
    assert _rel(_np(got.cpu()), _np(want.cpu())) <= tol
    x = g[:, :768].contiguous()
    w1 = w2.t().contiguous()
    b1 = torch.zeros(3072, device=dev)
    b2 = torch.zeros(768, device=dev)
    _, h1k, interk = pffn.ffn_cuda(x, w1, b1, w2, b2, with_h1=True)
    _, h1t = pffn._ffn_math(x, w1, b1, w2, b2)
    assert _rel(_np(h1k.cpu()), _np(h1t.cpu())) <= tol
    assert torch.equal(interk, pffn.gelu(h1k))
    ps = [torch.randn(s, device=dev) for s in ((768, 3072), (5,))]
    gs = [torch.randn_like(p) for p in ps]
    ms = [torch.zeros_like(p, dtype=tdt) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    scale = torch.tensor(0.5, device=dev)
    kw = dict(step_size=1e-3, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    want = [padamw._adamw_math(p.clone(), gg, m.clone(), v.clone(), scale,
                               wd=0.01, **kw)
            for p, gg, m, v in zip(ps, gs, ms, vs)]
    padamw.adamw_cuda(ps, gs, ms, vs, [0.01, 0.01], scale, **kw)
    torch.cuda.synchronize()
    for (p2, m2, v2), p, m, v in zip(want, ps, ms, vs):
        assert torch.equal(p, p2) and torch.equal(m, m2)
        assert torch.equal(v, v2)
