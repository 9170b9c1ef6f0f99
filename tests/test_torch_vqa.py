"""The port's VQA model, step and data path (lightningdot_tpu_torch:
models/vqa.py, training/vqa_step.py, data/vqa.py, B1's twin at the head's
widths) against the JAX package on the same inputs.

Sizes: tests/test_torch_train.py's SMALL towers (hidden 32, 2 layers,
projection 24) and 7 answers; the data cases are tests/test_vqa.py's (8
synthetic images x 2 questions, 12 answers), over DBs written by the
port's ``synth.py``. Tolerances: float32 within 1e-5 of the largest
magnitude (the same math summed in another order); the LayerNorm twin at
3,072 and 6,144 within 1e-6 forward and 1e-5 gradients in float32, one
bf16 ulp in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightningdot_tpu.data import vqa as jvqa
from lightningdot_tpu.data.feat_db import DetectFeatDb as JDetectFeatDb
from lightningdot_tpu.data.txt_db import TxtTokDb as JTxtTokDb
from lightningdot_tpu.models.vqa import BiEncoderForVQA as JBiEncoderForVQA
from lightningdot_tpu.ops import layernorm as jln
from lightningdot_tpu.training import optim as joptim
from lightningdot_tpu.training import vqa_step as jvqa_step
from lightningdot_tpu_torch.data import vqa
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.synth import make_synth_dataset
from lightningdot_tpu_torch.data.txt_db import TxtTokDb
from lightningdot_tpu_torch.models.vqa import BiEncoderForVQA
from lightningdot_tpu_torch.models.weights import vqa_state_dict_from_jax
from lightningdot_tpu_torch.ops import layernorm
from lightningdot_tpu_torch.training import checkpoints, optim, vqa_step

N_ANSWERS = 12
TOL = 1e-5


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("vqa")
    return make_synth_dataset(
        str(root), n_imgs=8, txts_per_img=2, img_dim=32, min_bb=5,
        max_bb=10, max_txt_len=20, seed=3, vqa_answers=N_ANSWERS)


@pytest.fixture(scope="module")
def dbs(synth):
    txt_dir, img_dir = synth
    return (TxtTokDb(txt_dir, -1),
            DetectFeatDb(img_dir, conf_th=0.2, max_bb=10, min_bb=5,
                         num_bb=10))


# ---------------------------------------------------------------------------
# B1's twin at the head's widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hidden", [3072, 6144])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_at_the_head_widths_matches_jax(hidden, dtype):
    """``layer_norm`` at 3,072 and 6,144 (the VQA head, plain and
    intersection) against JAX's, forward and VJP."""
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "float32"
                else (torch.bfloat16, jnp.bfloat16))
    rng = np.random.default_rng(hidden)
    x = (rng.standard_normal((5, hidden)) * 3 + 1).astype(np.float32)
    s = (rng.random(hidden) + 0.5).astype(np.float32)
    b = rng.standard_normal(hidden).astype(np.float32)
    g = rng.standard_normal((5, hidden)).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)
    out, vjp = jax.vjp(lambda a, c, d: jln.layer_norm(a, c, d), xj,
                       jnp.asarray(s), jnp.asarray(b))
    grads = vjp(jnp.asarray(g).astype(jdt))
    ins = [torch.from_numpy(x).to(tdt).requires_grad_(),
           torch.from_numpy(s).requires_grad_(),
           torch.from_numpy(b).requires_grad_()]
    y = layernorm.layer_norm(*ins)
    y.backward(torch.from_numpy(g).to(tdt))
    got = [y] + [t.grad for t in ins]
    want = [out] + list(grads)
    for i, (a, w) in enumerate(zip(got, want)):
        a = a.detach().float().numpy().astype(np.float64)
        w = np.asarray(w, np.float64)
        peak = max(1.0, np.abs(w).max())
        if dtype == "float32":
            tol = 1e-6 if i == 0 else 1e-5
        else:   # one bf16 ulp of the peak; the f32 parameter sums in f32
            tol = 2.0 ** -7 if i < 2 else 1e-5
        assert np.abs(a - w).max() <= tol * peak, (i, np.abs(a - w).max())


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _vqa_pair(intersection, seed=4):
    """The JAX VQA model on test_torch_train's towers (noise 0.02 on every
    leaf, so that the head's affines are not trivial), and the port's with
    the same weights through ``vqa_state_dict_from_jax``."""
    from test_torch_train import _pair

    jbi, bi_params, bi = _pair(seed=seed)
    jmodel = JBiEncoderForVQA(bi_encoder=jbi, hidden_size=jbi.txt_cfg.out_size,
                              num_answer=7, intersection=intersection)
    rng = np.random.default_rng(seed + 1)
    head = jax.tree.map(
        lambda x: (np.asarray(x) + 0.02 * rng.standard_normal(x.shape)
                   ).astype(np.float32),
        jmodel.init(jax.random.PRNGKey(seed))["vqa_output"])
    params = {"biencoder": bi_params,
              "vqa_output": jax.tree.map(jnp.asarray, head)}
    model = BiEncoderForVQA(bi, bi.txt_cfg.out_size, 7,
                            intersection=intersection)
    checkpoints.load_state_dict_strict(model, vqa_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    return jmodel, params, model


def _vqa_batch(bs=4, padded=1, seed=60):
    from test_torch_train import _itm_batch

    batch = _itm_batch(bs, 0, seed, padded=padded)
    rng = np.random.default_rng(seed + 1)
    batch["targets"] = (rng.random((bs, 7)) < 0.3).astype(np.float32) * \
        rng.integers(1, 4, (bs, 7)) / 3.0
    return batch


def _jax_batch(batch):
    return jax.tree.map(jnp.asarray, {k: v for k, v in batch.items()
                                      if v is not None})


@pytest.mark.parametrize("intersection", [False, True])
def test_vqa_model_matches_jax(intersection):
    """``BiEncoderForVQA.apply`` (scores and the elementwise BCE) and the
    masked instance-level loss with its gradient, every leaf, within 1e-5
    of the largest magnitude."""
    jmodel, params, model = _vqa_pair(intersection)
    batch = _vqa_batch()
    jb = _jax_batch(batch)
    want_scores = jmodel.apply(params, jb, compute_loss=False)
    want_elem = jmodel.apply(params, jb, targets=jb["targets"])
    tb = vqa_step.vqa_batch_to_device(batch, torch.device("cpu"))
    with torch.no_grad():
        got_scores = model.apply(tb)
        got_elem = model.apply(tb, targets=tb["targets"], compute_loss=True)
    for got, want in ((got_scores, want_scores), (got_elem, want_elem)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= TOL * np.abs(want).max()

    (jloss, jmetrics), jgrads = jax.value_and_grad(
        lambda p: jvqa_step.vqa_loss_fn(jmodel, p, jb, None,
                                        deterministic=True),
        has_aux=True)(params)
    loss, metrics = vqa_step.vqa_loss_fn(model, tb)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= TOL * abs(float(jloss))
    assert float(metrics["score"]) == pytest.approx(float(jmetrics["score"]),
                                                    abs=1e-6)
    want = vqa_state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    got = {n: (np.zeros(p.shape, np.float32) if p.grad is None
               else p.grad.numpy()) for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    worst = max((np.abs(got[n] - w).max() / top, n) for n, w in want.items())
    assert worst[0] <= TOL, worst


def test_vqa_score_takes_jax_argmax():
    scores = np.array([[0.1, 0.7, 0.7], [2.0, -1.0, 0.5]], np.float32)
    targets = np.array([[0.3, 0.6, 1.0], [0.9, 0.0, 0.0]], np.float32)
    got = vqa_step.vqa_score(torch.from_numpy(scores),
                             torch.from_numpy(targets))
    want = jvqa_step.vqa_score(jnp.asarray(scores), jnp.asarray(targets))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_init_vqa_head_draws_as_jax_does():
    """Init scale and layout (JAX's numbers differ: another generator)."""
    from lightningdot_tpu_torch.models.vqa import init_vqa_head_

    _, _, model = _vqa_pair(True)
    init_vqa_head_(model, torch.Generator().manual_seed(0))
    head = model.vqa_output
    assert head["0"].weight.shape == (8 * 24, 4 * 24)
    assert head["3"].weight.shape == (7, 8 * 24)
    for name in ("0", "3"):
        assert abs(head[name].weight.detach().std().item() - 0.02) < 2e-3
        assert not head[name].bias.any()
    assert bool((head["2"].weight == 1).all()) and not head["2"].bias.any()


# ---------------------------------------------------------------------------
# the optimizer: a learning-rate factor for the head
# ---------------------------------------------------------------------------

class _Grouped(torch.nn.Module):
    def __init__(self, rng):
        super().__init__()
        self.body = torch.nn.Module()
        self.body.w = torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal(6).astype(np.float32)))
        self.body.bias = torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal(3).astype(np.float32)))
        self.vqa_output = torch.nn.Module()
        self.vqa_output.kernel = torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal(5).astype(np.float32)))
        self.vqa_output.bias = torch.nn.Parameter(torch.from_numpy(
            rng.standard_normal(2).astype(np.float32)))


def test_lr_mul_matches_optax_multi_transform():
    """``FusedAdamW(lr_mul={"vqa_output.": 10})`` against the JAX VQA
    driver's chain: one global clip, then ``optax.multi_transform`` of two
    reference AdamWs, the head's at 10x the learning rate (its step and
    its decay), over five steps of a warmup-decay schedule."""
    rng = np.random.default_rng(0)
    model = _Grouped(rng)
    params = {"body": {"w": model.body.w, "bias": model.body.bias},
              "vqa_output": {"kernel": model.vqa_output.kernel,
                             "bias": model.vqa_output.bias}}
    params = jax.tree.map(lambda t: jnp.asarray(t.detach().numpy()), params)
    kw = dict(betas=(0.9, 0.98), adam_eps=1e-6, weight_decay=0.01,
              first_lr_step=1)
    tx = optax.chain(
        joptim.clip_by_global_norm_with_norm(1.0),
        optax.multi_transform(
            {"body": joptim.make_optimizer(
                joptim.schedule_linear(1e-2, 2, 8), **kw),
             "head": joptim.make_optimizer(
                 joptim.schedule_linear(1e-2 * 10, 2, 8), **kw)},
            lambda p: {k: ("head" if k == "vqa_output" else "body")
                       for k in p}))
    state = tx.init(params)
    opt = optim.make_optimizer(model, optim.schedule_linear(1e-2, 2, 8),
                               max_grad_norm=1.0,
                               lr_mul={"vqa_output.": 10.0}, **kw)
    for step in range(5):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rng.standard_normal(p.shape)
                                  .astype(np.float32)), params)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for mod, leaves in (("body", grads["body"]),
                            ("vqa_output", grads["vqa_output"])):
            for name, g in leaves.items():
                getattr(getattr(model, mod), name).grad = torch.from_numpy(
                    np.array(g))
        opt.step()
        for mod in ("body", "vqa_output"):
            for name, want in params[mod].items():
                got = getattr(getattr(model, mod), name).detach().numpy()
                np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                           atol=1e-6, err_msg=(step, name))
    assert opt.lr_muls == [1.0, 1.0, 10.0, 10.0]


# ---------------------------------------------------------------------------
# data (tests/test_vqa.py's cases)
# ---------------------------------------------------------------------------

def test_vqa_target_matches_jax_and_torch_scatter():
    ex = {"target": {"labels": [3, 7, 1], "scores": [0.9, 0.3, 1.0]}}
    ours = vqa.vqa_target(ex, N_ANSWERS)
    ref = torch.zeros(N_ANSWERS)
    ref.scatter_(0, torch.tensor(ex["target"]["labels"]),
                 torch.tensor(ex["target"]["scores"]))
    np.testing.assert_allclose(ours, ref.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(ours, jvqa.vqa_target(ex, N_ANSWERS))
    assert vqa.vqa_target({}, N_ANSWERS).sum() == 0
    assert vqa.vqa_target({"target": {"labels": [], "scores": []}},
                          N_ANSWERS).sum() == 0


def _jax_dbs(synth):
    txt_dir, img_dir = synth
    return (JTxtTokDb(txt_dir, -1),
            JDetectFeatDb(img_dir, conf_th=0.2, max_bb=10, min_bb=5,
                          num_bb=10))


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _assert_batches_equal(g, w)
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=k)
            assert g.dtype == w.dtype, k
        else:
            assert g == w, k


def test_vqa_collate_matches_jax(dbs, synth):
    """Bucketed shapes, fixed-batch padding (pad rows repeat the last
    item), targets, ``n_valid`` and ``valid_mask``: equal to JAX's batch,
    array for array, over the same DBs."""
    txt_db, img_db = dbs
    ds = vqa.VqaDataset(N_ANSWERS, txt_db, img_db)
    jds = jvqa.VqaDataset(N_ANSWERS, *_jax_dbs(synth))
    assert len(ds) == 16 and ds.lens == jds.lens
    items = [ds[i] for i in range(6)]
    batch = vqa.vqa_collate(items, vqa.VqaCollateConfig(fixed_batch=8))
    assert batch["txts"]["input_ids"].shape == (8, 32)
    assert batch["imgs"]["img_feat"].shape == (8, 31, 32)
    assert batch["imgs"]["attention_mask"].shape == (8, 32)
    assert batch["targets"].shape == (8, N_ANSWERS)
    assert batch["n_valid"] == 6 and len(batch["qids"]) == 6
    np.testing.assert_array_equal(batch["valid_mask"],
                                  [1, 1, 1, 1, 1, 1, 0, 0])
    np.testing.assert_array_equal(batch["targets"][7], batch["targets"][5])
    want = jvqa.vqa_collate([jds[i] for i in range(6)],
                            jvqa.VqaCollateConfig(fixed_batch=8))
    _assert_batches_equal(batch, want)


def test_vqa_eval_collate_matches_jax(dbs, synth):
    txt_db, img_db = dbs
    ds = vqa.VqaEvalDataset(N_ANSWERS, txt_db, img_db)
    jds = jvqa.VqaEvalDataset(N_ANSWERS, *_jax_dbs(synth))
    items = [ds[i] for i in range(4)]
    batch = vqa.vqa_eval_collate(items)
    L, R = batch["input_ids"].shape[1], batch["img_feat"].shape[1]
    assert batch["attn_masks_text"].shape == (4, L)
    assert batch["attn_masks_img"].shape == (4, R)
    assert batch["targets"].shape == (4, N_ANSWERS)
    _assert_batches_equal(batch, jvqa.vqa_eval_collate(
        [jds[i] for i in range(4)]))
    for it in items:
        it["has_target"] = False
    assert vqa.vqa_eval_collate(items)["targets"] is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_kernels_match_twins_on_card(dtype):
    """B1's forward and backward at the head's widths (64 and a ragged 37
    rows of 3,072 and 6,144) within a bf16 ulp (float32: 1e-5) of their
    twins, dscale/dbias within 1e-5 relative; AdamW with a learning-rate
    factor bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from lightningdot_tpu_torch.ops import adamw

    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}[tdt]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows, h in ((64, 3072), (37, 6144)):
        x = (torch.randn(rows, h, device=dev, generator=gen) * 3 + 1).to(tdt)
        g = torch.randn(rows, h, device=dev, generator=gen).to(tdt)
        s = torch.rand(h, device=dev, generator=gen) + 0.5
        b = torch.randn(h, device=dev, generator=gen)
        got = layernorm.layer_norm_cuda(x, s, b, 1e-12)
        want = layernorm.ln_fwd_math(x, s, b, 1e-12)
        peak = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * peak
        got = layernorm.layer_norm_bwd_cuda(x, s, g, 1e-12)
        want = layernorm.ln_bwd_math(x, s, g, 1e-12)
        peak = max(1.0, want[0].float().abs().max().item())
        assert (got[0].float() - want[0].float()).abs().max().item() \
            <= tol * peak
        for a, w in zip(got[2:], want[2:]):
            assert (a - w).abs().max().item() <= 1e-5 * w.abs().max().item()
    ps = [torch.randn(s, device=dev) for s in ((300, 7), (5,))]
    gs = [torch.randn_like(p) for p in ps]
    ms = [torch.zeros_like(p, dtype=tdt) for p in ps]
    vs = [torch.zeros_like(p) for p in ps]
    scale = torch.tensor(0.5, device=dev)
    kw = dict(step_size=1e-3, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    want = [adamw._adamw_math(p.clone(), gg, m.clone(), v.clone(), scale,
                              wd=0.01, lr_mul=mul, **kw)
            for p, gg, m, v, mul in zip(ps, gs, ms, vs, (1.0, 10.0))]
    adamw.adamw_(ps, gs, ms, vs, [0.01, 0.01], scale, lr_muls=[1.0, 10.0],
                 **kw)
    for trio, p, m, v in zip(want, ps, ms, vs):
        assert all(torch.equal(a, b) for a, b in zip(trio, (p, m, v)))
