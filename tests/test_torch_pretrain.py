"""The port's pre-training (``lightningdot_tpu_torch.cli.pretrain`` and what
it is built of: the datasets and collates, ``MetaLoader``, the heads of
``BiEncoderForPretraining``, the step and the schedules) against the JAX
package on the same inputs.

Sizes: the JAX e2e tests' tiny config (tests/test_pretrain_e2e.py:
hidden 32, 2 layers, 4 heads, intermediate 64, img_dim 32, vocab 28,996,
7 soft-label classes) over ``make_synth_dataset`` DBs of 8 images x 2
captions. float32 throughout. Tolerances: losses within 1e-5 relative;
every gradient and parameter leaf within 1e-5 of the largest magnitude in
the model's gradients (parameters), as tests/test_torch_train.py holds the
ITM step (leaves whose exact gradient cancels are float32 noise);
datasets, collates and task order equal.
"""
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.config import EncoderConfig as JCfg
from lightningdot_tpu.data import feat_db as jfeat_db
from lightningdot_tpu.data import loader as jloader
from lightningdot_tpu.data import pretrain as jpre
from lightningdot_tpu.data import txt_db as jtxt_db
from lightningdot_tpu.data.synth import make_synth_dataset
from lightningdot_tpu.models import bi_encoder as jbi
from lightningdot_tpu.models.checkpoint_torch import (load_torch_state_dict,
                                                      map_pretrain_model)
from lightningdot_tpu.training import optim as joptim
from lightningdot_tpu.training import pretrain_step as jstep
from lightningdot_tpu_torch.cli import pretrain as cli
from lightningdot_tpu_torch.config import EncoderConfig, parse_with_config
from lightningdot_tpu_torch.data import feat_db, loader, txt_db
from lightningdot_tpu_torch.data import pretrain as pre
from lightningdot_tpu_torch.models.bi_encoder import (BiEncoder,
                                                      BiEncoderForPretraining,
                                                      mrc_loss_from_logits)
from lightningdot_tpu_torch.models.weights import (pretrain_keys,
                                                   pretrain_state_dict_from_jax)
from lightningdot_tpu_torch.training import checkpoints, optim
from lightningdot_tpu_torch.training import pretrain_step as step_mod
from lightningdot_tpu_torch.utils.runtime import step_generator

SMALL = {"vocab_size": 28996, "hidden_size": 32, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 64,
         "max_position_embeddings": 64, "img_dim": 32,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
N_LABELS = 7
CFG = dict(txt_buckets=(16, 32), img_buckets=(16,), batch_pad=4,
           img_label_dim=N_LABELS)
TASKS = ("mlm", "mrfr", "mrckl", "mrc", "itm")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("pre")
    return make_synth_dataset(
        str(root), n_imgs=8, txts_per_img=2, img_dim=32, min_bb=5,
        max_bb=12, max_txt_len=20, with_soft_labels=True,
        n_labels=N_LABELS, seed=2)


def _dbs(synth, jax_side):
    txt_dir, img_dir = synth
    t, f = (jtxt_db, jfeat_db) if jax_side else (txt_db, feat_db)
    return (t.TxtTokDb(txt_dir, max_txt_len=-1),
            f.DetectFeatDb(img_dir, conf_th=0.2, max_bb=12, min_bb=5))


def _dataset(mod, task, tdb, idb):
    if task == "mlm":
        return mod.MlmDataset(tdb, idb, seed=0)
    if task == "mrfr":
        return mod.MrfrDataset(0.3, tdb, idb, seed=0)
    if task.startswith("mrc"):
        return mod.MrcDataset(0.3, tdb, idb, seed=0)
    return mod.ItmPreDataset(tdb, idb, neg_sample_p=0.5, seed=0)


def _collate(mod, task):
    fn = {"mlm": mod.mlm_collate, "mrfr": mod.mrfr_collate,
          "itm": mod.itm_pre_collate}.get(task, mod.mrc_collate)
    cfg = mod.PretrainCollateConfig(**CFG)
    return lambda items: fn(items, cfg)


def _assert_same(got, want, path="batch"):
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert got == want, path


def test_random_word_copy_matches_jax():
    for seed in range(5):
        tokens = list(range(200, 230))
        assert (pre.random_word(tokens, (106, 999), 103, random.Random(seed))
                == jpre.random_word(tokens, (106, 999), 103,
                                    random.Random(seed)))


@pytest.mark.parametrize("task", ["mlm", "mrfr", "mrc", "itm"])
def test_datasets_and_collates_match_jax(synth, task):
    """Each dataset's items and each collate's batch, the port's against
    JAX's on the same DBs and seeds, over two epochs of masks."""
    ds = _dataset(pre, task, *_dbs(synth, False))
    jds = _dataset(jpre, task, *_dbs(synth, True))
    assert ds.lens == jds.lens
    for _ in range(2):
        items = [ds[i] for i in range(len(ds))]
        jitems = [jds[i] for i in range(len(jds))]
        for got, want in zip(items, jitems):
            _assert_same(got, want, task)
        for lo in (0, 6):
            _assert_same(_collate(pre, task)(items[lo:lo + 6]),
                         _collate(jpre, task)(jitems[lo:lo + 6]), task)
        for d in (ds, jds):
            d.advance_epoch()
            if task == "itm":
                d.new_epoch()


def test_meta_loader_matches_jax():
    """The task sequence at one seed, per accumulation window, through
    exhausted loaders, and after ``fast_forward``."""
    loaders = {"a": ([1, 2, 3], 3), "b": ([10, 20], 1), "c": [7]}
    for accum in (1, 3):
        got = loader.MetaLoader(loaders, accum_steps=accum, seed=5)
        want = jloader.MetaLoader(loaders, accum_steps=accum, seed=5)
        g, w = iter(got), iter(want)
        assert [next(g) for _ in range(40)] == [next(w) for _ in range(40)]
        got = loader.MetaLoader(loaders, accum_steps=accum, seed=5)
        want = jloader.MetaLoader(loaders, accum_steps=accum, seed=5)
        got.fast_forward(9)
        want.fast_forward(9)
        g, w = iter(got), iter(want)
        assert [next(g)[0] for _ in range(12)] == [next(w)[0]
                                                    for _ in range(12)]
    with pytest.raises(ValueError, match="yielded no batches"):
        next(iter(loader.MetaLoader({"e": []})))


# ---------------------------------------------------------------------------
# the heads and the step against JAX
# ---------------------------------------------------------------------------

def _pair(seed=0, cls_concat=""):
    """A JAX BiEncoderForPretraining with noise of std 0.2 on every leaf,
    and the port's model holding the same weights."""
    jmodel = jbi.BiEncoderForPretraining(
        jbi.BiEncoder(JCfg(**SMALL), JCfg(**SMALL),
                      compute_dtype=jnp.float32),
        cls_concat=cls_concat, img_label_dim=N_LABELS)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape)
                   ).astype(np.float32), jmodel.init(jax.random.PRNGKey(seed)))
    model = BiEncoderForPretraining(
        BiEncoder(EncoderConfig(**SMALL), EncoderConfig(**SMALL)),
        cls_concat=cls_concat, img_label_dim=N_LABELS)
    checkpoints.load_state_dict_strict(model,
                                       pretrain_state_dict_from_jax(params))
    return jmodel, jax.tree.map(jnp.asarray, params), model


def _batch(synth, task, lo=0):
    ds = _dataset(pre, task, *_dbs(synth, False))
    return _collate(pre, task)([ds[i] for i in range(lo, lo + 6)])


def _jax_batch(batch):
    return {k: jax.tree.map(jnp.asarray, v) for k, v in batch.items()
            if k not in ("n_valid", "sample_size") and v is not None}


def _worst(got: dict, jax_tree, floor=1.0):
    """Worst leaf error over max(its own peak, floor x the largest peak)."""
    want = pretrain_state_dict_from_jax(jax.tree.map(np.asarray, jax_tree))
    assert got.keys() == want.keys()
    top = max(np.abs(w).max() for w in want.values())
    return max((np.abs(got[k] - w).max()
                / max(np.abs(w).max(), floor * top, 1e-30), k)
               for k, w in want.items())


def _grads(model):
    return {n: (p.grad.numpy() if p.grad is not None
                else np.zeros(tuple(p.shape), np.float32))
            for n, p in model.named_parameters()}


@pytest.mark.parametrize("task", TASKS)
def test_heads_match_jax_in_value_and_gradient(synth, task):
    """MLM (decoder tied to the image tower's word table), MRFR (tied to
    img_linear), MRC-kl, hard MRC and ITM: ``task_loss`` and every
    gradient leaf, the tied weights' summed gradients included."""
    jmodel, params, model = _pair(seed=1, cls_concat="add")
    batch = _batch(synth, task)
    jtask = "mrc" if task == "mrc" else task

    def jloss(p):
        return jstep.task_loss(jmodel, p, _jax_batch(batch), jtask, None,
                               deterministic=True)

    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    loss, metrics, _ = step_mod.task_loss(
        model, step_mod.pretrain_batch_to_device(batch, torch.device("cpu")),
        task)
    loss.backward()
    assert abs(loss.item() - float(loss_j)) <= 1e-5 * abs(float(loss_j))
    if "acc" in metrics_j:
        assert metrics["acc"].item() == pytest.approx(
            float(metrics_j["acc"]), abs=1e-6)
    worst = _worst(_grads(model), grads_j)
    assert worst[0] <= 1e-5, worst
    tied = model.bert.img_model.bert.embeddings.word_embeddings.weight
    assert tied.grad is not None or task != "mlm"


def test_mrc_kl_gradient_is_finite_where_targets_are_zero():
    """The log is taken of the clamped targets: zeros in the soft labels
    put no NaN into the gradient (``torch.where`` over log(0) would)."""
    logits = torch.randn(2, 3, 5, requires_grad=True)
    targets = torch.tensor([0.0, 0.5, 0.0, 0.5, 0.0]).expand(2, 3, 5)
    loss = mrc_loss_from_logits(logits, targets, "mrckl")
    loss.sum().backward()
    assert torch.isfinite(loss).all() and torch.isfinite(logits.grad).all()
    want = jbi.mrc_loss_from_logits(jnp.asarray(logits.detach().numpy()),
                                    jnp.asarray(targets.numpy()), "mrckl")
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(want),
                               atol=1e-6)


def _optimizers(model):
    kw = dict(betas=(0.9, 0.98), adam_eps=1e-6, weight_decay=0.01,
              max_grad_norm=5.0, first_lr_step=1)
    lr = dict(decay="linear", learning_rate=5e-5, warmup_steps=10,
              num_train_steps=100)
    return (optim.make_optimizer(model, optim.get_lr_sched(**lr), **kw),
            joptim.make_optimizer(joptim.get_lr_sched(**lr), **kw))


@pytest.mark.parametrize("task,accum", [(t, 1) for t in TASKS]
                         + [("itm", 2)])
def test_pretrain_step_matches_jax(synth, task, accum):
    """One update of ``make_pretrain_step`` (pretrain.py's optimizer:
    betas (0.9, 0.98), eps 1e-6, decay 0.01, clip 5, first_lr_step 1), the
    port's against JAX's, over ``accum`` micro-batches: losses and every
    parameter leaf."""
    jmodel, params, model = _pair(seed=2)
    opt, tx = _optimizers(model)
    model.train()
    step = step_mod.make_pretrain_step(model, opt, accum_steps=accum,
                                       device="cpu")(task)
    init, step_for_task = jstep.make_pretrain_step(jmodel, tx,
                                                   accum_steps=accum)
    state = init(params)
    for i in range(accum):
        batch = _batch(synth, task, lo=6 * i)
        metrics = step(batch)
        state, jm = step_for_task(task)(state, _jax_batch(batch),
                                        jax.random.PRNGKey(0))
        assert abs(metrics["loss"].item() - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"]))
    assert opt.count == 1 and int(state.step) == accum
    worst = _worst({n: p.detach().numpy()
                    for n, p in model.named_parameters()}, state.params)
    assert worst[0] <= 1e-5, worst


def test_validate_fn_runs_without_dropout_and_keeps_the_mode(synth):
    _, _, model = _pair(seed=3)
    model.train()
    validate = step_mod.make_validate_fn(model, device="cpu")
    batch = _batch(synth, "mlm")
    first = validate(batch, "mlm")
    assert model.training
    assert validate(batch, "mlm")["loss"].item() == first["loss"].item()


def test_lr_schedules_match_jax():
    for decay in ("linear", "invsqrt", "constant"):
        got = optim.get_lr_sched(decay, 5e-5, 10, 100)
        want = joptim.get_lr_sched(decay, 5e-5, 10, 100)
        for s in (0, 1, 5, 10, 11, 57, 100, 130):
            assert got(s) == float(want(s)), (decay, s)
    for s in (0, 3, 4000, 4001, 10 ** 5):
        assert optim.noam_schedule(s) == float(joptim.noam_schedule(s))
        assert optim.warmup_linear(s, 4000, 10 ** 5) == float(
            joptim.warmup_linear(s, 4000, 10 ** 5))
    vqa = dict(warm_int=3, decay_int=7, decay_st=20, decay_rate=0.2)
    got = optim.get_lr_sched("vqa", 1e-4, 1, 2, **vqa)
    want = joptim.get_lr_sched("vqa", 1e-4, 1, 2, **vqa)
    for s in (0, 2, 3, 5, 6, 8, 9, 19, 20, 21, 27, 28, 40, 130):
        assert got(s) == float(want(s)), ("vqa", s)
        assert optim.vqa_schedule(s, 3, 7, 20, 0.2) == float(
            joptim.vqa_schedule(s, 3, 7, 20, 0.2)), s


def test_pretrain_weights_carry_both_ways(tmp_path):
    """The port's checkpoint of the pre-training model, read by JAX's
    ``map_pretrain_model``, is the JAX tree the port's weights came from;
    a reference-layout state dict (tied duplicates, NSP and NCE heads
    included) loads through ``pretrain_keys``."""
    _, params, model = _pair(seed=4)
    path = str(tmp_path / "model_step_1")
    checkpoints.save_checkpoint(path, model=model, step=1)
    tree = map_pretrain_model(load_torch_state_dict(path + ".pt"),
                              num_layers=2)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    sd["cls.predictions.decoder.weight"] = sd[
        "bert.img_model.bert.embeddings.word_embeddings.weight"]
    sd["feat_regress.weight"] = sd[
        "bert.img_model.bert.img_embeddings.img_linear.weight"]
    sd["cls.seq_relationship.weight"] = np.zeros((2, 32), np.float32)
    sd["nce_output.weight"] = np.zeros((3, 32), np.float32)
    _, _, fresh = _pair(seed=5)
    checkpoints.load_state_dict_strict(fresh, pretrain_keys(sd))
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)


# ---------------------------------------------------------------------------
# the driver (tests/test_pretrain_e2e.py's cases)
# ---------------------------------------------------------------------------

def _write_config(root, synth, out_dir):
    txt_dir, img_dir = synth
    model_cfg = os.path.join(root, "model.json")
    with open(model_cfg, "w") as f:
        json.dump({k: v for k, v in SMALL.items() if "dropout" not in k}, f)
    cfg = {
        "txt_model_type": "bert-base", "txt_model_config": model_cfg,
        "img_model_type": "uniter-base", "img_model_config": model_cfg,
        "model_config": model_cfg, "output_dir": out_dir, "project_dim": 0,
        "mrm_prob": 0.3, "itm_neg_prob": 0.5, "max_txt_len": 30,
        "conf_th": 0.2, "max_bb": 12, "min_bb": 5, "num_bb": 10,
        "train_batch_size": 256, "val_batch_size": 256,
        "gradient_accumulation_steps": 2, "learning_rate": 1e-4,
        "valid_steps": 6, "num_train_steps": 6, "betas": [0.9, 0.98],
        "decay": "linear", "dropout": 0.0, "weight_decay": 0.01,
        "grad_norm": 5.0, "warmup_steps": 2, "seed": 7,
        "img_label_dim": N_LABELS,
        "train_datasets": [{"name": "synth", "db": [txt_dir],
                            "img": [img_dir],
                            "tasks": ["mlm", "mrfr", "mrc", "itm"],
                            "mix_ratio": [2, 1, 1, 1]}],
        "val_datasets": [{"name": "synth", "db": [txt_dir],
                          "img": [img_dir], "tasks": ["mlm", "itm"],
                          "mix_ratio": [1, 1]}],
    }
    path = os.path.join(root, "pretrain_cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _count(path):
    return torch.load(path + ".pt", weights_only=True)[
        "optimizer_dict"]["count"]


def _same_state(m1, o1, m2, o2):
    s1, s2 = o1.state_dict(), o2.state_dict()
    return (all(torch.equal(p, q) for p, q in zip(m1.parameters(),
                                                 m2.parameters()))
            and s1["count"] == s2["count"]
            and all(torch.equal(s1[k][n], s2[k][n])
                    for k in ("m", "v") for n in s1[k]))


def test_pretrain_driver_and_resume(synth, tmp_path, monkeypatch):
    """test_pretrain_e2e.py:148: finite validation losses, model_step_6
    (6 updates of 2 micro-batches), then a resume to step 10. The
    checkpoint restores the driver's weights and optimizer state bit for
    bit, a fast-forwarded task stream equals one iterated through the
    driver's micro-batches, and the next update from the restored state
    equals the uninterrupted one's (losses, weights, moments)."""
    out = str(tmp_path / "out")
    cfg = _write_config(str(tmp_path), synth, out)
    kept = {}
    real = cli.build_optimizer

    def build_optimizer(model, args):
        kept["opt"], lr_fn = real(model, args)
        return kept["opt"], lr_fn

    monkeypatch.setattr(cli, "build_optimizer", build_optimizer)
    cmds = ["--config", cfg, "--compute_dtype", "f32", "--device", "cpu"]
    results, model = cli.main(cmds)
    assert set(results) == {"mlm_synth", "itm_synth"}
    for task, metrics in results.items():
        assert np.isfinite(metrics["loss"]), (task, metrics)
    path = os.path.join(out, "ckpt", "model_step_6")
    assert _count(path) == 6

    opts = parse_with_config(cli.build_parser(), cmds)
    accum = opts.gradient_accumulation_steps
    resumed = cli.build_model(opts, torch.float32)
    ropt, _ = real(resumed, opts)
    checkpoints.load_checkpoint(path, model=resumed, optimizer=ropt)
    assert _same_state(resumed, ropt, model, kept["opt"])
    loaders = cli.create_dataloaders(
        opts.train_datasets, True, opts,
        feat_db.ImageDbGroup(opts.conf_th, opts.max_bb, opts.min_bb,
                             opts.num_bb), pre.PretrainCollateConfig())
    ran = loader.MetaLoader(loaders, accum_steps=accum, seed=opts.seed)
    it = iter(ran)
    for _ in range(6 * accum):
        next(it)
    ff = loader.MetaLoader(loaders, accum_steps=accum, seed=opts.seed)
    ff.fast_forward(6 * accum)
    assert ff.step == ran.step and ff._rng.getstate() == ran._rng.getstate()
    window = [next(it) for _ in range(accum)]
    task = window[0][0].split("_")[0]
    losses = []
    for m, o in ((resumed, ropt), (model, kept["opt"])):
        step = step_mod.make_pretrain_step(m, o, accum_steps=accum,
                                           device="cpu")(task)
        losses.append([float(step(b, step_generator(opts.seed, 6 * accum
                                                    + i))["loss"])
                       for i, (_, b) in enumerate(window)])
    assert losses[0] == losses[1]
    assert ropt.count == 7 and _same_state(resumed, ropt, model, kept["opt"])

    cli.main(cmds + ["--num_train_steps", "10"])
    assert _count(os.path.join(out, "ckpt", "model_step_10")) == 10
    assert checkpoints.latest_step_checkpoint(
        os.path.join(out, "ckpt"))[1] == 10


def test_pretrain_driver_resumes_a_jax_run(synth, tmp_path, monkeypatch):
    """The port's auto-resume carries on a run the JAX driver started: the
    JAX ``cli/pretrain.py`` writes ``ckpt/model_step_6.npz`` (weights and
    optax state), and the port's driver on the same output directory
    resumes from it (its weights, update count and both moments) and
    writes model_step_8."""
    from lightningdot_tpu.cli import pretrain as jcli
    from lightningdot_tpu.training import checkpoints as jckpt

    out = str(tmp_path / "out")
    cfg = _write_config(str(tmp_path), synth, out)
    cmds = ["--config", cfg, "--compute_dtype", "f32"]
    _, jstate = jcli.main(cmds)
    path = os.path.join(out, "ckpt", "model_step_6")
    assert os.path.exists(path + ".npz") and not os.path.exists(path + ".pt")
    kept = {}
    real_build, real_load = cli.build_optimizer, cli.load_checkpoint

    def build_optimizer(model, args):
        kept["opt"], lr_fn = real_build(model, args)
        return kept["opt"], lr_fn

    def load_checkpoint(p, **kw):
        meta = real_load(p, **kw)
        state = kw["optimizer"].state_dict()
        kept["resumed"] = (p, {k: ({n: t.clone() for n, t in v.items()}
                                   if isinstance(v, dict) else v)
                               for k, v in state.items()},
                           {n: t.detach().clone() for n, t in
                            kw["model"].state_dict().items()})
        return meta

    monkeypatch.setattr(cli, "build_optimizer", build_optimizer)
    monkeypatch.setattr(cli, "load_checkpoint", load_checkpoint)
    cli.main(cmds + ["--num_train_steps", "8", "--device", "cpu"])
    resumed_from, opt_state, weights = kept["resumed"]
    assert resumed_from == path and opt_state["count"] == 6
    jparams, jopt, _ = jckpt.load_checkpoint(
        path, model_template=jstate.params,
        optimizer_template=jstate.opt_state)
    want = pretrain_state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    for n, w in want.items():
        np.testing.assert_array_equal(weights[n].numpy(), w, err_msg=n)
    # optax.MultiSteps over (clip, the reference AdamW)
    inner = jopt.inner_opt_state[1]
    mu = pretrain_state_dict_from_jax(jax.tree.map(np.asarray, inner.mu))
    for n, w in mu.items():
        np.testing.assert_array_equal(opt_state["m"][n].numpy(), w,
                                      err_msg=n)
    assert kept["opt"].count == 8
    assert _count(os.path.join(out, "ckpt", "model_step_8")) == 8


def test_pretrain_preemption_checkpoint_and_resume(synth, tmp_path):
    """test_pretrain_e2e.py:189: a simulated SIGTERM at step 2 saves and
    exits; the same command then resumes and completes the run."""
    out = str(tmp_path / "out")
    cfg = _write_config(str(tmp_path), synth, out)
    cli.main(["--config", cfg, "--compute_dtype", "f32", "--device", "cpu",
              "--sim_preempt_step", "2"])
    ckpt = os.path.join(out, "ckpt")
    assert _count(os.path.join(ckpt, "model_step_2")) == 2
    assert not os.path.exists(os.path.join(ckpt, "model_step_6.json"))
    cli.main(["--config", cfg, "--compute_dtype", "f32", "--device", "cpu"])
    assert _count(os.path.join(ckpt, "model_step_6")) == 6


def test_pretrain_runs_on_the_card_by_default(synth, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _write_config(str(tmp_path), synth, str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", cfg])
    with open(cfg) as f:
        d = json.load(f)
    d["teacher_checkpoint"] = str(tmp_path / "no_teacher_here")
    with open(cfg, "w") as f:
        json.dump(d, f)
    # the one-tower teacher loads before any data: a missing directory
    # fails at once (tests/test_torch_kd.py trains with a real one)
    with pytest.raises(FileNotFoundError, match="no_teacher_here"):
        cli.main(["--config", cfg, "--device", "cpu"])


def test_sequence_outputs_match_jax(synth):
    """``BiEncoder.apply(..., sequence=True)``: both towers' sequences,
    against JAX's ``apply(sequence=True)``, which every head reads."""
    jmodel, params, model = _pair(seed=6)
    batch = _batch(synth, "mlm")
    want = jmodel.bi_encoder.apply(params["bert"], _jax_batch(batch),
                                   sequence=True)
    got = model.bert.apply(step_mod.pretrain_batch_to_device(
        batch, torch.device("cpu")), sequence=True)
    for g, w in zip(got[:2], want[:2]):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g.detach().numpy() - w).max() <= 1e-5 * np.abs(w).max()
    assert got[2] is None and want[2] is None
