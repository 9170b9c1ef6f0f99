"""Knowledge distillation in the port (``training/itm_step.make_kd_fn``,
``cli/train_itm.py --teacher_checkpoint``, ``models/uniter_pretrain.py``,
``training/pretrain_step.kd_loss`` and ``cli/pretrain.py``'s teacher)
against the JAX package (tests/test_cross_encoder.py's KD cases,
tests/test_pretrain_kd.py and test_train_parity_pretrain.py's KD formulas).

Sizes: the tiny BERT of the drivers' tests (hidden 32, 2 layers, 4 heads,
vocab 28,996, img_dim 32, 7 soft-label classes), ``make_synth_dataset``
DBs of 8 images x 2 captions, dropout 0, float32, weights with std-0.2
noise. Tolerances: KD terms and their gradients within 1e-5 (relative to
the largest); per-step losses within 1e-5 relative; weights within 1e-5
of the largest leaf (one update) or 1e-4 relative L2 per leaf (a driver).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningdot_tpu.config import EncoderConfig as JCfg
from lightningdot_tpu.data.synth import make_synth_dataset
from lightningdot_tpu.models import checkpoint_torch as jckpt
from lightningdot_tpu.models.cross_encoder import CrossEncoder as JCross
from lightningdot_tpu.models.uniter_pretrain import (
    UniterForPretraining as JUniter)
from lightningdot_tpu.training import itm_step as jitm_step
from lightningdot_tpu.training import pretrain_step as jstep
from lightningdot_tpu_torch.cli import pretrain as pre_cli
from lightningdot_tpu_torch.cli import train_itm
from lightningdot_tpu_torch.config import EncoderConfig
from lightningdot_tpu_torch.data import pretrain as pre
from lightningdot_tpu_torch.data.itm import make_teacher_batch
from lightningdot_tpu_torch.models.cross_encoder import CrossEncoder
from lightningdot_tpu_torch.models.uniter_pretrain import (
    UniterForPretraining)
from lightningdot_tpu_torch.models.weights import (
    cross_encoder_state_dict_from_jax, pretrain_keys,
    uniter_pretrain_state_dict_from_jax)
from lightningdot_tpu_torch.training import pretrain_step as step_mod
from lightningdot_tpu_torch.training.checkpoints import (
    load_state_dict_strict, save_checkpoint)
from lightningdot_tpu_torch.training.itm_step import make_kd_fn
from test_torch_pretrain import (_dbs, _jax_batch, _optimizers, _pair,
                                 _worst)

SMALL = {"vocab_size": 28996, "hidden_size": 32, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 64,
         "max_position_embeddings": 64, "img_dim": 32,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
N_LABELS = 7
KD_TASKS = ("mlm", "mrfr", "mrckl", "mrc")


def _noisy(tree, seed):
    r = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + 0.2 * r.standard_normal(
        x.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("kd")
    return make_synth_dataset(str(root), n_imgs=8, txts_per_img=2,
                              img_dim=32, min_bb=5, max_bb=12,
                              max_txt_len=20, with_soft_labels=True,
                              n_labels=N_LABELS, seed=2)


@pytest.fixture(scope="module")
def ft_synth(tmp_path_factory):
    """The fine-tuning driver tests' DBs (5-10 regions)."""
    return make_synth_dataset(str(tmp_path_factory.mktemp("kdft")),
                              n_imgs=8, txts_per_img=2, img_dim=32, min_bb=5,
                              max_bb=10, max_txt_len=20, seed=1)


def _cross_pair(seed):
    jm = JCross(JCfg(**SMALL))
    params = _noisy(jm.init(jax.random.PRNGKey(seed)), seed)
    pm = CrossEncoder(EncoderConfig(**SMALL))
    load_state_dict_strict(pm, cross_encoder_state_dict_from_jax(params))
    return jm, jax.tree.map(jnp.asarray, params), pm


def _itm_kd_batch(rng, bs=4, tl=8, nr=5):
    return {
        "sample_size": bs,
        "txts": {"input_ids": rng.integers(1000, 28996, (bs, tl)).astype(
                     np.int32),
                 "attention_mask": np.ones((bs, tl), np.int32),
                 "position_ids": np.broadcast_to(np.arange(tl, dtype=np.int32),
                                                 (bs, tl)).copy()},
        "imgs": {"input_ids": np.full((bs, 1), 101, np.int32),
                 "attention_mask": np.ones((bs, 1 + nr), np.int32),
                 "img_feat": rng.standard_normal((bs, nr, 32)).astype(
                     np.float32),
                 "img_pos_feat": rng.random((bs, nr, 7)).astype(np.float32)},
        "caps": None,
    }


@pytest.mark.parametrize("cap_weight", [0.0, 0.3])
def test_make_kd_fn_matches_jax_in_value_and_gradient(rng, cap_weight):
    jm, params, pm = _cross_pair(1)
    bs, n_teacher, T = 4, 2, 2.0
    batch = _itm_kd_batch(rng, bs)
    tb = make_teacher_batch(batch, n_teacher)
    from lightningdot_tpu.data.itm import make_teacher_batch as jmake
    jtb = jmake(batch, n_teacher)
    for k in tb:
        if tb[k] is not None:
            np.testing.assert_array_equal(tb[k], jtb[k], err_msg=k)
    embs = [rng.standard_normal((bs, 16)).astype(np.float32)
            for _ in range(3)]
    cap = embs[2] if cap_weight else None
    jkd = jitm_step.make_kd_fn(jm, params, T=T, n_teacher=n_teacher,
                               caption_score_weight=cap_weight)
    jbatch = {"teacher": {k: jnp.asarray(v) for k, v in jtb.items()
                          if v is not None}}

    def jloss(t, i):
        return jkd(None, jbatch, (t, i, None if cap is None
                                  else jnp.asarray(cap)))

    want, (gt_want, gi_want) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(embs[0]), jnp.asarray(embs[1]))
    pm.train()      # the student's train() must not reach the teacher
    kd = make_kd_fn(pm, T=T, n_teacher=n_teacher,
                    caption_score_weight=cap_weight)
    t = torch.from_numpy(embs[0]).requires_grad_(True)
    i = torch.from_numpy(embs[1]).requires_grad_(True)
    got = kd({"teacher": {k: torch.from_numpy(v) for k, v in tb.items()
                          if v is not None}},
             (t, i, None if cap is None else torch.from_numpy(cap)))
    assert not pm.training
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    scale = max(np.abs(gt_want).max(), np.abs(gi_want).max())
    np.testing.assert_allclose(t.grad.numpy(), gt_want, atol=1e-5 * scale)
    np.testing.assert_allclose(i.grad.numpy(), gi_want, atol=1e-5 * scale)


def test_make_kd_fn_guards_zero_teacher_probabilities():
    """A teacher probability that underflows to 0 contributes 0, not NaN
    (JAX's q > 0 guard)."""
    class Stub(torch.nn.Module):
        def rank_scores(self, batch):
            return torch.tensor([[0.0], [-1e5], [0.0], [3.0]])

    kd = make_kd_fn(Stub(), T=1.0, n_teacher=2)
    emb = torch.randn(2, 8, requires_grad=True)
    loss = kd({"teacher": {"input_ids": torch.zeros(4, 3)}},
              (emb, emb.detach().clone(), None))
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(emb.grad).all()

    class JStub:
        def rank_scores(self, params, batch, deterministic=True):
            return jnp.asarray([[0.0], [-1e5], [0.0], [3.0]])

    want = jitm_step.make_kd_fn(JStub(), None, T=1.0, n_teacher=2)(
        None, {"teacher": {"input_ids": jnp.zeros((4, 3))}},
        (jnp.asarray(emb.detach().numpy()), jnp.asarray(emb.detach().numpy()),
         None))
    assert abs(loss.item() - float(want)) <= 1e-5 * max(abs(float(want)),
                                                         1e-6)


def _init_pts(tmp_path_factory, cfg):
    """A bi-encoder .pt and a cross-encoder teacher directory, both from
    JAX weights with noise, in the reference layouts."""
    root = tmp_path_factory.mktemp("kdinit")
    from lightningdot_tpu.models.bi_encoder import BiEncoder as JBi

    jckpt.save_biencoder_pt(str(root / "bi.pt"), _noisy(JBi(
        JCfg(**SMALL), JCfg(**SMALL)).init(jax.random.PRNGKey(3)), 4))
    teacher = root / "teacher"
    os.makedirs(teacher)
    (teacher / "config.json").write_text(json.dumps(SMALL))
    jckpt.save_cross_encoder_pt(str(teacher / "model.pt"), _noisy(
        JCross(JCfg(**SMALL)).init(jax.random.PRNGKey(5)), 6))
    return str(root / "bi.pt"), str(teacher)


def test_train_itm_driver_with_a_teacher_matches_jax(ft_synth,
                                                     tmp_path_factory):
    """``--teacher_checkpoint`` (with ``--T`` and ``--kd_loss_weight``):
    the port's driver against JAX's from one .pt and one teacher
    directory: per-step losses, recall and final weights."""
    from lightningdot_tpu.cli import train_itm as jcli
    from test_torch_train_itm_cli import _cli, _leaf_rel_l2, _losses

    cfg = str(tmp_path_factory.mktemp("kdcfg") / "small.json")
    with open(cfg, "w") as f:
        json.dump(SMALL, f)
    bi, teacher = _init_pts(tmp_path_factory, cfg)
    extra = ("--train_batch_size", "4", "--valid_batch_size", "8",
             "--inf_minibatch_size", "8", "--num_train_epochs", "1",
             "--learning_rate", "1e-3", "--log_result_step", "1",
             "--loader_workers", "1", "--biencoder_checkpoint", bi,
             "--teacher_checkpoint", teacher, "--T", "2.0",
             "--kd_loss_weight", "0.5")
    out_p = str(tmp_path_factory.mktemp("kd_port"))
    out_j = str(tmp_path_factory.mktemp("kd_jax"))
    (results, model) = train_itm.main(_cli(cfg, ft_synth, out_p, *extra,
                                           "--device", "cpu", test=False))
    (jresults, jstate) = jcli.main(_cli(cfg, ft_synth, out_j, *extra,
                                        test=False))
    got, want = _losses(out_p), _losses(out_j)
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-5 * abs(w), (got, want)
    assert results["best_val_recall_mean"] == jresults[
        "best_val_recall_mean"]
    assert _leaf_rel_l2(model, jstate.params) <= 1e-4


def _uniter_pair(seed):
    jm = JUniter(JCfg(**SMALL), img_label_dim=N_LABELS)
    params = _noisy(jm.init(jax.random.PRNGKey(seed)), seed)
    pm = UniterForPretraining(EncoderConfig(**SMALL), img_label_dim=N_LABELS)
    load_state_dict_strict(pm, uniter_pretrain_state_dict_from_jax(params))
    return jm, jax.tree.map(jnp.asarray, params), pm


def _kd_batch(synth, task, lo=0):
    ds = {"mlm": lambda t, i: pre.MlmDataset(t, i, seed=0),
          "mrfr": lambda t, i: pre.MrfrDataset(0.3, t, i, seed=0),
          "itm": lambda t, i: pre.ItmPreDataset(t, i, 0.5, seed=0)}.get(
        task, lambda t, i: pre.MrcDataset(0.3, t, i, seed=0))(
        *_dbs(synth, False))
    fn = {"mlm": pre.mlm_collate, "mrfr": pre.mrfr_collate,
          "itm": pre.itm_pre_collate}.get(task, pre.mrc_collate)
    cfg = pre.PretrainCollateConfig(txt_buckets=(16, 32), img_buckets=(16,),
                                    batch_pad=4, img_label_dim=N_LABELS,
                                    with_teacher=True)
    return fn([ds[i] for i in range(lo, lo + 6)], cfg)


def _t(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items() if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("task", KD_TASKS + ("itm",))
def test_uniter_for_pretraining_matches_jax(synth, task):
    jm, params, pm = _uniter_pair(7)
    batch = _kd_batch(synth, task)
    if task == "itm":
        # itm batches carry no teacher grid: the joint pairs by hand
        tb = {"input_ids": batch["txts"]["input_ids"],
              "position_ids": batch["txts"]["position_ids"],
              "img_feat": batch["imgs"]["img_feat"],
              "img_pos_feat": batch["imgs"]["img_pos_feat"],
              "attn_masks": np.concatenate(
                  [batch["txts"]["attention_mask"],
                   batch["imgs"]["attention_mask"][:, 1:]], axis=1),
              "targets": batch["targets"]}
    else:
        tb = batch["teacher"]
        if task != "mlm":
            tb = dict(tb, **{k: batch[k] for k in (
                "img_masked_positions", "img_masked_weights",
                "feat_targets", "label_targets") if k in batch})
    want = jm.task_logits(params, {k: jnp.asarray(v) for k, v in tb.items()
                                   if v is not None}, task)
    got = pm.task_logits(_t(tb), task)
    w = np.asarray(want)
    assert got.shape == w.shape
    np.testing.assert_allclose(got.detach().numpy(), w,
                               atol=1e-5 * max(np.abs(w).max(), 1.0))


@pytest.mark.parametrize("task", KD_TASKS)
def test_kd_loss_matches_jax_in_value_and_gradient(task):
    rng = np.random.default_rng(70)
    T, w_kd = 2.0, 0.7
    bs, m = 3, 4
    n = 32 if task == "mrfr" else N_LABELS
    s = rng.standard_normal((bs, m, n)).astype(np.float32)
    t = rng.standard_normal((bs, m, n)).astype(np.float32)
    t[0, 0, 0] = -1e5         # a teacher probability of 0
    weights = np.ones((bs, m), np.float32)
    weights[0, 1] = 0.0
    if task == "mlm":
        weights = weights.reshape(-1)

    class JT:
        def task_logits(self, params, batch, task):
            return jnp.asarray(t)

    class PT(torch.nn.Module):
        def task_logits(self, batch, task):
            return torch.from_numpy(t)

    want, g_want = jax.value_and_grad(lambda x: jstep.kd_loss(
        JT(), None, {"teacher": {}}, task, x, jnp.asarray(weights), T=T,
        kd_loss_weight=w_kd))(jnp.asarray(s))
    x = torch.from_numpy(s).requires_grad_(True)
    got = step_mod.kd_loss(PT(), {"teacher": {}}, task, x,
                           torch.from_numpy(weights), T=T, kd_loss_weight=w_kd)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_want),
                               atol=1e-5 * np.abs(g_want).max())


@pytest.mark.parametrize("task", KD_TASKS + ("itm",))
def test_pretrain_kd_step_matches_jax(synth, task):
    """One update of ``make_pretrain_step`` with the one-tower teacher
    (KD on the non-itm tasks only), the port's against JAX's: the loss,
    the KD term and every parameter leaf."""
    jmodel, params, model = _pair(seed=2)
    jt, tparams, pt = _uniter_pair(8)
    opt, tx = _optimizers(model)
    model.train()
    step = step_mod.make_pretrain_step(model, opt, teacher=pt,
                                       kd_loss_weight=0.5, kd_T=2.0,
                                       device="cpu")(task)
    init, step_for_task = jstep.make_pretrain_step(
        jmodel, tx, teacher=jt, teacher_params=tparams, kd_loss_weight=0.5,
        kd_T=2.0)
    state = init(params)
    batch = _kd_batch(synth, task)
    if task == "itm":
        assert "teacher" not in batch
    metrics = step(batch)
    state, jm = step_for_task(task)(state, _jax_batch(batch),
                                    jax.random.PRNGKey(0))
    assert abs(metrics["loss"].item() - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert ("kd_loss" in metrics) == ("kd_loss" in jm) == (task != "itm")
    if task != "itm":
        assert abs(metrics["kd_loss"].item() - float(jm["kd_loss"])) <= \
            1e-5 * abs(float(jm["kd_loss"]))
    assert not pt.training
    worst = _worst({n: p.detach().numpy()
                    for n, p in model.named_parameters()}, state.params)
    assert worst[0] <= 1e-5, worst


def test_pretrain_driver_with_a_teacher(synth, tmp_path_factory):
    """``cli/pretrain.py`` with ``teacher_checkpoint`` (the JAX case of
    tests/test_pretrain_kd.py): a JAX teacher directory (model.npz) and
    the port's (model.pt, reference names read back by
    ``pretrain_keys``) both load, and the driver trains with KD."""
    from lightningdot_tpu.training.checkpoints import (
        save_checkpoint as jsave)

    txt_dir, img_dir = synth
    root = tmp_path_factory.mktemp("kdpre")
    mc = str(root / "model.json")
    with open(mc, "w") as f:
        json.dump(SMALL, f)
    jt, tparams, pt = _uniter_pair(9)
    jdir, pdir = root / "t_jax", root / "t_port"
    for d in (jdir, pdir):
        os.makedirs(d)
        (d / "config.json").write_text(json.dumps(SMALL))
    jsave(str(jdir / "model"), model=tparams)
    save_checkpoint(str(pdir / "model"), model=pt)
    sd = torch.load(pdir / "model.pt", weights_only=True)["model_dict"]
    assert set(pretrain_keys(sd)) == set(pt.state_dict())
    for tdir in (jdir, pdir):
        cfg = {"txt_model_type": "bert-base", "txt_model_config": mc,
               "img_model_type": "uniter-base", "img_model_config": mc,
               "model_config": mc, "output_dir": str(root / tdir.name / "o"),
               "project_dim": 0, "mrm_prob": 0.3, "itm_neg_prob": 0.5,
               "max_txt_len": 30, "conf_th": 0.2, "max_bb": 12,
               "min_bb": 5, "num_bb": 10, "train_batch_size": 256,
               "val_batch_size": 256, "gradient_accumulation_steps": 1,
               "learning_rate": 1e-4, "valid_steps": 3,
               "num_train_steps": 3, "betas": [0.9, 0.98],
               "decay": "linear", "dropout": 0.0, "weight_decay": 0.01,
               "grad_norm": 5.0, "warmup_steps": 1, "seed": 11,
               "img_label_dim": N_LABELS, "teacher_checkpoint": str(tdir),
               "kd_loss_weight": 0.5, "T": 2.0,
               "train_datasets": [{"name": "synth", "db": [txt_dir],
                                   "img": [img_dir],
                                   "tasks": ["mlm", "mrfr", "mrc"],
                                   "mix_ratio": [1, 1, 1]}],
               "val_datasets": [{"name": "synth", "db": [txt_dir],
                                 "img": [img_dir], "tasks": ["mlm"],
                                 "mix_ratio": [1]}]}
        path = str(root / f"{tdir.name}.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        results, _ = pre_cli.main(["--config", path, "--compute_dtype",
                                   "f32", "--device", "cpu"])
        assert np.isfinite(results["mlm_synth"]["loss"])
