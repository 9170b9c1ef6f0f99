"""The port's ITM fine-tuning driver (``lightningdot_tpu_torch.cli.
train_itm``) and what it is built of: checkpoints, hard-negative mining,
gradient accumulation, preemption and the train/eval mode, held against
the JAX package on the same inputs.

Sizes: the JAX e2e tests' tiny config (tests/test_train_itm_e2e.py:22-30:
hidden 32, 2 layers, 4 heads, intermediate 64, img_dim 32, dropout 0) over
``make_synth_dataset`` DBs of 8 images x 2 captions. Both drivers start
from one ``.pt`` of shared weights and run in float32. Tolerances: the
per-step losses within 1e-5 relative (the same math summed in another
order reads 2.5e-7 to 5.6e-7), each leaf of the final weights within 1e-4
relative L2, recall dicts equal.
"""
import argparse
import json
import os
import random
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightningdot_tpu.cli import train_itm as jcli
from lightningdot_tpu.data.synth import make_synth_dataset
from lightningdot_tpu.models import checkpoint_torch as jckpt_torch
from lightningdot_tpu.training import checkpoints as jckpt
from lightningdot_tpu.training import hn as jhn
from lightningdot_tpu.training import itm_step as jstep
from lightningdot_tpu.training import optim as joptim
from lightningdot_tpu_torch.cli import eval_itm
from lightningdot_tpu_torch.cli import train_itm
from lightningdot_tpu_torch.models import BiEncoder, factory
from lightningdot_tpu_torch.models.weights import biencoder_state_dict_from_jax
from lightningdot_tpu_torch.training import checkpoints, hn, itm_step, optim
from lightningdot_tpu_torch.utils import preemption, runtime
from lightningdot_tpu_torch.utils.preemption import PreemptionGuard

SMALL = {"vocab_size": 28996, "hidden_size": 32, "num_hidden_layers": 2,
         "num_attention_heads": 4, "intermediate_size": 64,
         "max_position_embeddings": 64, "img_dim": 32,
         "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
LOSS_RTOL = 1e-5
LEAF_REL_L2 = 1e-4


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft")
    return make_synth_dataset(str(root), n_imgs=8, txts_per_img=2,
                              img_dim=32, min_bb=5, max_bb=10,
                              max_txt_len=20, seed=1)


def _cfg_file(tmp_path_factory, **extra):
    p = tmp_path_factory.mktemp("cfg") / "small.json"
    p.write_text(json.dumps({**SMALL, **extra}))
    return str(p)


def _cli(cfg, synth, out_dir, *extra, test=True):
    txt_dir, img_dir = synth
    cmds = ["--txt_model_config", cfg, "--img_model_config", cfg,
            "--train_txt_dbs", txt_dir, "--train_img_dbs", img_dir,
            "--val_txt_db", txt_dir, "--val_img_db", img_dir,
            "--max_bb", "10", "--min_bb", "5", "--num_bb", "10",
            "--max_txt_len", "30", "--compute_dtype", "f32",
            "--output_dir", out_dir, *extra]
    if test:
        cmds += ["--test_txt_db", txt_dir, "--test_img_db", img_dir]
    return cmds


def _losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r["loss_train"] for r in map(json.loads, f)
                if "loss_train" in r]


def _init_pt(cfg, path):
    """Seeded weights with noise of std 0.2 on every leaf (at its init
    scale a tower this small gives nearly one embedding for every input),
    as a reference-layout .pt."""
    args = train_itm.build_parser().parse_args(
        ["--txt_model_config", cfg, "--img_model_config", cfg])
    model = factory.build_biencoder(args, seed=3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
    torch.save({"model_dict": model.state_dict()}, path)
    return path


# the JAX driver and the port's, from one .pt, with hard negatives mined
# before the first epoch and between epochs, and two micro-batches per
# update (optax.MultiSteps / the port's accumulation)
PARITY = ("--train_batch_size", "4", "--valid_batch_size", "8",
          "--inf_minibatch_size", "8", "--num_train_epochs", "2",
          "--learning_rate", "1e-3", "--log_result_step", "1",
          "--num_hard_negatives", "1", "--sample_init_hard_negatives",
          "--gradient_accumulation_steps", "2", "--loader_workers", "1")


@pytest.fixture(scope="module")
def runs(synth, tmp_path_factory):
    cfg = _cfg_file(tmp_path_factory)
    init = _init_pt(cfg, str(tmp_path_factory.mktemp("init") / "init.pt"))
    out_p = str(tmp_path_factory.mktemp("port"))
    out_j = str(tmp_path_factory.mktemp("jax"))
    extra = PARITY + ("--biencoder_checkpoint", init)
    port = train_itm.main(_cli(cfg, synth, out_p, *extra, "--device", "cpu"))
    jax_run = jcli.main(_cli(cfg, synth, out_j, *extra))
    return dict(cfg=cfg, port=port, jax=jax_run, out_p=out_p, out_j=out_j)


def _leaf_rel_l2(model, jax_params):
    want = biencoder_state_dict_from_jax(jax.tree.map(np.asarray,
                                                      jax_params))
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert got.keys() == want.keys()
    return max(float(np.linalg.norm(got[k] - w)
                     / max(np.linalg.norm(w), 1e-12))
               for k, w in want.items())


def test_train_itm_cli_matches_jax(runs):
    """Per-step losses, recall (best validation mean, test dicts) and the
    final weights of the two drivers from the same .pt."""
    (results, model), (jresults, jstate) = runs["port"], runs["jax"]
    got, want = _losses(runs["out_p"]), _losses(runs["out_j"])
    assert len(got) == len(want) == 6
    rel = np.abs(np.subtract(got, want)) / np.abs(want)
    assert rel.max() <= LOSS_RTOL, (got, want)
    assert results["best_val_recall_mean"] == jresults["best_val_recall_mean"]
    assert results["test"] == jresults["test"]
    assert _leaf_rel_l2(model, jstate.params) <= LEAF_REL_L2
    # the checkpoints both drivers wrote
    for out in (runs["out_p"], runs["out_j"]):
        assert os.path.exists(os.path.join(out, "biencoder.best.json"))
        assert os.path.exists(os.path.join(out, "biencoder.last.json"))
    assert [e["steps"] for e in results["epochs"]] == [4, 4]


def test_checkpoints_cross_read(runs, tmp_path):
    """The port's biencoder.last read by JAX's load_biencoder_checkpoint,
    and the JAX driver's biencoder.last (.npz) read by the port: equal to
    each writer's weights."""
    model, jstate = runs["port"][1], runs["jax"][1]
    tree = jckpt_torch.load_biencoder_checkpoint(
        os.path.join(runs["out_p"], "biencoder.last.pt"), num_layers=2)
    sd = biencoder_state_dict_from_jax(jax.tree.map(np.asarray, tree))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(sd[k], v.numpy(), err_msg=k)
    fresh = BiEncoder(model.txt_cfg, model.img_cfg)
    meta = checkpoints.load_checkpoint(
        os.path.join(runs["out_j"], "biencoder.last"), model=fresh)
    assert meta["epoch"] == 1
    want = biencoder_state_dict_from_jax(jax.tree.map(np.asarray,
                                                      jstate.params))
    for k, v in fresh.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_eval_cli_reads_a_checkpoint_the_jax_trainer_wrote(runs, synth):
    """``--biencoder_checkpoint`` takes the JAX driver's biencoder.last:
    the port's eval_itm gives the recall JAX's test sweep read from the
    same weights."""
    txt_dir, img_dir = synth
    cfg = runs["cfg"]
    got = eval_itm.main([
        "--txt_model_config", cfg, "--img_model_config", cfg,
        "--test_txt_db", txt_dir, "--test_img_db", img_dir,
        "--max_bb", "10", "--min_bb", "5", "--num_bb", "10",
        "--valid_batch_size", "8", "--inf_minibatch_size", "8",
        "--compute_dtype", "f32", "--device", "cpu",
        "--biencoder_checkpoint",
        os.path.join(runs["out_j"], "biencoder.last")])["test"]
    want = runs["jax"][0]["test"]
    assert got["recall_txt"] == want["recall_txt"]
    assert got["recall_img"] == want["recall_img"]


# ---------------------------------------------------------------------------
# the JAX e2e cases (tests/test_train_itm_e2e.py) on the port
# ---------------------------------------------------------------------------

E2E = ("--train_batch_size", "16", "--valid_batch_size", "16",
       "--inf_minibatch_size", "16", "--device", "cpu")


def test_train_itm_overfit(synth, tmp_path_factory):
    """test_train_itm_e2e.py:32: trained on = evaluated on, far above
    chance (1/8)."""
    out = str(tmp_path_factory.mktemp("out"))
    results, _ = train_itm.main(_cli(
        _cfg_file(tmp_path_factory), synth, out, *E2E,
        "--num_train_epochs", "4", "--learning_rate", "2e-3",
        "--log_result_step", "1"))
    assert results["best_val_recall_mean"] > 0.5, results
    for name in ("biencoder.best.pt", "biencoder.last.json",
                 "metrics.jsonl"):
        assert os.path.exists(os.path.join(out, name))


@pytest.mark.parametrize("sampling", ["random", "sampled"])
def test_train_itm_with_hard_negatives(synth, tmp_path_factory, sampling):
    """test_train_itm_e2e.py:65, with random and with mined negatives."""
    out = str(tmp_path_factory.mktemp("out_hn"))
    extra = (["--hard_negatives_sampling", "random"] if sampling == "random"
             else ["--sample_init_hard_negatives"])
    results, _ = train_itm.main(_cli(
        _cfg_file(tmp_path_factory), synth, out, "--train_batch_size", "8",
        "--valid_batch_size", "8", "--inf_minibatch_size", "8",
        "--device", "cpu", "--num_train_epochs", "2",
        "--learning_rate", "1e-3", "--num_hard_negatives", "1",
        "--log_result_step", "2", *extra, test=False))
    assert np.isfinite(results["best_val_recall_mean"])


def test_train_itm_bf16_optstate_and_workers(synth, tmp_path_factory,
                                             monkeypatch):
    """test_train_itm_e2e.py:94: a bfloat16 first moment and two loader
    workers drive the loop end to end and still learn."""
    made = []
    real = train_itm.make_fused_adamw
    monkeypatch.setattr(train_itm, "make_fused_adamw",
                        lambda *a, **k: made.append(real(*a, **k))
                        or made[-1])
    out = str(tmp_path_factory.mktemp("out_bf16"))
    results, _ = train_itm.main(_cli(
        _cfg_file(tmp_path_factory), synth, out, *E2E,
        "--num_train_epochs", "4", "--learning_rate", "2e-3",
        "--log_result_step", "1", "--optim_state_dtype", "bfloat16",
        "--loader_workers", "2"))
    assert results["best_val_recall_mean"] > 0.5, results
    (opt,) = made
    assert all(m.dtype == torch.bfloat16 for m in opt.m)
    assert all(v.dtype == torch.float32 for v in opt.v)


def test_train_itm_preemption_snapshot(synth, tmp_path_factory):
    """test_train_itm_e2e.py:137: a simulated SIGTERM mid-epoch saves
    biencoder.preempt and exits, skipping eval, mining and the test sweep;
    the snapshot loads."""
    out = str(tmp_path_factory.mktemp("out_pre"))
    results, model = train_itm.main(_cli(
        _cfg_file(tmp_path_factory), synth, out, *E2E,
        "--num_train_epochs", "4", "--sim_preempt_step", "1"))
    assert os.path.exists(os.path.join(out, "biencoder.preempt.pt"))
    assert not os.path.exists(os.path.join(out, "biencoder.last.pt"))
    assert "test" not in results
    meta = checkpoints.load_checkpoint(
        os.path.join(out, "biencoder.preempt"),
        model=BiEncoder(model.txt_cfg, model.img_cfg))
    assert meta["step"] >= 1


def test_dropout_is_live_after_the_per_epoch_evaluation(
        synth, tmp_path_factory, monkeypatch):
    """The evaluator and the miner put the model in eval mode (JAX has no
    such state); the driver must train the next epoch with dropout on:
    every step runs in training mode, and at the first step after an
    evaluation two passes under different generators differ."""
    seen = []
    real = train_itm.make_itm_train_step

    def make(model, *a, **k):
        step = real(model, *a, **k)

        def wrapped(batch, generator=None):
            seen.append(model.training)
            if len(seen) == 3:          # epoch 2's first step
                sub = itm_step.batch_to_device(batch, torch.device("cpu"))
                with torch.no_grad():
                    outs = [model.apply(sub, [torch.Generator().manual_seed(
                        s + i) for i in range(3)])[0] for s in (1, 7)]
                seen.append(not torch.equal(*outs))
            return step(batch, generator)

        return wrapped

    monkeypatch.setattr(train_itm, "make_itm_train_step", make)
    out = str(tmp_path_factory.mktemp("out_mode"))
    cfg = _cfg_file(tmp_path_factory, hidden_dropout_prob=0.1,
                    attention_probs_dropout_prob=0.1)
    train_itm.main(_cli(cfg, synth, out, "--train_batch_size", "8",
                        "--valid_batch_size", "8", "--inf_minibatch_size",
                        "8", "--device", "cpu", "--num_train_epochs", "2",
                        "--num_hard_negatives", "1",
                        "--sample_init_hard_negatives", test=False))
    assert seen == [True, True, True, True, True], seen


def test_train_itm_runs_on_the_card_by_default(synth, tmp_path,
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = str(tmp_path / "small.json")
    with open(cfg, "w") as f:
        json.dump(SMALL, f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_itm.main(_cli(cfg, synth, str(tmp_path / "out"),
                            "--num_train_epochs", "1"))
    # the teacher loads before any data: a missing one fails at once
    # (tests/test_torch_kd.py trains with a real one)
    with pytest.raises(FileNotFoundError, match="no_teacher_here"):
        train_itm.main(_cli(cfg, synth, str(tmp_path / "out"), "--device",
                            "cpu", "--teacher_checkpoint",
                            str(tmp_path / "no_teacher_here")))


# ---------------------------------------------------------------------------
# gradient accumulation against optax.MultiSteps
# ---------------------------------------------------------------------------

def test_accumulation_matches_optax_multisteps():
    """k = 2: two micro-batches, one update from the mean of their
    gradients, clip and schedule read once; against the JAX step under
    ``optax.MultiSteps(make_optimizer(...), 2)`` on the same batches."""
    from test_torch_train import _itm_batch, _jax_batch, _pair

    jmodel, params, model = _pair(seed=4)
    # configs/coco_ft.json's lr, as test_itm_step_matches_jax: leaves whose
    # exact gradient cancels step by noise of lr size in either package
    sched = joptim.schedule_linear(2e-5, 1, 10)
    tx = optax.MultiSteps(joptim.make_optimizer(sched, max_grad_norm=0.5,
                                                weight_decay=0.01), 2)
    jtrain = jax.jit(jstep.make_itm_train_step(jmodel, tx))
    state = jstep.create_train_state(params, tx)
    opt = optim.make_optimizer(model, optim.schedule_linear(2e-5, 1, 10),
                               max_grad_norm=0.5, weight_decay=0.01)
    model.train()
    step = itm_step.make_itm_train_step(model, opt, accum_steps=2,
                                        device="cpu")
    for i in range(4):
        b = _itm_batch(4, 0, seed=50 + i)
        metrics = step(b)
        state, jm = jtrain(state, _jax_batch(b), jax.random.PRNGKey(0))
        assert abs(metrics["loss"].item() - float(jm["loss"])) <= \
            LOSS_RTOL * abs(float(jm["loss"]))
        assert opt.count == (i + 1) // 2
    want = biencoder_state_dict_from_jax(jax.tree.map(np.asarray,
                                                      state.params))
    top = max(np.abs(w).max() for w in want.values())
    for k, v in model.state_dict().items():
        assert np.abs(v.numpy() - want[k]).max() <= 1e-5 * top, k


# ---------------------------------------------------------------------------
# checkpoints (tests/test_checkpoint_roundtrip.py's cases)
# ---------------------------------------------------------------------------

class _Tiny(torch.nn.Module):
    def __init__(self, n=8):
        super().__init__()
        self.w = torch.nn.Parameter(torch.arange(n, dtype=torch.float32))
        self.b = torch.nn.Parameter(torch.zeros(4))


def test_async_model_saver_snapshots_before_mutation(tmp_path):
    """test_checkpoint_roundtrip.py:66: a save captures the values at
    save time, whatever the loop does to the weights afterwards."""
    model = _Tiny()
    saver = checkpoints.ModelSaver(str(tmp_path), async_save=True)
    saver.save(model, step=3)
    with torch.no_grad():
        model.w.mul_(0).sub_(1)
    saver.wait()
    found = checkpoints.latest_step_checkpoint(str(tmp_path))
    assert found is not None and found[1] == 3
    fresh = _Tiny()
    with torch.no_grad():
        fresh.w.zero_()
    assert checkpoints.load_checkpoint(found[0], model=fresh)["step"] == 3
    np.testing.assert_array_equal(fresh.w.detach().numpy(),
                                  np.arange(8, dtype=np.float32))
    saver.save(_Tiny(), step=7)
    saver.wait()
    assert checkpoints.latest_step_checkpoint(str(tmp_path))[1] == 7


def test_interrupted_save_never_selected(tmp_path):
    """test_checkpoint_roundtrip.py:99: discovery keys off the manifest,
    written last; a truncated data file or temporaries are never picked."""
    d = str(tmp_path / "ckpt")
    model = _Tiny()
    checkpoints.save_checkpoint(f"{d}/model_step_5", model=model, step=5)
    with open(f"{d}/model_step_9.pt", "wb") as f:
        f.write(b"PK\x03\x04 half a zip")
    assert checkpoints.latest_step_checkpoint(d)[1] == 5
    with open(f"{d}/model_step_7.pt.tmp", "wb") as f:
        f.write(b"partial")
    assert checkpoints.latest_step_checkpoint(d)[1] == 5
    assert checkpoints.latest_step_checkpoint(str(tmp_path / "none")) is None
    fresh = _Tiny()
    assert checkpoints.load_checkpoint(f"{d}/model_step_5",
                                       model=fresh)["step"] == 5


def test_strict_load_rejects_shape_and_extra_keys(tmp_path):
    """test_checkpoint_roundtrip.py:130, and a missing parameter; a JAX
    .npz is held the same way."""
    path = str(tmp_path / "m")
    checkpoints.save_checkpoint(path, model=_Tiny(8))
    with pytest.raises(ValueError, match="shape"):
        checkpoints.load_checkpoint(path, model=_Tiny(6))

    class Fewer(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.zeros(8))

    with pytest.raises(KeyError, match="parameters the model does not"):
        checkpoints.load_checkpoint(path, model=Fewer())

    class More(_Tiny):
        def __init__(self):
            super().__init__()
            self.c = torch.nn.Parameter(torch.zeros(2))

    with pytest.raises(KeyError, match="missing parameter c"):
        checkpoints.load_checkpoint(path, model=More())
    jpath = str(tmp_path / "j")
    jckpt.save_checkpoint(jpath, model={"w": np.zeros(8, np.float32),
                                        "b": np.ones(4, np.float32)})
    fresh = _Tiny()
    checkpoints.load_checkpoint(jpath, model=fresh)
    assert float(fresh.b.detach().sum()) == 4.0
    with pytest.raises(ValueError, match="shape"):
        checkpoints.load_checkpoint(jpath, model=_Tiny(6))


def test_optimizer_resume_needs_the_ports_optimizer_state(tmp_path):
    """A save without an optimizer cannot resume one: the load raises, and
    a model-only load of the same file still works. A JAX .npz with its
    optax state resumes: the update count and both moments come back under
    the port's names (the cases of :func:`test_jax_optimizer_state_resumes`
    hold the next update)."""
    model = _Tiny()
    opt = optim.FusedAdamW(model, 1e-3)
    path = str(tmp_path / "m")
    checkpoints.save_checkpoint(path, model=_Tiny())
    with pytest.raises(ValueError, match="no optimizer state"):
        checkpoints.load_checkpoint(path, model=model, optimizer=opt)
    checkpoints.load_checkpoint(path, model=model)
    assert opt.count == 0
    params = {"w": jnp.arange(8, dtype=jnp.float32), "b": jnp.ones(4)}
    tx = joptim.make_optimizer(1e-3, max_grad_norm=1.0)
    state = tx.init(params)
    grads = {"w": jnp.full(8, 0.5), "b": jnp.full(4, -0.25)}
    for _ in range(5):
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    jpath = str(tmp_path / "j")
    jckpt.save_checkpoint(jpath, model=params, optimizer=state)
    checkpoints.load_checkpoint(jpath, model=model, optimizer=opt)
    assert opt.count == 5
    got = opt.state_dict()
    for key, tree in (("m", state[1].mu), ("v", state[1].nu)):
        for name in ("w", "b"):
            np.testing.assert_array_equal(got[key][name].numpy(),
                                          np.asarray(tree[name]))


def _resume_case(chain, lr_fn, params):
    """(tx, apply): a JAX optimizer the drivers build, and one update or
    micro-step ``apply(grads, state, params) -> (params, state)``."""
    kw = dict(adam_eps=1e-6, weight_decay=0.01, betas=(0.9, 0.98),
              max_grad_norm=1.0, first_lr_step=1)
    if chain.startswith("fused"):
        tx = joptim.make_fused_adamw(
            lr_fn, state_dtype=jnp.bfloat16 if chain == "fused_bf16" else None,
            **kw)
        return tx, lambda g, s, p: tx.apply(g, s, p)
    tx = joptim.make_optimizer(lr_fn, **kw)
    if chain.startswith("multisteps"):
        tx = optax.MultiSteps(tx, every_k_schedule=2)

    def apply(g, s, p):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    return tx, apply


@pytest.mark.parametrize("chain,micro_steps", [
    ("clip_chain", 3), ("fused", 3), ("fused_bf16", 3),
    ("multisteps_boundary", 4), ("multisteps_mid_window", 5)])
def test_jax_optimizer_state_resumes(tmp_path, chain, micro_steps):
    """A JAX .npz written by ``make_optimizer`` (clip + the reference
    AdamW; under ``optax.MultiSteps`` at an update boundary and mid-way
    through a window) or by ``make_fused_adamw`` (a float32 or a bfloat16
    first moment, the latter stored as 2-byte leaves) resumes in the port:
    the next update equals JAX's within 1e-5, and the count and the
    schedule carry (UNITER's first_lr_step 1, decay, clip). A window left
    mid-way goes into the step's accumulator; without one the load
    raises."""
    rng = np.random.default_rng(3)
    params = {"w": jnp.asarray(rng.standard_normal(8), jnp.float32),
              "b": jnp.asarray(rng.standard_normal(4), jnp.float32)}
    j_lr = joptim.schedule_linear(1e-2, 2, 10)
    tx, apply = _resume_case(chain, j_lr, params)
    state = tx.init(params)
    grads = [{k: jnp.asarray(rng.standard_normal(v.shape), jnp.float32)
              for k, v in params.items()} for _ in range(micro_steps + 1)]
    for g in grads[:-1]:
        params, state = apply(g, state, params)
    path = str(tmp_path / "model_step_2")
    jckpt.save_checkpoint(path, model=params, optimizer=state, step=2)

    model = _Tiny()
    accum = 2 if chain.startswith("multisteps") else 1
    opt = optim.make_fused_adamw(
        model, optim.schedule_linear(1e-2, 2, 10), adam_eps=1e-6,
        weight_decay=0.01, betas=(0.9, 0.98), max_grad_norm=1.0,
        first_lr_step=1, state_dtype=(torch.bfloat16 if chain == "fused_bf16"
                                      else torch.float32))
    acc = itm_step.GradAccumulator(opt.params, accum)
    if chain == "multisteps_mid_window":
        with pytest.raises(ValueError, match="micro-batch 1"):
            checkpoints.load_checkpoint(path, model=_Tiny(),
                                        optimizer=optim.make_optimizer(
                                            _Tiny(), 1e-2))
    assert checkpoints.load_checkpoint(path, model=model, optimizer=opt,
                                       accumulator=acc)["step"] == 2
    assert opt.count == micro_steps // accum
    assert acc.mini_step == micro_steps % accum
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(),
                                      np.asarray(params[n]))
    params, state = apply(grads[-1], state, params)
    for n, p in model.named_parameters():
        p.grad = torch.from_numpy(np.array(grads[-1][n]))
    if acc.add():
        opt.step()
    assert opt.count == (micro_steps + 1) // accum
    for n, p in model.named_parameters():
        want = np.asarray(params[n])
        np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=n)


def test_optimizer_state_round_trips(tmp_path):
    """The optimizer's count and both moments come back from a
    checkpoint, and a further update equals one without the save."""
    from test_torch_train import _itm_batch, _pair

    _, _, model = _pair(seed=5)
    model.train()
    opt = optim.make_optimizer(model, 1e-3, max_grad_norm=1.0)
    step = itm_step.make_itm_train_step(model, opt, device="cpu")
    step(_itm_batch(4, 0, seed=60))
    path = str(tmp_path / "s")
    checkpoints.save_checkpoint(path, model=model, optimizer=opt, step=1)
    _, _, other = _pair(seed=6)
    other.train()
    opt2 = optim.make_optimizer(other, 1e-3, max_grad_norm=1.0)
    assert checkpoints.load_checkpoint(path, model=other,
                                       optimizer=opt2)["step"] == 1
    assert opt2.count == 1
    step2 = itm_step.make_itm_train_step(other, opt2, device="cpu")
    b = _itm_batch(4, 0, seed=61)
    step(b)
    step2(b)
    for (n, p), q in zip(model.named_parameters(), other.parameters()):
        assert torch.equal(p, q), n


def test_factory_rejects_a_path_without_a_checkpoint(tmp_path):
    args = train_itm.build_parser().parse_args([])
    args.txt_model_config = args.img_model_config = str(tmp_path / "c.json")
    with open(args.txt_model_config, "w") as f:
        json.dump(SMALL, f)
    args.compute_dtype = "f32"
    args.biencoder_checkpoint = str(tmp_path / "nothing")
    with pytest.raises(ValueError, match="torch state dicts"):
        factory.build_biencoder(args)


# ---------------------------------------------------------------------------
# hard negatives, preemption, runtime
# ---------------------------------------------------------------------------

def _jax_pair(cfg_path, seed=7):
    """A JAX BiEncoder at the file's config with seeded noise on every
    leaf, and the port's BiEncoder holding the same weights."""
    from lightningdot_tpu.config import EncoderConfig as JCfg
    from lightningdot_tpu.models.bi_encoder import BiEncoder as JBiEncoder
    from lightningdot_tpu_torch.config import EncoderConfig

    with open(cfg_path) as f:
        d = json.load(f)
    jmodel = JBiEncoder(JCfg(**d), JCfg(**d), compute_dtype=jnp.float32)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: (np.asarray(x) + 0.2 * rng.standard_normal(x.shape)
                   ).astype(np.float32), jmodel.init(jax.random.PRNGKey(0)))
    model = BiEncoder(EncoderConfig(**d), EncoderConfig(**d))
    checkpoints.load_state_dict_strict(
        model, biencoder_state_dict_from_jax(params))
    return jmodel, jax.tree.map(jnp.asarray, params), model


def test_hard_negative_mining_matches_jax(synth, tmp_path_factory):
    """The same ranks give the same negatives: the port's miner against
    JAX's on one model's weights, the seeded rng in the same state; the
    mappings and random negatives too; a short pool raises in both."""
    from lightningdot_tpu.data import feat_db as jfeat_db
    from lightningdot_tpu.data import itm as jitm
    from lightningdot_tpu.training import trainer_utils as jtu
    from lightningdot_tpu_torch.data import feat_db, itm
    from lightningdot_tpu_torch.training import trainer_utils

    txt_dir, img_dir = synth
    got_maps = hn.get_img_txt_mappings([txt_dir])
    want_maps = jhn.get_img_txt_mappings([txt_dir])
    assert [dict(m) for m in got_maps] == [dict(m) for m in want_maps]
    i2t, t2i, i2s, t2s, s2i, s2t = got_maps
    assert (hn.random_hard_neg(t2i, 2, t2s, s2i, rng=random.Random(3))
            == jhn.random_hard_neg(t2i, 2, t2s, s2i, rng=random.Random(3)))
    assert (hn.random_hard_neg(i2t, 2, i2s, s2t, rng=random.Random(4))
            == jhn.random_hard_neg(i2t, 2, i2s, s2t, rng=random.Random(4)))

    jmodel, params, model = _jax_pair(_cfg_file(tmp_path_factory))
    args = argparse.Namespace(
        max_txt_len=30, num_hard_negatives=2, inf_minibatch_size=0,
        train_batch_size=8, valid_batch_size=8, seed=1, loader_workers=1)
    ds = trainer_utils.load_dataset(feat_db.ImageDbGroup(0.2, 10, 5, 10),
                                    [txt_dir], [img_dir], args, True)
    jds = jtu.load_dataset(jfeat_db.ImageDbGroup(0.2, 10, 5, 10),
                           [txt_dir], [img_dir], args, True)
    collate = lambda x: itm.itm_fast_collate(  # noqa: E731
        x, itm.CollateConfig(fixed_batch=8))
    jcollate = lambda x: jitm.itm_fast_collate(  # noqa: E731
        x, jitm.CollateConfig(fixed_batch=8))
    got = hn.sampled_hard_negatives(model, ds.datasets, collate, args, i2t,
                                    t2i, rng=random.Random(5), device="cpu")
    want = jhn.sampled_hard_negatives(jmodel, params, jds.datasets,
                                      jcollate, args, i2t, t2i,
                                      rng=random.Random(5))
    assert got == want
    assert not model.training   # the miner encodes in eval mode
    args.num_hard_negatives = 60
    with pytest.raises(ValueError, match="hard-negative candidates"):
        hn.sampled_hard_negatives(model, ds.datasets, collate, args, i2t,
                                  t2i, device="cpu")


def test_single_host_sim_acts_immediately():
    """test_preemption.py:13."""
    guard = PreemptionGuard(sim_after_step=3)
    assert not guard.check(1)
    assert not guard.check(2)
    assert guard.check(3)
    assert guard.requested and guard.sync()


def test_reentrant_enter_exit_preserves_outer_handler():
    """test_preemption.py:57: only the outermost exit restores the
    previous handler."""
    def noop(sig, frm):
        pass

    old = signal.signal(signal.SIGTERM, noop)
    try:
        guard = PreemptionGuard()
        with guard:
            assert signal.getsignal(signal.SIGTERM) == guard._handler
            with guard:
                assert signal.getsignal(signal.SIGTERM) == guard._handler
            assert signal.getsignal(signal.SIGTERM) == guard._handler
        assert signal.getsignal(signal.SIGTERM) is noop
    finally:
        signal.signal(signal.SIGTERM, old)


def test_guard_refuses_several_processes(monkeypatch):
    """With more than one process the guard does not act for one host
    alone: off the ``check_every`` boundaries a local latch waits, and at
    a boundary (and at ``sync``) the flag is OR-reduced over the
    processes, a peer's latch included (test_preemption.py:23,46)."""
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    calls = []
    monkeypatch.setattr(preemption, "host_all_gather",
                        lambda flag: calls.append(flag) or [flag, True])
    guard = PreemptionGuard(check_every=4)
    assert [guard.check(s) for s in (1, 2, 3)] == [False] * 3
    assert calls == []
    assert guard.check(4) and calls == [False]
    assert PreemptionGuard().sync() and len(calls) == 2


def test_step_generator_is_a_function_of_seed_and_step():
    draw = lambda s, n: torch.rand(4, generator=runtime.step_generator(  # noqa
        s, n))
    assert torch.equal(draw(42, 7), draw(42, 7))
    assert not torch.equal(draw(42, 7), draw(42, 8))
    assert not torch.equal(draw(42, 7), draw(43, 7))


def test_fixed_tower_gets_no_gradient():
    """``--fix_txt_encoder`` (JAX's ``stop_gradient`` on the tower): the
    text tower gets no gradient, the image tower does."""
    from test_torch_train import _itm_batch, _pair

    _, _, model = _pair(seed=8)
    model.fix_txt_encoder = True
    model.train()
    loss, _, _ = itm_step.itm_loss_fn(
        model, itm_step.batch_to_device(_itm_batch(4, 0, seed=70),
                                        torch.device("cpu")))
    loss.backward()
    assert all(p.grad is None for p in model.txt_model.parameters())
    assert any(p.grad is not None for p in model.img_model.parameters())
