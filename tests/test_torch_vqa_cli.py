"""The port's VQA fine-tuning driver (``lightningdot_tpu_torch.cli.
train_vqa``) against the JAX driver, and tests/test_vqa.py's driver cases
on the port.

Sizes: tests/test_vqa.py's tiny config (hidden 32, 2 layers, 4 heads,
intermediate 64, img_dim 32, dropout 0) over ``synth.py`` DBs of 8 images
x 2 questions with 12 answers. Both drivers start from one ``.pt`` of
towers; the JAX head comes from ``BiEncoderForVQA.init(PRNGKey(seed))`` and
reaches the port through ``vqa_state_dict_from_jax``. float32 throughout.
Tolerances: per-step losses within 1e-5 relative, each leaf of the final
weights within 1e-4 relative L2, the accuracy and the answers equal.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from lightningdot_tpu.cli import train_vqa as jcli
from lightningdot_tpu.data.feat_db import DetectFeatDb as JDetectFeatDb
from lightningdot_tpu.data.synth import make_synth_dataset as jmake_synth
from lightningdot_tpu.data.txt_db import TxtTokDb as JTxtTokDb
from lightningdot_tpu.data.vqa import VqaCollateConfig as JCollateConfig
from lightningdot_tpu.data.vqa import VqaEvalDataset as JVqaEvalDataset
from lightningdot_tpu.data.vqa import vqa_collate as jvqa_collate
from lightningdot_tpu.models.checkpoint_torch import map_tower
from lightningdot_tpu.models.vqa import BiEncoderForVQA as JBiEncoderForVQA
from lightningdot_tpu.training import checkpoints as jckpt
from lightningdot_tpu.training import vqa_step as jvqa_step
from lightningdot_tpu.training.trainer_utils import \
    build_dataloader as jbuild_dataloader
from lightningdot_tpu_torch.cli import train_itm, train_vqa
from lightningdot_tpu_torch.data.synth import make_synth_dataset
from lightningdot_tpu_torch.models import factory
from lightningdot_tpu_torch.models.vqa import BiEncoderForVQA
from lightningdot_tpu_torch.models.weights import (load_torch_state_dict,
                                                   vqa_state_dict_from_jax)
from lightningdot_tpu_torch.training import checkpoints
from lightningdot_tpu_torch.training.vqa_step import evaluate_vqa

N_ANSWERS = 12
CFG = {"vocab_size": 28996, "hidden_size": 32, "num_hidden_layers": 2,
       "num_attention_heads": 4, "intermediate_size": 64,
       "max_position_embeddings": 64, "img_dim": 32,
       "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}
LOSS_RTOL = 1e-5
LEAF_REL_L2 = 1e-4


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("vqa")
    return make_synth_dataset(
        str(root), n_imgs=8, txts_per_img=2, img_dim=32, min_bb=5,
        max_bb=10, max_txt_len=20, seed=3, vqa_answers=N_ANSWERS)


@pytest.fixture(scope="module")
def cfg(tmp_path_factory):
    p = tmp_path_factory.mktemp("cfg") / "small.json"
    p.write_text(json.dumps(CFG))
    return str(p)


def _cli(cfg, synth, out_dir, *extra):
    txt_dir, img_dir = synth
    return ["--txt_model_config", cfg, "--img_model_config", cfg,
            "--train_txt_dbs", txt_dir, "--train_img_dbs", img_dir,
            "--val_txt_db", txt_dir, "--val_img_db", img_dir,
            "--num_answers", str(N_ANSWERS), "--train_batch_size", "8",
            "--valid_batch_size", "16", "--max_bb", "10", "--min_bb", "5",
            "--num_bb", "10", "--max_txt_len", "30", "--compute_dtype",
            "f32", "--output_dir", out_dir, *extra]


def test_synth_dbs_equal_jax_synth(synth, tmp_path):
    """The port's synth.py writes JAX's records (answers included)."""
    jtxt, jimg = jmake_synth(str(tmp_path), n_imgs=8, txts_per_img=2,
                             img_dim=32, min_bb=5, max_bb=10, max_txt_len=20,
                             seed=3, vqa_answers=N_ANSWERS)
    txt = JTxtTokDb(synth[0], -1)
    want = JTxtTokDb(jtxt, -1)
    assert txt.ids == want.ids
    assert all(txt[i] == want[i] for i in want.ids)
    img = JDetectFeatDb(synth[1], conf_th=0.2, max_bb=10, min_bb=5)
    jdb = JDetectFeatDb(jimg, conf_th=0.2, max_bb=10, min_bb=5)
    assert img.name2nbb == jdb.name2nbb
    for name in jdb.name2nbb:
        for a, b in zip(img[name], jdb[name]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _init_pt(cfg, path):
    """Seeded towers with noise of std 0.2 on every leaf, as a .pt."""
    args = train_itm.build_parser().parse_args(
        ["--txt_model_config", cfg, "--img_model_config", cfg])
    model = factory.build_biencoder(args, seed=3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
    torch.save({"model_dict": model.state_dict()}, path)
    return path


# accumulation 2 over 2 epochs of 4 micro-batches, the head at 10x the
# learning rate
PARITY = ("--num_train_epochs", "2", "--learning_rate", "1e-3",
          "--train_batch_size", "4",
          "--vqa_lr_mul", "10", "--gradient_accumulation_steps", "2",
          "--log_result_step", "1", "--loader_workers", "1", "--seed", "5")


def _jax_head_(model, generator):
    """The port's head set to the JAX driver's ``model.init(PRNGKey(5))``
    head, through ``vqa_state_dict_from_jax``."""
    from lightningdot_tpu.config import EncoderConfig as JCfg
    from lightningdot_tpu.models.bi_encoder import BiEncoder as JBiEncoder

    jbi = JBiEncoder(JCfg(**CFG, project_dim=0), JCfg(**CFG, project_dim=0))
    params = JBiEncoderForVQA(bi_encoder=jbi, hidden_size=32,
                              num_answer=N_ANSWERS).init(
        jax.random.PRNGKey(5))
    sd = vqa_state_dict_from_jax(jax.tree.map(np.asarray, params))
    checkpoints.load_state_dict_strict(
        model, {**{k: v.detach() for k, v in model.state_dict().items()},
                **{k: v for k, v in sd.items()
                   if k.startswith("vqa_output.")}})
    return model


@pytest.fixture(scope="module")
def runs(synth, cfg, tmp_path_factory):
    init = _init_pt(cfg, str(tmp_path_factory.mktemp("init") / "init.pt"))
    out_p = str(tmp_path_factory.mktemp("port"))
    out_j = str(tmp_path_factory.mktemp("jax"))
    extra = PARITY + ("--biencoder_checkpoint", init)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_vqa, "init_vqa_head_", _jax_head_)
        port = train_vqa.main(_cli(cfg, synth, out_p, *extra, "--device",
                                   "cpu"))
    jax_run = jcli.main(_cli(cfg, synth, out_j, *extra))
    return dict(port=port, jax=jax_run, out_p=out_p, out_j=out_j)


def _losses(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [r["loss_train"] for r in map(json.loads, f)
                if "loss_train" in r]


def test_train_vqa_cli_matches_jax(runs, synth, cfg):
    """Per-step losses, validation accuracy and loss, final weights (every
    leaf), and ``evaluate_vqa``'s answers on the final weights."""
    (results, model), (jresults, jstate) = runs["port"], runs["jax"]
    got, want = _losses(runs["out_p"]), _losses(runs["out_j"])
    assert len(got) == len(want) == 6
    rel = np.abs(np.subtract(got, want)) / np.abs(want)
    assert rel.max() <= LOSS_RTOL, (got, want)
    assert results["best_val_acc"] == jresults["best_val_acc"]
    assert results["last_val"]["acc"] == jresults["last_val"]["acc"]
    assert results["last_val"]["loss"] == pytest.approx(
        jresults["last_val"]["loss"], rel=1e-5)
    want_sd = vqa_state_dict_from_jax(jax.tree.map(np.asarray,
                                                   jstate.params))
    got_sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert got_sd.keys() == want_sd.keys()
    worst = max((float(np.linalg.norm(got_sd[k] - w)
                       / max(np.linalg.norm(w), 1e-12)), k)
                for k, w in want_sd.items())
    assert worst[0] <= LEAF_REL_L2, worst

    # evaluate_vqa of each package on its final weights
    txt_dir, img_dir = synth
    jds = JVqaEvalDataset(N_ANSWERS, JTxtTokDb(txt_dir, -1),
                          JDetectFeatDb(img_dir, conf_th=0.2, max_bb=10,
                                        min_bb=5, num_bb=10))
    args = jcli.build_parser().parse_args(
        _cli(cfg, synth, runs["out_j"], "--seed", "5"))
    jloader = jbuild_dataloader(
        jds, lambda items: jvqa_collate(items, JCollateConfig(
            fixed_batch=16)), False, args)
    jmodel = JBiEncoderForVQA(
        bi_encoder=jcli.build_biencoder(args, seed=5)[0], hidden_size=32,
        num_answer=N_ANSWERS)
    jeval = jvqa_step.evaluate_vqa(jmodel, jstate.params, jloader)
    val = results["epochs"][-1]
    assert val["answers"] == jeval["results"]
    assert val["val_acc"] == jeval["acc"]


def test_vqa_checkpoints_read_across_packages(runs):
    """The port reads the JAX driver's vqa.best/last (.npz) into a
    ``BiEncoderForVQA``; JAX's ``map_tower`` reads the port's vqa.last.pt
    (towers under ``biencoder.``, the head under ``vqa_output.{0,2,3}``):
    each equal to its writer's weights."""
    model, jstate = runs["port"][1], runs["jax"][1]
    want = vqa_state_dict_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name in ("best", "last"):
        fresh = BiEncoderForVQA(model.biencoder.__class__(
            model.biencoder.txt_cfg, model.biencoder.img_cfg), 32,
            N_ANSWERS)
        meta = checkpoints.load_checkpoint(
            os.path.join(runs["out_j"], f"vqa.{name}"), model=fresh)
        assert meta["epoch"] == 1 or name == "best"
        if name == "last":
            for k, v in fresh.state_dict().items():
                np.testing.assert_array_equal(v.numpy(), want[k],
                                              err_msg=k)
    sd = load_torch_state_dict(os.path.join(runs["out_p"], "vqa.last.pt"))
    for tower, with_img in (("txt_model", False), ("img_model", True)):
        prefix = f"biencoder.{tower}."
        part = {k[len(prefix):]: v for k, v in sd.items()
                if k.startswith(prefix)}
        tree = map_tower(part, with_img=with_img, num_layers=2)
        got = vqa_state_dict_from_jax(jax.tree.map(np.asarray, {
            "biencoder": {"txt_model": tree, "img_model": tree},
            "vqa_output": {"fc1": {"kernel": sd["vqa_output.0.weight"].T,
                                   "bias": sd["vqa_output.0.bias"]},
                           "ln": {"scale": sd["vqa_output.2.weight"],
                                  "bias": sd["vqa_output.2.bias"]},
                           "fc2": {"kernel": sd["vqa_output.3.weight"].T,
                                   "bias": sd["vqa_output.3.bias"]}}}))
        for k, v in model.state_dict().items():
            if k.startswith(prefix) or k.startswith("vqa_output."):
                np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    jparams = jckpt.load_checkpoint(
        os.path.join(runs["out_j"], "vqa.last"),
        model_template=jstate.params)[0]
    assert jax.tree.structure(jparams) == jax.tree.structure(jstate.params)


def test_train_vqa_overfit(synth, cfg, tmp_path):
    """test_vqa.py's overfit case on the port: trained on = evaluated on
    with soft targets, the argmax answer hits a positive label well above
    the 1/12 chance rate."""
    out = str(tmp_path / "out")
    results, _ = train_vqa.main(_cli(
        cfg, synth, out, "--num_train_epochs", "80", "--learning_rate",
        "1e-3", "--vqa_lr_mul", "10.0", "--log_result_step", "1",
        "--device", "cpu"))
    assert results["best_val_acc"] > 0.5, results["best_val_acc"]
    assert os.path.exists(os.path.join(out, "vqa.best.pt"))
    assert os.path.exists(os.path.join(out, "vqa.last.json"))


@pytest.mark.parametrize("intersection", [False, True])
def test_train_vqa_preemption_checkpoints_and_exits(synth, cfg, tmp_path,
                                                    intersection):
    """The simulated preemption of test_vqa.py: the epoch loop writes
    vqa.last at step 2 of epoch 0 and exits before any validation."""
    out = str(tmp_path / "out")
    results, model = train_vqa.main(_cli(
        cfg, synth, out, "--num_train_epochs", "50", "--sim_preempt_step",
        "2", "--device", "cpu",
        *(["--vqa_intersection"] if intersection else [])))
    assert results == {}
    meta = json.load(open(os.path.join(out, "vqa.last.json")))
    assert meta["step"] == 2 and meta["epoch"] == 0
    fresh = train_vqa.build_model(train_vqa.build_parser().parse_args(
        _cli(cfg, synth, out, *(["--vqa_intersection"] if intersection
                                else []))))
    checkpoints.load_checkpoint(os.path.join(out, "vqa.last"), model=fresh)
    for (n, a), b in zip(model.state_dict().items(),
                         fresh.state_dict().values()):
        assert torch.equal(a, b), n
    assert fresh.vqa_output["2"].weight.shape == (
        (8 if intersection else 4) * 32,)


def test_train_vqa_runs_on_the_card_by_default(synth, cfg, tmp_path):
    """Without ``--device`` the driver asks for the card and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_vqa.main(_cli(cfg, synth, str(tmp_path / "o"),
                            "--num_train_epochs", "1"))


def test_evaluate_vqa_returns_to_training_mode(synth, cfg):
    """The train/eval mode trap: evaluation runs in eval mode and hands
    the model back in training mode."""
    args = train_vqa.build_parser().parse_args(_cli(cfg, synth, "o"))
    model = train_vqa.build_model(args)
    from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
    from lightningdot_tpu_torch.data.loader import DataLoader
    from lightningdot_tpu_torch.data.txt_db import TxtTokDb
    from lightningdot_tpu_torch.data.vqa import (VqaCollateConfig,
                                                 VqaEvalDataset, vqa_collate)

    ds = VqaEvalDataset(N_ANSWERS, TxtTokDb(synth[0], -1),
                        DetectFeatDb(synth[1], conf_th=0.2, max_bb=10,
                                     min_bb=5, num_bb=10))
    modes = []
    real = model.apply

    def spy(*a, **k):
        modes.append(model.training)
        return real(*a, **k)

    model.apply = spy
    loader = DataLoader(ds, batch_size=16, collate_fn=lambda items:
                        vqa_collate(items, VqaCollateConfig(fixed_batch=16)))
    res = evaluate_vqa(model, loader, device="cpu")
    assert modes == [False] and model.training
    assert res["n_ex"] == 16 and len(res["results"]) == 16
