"""Knowledge distillation and VQA across processes (``torch.distributed``
over gloo on the CPU), each held against the port's one-process step on the
global batch and against the JAX package's single-process step on it.

JAX is no yardstick across processes here: its multi-host ``shard_batch``
concatenates the per-host KD grids, so student and teacher rows stop
pairing up, and its VQA driver jits without a mesh, so its replicas
exchange no gradients (ROADMAP §C). Its single-process run on the global
batch is correct, and both ports are held to it.

The ranks are the workers of tests/test_torch_multiprocess.py
(``run_workers``), running this file's ``run_kd_vqa`` scenario on
mp_common's tiny model. Each rank's batches have their own text and region
padding (the global batch pads to the largest, as one process's collate
would), so the KD grid's gathered image rows and texts are re-padded. The
cases:

* KD (T 2, weight 1) with local batch 6 and ``n_teacher`` 4; with
  ``n_teacher`` 10, whose first images span both ranks; with one hard
  negative per item; and on four ranks of 3 rows, ``n_teacher`` 10;
* VQA (12 answers) with accumulation 2 and the head at 10x the learning
  rate, one row of rank 1's batches padded out.

Bounds: per-step losses within 2e-5 (``LOSS_ATOL``) of both references,
and the ranks' weights within ``UPDATE_RTOL`` (1e-3) of the update that
each reference made, every leaf in one norm. This module imports no JAX at
its top: the workers import it.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

import mp_common as mpc
from test_torch_multiprocess import (LOSS_ATOL, LR, UPDATE_RTOL, _digest,
                                     _one, _optimizer, _tiny_biencoder, emit,
                                     run_workers)

SCENARIO = "test_torch_multiprocess_kd_vqa:run_kd_vqa"
STEPS = 3
KD_T = 2.0
KD_WEIGHT = 1.0
# (name, local batch, n_teacher, hard negatives per item)
KD_CASES = (("kd", 6, 4, 0), ("kd_span", 6, 10, 0), ("kd_hn", 4, 4, 1))
KD_FOUR = (("kd_four", 3, 10, 0),)
VQA_ANSWERS = 12
VQA_BS = 4
VQA_STEPS = 4        # micro-batches: two updates at accumulation 2
VQA_ACCUM = 2
VQA_LR_MUL = 10.0


# ---------------------------------------------------------------------------
# per-rank batches, and the global batch one process's collate makes
# ---------------------------------------------------------------------------

def local_batch(step: int, rank: int, bs: int, negs: int = 0,
                seed: int = 55):
    """``bs`` positives then ``bs * negs`` negatives (item-major) for
    (step, rank), with this rank's own padding: texts padded to
    8-12 tokens and images to 4-6 regions by rank, shorter rows inside."""
    rng = np.random.default_rng([seed, step, rank])
    rows = bs * (1 + negs)
    length = mpc.TXT_LEN - 4 + 2 * (rank % 3)
    regions = mpc.N_REG - 2 + rank % 3
    lens = rng.integers(3, length + 1, rows)
    lens[rank % rows] = length
    nbb = rng.integers(2, regions + 1, rows)
    nbb[(rank + 1) % rows] = regions
    ids = np.zeros((rows, length), np.int32)
    txt_mask = np.zeros((rows, length), np.int32)
    img_mask = np.zeros((rows, 1 + regions), np.int32)
    feat = np.zeros((rows, regions, mpc.TINY["img_dim"]), np.float32)
    pos = np.zeros((rows, regions, 7), np.float32)
    for i in range(rows):
        ids[i, :lens[i]] = rng.integers(5, mpc.TINY["vocab_size"], lens[i])
        txt_mask[i, :lens[i]] = 1
        img_mask[i, :1 + nbb[i]] = 1
        feat[i, :nbb[i]] = rng.standard_normal((nbb[i], feat.shape[2]))
        pos[i, :nbb[i]] = rng.random((nbb[i], 7))
    return {
        "txts": {"input_ids": ids, "attention_mask": txt_mask,
                 "position_ids": np.tile(np.arange(length, dtype=np.int32),
                                         (rows, 1))},
        "imgs": {"input_ids": np.full((rows, 1), 101, np.int32),
                 "attention_mask": img_mask, "img_feat": feat,
                 "img_pos_feat": pos},
        "caps": None,
        "valid_mask": np.ones((bs,), np.float32),
        "sample_size": bs,
    }


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    return np.pad(x, [(0, 0), (0, n - x.shape[1])]
                  + [(0, 0)] * (x.ndim - 2))


def global_batch(parts, bs: int, negs: int = 0):
    """The ranks' ``parts`` as one process's collate lays out their items:
    every rank's positives, then every rank's negatives, padded to the
    longest text and the most regions."""
    length = max(p["txts"]["input_ids"].shape[1] for p in parts)
    regions = max(p["imgs"]["img_feat"].shape[1] for p in parts)
    pad = {"input_ids": length, "attention_mask": length,
           "position_ids": length}
    img_pad = {"input_ids": 1, "attention_mask": 1 + regions,
               "img_feat": regions, "img_pos_feat": regions}

    def cat(side, key, width):
        rows = [p[side][key] for p in parts]
        if key == "position_ids":
            rows = [np.tile(np.arange(width, dtype=np.int32),
                            (r.shape[0], 1)) for r in rows]
        rows = [_pad_to(r, width) for r in rows]
        return np.concatenate([r[:bs] for r in rows]
                              + [r[bs:] for r in rows])

    out = {"txts": {k: cat("txts", k, w) for k, w in pad.items()},
           "imgs": {k: cat("imgs", k, w) for k, w in img_pad.items()},
           "caps": None,
           "valid_mask": np.concatenate([p["valid_mask"] for p in parts]),
           "sample_size": bs * len(parts)}
    if "targets" in parts[0]:
        out["targets"] = np.concatenate([p["targets"] for p in parts])
    return out


def vqa_local_batch(step: int, rank: int):
    """``local_batch`` with soft targets over VQA_ANSWERS answers; rank 1's
    last row is padding (``valid_mask`` 0), so the global valid count is
    not the ranks' rows."""
    b = local_batch(step, rank, VQA_BS, seed=77)
    rng = np.random.default_rng([78, step, rank])
    b["targets"] = ((rng.random((VQA_BS, VQA_ANSWERS)) < 0.3)
                    * rng.integers(1, 4, (VQA_BS, VQA_ANSWERS)) / 3.0
                    ).astype(np.float32)
    if rank == 1:
        b["valid_mask"][-1] = 0.0
    return b


# ---------------------------------------------------------------------------
# the port's models and steps (workers and one-process references)
# ---------------------------------------------------------------------------

def _tiny_teacher(path: str):
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.models.cross_encoder import CrossEncoder

    teacher = CrossEncoder(EncoderConfig(**mpc.TINY))
    teacher.load_state_dict({k: torch.as_tensor(v) for k, v in
                             torch.load(path).items()})
    return teacher.eval()


def _kd_step(cfg, n_teacher, negs):
    from lightningdot_tpu_torch.training.itm_step import (make_itm_train_step,
                                                          make_kd_fn)

    model = _tiny_biencoder(cfg["weights"])
    kd_fn = make_kd_fn(_tiny_teacher(cfg["teacher"]), T=KD_T,
                       n_teacher=n_teacher, num_hard_negatives=negs)
    step = make_itm_train_step(model, _optimizer(model),
                               num_hard_negatives=negs, kd_fn=kd_fn,
                               kd_loss_weight=KD_WEIGHT, device="cpu")
    return model, step


def _tiny_vqa(path: str):
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
    from lightningdot_tpu_torch.models.vqa import BiEncoderForVQA

    model = BiEncoderForVQA(BiEncoder(EncoderConfig(**mpc.TINY),
                                      EncoderConfig(**mpc.TINY)),
                            mpc.TINY["hidden_size"], VQA_ANSWERS)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           torch.load(path).items()})
    return model.train()


def _vqa_step(path: str):
    from lightningdot_tpu_torch.training.optim import (make_optimizer,
                                                       schedule_linear)
    from lightningdot_tpu_torch.training.vqa_step import make_vqa_train_step

    model = _tiny_vqa(path)
    opt = make_optimizer(model, schedule_linear(LR["peak"], LR["warmup"],
                                                LR["total"]),
                         betas=(0.9, 0.98), adam_eps=1e-6, weight_decay=0.01,
                         max_grad_norm=1.0, first_lr_step=1,
                         lr_mul={"vqa_output.": VQA_LR_MUL})
    return model, make_vqa_train_step(model, opt, accum_steps=VQA_ACCUM,
                                      device="cpu")


def _port_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def run_kd_vqa(cfg) -> None:
    """The worker: each of ``cfg['kd_cases']`` for STEPS steps, then (with
    ``cfg['vqa']``) the VQA steps; losses and digests for every rank, the
    weights from rank 0."""
    rank, world = cfg["rank"], cfg["world"]
    for name, bs, n_teacher, negs in cfg["kd_cases"]:
        model, step = _kd_step(cfg, n_teacher, negs)
        metrics = [step(local_batch(s, rank, bs, negs)) for s in range(STEPS)]
        emit("losses", phase=name, rank=rank,
             values=[float(m["loss"]) for m in metrics],
             kd=[float(m["kd_loss"]) for m in metrics])
        emit("digest", phase=name, rank=rank, value=_digest(model))
        if rank == 0:
            torch.save(_port_state(model),
                       os.path.join(cfg["workdir"], f"{name}.pt"))
    if not cfg.get("vqa"):
        return
    model, step = _vqa_step(cfg["vqa_weights"])
    metrics = [step(vqa_local_batch(s, rank)) for s in range(VQA_STEPS)]
    emit("losses", phase="vqa", rank=rank,
         values=[float(m["loss"]) for m in metrics],
         score=[float(m["score"]) for m in metrics])
    emit("digest", phase="vqa", rank=rank, value=_digest(model))
    if rank == 0:
        torch.save(_port_state(model), os.path.join(cfg["workdir"],
                                                    "vqa.pt"))


# ---------------------------------------------------------------------------
# the JAX package's single-process references
# ---------------------------------------------------------------------------

def _numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _noisy(tree, seed, std):
    import jax

    r = np.random.default_rng(seed)
    return jax.tree.map(lambda x: np.asarray(x) + std * r.standard_normal(
        x.shape).astype(np.float32), tree)


def _jax_teacher():
    """The tiny cross-encoder with noise of 0.2 on every leaf: at init
    scale every pair scores nearly alike."""
    import jax

    from lightningdot_tpu.config import EncoderConfig as JCfg
    from lightningdot_tpu.models.cross_encoder import CrossEncoder as JCross

    model = JCross(JCfg(**mpc.TINY))
    return model, _noisy(model.init(jax.random.PRNGKey(5)), 6, 0.2)


def _jax_vqa():
    """The tiny VQA model: mp_common's towers and a head with noise 0.02
    on its init (so that its affines are not trivial)."""
    import jax

    from lightningdot_tpu.models.vqa import BiEncoderForVQA as JVqa

    model = JVqa(bi_encoder=mpc.model_for_step(),
                 hidden_size=mpc.TINY["hidden_size"], num_answer=VQA_ANSWERS)
    params = model.init(jax.random.PRNGKey(2))
    return model, {"biencoder": mpc.init_params(),
                   "vqa_output": _noisy(params["vqa_output"], 3, 0.02)}


def _jax_kd_run(n_teacher, negs, batches):
    """JAX's single-process KD step (jitted, no mesh) on the global
    ``batches``, each with JAX's teacher grid: losses and final params."""
    import jax
    import jax.numpy as jnp

    from lightningdot_tpu.data.itm import make_teacher_batch
    from lightningdot_tpu.training.itm_step import (create_train_state,
                                                    jit_train_step,
                                                    make_itm_train_step,
                                                    make_kd_fn)
    from lightningdot_tpu.training.optim import (make_optimizer,
                                                 schedule_linear)

    tmodel, tparams = _jax_teacher()
    tx = make_optimizer(schedule_linear(LR["peak"], LR["warmup"],
                                        LR["total"]), max_grad_norm=1.0)
    kd = make_kd_fn(tmodel, jax.tree.map(jnp.asarray, tparams), T=KD_T,
                    n_teacher=n_teacher)
    step = jit_train_step(make_itm_train_step(
        mpc.model_for_step(), tx, num_hard_negatives=negs, kd_fn=kd,
        kd_loss_weight=KD_WEIGHT))
    state = create_train_state(jax.tree.map(jnp.array, mpc.init_params()),
                               tx)
    rng = jax.random.PRNGKey(7)
    losses = []
    for s, b in enumerate(batches):
        b = dict(b, teacher=make_teacher_batch(b, n_teacher))
        state, m = step(state, b, jax.random.fold_in(rng, s))
        losses.append(float(m["loss"]))
    return losses, state.params


def _jax_vqa_run(batches):
    """JAX's VQA driver's optimizer (one clip, then the body's and the
    head's AdamW at VQA_LR_MUL, under ``optax.MultiSteps``) and step,
    jitted without a mesh, on the global ``batches``."""
    import jax
    import jax.numpy as jnp
    import optax

    from lightningdot_tpu.training.itm_step import (create_train_state,
                                                    jit_train_step)
    from lightningdot_tpu.training.optim import (
        clip_by_global_norm_with_norm, make_optimizer, schedule_linear)
    from lightningdot_tpu.training.vqa_step import make_vqa_train_step

    model, params = _jax_vqa()
    kw = dict(betas=(0.9, 0.98), adam_eps=1e-6, weight_decay=0.01,
              first_lr_step=1)
    tx = optax.MultiSteps(optax.chain(
        clip_by_global_norm_with_norm(1.0),
        optax.multi_transform(
            {"body": make_optimizer(schedule_linear(
                LR["peak"], LR["warmup"], LR["total"]), **kw),
             "head": make_optimizer(schedule_linear(
                 LR["peak"] * VQA_LR_MUL, LR["warmup"], LR["total"]), **kw)},
            lambda p: {k: ("head" if k == "vqa_output" else "body")
                       for k in p})), every_k_schedule=VQA_ACCUM)
    step = jit_train_step(make_vqa_train_step(model, tx))
    state = create_train_state(jax.tree.map(jnp.array, params), tx)
    rng = jax.random.PRNGKey(9)
    losses = []
    for s, b in enumerate(batches):
        state, m = step(state, b, jax.random.fold_in(rng, s))
        losses.append(float(m["loss"]))
    return losses, state.params


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _update_rel(got, want, master) -> float:
    """||got - want|| / ||want - master||, every leaf in one norm."""
    diff = upd = 0.0
    for k, w in want.items():
        w = torch.from_numpy(np.array(w)).double()
        diff += float((got[k].double() - w).norm()) ** 2
        upd += float((w - master[k].double()).norm()) ** 2
    assert upd > 0
    return (diff / upd) ** 0.5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """mp_common's tiny bi-encoder, the noisy teacher and the VQA model,
    from the JAX package's initializations, as the port's state dicts."""
    from lightningdot_tpu_torch.models.weights import (
        biencoder_state_dict_from_jax, cross_encoder_state_dict_from_jax,
        vqa_state_dict_from_jax)

    root = tmp_path_factory.mktemp("kd_vqa_weights")
    out = {}
    for name, sd in (
            ("weights", biencoder_state_dict_from_jax(mpc.init_params())),
            ("teacher", cross_encoder_state_dict_from_jax(_jax_teacher()[1])),
            ("vqa_weights", vqa_state_dict_from_jax(_jax_vqa()[1]))):
        out[name] = str(root / f"{name}.pt")
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   out[name])
    return out


def _ranks(world, cases, tmp_path, weights, vqa):
    events = run_workers(world, SCENARIO, workdir=str(tmp_path),
                         kd_cases=cases, vqa=vqa, **weights)
    out = {}
    for name in [c[0] for c in cases] + (["vqa"] if vqa else []):
        curves = [_one(events[r], "losses", phase=name) for r in range(world)]
        digests = {_one(events[r], "digest", phase=name)["value"]
                   for r in range(world)}
        assert all(c["values"] == curves[0]["values"] for c in curves), name
        assert len(digests) == 1, f"{name}: the ranks hold other weights"
        out[name] = dict(curves[0], weights=torch.load(
            tmp_path / f"{name}.pt"))
    return out


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, weights):
    return _ranks(2, KD_CASES, tmp_path_factory.mktemp("kd_vqa_two"),
                  weights, vqa=True)


def _hold_kd(ranks, weights, world, name, bs, n_teacher, negs):
    """The ranks' KD run against the port's one process and JAX's single
    process on the global batches."""
    from lightningdot_tpu_torch.data.itm import make_teacher_batch
    from lightningdot_tpu_torch.models.weights import \
        biencoder_state_dict_from_jax

    batches = [global_batch([local_batch(s, r, bs, negs)
                             for r in range(world)], bs, negs)
               for s in range(STEPS)]
    model, step = _kd_step(weights, n_teacher, negs)
    master = _port_state(model)
    one = [step(dict(b, teacher=make_teacher_batch(b, n_teacher)))
           for b in batches]
    jlosses, jparams = _jax_kd_run(n_teacher, negs, batches)
    got = ranks[name]
    np.testing.assert_allclose(got["values"], [float(m["loss"]) for m in one],
                               rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["kd"], [float(m["kd_loss"]) for m in one],
                               rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["values"], jlosses, rtol=0,
                               atol=LOSS_ATOL)
    assert min(got["kd"]) > 0 and got["values"][0] != got["values"][-1]
    assert _update_rel(got["weights"], _port_state(model),
                       master) <= UPDATE_RTOL
    assert _update_rel(got["weights"], biencoder_state_dict_from_jax(
        jparams), master) <= UPDATE_RTOL


@pytest.mark.parametrize("case", KD_CASES, ids=[c[0] for c in KD_CASES])
def test_kd_two_processes_match_one_process_and_jax(two_ranks, weights,
                                                     case):
    """KD on two gloo ranks: the global KD term (the student against every
    rank's positives, the teacher's blocks of every rank's texts against
    the first ``n_teacher`` global images), 1/2 of it differentiated on
    each rank. Cases: ``n_teacher`` within rank 0's rows; spanning both
    ranks (local batch 6, ``n_teacher`` 10); one hard negative per item
    (the positives first in the gathered layout)."""
    _hold_kd(two_ranks, weights, 2, *case)


def test_kd_four_processes_match_one_process_and_jax(tmp_path, weights):
    """KD on four gloo ranks of 3 rows, ``n_teacher`` 10: the first images
    come from four ranks, and each rank adds 1/4 of the term."""
    ranks = _ranks(4, KD_FOUR, tmp_path, weights, vqa=False)
    _hold_kd(ranks, weights, 4, *KD_FOUR[0])


def test_vqa_two_processes_match_one_process_and_jax(two_ranks, weights):
    """VQA on two gloo ranks, accumulation 2, the head at 10x the learning
    rate: the loss over the global valid count (rank 1 pads a row), the
    gradients summed once per update before the clip."""
    from lightningdot_tpu_torch.models.weights import vqa_state_dict_from_jax

    batches = [global_batch([vqa_local_batch(s, r) for r in range(2)],
                            VQA_BS) for s in range(VQA_STEPS)]
    model, step = _vqa_step(weights["vqa_weights"])
    master = _port_state(model)
    one = [step(b) for b in batches]
    jlosses, jparams = _jax_vqa_run(batches)
    got = two_ranks["vqa"]
    np.testing.assert_allclose(got["values"], [float(m["loss"]) for m in one],
                               rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(got["score"],
                               [float(m["score"]) for m in one], rtol=0,
                               atol=LOSS_ATOL)
    np.testing.assert_allclose(got["values"], jlosses, rtol=0,
                               atol=LOSS_ATOL)
    assert got["values"][0] != got["values"][-1]
    assert _update_rel(got["weights"], _port_state(model),
                       master) <= UPDATE_RTOL
    assert _update_rel(got["weights"], vqa_state_dict_from_jax(
        _numpy(jparams)), master) <= UPDATE_RTOL
