"""The port across processes (``torch.distributed`` over gloo on the CPU),
held against the JAX package's single-process mesh and against the port's
own one-process run on the global batch.

The file is its own worker: ``python tests/test_torch_multiprocess.py
'<json>'`` joins a gloo group from the environment (as under ``torchrun``)
and runs one scenario, printing ``MPRES {json}`` lines that the tests
read. The cases mirror tests/test_multiprocess.py:122,162,186 on the same
tiny model and the same per-(step, rank) batches (tests/mp_common.py):

* ``journey``: ``host_all_gather``, ``assert_same_across_hosts`` raising
  on every rank, ``MetaLoader`` agreement and the preemption flag
  OR-reduced from a peer (``mp_worker.run_smoke``); four ITM steps with
  global in-batch negatives, rank 0's checkpoint, every rank's resume and
  two more steps; three steps of the pre-training itm task (global
  positives); three ITM steps with a hard negative per item; three
  cross-encoder teacher steps (``cli/train_teacher.make_teacher_step``);
* ``driver``: ``cli/pretrain.main`` across processes (fixed-row batches,
  one writer, auto-resume, equal validation), then ``cli/train_itm.main``
  (one writer, the same recall on every rank), with a teacher (KD),
  ``cli/train_teacher.main`` (mined negatives, one writer, the same weights
  on every rank) and ``cli/train_vqa.main``.

Other files run their own scenarios through this worker
(``"module:function"``): tests/test_torch_multiprocess_kd_vqa.py.

Each worker has its own timeout; the worker imports no JAX.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import mp_common as mpc  # noqa: E402

LR = dict(peak=1e-3, warmup=2, total=100)   # mp_common.make_train_setup
HN_BS = 4            # positives per rank in the hard-negative case
HN_STEPS = 3
TEACHER_GROUPS = 2   # triplet groups per rank in the teacher case
TEACHER_STEPS = 3
LOSS_ATOL = 2e-5     # tests/test_multiprocess.py's bound
# the weights after the steps, every leaf in one norm, against the update
# the one-process run made (chip_smoke.py's DIST_UPDATE_RTOL)
UPDATE_RTOL = 1e-3


def emit(event: str, **payload) -> None:
    print("MPRES " + json.dumps({"event": event, **payload}), flush=True)


# ---------------------------------------------------------------------------
# shared by the workers and the one-process references
# ---------------------------------------------------------------------------

def _tiny_biencoder(weights: str):
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.models.bi_encoder import BiEncoder

    model = BiEncoder(EncoderConfig(**mpc.TINY), EncoderConfig(**mpc.TINY))
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           torch.load(weights).items()})
    return model.train()


def _tiny_pretrain(weights: str):
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.models.bi_encoder import (
        BiEncoder, BiEncoderForPretraining)

    model = BiEncoderForPretraining(
        BiEncoder(EncoderConfig(**mpc.TINY), EncoderConfig(**mpc.TINY)),
        img_label_dim=7)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in
                           torch.load(weights).items()})
    return model.train()


def _optimizer(model):
    from lightningdot_tpu_torch.training.optim import (make_optimizer,
                                                       schedule_linear)

    return make_optimizer(model, schedule_linear(LR["peak"], LR["warmup"],
                                                 LR["total"]),
                          max_grad_norm=1.0)


def _itm_step(model, optimizer, negs=0):
    from lightningdot_tpu_torch.training.itm_step import make_itm_train_step

    return make_itm_train_step(model, optimizer, num_hard_negatives=negs,
                               device="cpu")


def hn_local_batch(step: int, rank: int):
    """HN_BS positives then HN_BS negatives (one per item, item-major),
    as ``itm_fast_collate`` lays out a batch with a hard negative."""
    b = mpc.local_itm_batch(step, rank, local_bs=2 * HN_BS, seed=777)
    b["valid_mask"] = np.ones((HN_BS,), np.float32)
    return b


def hn_global_batch(step: int, world: int):
    """The batch one process's collate makes of the same items: every
    rank's positives, then every rank's negatives."""
    parts = [hn_local_batch(step, r) for r in range(world)]

    def cat(key, sub=None):
        rows = [p[key] if sub is None else p[key][sub] for p in parts]
        return np.concatenate([r[:HN_BS] for r in rows]
                              + [r[HN_BS:] for r in rows])

    return {"txts": {k: cat("txts", k) for k in parts[0]["txts"]},
            "imgs": {k: cat("imgs", k) for k in parts[0]["imgs"]},
            "caps": None,
            "valid_mask": np.concatenate([p["valid_mask"] for p in parts])}


def _global(batch_fn, step, world):
    parts = [batch_fn(step, r) for r in range(world)]

    def merge(xs):
        if isinstance(xs[0], dict):
            return {k: merge([x[k] for x in xs]) for k in xs[0]}
        if xs[0] is None:
            return None
        return np.concatenate(xs)

    return merge(parts)


def teacher_groups(step: int, rank: int):
    """TEACHER_GROUPS triplet groups (positive, negative image, negative
    text) of ragged texts and regions for (step, rank), as
    ``ItmRankDataset`` yields them."""
    rng = np.random.default_rng([step, rank, 31])
    groups = []
    for _ in range(TEACHER_GROUPS):
        group = []
        for _ in range(3):
            nbb = int(rng.integers(3, mpc.N_REG + 1))
            group.append({
                "input_ids": [101] + rng.integers(
                    5, mpc.TINY["vocab_size"],
                    int(rng.integers(3, mpc.TXT_LEN))).tolist() + [102],
                "img_feat": rng.standard_normal(
                    (nbb, mpc.TINY["img_dim"])).astype(np.float32),
                "img_pos_feat": rng.random((nbb, 7)).astype(np.float32),
                "num_bb": nbb})
        groups.append(group)
    return groups


def teacher_batch(groups):
    """The joint teacher driver's staged batch of ``groups``."""
    from lightningdot_tpu_torch.data.itm_rank import itm_rank_collate
    from lightningdot_tpu_torch.data.loader import (PinnedStager,
                                                    await_staged)

    batch = itm_rank_collate(groups)
    drop = ("n_groups", "sample_size", "attn_masks_text", "attn_masks_img")
    return await_staged(PinnedStager(torch.device("cpu"))(
        {k: v for k, v in batch.items() if k not in drop}))


def _tiny_teacher():
    """The tiny joint cross-encoder (seeded weights), its step at the
    teacher driver's optimizer, the initial state."""
    from lightningdot_tpu_torch.cli.train_teacher import make_teacher_step
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.models.cross_encoder import (
        CrossEncoder, init_cross_encoder_)
    from lightningdot_tpu_torch.training.optim import (make_optimizer,
                                                       schedule_linear)

    model = init_cross_encoder_(CrossEncoder(EncoderConfig(**mpc.TINY)),
                                torch.Generator().manual_seed(5)).train()
    master = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, schedule_linear(LR["peak"], LR["warmup"],
                                                LR["total"]),
                         max_grad_norm=1.0, betas=(0.9, 0.98),
                         adam_eps=1e-6, weight_decay=0.01, first_lr_step=1)
    return model, make_teacher_step(model, opt, torch.device("cpu")), master


def _teacher_steps(step, batches, rank=0):
    from lightningdot_tpu_torch.utils.runtime import step_generator

    return [float(step(b, step_generator(0, s, rank), sample_size=3)
                  ["loss"]) for s, b in enumerate(batches)]


def _digest(model) -> str:
    from lightningdot_tpu_torch.utils.misc import state_digest

    return state_digest(model)


# ---------------------------------------------------------------------------
# worker scenarios
# ---------------------------------------------------------------------------

def run_smoke(cfg) -> None:
    """mp_worker.run_smoke's checks through the port."""
    from lightningdot_tpu_torch.data.loader import MetaLoader
    from lightningdot_tpu_torch.parallel.mesh import assert_same_across_hosts
    from lightningdot_tpu_torch.utils.misc import host_all_gather
    from lightningdot_tpu_torch.utils.preemption import PreemptionGuard

    rank, world = cfg["rank"], cfg["world"]
    assert_same_across_hosts("mlm_task", "task")
    gathered = host_all_gather({"rank": rank, "sq": rank * rank})
    assert [g["rank"] for g in gathered] == list(range(world)), gathered
    assert [g["sq"] for g in gathered] == [r * r for r in range(world)]
    try:
        assert_same_across_hosts(f"divergent-{rank}", "task")
        raise SystemExit("assert_same_across_hosts missed divergence")
    except RuntimeError:
        pass

    def fake_loader(tag):
        i = 0
        while True:
            yield f"{tag}-{i}"
            i += 1

    it = iter(MetaLoader({"mlm_coco": (fake_loader("a"), 2),
                          "itm_vg": (fake_loader("b"), 1)},
                         accum_steps=2, seed=7))
    assert_same_across_hosts([next(it)[0] for _ in range(12)],
                             "MetaLoader task sequence")
    # only rank 0 latches; off the boundary nobody acts; at it every rank
    guard = PreemptionGuard(check_every=4)
    if rank == 0:
        guard.requested = True
    assert guard.check(3) is False, "acted off the boundary"
    assert guard.check(4), f"rank {rank}: the flag was not OR-reduced"
    assert all(host_all_gather(guard.requested))
    emit("smoke", ok=True, rank=rank)


def run_journey(cfg) -> None:
    from lightningdot_tpu_torch.parallel.mesh import barrier
    from lightningdot_tpu_torch.training.checkpoints import (load_checkpoint,
                                                             rank_saver)
    from lightningdot_tpu_torch.training.pretrain_step import \
        make_pretrain_step

    run_smoke(cfg)
    rank = cfg["rank"]
    model = _tiny_biencoder(cfg["weights"])
    opt = _optimizer(model)
    step = _itm_step(model, opt)
    losses = [float(step(mpc.local_itm_batch(s, rank))["loss"])
              for s in range(mpc.N_STEPS)]
    emit("losses", phase="train", rank=rank, values=losses)
    if cfg.get("short"):
        emit("digest", rank=rank, value=_digest(model))
        return

    # rank 0 writes; every rank resumes from its file
    saver = rank_saver(cfg["workdir"])
    saver.save(model, mpc.N_STEPS, optimizer=opt)
    saver.wait()
    barrier()
    resumed = _tiny_biencoder(cfg["weights"])
    ropt = _optimizer(resumed)
    meta = load_checkpoint(os.path.join(cfg["workdir"],
                                        f"model_step_{mpc.N_STEPS}"),
                           model=resumed, optimizer=ropt)
    assert meta["step"] == mpc.N_STEPS
    for (n, a), b in zip(resumed.state_dict().items(),
                         model.state_dict().values()):
        assert torch.equal(a, b), n
    step = _itm_step(resumed, ropt)
    losses = [float(step(mpc.local_itm_batch(s, rank))["loss"])
              for s in range(mpc.N_STEPS, mpc.N_STEPS + mpc.N_RESUME_STEPS)]
    emit("losses", phase="resume", rank=rank, values=losses)
    emit("digest", rank=rank, value=_digest(resumed))

    # the pre-training itm task: global positives, not the collate's
    # local pos_ctx_indices
    pre = _tiny_pretrain(cfg["pre_weights"])
    step_for_task = make_pretrain_step(pre, _optimizer(pre), device="cpu")
    losses = [float(step_for_task("itm")(mpc.local_itm_pre_batch(s, rank))
                    ["loss"]) for s in range(mpc.N_ITM_PRE_STEPS)]
    emit("losses", phase="itm_pre", rank=rank, values=losses)

    # one hard negative per item
    model = _tiny_biencoder(cfg["weights"])
    step = _itm_step(model, _optimizer(model), negs=1)
    losses = [float(step(hn_local_batch(s, rank))["loss"])
              for s in range(HN_STEPS)]
    emit("losses", phase="hard_negative", rank=rank, values=losses)
    emit("digest_hn", rank=rank, value=_digest(model))

    # the cross-encoder teacher's step: the gradients averaged over the
    # ranks' equal-shaped batches
    model, step, _ = _tiny_teacher()
    losses = _teacher_steps(step, [teacher_batch(teacher_groups(s, rank))
                                   for s in range(TEACHER_STEPS)], rank)
    emit("losses", phase="teacher", rank=rank, values=losses)
    emit("digest_teacher", rank=rank, value=_digest(model))
    if rank == 0:
        torch.save(model.state_dict(),
                   os.path.join(cfg["workdir"], "teacher_ranks.pt"))


def run_driver(cfg) -> None:
    from lightningdot_tpu_torch.cli import (pretrain, train_itm, train_teacher,
                                            train_vqa)

    rank = cfg["rank"]
    for phase, extra in (("initial", []), ("resume", [
            "--num_train_steps", str(cfg["resume_steps"])])):
        results, model = pretrain.main(["--config", cfg["pretrain_config"],
                                        "--compute_dtype", "f32",
                                        "--device", "cpu"] + extra)
        emit("driver", rank=rank, phase=phase, results=results)
    emit("digest", rank=rank, value=_digest(model))
    results, model = train_itm.main(cfg["itm_args"])
    emit("train_itm", rank=rank, recall=[
        (e["recall_txt"], e["recall_img"]) for e in results["epochs"]],
         best=results["best_val_recall_mean"], digest=_digest(model))
    results, model = train_itm.main(cfg["itm_args"] + cfg["kd_args"])
    emit("train_itm_kd", rank=rank, recall=[
        (e["recall_txt"], e["recall_img"]) for e in results["epochs"]],
         best=results["best_val_recall_mean"], digest=_digest(model))
    results, model = train_teacher.main(cfg["teacher_args"])
    emit("train_teacher", rank=rank, losses=results["losses"],
         digest=_digest(model))
    results, model = train_vqa.main(cfg["vqa_args"])
    emit("train_vqa", rank=rank, best=results["best_val_acc"],
         last=results["last_val"], answers=results["epochs"][-1]["answers"],
         steps=[e["steps"] for e in results["epochs"]],
         digest=_digest(model))


def worker_main() -> None:
    cfg = json.loads(sys.argv[1])
    sys.path.insert(0, REPO)
    torch.set_num_threads(1)
    from lightningdot_tpu_torch.parallel.mesh import (initialize_distributed,
                                                      process_count)

    assert initialize_distributed("gloo")    # from the environment
    assert process_count() == cfg["world"]
    scenario = cfg["scenario"]
    if ":" in scenario:
        # another test file's scenario, "module:function" (the module
        # imports no JAX at its top)
        import importlib

        module, name = scenario.split(":")
        run = getattr(importlib.import_module(module), name)
    else:
        run = {"journey": run_journey, "driver": run_driver}[scenario]
    run(cfg)
    emit("done", rank=cfg["rank"])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(world: int, scenario: str, timeout: int = 240, **extra):
    """``world`` worker processes joined over gloo, as ``torchrun`` starts
    them; returns each rank's events."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE=str(world), OMP_NUM_THREADS="1",
                   CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        cfg = {"world": world, "rank": rank, "scenario": scenario, **extra}
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), json.dumps(cfg)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=REPO))
    outs = [""] * world
    try:
        for i, p in enumerate(procs):
            outs[i] = p.communicate(timeout=timeout)[0]
    finally:
        for i, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                outs[i] += p.communicate()[0]
    events = [[json.loads(line[len("MPRES "):])
               for line in out.splitlines() if line.startswith("MPRES ")]
              for out in outs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"rank {r} failed (rc={p.returncode}):\n{out[-6000:]}"
        assert any(e["event"] == "done" for e in events[r]), out[-6000:]
    return events


def _one(events_r, event, **match):
    got = [e for e in events_r if e["event"] == event
           and all(e.get(k) == v for k, v in match.items())]
    assert len(got) == 1, (event, match, events_r)
    return got[0]


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The JAX package's tiny models (mp_common, PRNGKey 0 and 1) as the
    port's state dicts."""
    from lightningdot_tpu_torch.models.weights import (
        biencoder_state_dict_from_jax, pretrain_state_dict_from_jax)

    root = tmp_path_factory.mktemp("mp_weights")
    out = {}
    for name, sd in (
            ("weights", biencoder_state_dict_from_jax(
                mpc.tiny_biencoder()[1])),
            ("pre_weights", pretrain_state_dict_from_jax(
                mpc.tiny_pretrain_model()[1]))):
        out[name] = str(root / f"{name}.pt")
        torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
                   out[name])
    return out


def _port_one_process(weights, batches, negs=0):
    """The port on one process over the global batches."""
    model = _tiny_biencoder(weights["weights"])
    step = _itm_step(model, _optimizer(model), negs)
    return [float(step(b)["loss"]) for b in batches]


def _jax_hn_losses(layout):
    """JAX's single-process two-device mesh over ``layout``'s global
    batches, one hard negative per item."""
    import jax
    from jax.sharding import Mesh

    from lightningdot_tpu.parallel.mesh import replicate
    from lightningdot_tpu.training.itm_step import (create_train_state,
                                                    jit_train_step,
                                                    make_itm_train_step)
    from lightningdot_tpu.training.optim import (make_optimizer,
                                                 schedule_linear)

    mesh = Mesh(np.asarray(jax.devices()[:2]), ("dp",))
    tx = make_optimizer(schedule_linear(LR["peak"], LR["warmup"],
                                        LR["total"]), max_grad_norm=1.0)
    # fresh arrays: the jitted step donates its state
    state = replicate(mesh, create_train_state(mpc.tiny_biencoder()[1], tx))
    step = jit_train_step(make_itm_train_step(mpc.model_for_step(), tx,
                                              num_hard_negatives=1),
                          mesh=mesh)
    rng = jax.random.PRNGKey(7)
    out = []
    for s in range(HN_STEPS):
        state, m = step(state, layout(s), jax.random.fold_in(rng, s))
        out.append(float(m["loss"]))
    return out


def test_two_process_journey_matches_one_process_and_jax(tmp_path, weights):
    """Two gloo ranks: the smoke checks; per-step global ITM losses equal
    on both ranks, within 2e-5 of the port's one-process run on the global
    batch and of the JAX package's single-process mesh run
    (test_multiprocess.py:122); rank 0's checkpoint, the resume, and
    bit-equal weights across ranks; the pre-training itm task against
    both references; one hard negative per item against the one-process
    global batch; the teacher's step (its gradients averaged over the
    ranks, where JAX's replicas exchange none: ROADMAP §C) against the
    one-process step on every rank's groups: losses within 2e-5, weights
    within UPDATE_RTOL of the update."""
    from test_multiprocess import (_single_process_itm_pre_losses,
                                   _single_process_losses)

    events = run_workers(2, "journey", workdir=str(tmp_path), **weights)
    for r in range(2):
        assert _one(events[r], "smoke")["ok"]
    curves = {phase: [_one(events[r], "losses", phase=phase)["values"]
                      for r in range(2)]
              for phase in ("train", "resume", "itm_pre", "hard_negative",
                            "teacher")}
    for phase, (a, b) in curves.items():
        assert a == b, f"{phase}: the ranks report other losses"
        assert all(np.isfinite(a)), phase
    run = curves["train"][0] + curves["resume"][0]

    steps = mpc.N_STEPS + mpc.N_RESUME_STEPS
    port = _port_one_process(
        weights, [mpc.global_itm_batch(s, 2) for s in range(steps)])
    np.testing.assert_allclose(run, port, rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(run, _single_process_losses(2), rtol=0,
                               atol=LOSS_ATOL)
    assert run[0] != run[-1]
    digs = {_one(events[r], "digest")["value"] for r in range(2)}
    assert len(digs) == 1, "the ranks ended on different weights"
    assert os.path.exists(tmp_path / f"model_step_{mpc.N_STEPS}.pt")
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]

    np.testing.assert_allclose(curves["itm_pre"][0],
                               _single_process_itm_pre_losses(2), rtol=0,
                               atol=LOSS_ATOL)

    hn = _port_one_process(
        weights, [hn_global_batch(s, 2) for s in range(HN_STEPS)], negs=1)
    np.testing.assert_allclose(curves["hard_negative"][0], hn, rtol=0,
                               atol=LOSS_ATOL)
    assert len({_one(events[r], "digest_hn")["value"]
                for r in range(2)}) == 1

    model, step, master = _tiny_teacher()
    one = _teacher_steps(step, [teacher_batch(teacher_groups(s, 0)
                                              + teacher_groups(s, 1))
                                for s in range(TEACHER_STEPS)])
    np.testing.assert_allclose(curves["teacher"][0], one, rtol=0,
                               atol=LOSS_ATOL)
    assert len({_one(events[r], "digest_teacher")["value"]
                for r in range(2)}) == 1
    ranks = torch.load(tmp_path / "teacher_ranks.pt")
    want = model.state_dict()
    diff = sum(float((ranks[k].double() - w.double()).norm()) ** 2
               for k, w in want.items())
    update = sum(float((w.double() - master[k].double()).norm()) ** 2
                 for k, w in want.items())
    assert update > 0
    assert (diff / update) ** 0.5 <= UPDATE_RTOL, (diff / update) ** 0.5


def test_hard_negative_layout_against_jax_multi_host(weights):
    """One hard negative per item: JAX's single-process mesh on the batch
    that one process's collate makes (all positives, then all negatives)
    gives the port's one-process losses, and so the port's two ranks'
    (above). JAX's multi-process ``shard_batch`` concatenates whole
    per-host batches instead ([pos0, neg0, pos1, neg1], parallel/mesh.py:
    80-115), which ``itm_step`` reads as a batch of 2 x (pos + neg)
    positives: its losses differ (ROADMAP §C)."""
    collate = _jax_hn_losses(lambda s: hn_global_batch(s, 2))
    per_host = _jax_hn_losses(lambda s: _global(hn_local_batch, s, 2))
    port = _port_one_process(
        weights, [hn_global_batch(s, 2) for s in range(HN_STEPS)], negs=1)
    np.testing.assert_allclose(port, collate, rtol=0, atol=LOSS_ATOL)
    assert np.abs(np.asarray(per_host) - np.asarray(collate)).max() > 1e-3


def test_four_process_train_agreement(tmp_path, weights):
    """Four gloo ranks (test_multiprocess.py:162): equal global losses and
    weights on every rank, and the port's one-process run on the global
    batch of 16 rows within 2e-5."""
    events = run_workers(4, "journey", workdir=str(tmp_path), short=True,
                         **weights)
    losses = [_one(events[r], "losses", phase="train")["values"]
              for r in range(4)]
    assert all(v == losses[0] for v in losses)
    assert len({_one(events[r], "digest")["value"] for r in range(4)}) == 1
    port = _port_one_process(
        weights, [mpc.global_itm_batch(s, 4) for s in range(mpc.N_STEPS)])
    np.testing.assert_allclose(losses[0], port, rtol=0, atol=LOSS_ATOL)


@pytest.fixture(scope="module")
def driver_fixtures(tmp_path_factory):
    from lightningdot_tpu_torch.data.synth import make_synth_dataset

    root = tmp_path_factory.mktemp("mp_driver")
    txt_dir, img_dir = make_synth_dataset(
        str(root / "data"), n_imgs=16, txts_per_img=2, img_dim=32, min_bb=5,
        max_bb=12, max_txt_len=20, with_soft_labels=True, n_labels=7, seed=3)
    out_dir = str(root / "out")
    cfg = mpc.write_mp_pretrain_config(root, txt_dir, img_dir, out_dir,
                                       num_train_steps=4, valid_steps=4)
    model_cfg = str(root / "model.json")
    itm_out = str(root / "itm")
    itm_args = ["--txt_model_config", model_cfg, "--img_model_config",
                model_cfg, "--itm_global_file", "", "--img_checkpoint",
                "none", "--train_txt_dbs", txt_dir, "--train_img_dbs",
                img_dir, "--val_txt_db", txt_dir, "--val_img_db", img_dir,
                "--train_batch_size", "8", "--valid_batch_size", "16",
                "--num_train_epochs", "1", "--max_txt_len", "20",
                "--conf_th", "0.2", "--max_bb", "12", "--min_bb", "5",
                "--num_bb", "10", "--compute_dtype", "f32",
                "--learning_rate", "1e-4", "--loader_workers", "1",
                "--output_dir", itm_out, "--device", "cpu"]
    teacher_out = str(root / "teacher")
    teacher_args = ["--model_config", model_cfg, "--train_txt_db", txt_dir,
                    "--train_img_db", img_dir, "--output_dir", teacher_out,
                    "--num_train_steps", "3", "--train_batch_size", "2",
                    "--hard_neg_size", "1", "--inf_minibatch_size", "4",
                    "--warmup_steps", "1", "--max_bb", "12", "--min_bb",
                    "5", "--num_bb", "10", "--compute_dtype", "f32",
                    "--device", "cpu"]
    # a KD teacher directory at the model's configuration, noise 0.2 on
    # its weights (at init scale every pair scores alike); KD's n_teacher
    # is min(10, 2 x 8): its first images span both ranks
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.models.cross_encoder import (
        CrossEncoder, init_cross_encoder_)
    from lightningdot_tpu_torch.training.checkpoints import save_checkpoint

    with open(model_cfg) as f:
        teacher = CrossEncoder(EncoderConfig(**json.load(f)))
    gen = torch.Generator().manual_seed(8)
    init_cross_encoder_(teacher, gen)
    with torch.no_grad():
        for p in teacher.parameters():
            p.add_(0.2 * torch.randn(p.shape, generator=gen))
    kd_dir = root / "kd_teacher"
    os.makedirs(kd_dir)
    (kd_dir / "config.json").write_text(json.dumps(teacher.cfg.to_dict()))
    save_checkpoint(str(kd_dir / "model"), model=teacher)
    kd_out = str(root / "itm_kd")
    kd_args = ["--teacher_checkpoint", str(kd_dir), "--T", "2.0",
               "--kd_loss_weight", "0.5", "--output_dir", kd_out]
    vqa_txt, vqa_img = make_synth_dataset(
        str(root / "vqa"), n_imgs=8, txts_per_img=2, img_dim=32, min_bb=5,
        max_bb=12, max_txt_len=20, seed=4, vqa_answers=12)
    vqa_out = str(root / "vqa_out")
    # 8 questions a rank in batches of 4: one update at accumulation 2
    vqa_args = ["--txt_model_config", model_cfg, "--img_model_config",
                model_cfg, "--img_checkpoint", "none", "--train_txt_dbs",
                vqa_txt, "--train_img_dbs", vqa_img, "--val_txt_db",
                vqa_txt, "--val_img_db", vqa_img, "--num_answers", "12",
                "--train_batch_size", "4", "--valid_batch_size", "8",
                "--num_train_epochs", "1", "--max_txt_len", "20",
                "--conf_th", "0.2", "--max_bb", "12", "--min_bb", "5",
                "--num_bb", "10", "--compute_dtype", "f32",
                "--learning_rate", "1e-3", "--vqa_lr_mul", "10",
                "--gradient_accumulation_steps", "2", "--loader_workers",
                "1", "--output_dir", vqa_out, "--device", "cpu"]
    return dict(cfg=cfg, out_dir=out_dir, itm_args=itm_args,
                itm_out=itm_out, teacher_args=teacher_args,
                teacher_out=teacher_out, kd_args=kd_args, kd_out=kd_out,
                vqa_args=vqa_args, vqa_out=vqa_out)


def test_drivers_two_process(driver_fixtures):
    """``cli/pretrain.main`` under two processes (test_multiprocess.py:186):
    rank-sharded DBs in fixed-row batches, rank 0's checkpoints (one
    writer, no temporaries), the auto-resume that every rank takes from
    them, validation metrics equal on both ranks, equal weights; then
    ``cli/train_itm.main``: one writer of ``biencoder.*``, the same recall
    and weights on both ranks; then ``cli/train_teacher.main`` with mined
    negatives: the same losses and weights on both ranks, one teacher
    directory, each rank's text map and one merged image map; then
    ``cli/train_itm.main --teacher_checkpoint`` (KD across the ranks) and
    ``cli/train_vqa.main`` (rank-sharded DBs, summed gradients), each held
    as the ITM run is held: one writer, the same results and weights on
    both ranks."""
    fx = driver_fixtures
    out_dir, itm_out, teacher_out = (fx["out_dir"], fx["itm_out"],
                                     fx["teacher_out"])
    events = run_workers(2, "driver", timeout=300,
                         pretrain_config=fx["cfg"], resume_steps=6,
                         itm_args=fx["itm_args"], kd_args=fx["kd_args"],
                         teacher_args=fx["teacher_args"],
                         vqa_args=fx["vqa_args"])
    for phase in ("initial", "resume"):
        res = [_one(events[r], "driver", phase=phase)["results"]
               for r in range(2)]
        assert res[0] and res[0] == res[1], phase
        assert all(np.isfinite(v) for m in res[0].values()
                   for v in m.values())
    ckpts = sorted(os.listdir(os.path.join(out_dir, "ckpt")))
    assert {"model_step_4.pt", "model_step_6.pt"} <= set(ckpts), ckpts
    assert not [c for c in ckpts if c.endswith(".tmp")]
    assert len({_one(events[r], "digest")["value"] for r in range(2)}) == 1
    for event, out in (("train_itm", itm_out),
                       ("train_itm_kd", fx["kd_out"])):
        runs = [_one(events[r], event) for r in range(2)]
        assert runs[0] == dict(runs[1], rank=0), event
        written = sorted(f for f in os.listdir(out)
                         if f.startswith("biencoder."))
        assert written == ["biencoder.best.json", "biencoder.best.pt",
                           "biencoder.last.json", "biencoder.last.pt"], \
            (event, written)
    vqa = [_one(events[r], "train_vqa") for r in range(2)]
    assert vqa[0] == dict(vqa[1], rank=0)
    assert vqa[0]["steps"] == [2] and np.isfinite(vqa[0]["last"]["loss"])
    assert sorted(os.listdir(fx["vqa_out"])) == [
        "metrics.jsonl", "vqa.best.json", "vqa.best.pt", "vqa.last.json",
        "vqa.last.pt"]
    teacher = [_one(events[r], "train_teacher") for r in range(2)]
    assert teacher[0] == dict(teacher[1], rank=0)
    assert all(np.isfinite(teacher[0]["losses"]))
    assert sorted(os.listdir(teacher_out)) == [
        "config.json", "model.json", "model.pt", "results_train"]
    assert sorted(os.listdir(os.path.join(teacher_out, "results_train"))) \
        == ["img2hardtxts.json", "txt2hardimgs_rank0.json",
            "txt2hardimgs_rank1.json"]


def test_kd_and_vqa_reach_the_process_group_under_two_processes(
        monkeypatch, tmp_path):
    """Under ``WORLD_SIZE=2`` KD and VQA no longer refuse: ``cli/train_vqa.
    main`` and ``cli/train_itm.main --teacher_checkpoint`` go on to join
    the process group (stopped there), and the ITM step builds with a KD
    term in a group of two."""
    from lightningdot_tpu_torch.cli import train_itm, train_vqa
    from lightningdot_tpu_torch.config import EncoderConfig
    from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
    from lightningdot_tpu_torch.training.itm_step import make_itm_train_step

    class Joined(Exception):
        pass

    def init_process_group(backend, **kw):
        raise Joined(backend, kw["world_size"], kw["rank"])

    for name, value in (("WORLD_SIZE", "2"), ("RANK", "0"),
                        ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "1")):
        monkeypatch.setenv(name, value)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        init_process_group)
    for main, extra in ((train_vqa.main, []), (train_itm.main, [
            "--teacher_checkpoint", str(tmp_path / "teacher")])):
        with pytest.raises(Joined) as joined:
            main(["--img_checkpoint", "none", "--device", "cpu",
                  "--output_dir", str(tmp_path)] + extra)
        assert joined.value.args == ("gloo", 2, 0)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 2)
    model = BiEncoder(EncoderConfig(**mpc.TINY))
    assert callable(make_itm_train_step(model, _optimizer(model),
                                        kd_fn=lambda *a: 0, device="cpu"))


if __name__ == "__main__":
    worker_main()
