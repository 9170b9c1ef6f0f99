"""Fine-tuning steps of the bi-encoder, as ``cli/train_itm.py`` takes them.

``training/itm_step.py::make_itm_train_step`` over ``FusedAdamW``, fed by
``data/loader.py``'s ``DataLoader`` (the port's ``itm_fast_collate``, padded
by its ladders) and ``DevicePrefetcher`` with ``PinnedStager``: the next
batch is staged while a step runs, and nothing waits for the device
between steps. Each step gets a CPU generator seeded from the run's seed
and its index, which seeds its dropout.

Set-up makes the weights and the pools from the seed, builds the step and
drives it through its first ``checked_steps`` steps (the window's own call
and feed, on rows that all differ), then warms up, with one more step at
each further text length the pool's captions pad to. After a traced window
it times ``PROBE_STEPS`` more calls, each issued once the device has
drained: the host's own cost of a step, which the window's calls hide once
the card paces them. The program's readings
of those steps are its losses, the first gradient as the optimizer got it
(its first moment after one step over 1 - beta1) and the change of the
parameters after them. After the window, with the program freed, the
reference (``reference/bi_encoder.py``) runs the same steps on the same
raw inputs, seeds and weights, and the worst gaps are compared.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from harness import gaps, program
from harness import traffic as T
from harness import weights
from reference import bi_encoder as ref
from reference.bert import Precision

N_BATCHES = 20000     # the loader's length in batches: more than any run
PROBE_STEPS = 8       # steps timed on a drained queue after a traced window


def step_seed(seed: int, i: int) -> int:
    return int(np.random.SeedSequence([int(seed), 2, i]).generate_state(
        1, np.uint64)[0])


class Pairs:
    """Item i: caption i mod n_captions with image i mod n_images, an
    ``ItmFastDataset`` item."""

    def __init__(self, caps, regs, n: int):
        self.caps, self.regs, self.n = caps, regs, n

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, i: int) -> dict:
        r = i % len(self.regs)
        feat, box = self.regs[r]
        return {"txt_id": i, "input_ids": self.caps[i % len(self.caps)],
                "img": {"fname": r, "img_feat": feat, "img_pos_feat": box,
                        "num_bb": feat.shape[0], "caption_ids": None},
                "neg_imgs": None, "neg_txts": None}


def pools(run_seed: int, cfg: dict, tr: dict, device):
    gen = T.rng(run_seed, 10)
    caps = T.captions(T.sizes(tr["caption_tokens"], tr["captions"], gen),
                      cfg["text"]["vocab_size"], gen)
    regs = T.regions(T.sizes(tr["regions"], tr["images"], gen),
                     cfg["image"]["img_dim"], gen,
                     tr["image_share"], device)
    return caps, regs


def reference_batch(dataset: Pairs, i: int, batch: int, ladders: dict):
    """Batch ``i``'s raw inputs, and the lengths the reference pads them to
    (the dropout draws follow the padded shapes)."""
    items = [dataset[j] for j in range(i * batch, (i + 1) * batch)]
    caps = [it["input_ids"] for it in items]
    regs = [(it["img"]["img_feat"], it["img"]["img_pos_feat"])
            for it in items]
    return {"captions": caps, "regions": regs,
            "txt_len": T.bucket(max(len(c) for c in caps), ladders["txt"]),
            "img_len": T.bucket(max(f.shape[0] for f, _ in regs) + 1,
                                ladders["img"])}


def numbers(got: dict, want: dict) -> dict:
    """The gaps that decide ``correct``: the worst step's loss, the worst
    leaf of the first clipped gradient, the worst leaf of the change over
    the steps among the leaves the reference's gradient moves."""
    return {
        "loss_gap": max(gaps.rel_gap(a, b)
                        for a, b in zip(got["losses"], want["losses"])),
        "grad_gap": gaps.worst_leaf(got["grad_norms"], want["grad_norms"]),
        "change_gap": gaps.worst_leaf(got["change_norms"],
                                      want["change_norms"],
                                      gaps.moved_leaves(want["grad_norms"])),
    }


def _first_gradient(opt, b1: float) -> dict:
    if opt.m is None:                   # no update was made
        return {n: 0.0 for n in opt.names}
    norms = torch.stack([torch.linalg.vector_norm(m.float())
                         for m in opt.m]) / (1.0 - b1)
    return dict(zip(opt.names, norms.tolist()))


def _change(opt, state0: dict) -> dict:
    norms = torch.stack([torch.linalg.vector_norm(p.detach() - state0[n])
                         for n, p in zip(opt.names, opt.params)])
    return dict(zip(opt.names, norms.tolist()))


def _initial_state(run):
    cfg = run.config
    return weights.make_state(ref.layout(cfg), run.seed, run.device,
                              cfg["text"]["initializer_range"])


def run(run) -> dict:
    from lightningdot_tpu_torch.data.itm import (CollateConfig,
                                                 itm_fast_collate)
    from lightningdot_tpu_torch.data.loader import (DataLoader,
                                                    DevicePrefetcher,
                                                    PinnedStager,
                                                    await_staged)
    from lightningdot_tpu_torch.data.padding import Recycler
    from lightningdot_tpu_torch.training.itm_step import make_itm_train_step
    from lightningdot_tpu_torch.training.optim import make_optimizer

    cfg, tr, job = run.config, run.traffic, run.settings
    bsz = tr["batch"]
    caps, regs = pools(run.seed, cfg, tr, run.device)
    dataset = Pairs(caps, regs, bsz * N_BATCHES)
    model = program.bi_encoder(cfg, job["compute_dtype"], run.seed,
                               run.device)
    model.train()
    opt = make_optimizer(model, job["learning_rate"],
                         max_grad_norm=job["max_grad_norm"],
                         adam_eps=job["adam_eps"], betas=tuple(job["betas"]))
    step = make_itm_train_step(model, opt, device=run.device)
    collate_cfg = CollateConfig(fixed_batch=bsz)
    collate = functools.partial(itm_fast_collate, cfg=collate_cfg)
    loader = DataLoader(dataset, batch_size=bsz, drop_last=True,
                        collate_fn=collate)
    feed = iter(DevicePrefetcher(loader, put=PinnedStager(run.device)))
    recycler = Recycler(enabled=run.on_card)
    padded = set()

    def one(i: int, span: str = "step", drained: bool = False):
        with run.spans("feed"):
            batch = next(feed)
        padded.add(batch.host["txts"]["input_ids"].shape[1])
        if drained:
            run.sync()
        with run.spans(span):
            metrics = step(batch, torch.Generator().manual_seed(
                step_seed(run.seed, i)))
        done = None
        if run.on_card:
            done = torch.cuda.Event()
            done.record()
        recycler.push(batch.host, ready=done)
        return batch, metrics

    # the checked steps: the window's own call and feed
    n_check = job["checked_steps"]
    got = {}
    losses = []
    for i in range(n_check):
        _, metrics = one(i)
        losses.append(metrics["loss"])
        if i == 0:
            got["grad_norms"] = _first_gradient(opt, job["betas"][0])
    got["losses"] = [float(x) for x in losses]
    state0 = _initial_state(run)
    got["change_norms"] = _change(opt, state0)
    del state0
    for i in range(n_check, job["warm_steps"]):
        one(i)
    # one step at each further text length a batch of the pool pads to
    stager = PinnedStager(run.device)
    for length, c in sorted(T.first_of_each_bucket(
            caps, collate_cfg.txt_buckets).items()):
        host = collate([dataset[j] for j in range(c, c + bsz)])
        if host["txts"]["input_ids"].shape[1] not in padded:
            padded.add(host["txts"]["input_ids"].shape[1])
            step(await_staged(stager(host)), torch.Generator().manual_seed(
                step_seed(run.seed, N_BATCHES + length)))
    del stager
    run.setup_done()

    i, last = job["warm_steps"], None
    with run.window():
        while run.running():
            batch, last = one(i)
            host = batch.host
            run.calls.append({
                "txt_shape": host["txts"]["input_ids"].shape,
                "img_shape": host["imgs"]["attention_mask"].shape,
                "txt_lens": host["txts"]["attention_mask"].sum(1),
                "img_lens": host["imgs"]["attention_mask"].sum(1)})
            run.count(pairs=host["n_valid"], steps=1)
            i += 1
    if run.traced:
        # the host's own cost of a step: each call issued onto a drained
        # device queue, so that no launch waits for room in it
        for _ in range(PROBE_STEPS):
            one(i, "step_drained", drained=True)
            i += 1
    steps = int(run.work.get("steps", 0))
    failed = 0
    if last is not None and not math.isfinite(float(last["loss"])):
        failed = steps
    recycler.flush()
    feed.close()
    del feed, loader, step, opt, model, last
    program.release(run.device)

    ladders = job["reference_ladders"]
    batches = [reference_batch(dataset, i, bsz, ladders)
               for i in range(n_check)]
    want = ref.train_steps(_initial_state(run), batches,
                           [step_seed(run.seed, i) for i in range(n_check)],
                           cfg, job, Precision("f32"))
    found = numbers(got, want)
    return {"attempted": steps, "failed": failed,
            "check": {k: (v, job["limits"][k]) for k, v in found.items()}}


def control(run) -> dict:
    """The readings of the control (the reference with every product's
    operands in TF32) and of the fault that leaves out half of each batch,
    each against the float32 reference, on this run's seed."""
    cfg, tr, job = run.config, run.traffic, run.settings
    caps, regs = pools(run.seed, cfg, tr, run.device)
    dataset = Pairs(caps, regs, tr["batch"] * N_BATCHES)
    n_check = job["checked_steps"]
    batches = [reference_batch(dataset, i, tr["batch"],
                               job["reference_ladders"])
               for i in range(n_check)]
    seeds = [step_seed(run.seed, i) for i in range(n_check)]
    state0 = _initial_state(run)
    base = ref.train_steps(state0, batches, seeds, cfg, job,
                           Precision("f32"))
    out = {}
    for name, prec, half in (("tf32", "tf32", False),
                             ("half_batch", "f32", True)):
        out[name] = numbers(ref.train_steps(state0, batches, seeds, cfg, job,
                                            Precision(prec), half=half),
                            base)
    return out
