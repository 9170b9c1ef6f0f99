"""Fine-tuning steps of the bi-encoder with the Moonlight text tower (bf16,
``models/moonlight.py``), as ``cli/train_itm.py --txt_model_type
moonlight-16b-a3b`` takes them: ``make_itm_train_step`` over
``FusedAdamW``, fed as ``runners/itm_train.py`` feeds it (the loader, the
collate's ladders, ``DevicePrefetcher`` with ``PinnedStager``).

Set-up makes the weights from the seed (the text tower's here, the image
tower's as ``harness/weights.py`` makes them), runs the first
``checked_steps`` steps recording each MoE layer's top-k choices, then
warms up. After the window, with the program freed, the plain float32
reference (``reference/moonlight.py`` for the text tower and the image
tower, with the image tower's dropout replayed) runs the same steps on the
same raw inputs and weights. It cannot hold 512 pairs' activations with
gradients, so each step is computed in blocks (GradCache, arXiv
2101.06983): all embeddings without gradients, the loss and its gradient
with respect to them, then each block's forward again with gradients,
back-propagating its share. The reference replays the program's own
choices of experts; ``route_mismatch`` is the share of real tokens' choices
in which its own top-k set differs.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from harness import program
from harness import traffic as T
from harness import weights
from harness.core import load_module
from reference import bert
from reference import bi_encoder as ref_bi
from reference import moonlight as ref

base = load_module(Path(__file__).with_name("itm_train.py"),
                   "bench_runner_itm_train")
# the selection biases: normal(BIAS_MEAN, BIAS_STD) (the configuration's
# assumed.weights; models/moonlight.py::init_moonlight_)
BIAS_MEAN, BIAS_STD = 0.5, 0.005
PROBE_STEPS = 8


def text_state(cfg: dict, seed: int, device) -> dict:
    """The text tower's weights from the seed, in one draw on the device:
    matrices and the table normal(0, initializer_range), norm scales one,
    head biases zero, selection biases normal(BIAS_MEAN, BIAS_STD)."""
    layout = ref.text_layout(cfg, cfg["project_dim"])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([int(seed), 3]).generate_state(
        1, np.uint64)[0]))
    mats = [(n, s) for n, s in layout if len(s) >= 2]
    flat = torch.randn(sum(math.prod(s) for _, s in mats), generator=gen,
                       device=device)
    flat.mul_(cfg["initializer_range"])
    state, at = {}, 0
    for name, shape in layout:
        if len(shape) >= 2:
            state[name] = flat[at:at + math.prod(shape)].view(shape)
            at += math.prod(shape)
        elif name.endswith("e_score_correction_bias"):
            state[name] = BIAS_MEAN + torch.randn(
                shape, generator=gen, device=device) * BIAS_STD
        elif name.endswith("bias"):
            state[name] = torch.zeros(shape, device=device)
        else:
            state[name] = torch.ones(shape, device=device)
    return state


def image_state(cfg: dict, seed: int, device) -> dict:
    img = cfg["image"]
    return weights.make_state(
        ref_bi.tower_layout(img, "img_model.", True, cfg["project_dim"]),
        seed, device, img["initializer_range"])


def initial_state(run) -> dict:
    return {**text_state(run.config, run.seed, run.device),
            **image_state(run.config, run.seed, run.device)}


def build_program(cfg: dict, dtype: str, seed: int, device):
    from lightningdot_tpu_torch.config import EncoderConfig, MoonlightConfig
    from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
    pd = cfg["project_dim"]
    with torch.device(device):
        model = BiEncoder(MoonlightConfig.from_dict(dict(cfg, project_dim=pd)),
                          EncoderConfig.from_dict(dict(cfg["image"],
                                                       project_dim=pd)),
                          compute_dtype=program.DTYPES[dtype])
    state = {**text_state(cfg, seed, device), **image_state(cfg, seed, device)}
    buffers = {k for k, _ in model.named_buffers()}
    model.load_state_dict(state, strict=True)
    del state
    assert buffers == {k for k in model.state_dict()
                       if k.endswith("e_score_correction_bias")}
    return model


# ---------------------------------------------------------------------------
# the reference, in blocks
# ---------------------------------------------------------------------------

class BlockDropout:
    """The image pass's dropout, drawn once over the whole batch in the
    program's order (``reference/bert.py::Dropout``) and replayed on a
    block of its rows."""

    def __init__(self, inner: bert.Dropout):
        self.inner = inner
        self.hidden_masks, self.attention_masks = [], []
        self.rows = None          # (lo, hi) while replaying
        self.at = 0

    def hidden(self, x):
        rate = self.inner.hidden_rate
        if self.rows is None:
            keep = torch.rand(x.shape, generator=self.inner.gen,
                              device=self.inner.gen.device) < 1.0 - rate
            self.hidden_masks.append(keep)
        else:
            keep = self.hidden_masks[self.at][self.rows[0]:self.rows[1]]
            self.at += 1
        return x * keep.to(x.dtype) * (1.0 / (1.0 - rate))

    def attention(self, layer, probs):
        rate = self.inner.attention_rate
        if self.rows is None:
            b, h, s, t = probs.shape
            keep = bert.philox_keep(self.inner.seeds[layer], b, h, s, t, rate,
                                    probs.device)
            self.attention_masks.append(keep)
        else:
            keep = self.attention_masks[layer][self.rows[0]:self.rows[1]]
        return probs * keep.to(probs.dtype) * (1.0 / (1.0 - rate))

    def replay(self, lo, hi):
        self.rows, self.at = (lo, hi), 0
        return self


def _inputs(batch: dict, cfg: dict, device):
    caps = [torch.as_tensor(c, dtype=torch.int64, device=device)
            for c in batch["captions"]]
    ids, mask = bert.pad_rows(caps, batch["txt_len"])
    n_reg = batch["img_len"] - 1
    feat, rmask = bert.pad_rows([torch.as_tensor(f, device=device).float()
                                 for f, _ in batch["regions"]], n_reg)
    boxes, _ = bert.pad_rows([torch.as_tensor(b, device=device).float()
                              for _, b in batch["regions"]], n_reg)
    return ids, mask, feat, boxes, rmask


def _planted(state: dict, fault: str) -> dict:
    """The weights a run with the fault ``drop_expert`` sees: held expert
    0's down projection zero, so that its part is left out."""
    if fault != "drop_expert":
        return state
    return {k: (v.clone().index_fill_(0, torch.tensor([0], device=v.device),
                                      0.0)
                if k.endswith("mlp.experts.down_proj.weight") else v)
            for k, v in state.items()}


def train_steps(state: dict, batches, step_seeds, choices, cfg: dict,
                job: dict, prec: str = "f32", *, fault: str = "") -> dict:
    """``len(batches)`` steps from ``state`` (left as it is), in blocks of
    ``job["reference_block"]`` pairs. ``choices[t]``: step t's top-k
    choices of each MoE layer (None: the reference's own). ``fault``
    plants one: ``drop_expert`` leaves held expert 0's part out,
    ``biased_weights`` takes the routing weights from s + b.

    Returns {"losses", "grad_norms" (step 1, clipped), "change_norms",
    "route_mismatch", "choices" (the choices used, per step and layer)}."""
    device = next(iter(state.values())).device
    weights_from = ((lambda s, b: s + b) if fault == "biased_weights"
                    else None)
    params = {k: v.detach().clone()
              for k, v in _planted(state, fault).items()}
    trained = [k for k in params if not k.endswith("e_score_correction_bias")]
    m = {k: torch.zeros_like(params[k]) for k in trained}
    v2 = {k: torch.zeros_like(params[k]) for k in trained}
    b1, b2, eps = job["betas"][0], job["betas"][1], job["adam_eps"]
    lr, max_norm = job["learning_rate"], job["max_grad_norm"]
    i_cfg = cfg["image"]
    block = job["reference_block"]
    losses, grad_norms, differ, total, used = [], {}, 0, 0, []
    for t, (batch, seed, sel) in enumerate(zip(batches, step_seeds, choices),
                                           start=1):
        ids, mask, feat, boxes, rmask = _inputs(batch, cfg, device)
        n, s = ids.shape
        _, g_img, _ = ref_bi.pass_generators(seed, device)
        drop = BlockDropout(bert.Dropout(
            g_img, i_cfg["hidden_dropout_prob"],
            i_cfg["attention_probs_dropout_prob"],
            i_cfg["num_hidden_layers"]))
        log = []
        with torch.no_grad():
            _, txt = ref.text_tower(params, ids, mask, cfg, prec,
                                    replay=sel, log=log,
                                    weights_from=weights_from)
            img = ref.image_tower(params, feat, boxes, rmask, i_cfg, prec,
                                  drop)
        d, tot = ref.route_mismatch(log, mask.reshape(-1) > 0)
        differ, total = differ + d, total + tot
        used.append([u for _, u in log])
        sel = used[-1]
        txt.requires_grad_(True)
        img.requires_grad_(True)
        loss = ref.itm_loss(txt, img, prec)
        g_txt, g_img_emb = torch.autograd.grad(loss, [txt, img])
        leaves = dict(params)
        for k in trained:
            leaves[k] = params[k].requires_grad_(True)
        grads = {k: torch.zeros_like(params[k]) for k in trained}
        for lo in range(0, n, block):
            hi = min(n, lo + block)
            rsel = None if sel is None else [c[lo * s:hi * s] for c in sel]
            _, tb = ref.text_tower(leaves, ids[lo:hi], mask[lo:hi], cfg,
                                   prec, replay=rsel,
                                   weights_from=weights_from)
            ib = ref.image_tower(leaves, feat[lo:hi], boxes[lo:hi],
                                 rmask[lo:hi], i_cfg, prec,
                                 drop.replay(lo, hi))
            out = (tb * g_txt[lo:hi]).sum() + (ib * g_img_emb[lo:hi]).sum()
            got = torch.autograd.grad(out, [leaves[k] for k in trained],
                                      allow_unused=True)
            for k, g in zip(trained, got):
                if g is not None:
                    grads[k].add_(g)
            del out, got, tb, ib
        for k in trained:
            params[k] = params[k].detach()
        with torch.no_grad():
            norm = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(grads[k]) for k in trained]))
            scale = max_norm / torch.clamp(norm, min=max_norm)
            step_size = lr * (1.0 - b2 ** t) ** 0.5 / (1.0 - b1 ** t)
            for k in trained:
                g = grads[k] * scale
                if t == 1:
                    grad_norms[k] = float(torch.linalg.vector_norm(g))
                m[k].mul_(b1).add_((1.0 - b1) * g)
                v2[k].mul_(b2).add_((1.0 - b2) * g * g)
                params[k].sub_(step_size * m[k] / (v2[k].sqrt() + eps))
        del grads, drop
        losses.append(float(loss.detach()))
    with torch.no_grad():
        change = {k: float(torch.linalg.vector_norm(params[k] - state[k]))
                  for k in trained}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "route_mismatch": differ / max(total, 1),
            "choices": used}


def numbers(got: dict, want: dict) -> dict:
    out = base.numbers(got, want)
    out["route_mismatch"] = want["route_mismatch"]
    return out


def pools(run):
    """``runners/itm_train.py``'s pools, each caption's opening id drawn
    from the held slice like the ids after it where the traffic file says
    so (``opening_id`` "drawn"): the closing id stays, and stands for the
    decoder's EOS, whose row is pooled."""
    cfg, tr = run.config, run.traffic
    caps, regs = base.pools(run.seed, {"text": cfg, "image": cfg["image"]},
                            tr, run.device)
    if tr.get("opening_id") == "drawn":
        gen = T.rng(run.seed, 11)
        first = gen.integers(min(999, cfg["vocab_size"] // 2),
                             cfg["vocab_size"], len(caps))
        caps = [np.concatenate([[f], c[1:]]).astype(c.dtype)
                for f, c in zip(first, caps)]
    return caps, regs


def _batches(run, dataset, n_check):
    ladders = run.settings["reference_ladders"]
    return [base.reference_batch(dataset, i, run.traffic["batch"], ladders)
            for i in range(n_check)]


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
    import functools

    cfg, tr, job = run.config, run.traffic, run.settings
    bsz = tr["batch"]
    caps, regs = pools(run)
    dataset = base.Pairs(caps, regs, bsz * base.N_BATCHES)
    model = build_program(cfg, job["compute_dtype"], run.seed, run.device)
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
    moe_layers = (model.txt_model.moe_layers()
                  if hasattr(model.txt_model, "moe_layers") else [])

    def one(i: int, span: str = "step", drained: bool = False):
        with run.spans("feed"):
            batch = next(feed)
        padded.add(batch.host["txts"]["input_ids"].shape[1])
        if drained:
            run.sync()
        with run.spans(span):
            metrics = step(batch, torch.Generator().manual_seed(
                base.step_seed(run.seed, i)))
        done = None
        if run.on_card:
            done = torch.cuda.Event()
            done.record()
        recycler.push(batch.host, ready=done)
        return batch, metrics

    n_check = job["checked_steps"]
    got, losses, choices = {}, [], []
    for i in range(n_check):
        for layer in moe_layers:
            layer.choices = []
        _, metrics = one(i)
        choices.append([layer.choices[0].cpu() for layer in moe_layers])
        losses.append(metrics["loss"])
        if i == 0:
            got["grad_norms"] = base._first_gradient(opt, job["betas"][0])
    for layer in moe_layers:
        layer.choices = None
    got["losses"] = [float(x) for x in losses]
    state0 = initial_state(run)
    got["change_norms"] = base._change(opt, state0)
    del state0
    for i in range(n_check, job["warm_steps"]):
        one(i)
    stager = PinnedStager(run.device)
    for length, c in sorted(T.first_of_each_bucket(
            caps, collate_cfg.txt_buckets).items()):
        host = collate([dataset[j] for j in range(c, c + bsz)])
        if host["txts"]["input_ids"].shape[1] not in padded:
            padded.add(host["txts"]["input_ids"].shape[1])
            step(await_staged(stager(host)), torch.Generator().manual_seed(
                base.step_seed(run.seed, base.N_BATCHES + length)))
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

    batches = _batches(run, dataset, n_check)
    dev_choices = [[c.to(run.device) for c in s] for s in choices]
    want = train_steps(initial_state(run), batches,
                       [base.step_seed(run.seed, i) for i in range(n_check)],
                       dev_choices, cfg, job)
    found = numbers(got, want)
    # the cell's file names the numbers that decide correct (its
    # limits_why says why loss_gap and grad_gap are not among them)
    return {"attempted": steps, "failed": failed,
            "check": {k: (found[k], lim) for k, lim in job["limits"].items()}}


def control(run) -> dict:
    """The readings that set the limits' upper end, each against the
    float32 reference on this run's seed with the reference's own routing:
    the reference with every product's operands in fp8 e4m3 (the
    precision below bf16), and the two planted faults (held expert 0's
    part left out; the routing weights taken from s + b)."""
    cfg, tr, job = run.config, run.traffic, run.settings
    caps, regs = pools(run)
    dataset = base.Pairs(caps, regs, tr["batch"] * base.N_BATCHES)
    n_check = job["checked_steps"]
    batches = _batches(run, dataset, n_check)
    seeds = [base.step_seed(run.seed, i) for i in range(n_check)]
    state0 = initial_state(run)
    out = {}
    for name, prec, fault in (("fp8", "fp8", ""),
                              ("drop_expert", "f32", "drop_expert"),
                              ("biased_weights", "f32", "biased_weights")):
        # as for the program: the faulty run routes itself, the float32
        # reference replays its choices
        got = train_steps(state0, batches, seeds, [None] * n_check, cfg, job,
                          prec, fault=fault)
        want = train_steps(state0, batches, seeds, got["choices"], cfg, job)
        out[name] = numbers(got, want)
    return out
