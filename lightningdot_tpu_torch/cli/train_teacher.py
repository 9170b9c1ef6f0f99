"""Cross-encoder (teacher) training driver (the port's ``train_teacher``,
lightningdot_tpu/cli/train_teacher.py; reference uniter_model/train_itm.py):
train UniterForImageTextRetrieval with the sigmoid-triplet loss over
``ItmRankDataset`` groups, and save a teacher directory (``config.json`` +
``model.pt`` with ``model.json``, the reference's state-dict names) that
both packages' ``load_cross_encoder`` read, for KD and re-ranking.

Variants, as the JAX driver's:
  * ``--hard_neg_size > 0``: mined hard negatives, an initial and a
    periodic (``--steps_per_hard_neg``) mining pass over random pools
    (``ItmHardNegDataset``) feeding ``ItmRankDatasetHardNeg``
    (train_itm.py:118-136,191-193,266-270);
  * ``--self_mining``: ``CrossEncoderHardNeg`` scores a candidate group
    and trains on its top ``--self_mining_hard_size`` negatives,
    alternating text-shared and image-shared groups (train_itm_v2.py:92-101);
  * ``--model_variant fast``: the two-stream cosine teacher
    (``CrossEncoderFast``).

It runs on the card by default, or on the CPU with ``--device cpu``. Each
step stages its batch through pinned buffers on a side stream and updates
through ``FusedAdamW`` (UNITER's betas (0.9, 0.98), eps 1e-6, weight decay
0.01, the post-increment schedule read). The dropout masks of step N come
from ``step_generator(seed, N)``. A preemption signal (or
``--sim_preempt_step``) ends the loop and the directory is saved.

Under ``torchrun`` each process trains on its card (``--dist_backend gloo``
for ranks that share one) over its rank-strided shard of the texts (the
JAX driver's cli/train_teacher.py:158-165), mines that shard, and the
gradients are averaged over the ranks before the clip, so that every rank
takes the global batch's update; rank 0 alone writes the teacher
directory. (The JAX driver trains its replicas without exchanging
gradients and writes from every host: ROADMAP §C.)

Usage:
  python -m lightningdot_tpu_torch.cli.train_teacher \\
      --model_config configs/img_base.json --train_txt_db ... \\
      --train_img_db ... --output_dir teacher
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from lightningdot_tpu_torch.config import (add_dist_params, parse_with_config,
                                           print_args)
from lightningdot_tpu_torch.data.feat_db import DetectFeatDb
from lightningdot_tpu_torch.data.itm_rank import (
    ItmRankDataset, ItmRankDatasetHardNeg, ItmRankDatasetHardNegFromImage,
    ItmRankDatasetHardNegFromText, itm_rank_collate, itm_rank_hn_collate)
from lightningdot_tpu_torch.data.loader import (DataLoader, PinnedStager,
                                                await_staged)
from lightningdot_tpu_torch.data.padding import Recycler
from lightningdot_tpu_torch.data.txt_db import TxtTokDb
from lightningdot_tpu_torch.models.cross_encoder import (CrossEncoder,
                                                         CrossEncoderFast,
                                                         CrossEncoderHardNeg,
                                                         init_cross_encoder_)
from lightningdot_tpu_torch.models.factory import (load_cross_encoder,
                                                   resolve_encoder_config)
from lightningdot_tpu_torch.models.weights import (cross_encoder_keys,
                                                   load_torch_state_dict)
from lightningdot_tpu_torch.ops.matmul import require_full_f32
from lightningdot_tpu_torch.parallel.mesh import (all_reduce_grads_, barrier,
                                                  global_sums,
                                                  is_main_process,
                                                  process_count,
                                                  process_index, setup_process)
from lightningdot_tpu_torch.training.checkpoints import save_checkpoint
from lightningdot_tpu_torch.training.hn_teacher import (compute_hard_neg,
                                                        make_fast_score_fn,
                                                        make_joint_score_fn)
from lightningdot_tpu_torch.training.itm_step import pass_generators
from lightningdot_tpu_torch.training.optim import (make_optimizer,
                                                   schedule_linear)
from lightningdot_tpu_torch.utils.logging import LOGGER
from lightningdot_tpu_torch.utils.preemption import PreemptionGuard
from lightningdot_tpu_torch.utils.runtime import setup_runtime, step_generator


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("train_teacher", allow_abbrev=False)
    p.add_argument("--config", default=None)
    p.add_argument("--model_config", required=True)
    p.add_argument("--checkpoint", default=None,
                   help="initial weights: a UNITER or teacher .pt, or a "
                        "teacher directory")
    p.add_argument("--train_txt_db", required=True)
    p.add_argument("--train_img_db", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--neg_sample_size", default=1, type=int)
    p.add_argument("--margin", default=0.2, type=float)
    p.add_argument("--model_variant", default="joint",
                   choices=["joint", "fast"])
    p.add_argument("--hard_neg_size", default=0, type=int,
                   help=">0 trains on mined hard negatives")
    p.add_argument("--hard_neg_pool_size", default=20, type=int,
                   help="mined hard negatives kept per text/image")
    p.add_argument("--steps_per_hard_neg", default=-1, type=int,
                   help="re-mine every N steps (-1: once at the start)")
    p.add_argument("--inf_minibatch_size", default=400, type=int,
                   help="random candidate pool size for mining")
    p.add_argument("--self_mining", action="store_true",
                   help="in-batch self-mining (CrossEncoderHardNeg)")
    p.add_argument("--self_mining_hard_size", default=16, type=int)
    p.add_argument("--train_batch_size", default=8, type=int,
                   help="groups per batch (each 1+2n pairs)")
    p.add_argument("--learning_rate", default=5e-5, type=float)
    p.add_argument("--num_train_steps", default=5000, type=int)
    p.add_argument("--warmup_steps", default=500, type=int)
    p.add_argument("--max_grad_norm", default=2.0, type=float)
    p.add_argument("--valid_steps", default=500, type=int)
    p.add_argument("--sim_preempt_step", type=int, default=None,
                   help="fault injection: act as if SIGTERM arrived at "
                        "this global step")
    p.add_argument("--max_txt_len", default=60, type=int)
    p.add_argument("--conf_th", default=0.2, type=float)
    p.add_argument("--max_bb", default=100, type=int)
    p.add_argument("--min_bb", default=10, type=int)
    p.add_argument("--num_bb", default=36, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--compute_dtype", default="bf16",
                   choices=["bf16", "f32"])
    add_dist_params(p, dp_size=False)
    return p


def main(cmds=None):
    """Train; returns ({"final_loss", "losses"}, model) and prints
    {"final_loss", "steps"} last."""
    args = parse_with_config(build_parser(), cmds)
    # installed before set-up: a signal during construction latches
    guard = PreemptionGuard(
        sim_after_step=args.sim_preempt_step,
        check_every=getattr(args, "preempt_check_steps", 25))
    with guard:
        return _main(args, guard)


def build_model(args, cfg, dtype):
    """The variant's model with its initial weights (cli/train_teacher.py:
    118-160): random from ``--seed`` (the port's generator), then
    ``--checkpoint``. A Fast teacher takes ``bert.*`` (and ``img_bert.*``
    where the file has it) and seeds its rank head from the itm head."""
    if args.model_variant == "fast":
        model = init_cross_encoder_(
            CrossEncoderFast(cfg, margin=args.margin, compute_dtype=dtype),
            torch.Generator().manual_seed(args.seed))
        if args.checkpoint:
            sd = cross_encoder_keys(load_torch_state_dict(args.checkpoint))
            own = model.state_dict()
            missing = [k for k in own if k.startswith("bert.")
                       and k not in sd]
            unknown = [k for k in sd if k not in own]
            if missing or unknown:
                raise KeyError(f"{args.checkpoint}: missing {missing[:5]}, "
                               f"unknown {unknown[:5]}")
            if not any(k.startswith("img_bert.") for k in sd):
                LOGGER.info("fast teacher: %s has no img_bert stream; the "
                            "image stream keeps its random weights",
                            args.checkpoint)
            model.load_state_dict({k: torch.as_tensor(np.asarray(sd[k]))
                                   if k in sd else v
                                   for k, v in own.items()})
            if "itm_output.weight" in sd:
                model.init_output()
        return model
    if args.checkpoint:
        model = load_cross_encoder(args.checkpoint,
                                   model_config=args.model_config,
                                   margin=args.margin, compute_dtype=dtype,
                                   device="cpu")
    else:
        model = init_cross_encoder_(
            CrossEncoder(cfg, margin=args.margin, compute_dtype=dtype),
            torch.Generator().manual_seed(args.seed))
    if args.self_mining:
        mined = CrossEncoderHardNeg(cfg, margin=args.margin,
                                    compute_dtype=dtype,
                                    hard_size=args.self_mining_hard_size)
        mined.load_state_dict(model.state_dict())
        model = mined
    return model


def make_teacher_step(model, optimizer, device):
    """``step(batch, generator, **kw) -> {"loss"}``: one update of the
    mean triplet loss of a staged batch (``kw`` goes to ``model.apply``),
    the dropout masks seeded from ``generator``; the loss stays on the
    device. float32 on the card needs TF32 products off."""

    def step(batch, generator, **kw):
        require_full_f32(device, model.compute_dtype)
        optimizer.zero_grad()
        # across processes: the mean over the ranks' equal-shaped batches
        loss = model.apply(batch, compute_loss=True,
                           generator=pass_generators(generator, device)[0],
                           **kw).mean() / process_count()
        loss.backward()
        all_reduce_grads_(optimizer.params)
        optimizer.step()
        return global_sums({"loss": loss})

    return step


def _loop(loader):
    while True:
        yield from loader


def _main(args, guard):
    print_args(args, LOGGER.info)
    os.makedirs(args.output_dir, exist_ok=True)
    setup_runtime(args)
    device = setup_process(args.device, args.dist_backend)
    rank = process_index()
    cfg = resolve_encoder_config(args.model_config)
    dtype = torch.bfloat16 if args.compute_dtype == "bf16" else torch.float32
    if args.self_mining:
        assert args.model_variant == "joint", \
            "self-mining is defined for the joint cross-encoder"
        assert args.neg_sample_size > args.self_mining_hard_size, (
            "self-mining needs a candidate pool larger than hard_size")
    model = build_model(args, cfg, dtype).to(device)

    txt_db = TxtTokDb(args.train_txt_db, args.max_txt_len, rank=rank,
                      world_size=process_count())
    img_db = DetectFeatDb(args.train_img_db, args.conf_th, args.max_bb,
                          args.min_bb, args.num_bb)
    lr = schedule_linear(args.learning_rate, args.warmup_steps,
                         args.num_train_steps)
    # UNITER's optimizer (uniter_model/train_itm.py:221-240)
    optimizer = make_optimizer(model, lr, max_grad_norm=args.max_grad_norm,
                               betas=(0.9, 0.98), adam_eps=1e-6,
                               weight_decay=0.01, first_lr_step=1)
    stager = PinnedStager(device)
    hard_neg_dir = os.path.join(args.output_dir, "results_train")
    mine = None

    if args.self_mining:
        # one candidate group a step, text-shared and image-shared in turn
        groups = [ItmRankDatasetHardNegFromText(txt_db, img_db,
                                                args.neg_sample_size,
                                                seed=args.seed),
                  ItmRankDatasetHardNegFromImage(txt_db, img_db,
                                                 args.neg_sample_size,
                                                 seed=args.seed + 1)]
        loaders = [_loop(DataLoader(ds, batch_size=1, shuffle=True,
                                    drop_last=True,
                                    collate_fn=itm_rank_hn_collate,
                                    seed=args.seed)) for ds in groups]

        def next_batch(global_step):
            side = global_step % 2
            batch = next(loaders[side])
            mb = {k: v for k, v in batch.items() if k != "sample_size"}
            return mb, dict(sample_from="ti"[side])
    else:
        if args.hard_neg_size > 0:
            from lightningdot_tpu_torch.data.itm import ItmHardNegDataset

            dataset = ItmRankDatasetHardNeg(
                txt_db, img_db, args.neg_sample_size, args.hard_neg_size,
                seed=args.seed)
            hn_dataset = ItmHardNegDataset(txt_db, img_db,
                                           args.inf_minibatch_size,
                                           seed=args.seed)
            sample_size = 1 + 2 * (args.neg_sample_size + args.hard_neg_size)
            score_fn = (make_fast_score_fn if args.model_variant == "fast"
                        else make_joint_score_fn)(model, device)

            def mine():   # the score function scores in eval mode
                compute_hard_neg(score_fn, (hn_dataset[i]
                                            for i in range(len(hn_dataset))),
                                 dataset, args.hard_neg_pool_size,
                                 hard_neg_dir, rank=rank)
        else:
            dataset = ItmRankDataset(txt_db, img_db, args.neg_sample_size,
                                     seed=args.seed)
            sample_size = 1 + 2 * args.neg_sample_size
        loader = _loop(DataLoader(dataset, batch_size=args.train_batch_size,
                                  shuffle=True, drop_last=True,
                                  collate_fn=itm_rank_collate,
                                  seed=args.seed))
        drop = (("n_groups", "sample_size", "attn_masks")
                if args.model_variant == "fast" else
                ("n_groups", "sample_size", "attn_masks_text",
                 "attn_masks_img"))

        def next_batch(global_step):
            batch = next(loader)
            return ({k: v for k, v in batch.items() if k not in drop},
                    dict(sample_size=sample_size))

    if mine is not None:
        mine()   # the initial mining pass (train_itm.py:191-193)

    train_step = make_teacher_step(model, optimizer, device)
    model.train()
    global_step = 0
    t0 = time.time()
    losses = []
    recycler = Recycler(enabled=device.type == "cuda")
    with guard:   # re-enter main()'s guard around the hot loop
        try:
            while global_step < args.num_train_steps:
                host, kw = next_batch(global_step)
                staged = await_staged(stager(host))
                losses.append(train_step(
                    staged, step_generator(args.seed, global_step, rank),
                    **kw)["loss"])
                done = None
                if device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                recycler.push(host, ready=done)
                global_step += 1
                if guard.check(global_step):
                    LOGGER.warning("preempted at step %d: saving the "
                                   "teacher directory and exiting",
                                   global_step)
                    break
                if global_step % max(args.valid_steps, 1) == 0 or \
                        global_step >= args.num_train_steps:
                    LOGGER.info("step %d: triplet loss=%.4f (%.1f steps/s)",
                                global_step,
                                float(torch.stack(losses[-50:]).mean()),
                                global_step / (time.time() - t0))
                if (mine is not None and args.steps_per_hard_neg > 0
                        and global_step % args.steps_per_hard_neg == 0
                        and global_step < args.num_train_steps):
                    mine()   # periodic re-mining (train_itm.py:266-270)
        finally:
            recycler.flush()

    # the teacher directory, read by load_cross_encoder of either package
    if is_main_process():
        with open(os.path.join(args.output_dir, "config.json"), "w") as f:
            json.dump(cfg.to_dict(), f)
        save_checkpoint(os.path.join(args.output_dir, "model"), model=model,
                        step=global_step)
        LOGGER.info("teacher saved to %s", args.output_dir)
    barrier()
    per_step = [float(v) for v in torch.stack(losses).cpu()] if losses \
        else []
    final_loss = float(np.mean(per_step[-20:])) if per_step else float("nan")
    print(json.dumps({"final_loss": final_loss, "steps": global_step}))
    return {"final_loss": final_loss, "losses": per_step}, model


if __name__ == "__main__":
    main()
