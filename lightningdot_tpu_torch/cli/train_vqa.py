"""VQA fine-tuning driver (the port's ``train_vqa``,
lightningdot_tpu/cli/train_vqa.py; reference uniter_model/train_vqa.py:
100-265 adapted to the bi-encoder VQA head, dvl/models/bi_encoder.py:
683-734): an epoch loop over ``VqaDataset`` batches (a ``ConcatDataset``
over several train DBs), the instance-level BCE, AdamW under a linear
warmup over 10 % of the updates with the UNITER conventions (betas
(0.9, 0.98), eps 1e-6, decay 0.01, ``first_lr_step`` 1) and one
model-wide clip, gradient accumulation (``optax.MultiSteps``' running
mean), per-epoch ``evaluate_vqa`` with ``vqa.{best,last}`` checkpoints, a
preemption snapshot, and the results JSON printed last.

``--vqa_lr_mul`` multiplies the head's (``vqa_output``) learning rate, in
its step size and its decay: JAX's ``optax.multi_transform`` over {body,
head} under one clip (cli/train_vqa.py:131-149), here a per-tensor factor
of the one AdamW launch. ``--vqa_intersection`` feeds the head
``[q, ctx, q*ctx, q+ctx]``.

It runs on the card by default, or on the CPU with ``--device cpu``.
Batches are staged one ahead through pinned buffers on a side stream
(``DevicePrefetcher`` + ``PinnedStager``), and a spent batch's host arrays
return to the buffer pool once an event recorded after its step has
passed. The dropout masks of step N come from a generator derived from
(seed, N) (``utils/runtime.step_generator``). Evaluation puts the model in
eval mode; it goes back to training mode after each.

Under ``torchrun`` each process trains on its card (``cuda:LOCAL_RANK``
unless ``--device`` names one; ``--dist_backend gloo`` lets two ranks
share one card) over its rank-strided shard of the training DBs (JAX's
cli/train_vqa.py:95-99), with the loss over the global valid count and
the gradients summed once per update (``make_vqa_train_step``), where
JAX's replicas exchange none. The weights are checked equal across ranks
at the start, every rank runs the steps that the smallest shard gives,
the preemption flag is OR-reduced every ``--preempt_check_steps``, every
rank evaluates on the whole validation set and so takes the same
best-checkpoint decision, and rank 0 alone logs metrics and writes
``vqa.*``.

Usage:
  python -m lightningdot_tpu_torch.cli.train_vqa --config configs/coco_ft.json \\
      --train_txt_dbs vqa_train.db --train_img_dbs img/ --val_txt_db ... \\
      --val_img_db ... --img_checkpoint none --output_dir out/vqa
  python -m torch.distributed.run --nproc_per_node 2 \\
      -m lightningdot_tpu_torch.cli.train_vqa ...   # a card per rank, NCCL
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from lightningdot_tpu_torch.config import (add_dist_params, add_itm_params,
                                           add_logging_params, default_params,
                                           parse_with_config, print_args)
from lightningdot_tpu_torch.data.feat_db import ImageDbGroup
from lightningdot_tpu_torch.data.loader import DevicePrefetcher, PinnedStager
from lightningdot_tpu_torch.data.padding import Recycler
from lightningdot_tpu_torch.data.txt_db import TxtTokDb
from lightningdot_tpu_torch.data.vqa import (VqaCollateConfig, VqaDataset,
                                             VqaEvalDataset, vqa_collate)
from lightningdot_tpu_torch.models.factory import build_biencoder
from lightningdot_tpu_torch.models.vqa import BiEncoderForVQA, init_vqa_head_
from lightningdot_tpu_torch.parallel.mesh import (assert_same_across_hosts,
                                                  barrier, is_main_process,
                                                  process_count,
                                                  process_index, setup_process)
from lightningdot_tpu_torch.training.checkpoints import save_checkpoint
from lightningdot_tpu_torch.training.optim import (make_optimizer,
                                                   schedule_linear)
from lightningdot_tpu_torch.training.trainer_utils import (ConcatDataset,
                                                           build_dataloader)
from lightningdot_tpu_torch.training.vqa_step import (evaluate_vqa,
                                                      make_vqa_train_step)
from lightningdot_tpu_torch.utils.logging import (LOGGER, TB_LOGGER,
                                                  RunningMeter)
from lightningdot_tpu_torch.utils.misc import host_all_gather, state_digest
from lightningdot_tpu_torch.utils.preemption import PreemptionGuard
from lightningdot_tpu_torch.utils.runtime import setup_runtime, step_generator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("train_vqa", allow_abbrev=False)
    default_params(parser)
    add_itm_params(parser)  # db paths + region-feature knobs
    add_logging_params(parser)
    parser.add_argument("--num_answers", default=3129, type=int,
                        help="answer vocabulary size (VQA v2: 3129)")
    parser.add_argument("--vqa_intersection", action="store_true",
                        help="[q,ctx,q*ctx,q+ctx] head input "
                             "(bi_encoder.py:694-710)")
    parser.add_argument("--vqa_lr_mul", default=1.0, type=float,
                        help="learning-rate multiplier for the vqa_output "
                             "head (train_vqa.py:52-76)")
    add_dist_params(parser)
    return parser


def build_model(args) -> BiEncoderForVQA:
    """The towers per ``args`` (``build_biencoder``) under a VQA head drawn
    from ``seed`` (JAX's ``model.init(PRNGKey(seed))`` draws other
    numbers), on the CPU in eval mode."""
    biencoder = build_biencoder(args, seed=args.seed)
    model = BiEncoderForVQA(biencoder, biencoder.txt_cfg.out_size,
                            args.num_answers,
                            intersection=args.vqa_intersection)
    init_vqa_head_(model, torch.Generator().manual_seed(args.seed))
    return model.eval()


def main(cmds=None):
    """Train; returns (results, model) and prints the results JSON last."""
    args = parse_with_config(build_parser(), cmds)
    # installed before set-up: a signal during model or data construction
    # latches, and the loop checkpoints at its first boundary and exits
    guard = PreemptionGuard(sim_after_step=args.sim_preempt_step,
                            check_every=args.preempt_check_steps)
    with guard:
        return _main(args, guard)


def _main(args, guard):
    os.makedirs(args.output_dir, exist_ok=True)
    print_args(args, LOGGER.info)
    device = setup_process(args.device, args.dist_backend, args.dp_size)
    rank = process_index()
    if is_main_process():
        TB_LOGGER.create(os.path.join(args.output_dir, "metrics.jsonl"))
    setup_runtime(args)
    np.random.seed(args.seed)

    if isinstance(args.train_txt_dbs, str):
        args.train_txt_dbs = [args.train_txt_dbs]
    if isinstance(args.train_img_dbs, str):
        args.train_img_dbs = [args.train_img_dbs]

    model = build_model(args).to(device)
    if process_count() > 1:
        assert_same_across_hosts(state_digest(model), "initial weights")
    all_img_dbs = ImageDbGroup(args.conf_th, args.max_bb, args.min_bb,
                               args.num_bb)
    # rank-strided shards of the training DBs (JAX's cli/train_vqa.py:
    # 95-99); the validation DB is whole on every rank
    train_sets = [VqaDataset(args.num_answers,
                             TxtTokDb(t, args.max_txt_len, rank=rank,
                                      world_size=process_count()),
                             all_img_dbs[im])
                  for t, im in zip(args.train_txt_dbs, args.train_img_dbs)]
    train_dataset = (train_sets[0] if len(train_sets) == 1
                     else ConcatDataset(train_sets))
    val_dataset = VqaEvalDataset(args.num_answers,
                                 TxtTokDb(args.val_txt_db, -1),
                                 all_img_dbs[args.val_img_db])

    collate_cfg = VqaCollateConfig(fixed_batch=args.train_batch_size)
    collate = lambda items: vqa_collate(items, collate_cfg)  # noqa: E731
    eval_cfg = VqaCollateConfig(fixed_batch=args.valid_batch_size)
    eval_collate = lambda items: vqa_collate(items, eval_cfg)  # noqa: E731
    # page-locks the buffer pool on the card before any loader starts
    stager = PinnedStager(device)
    train_loader = build_dataloader(train_dataset, collate, True, args)
    val_loader = build_dataloader(val_dataset, eval_collate, False, args)

    accum = args.gradient_accumulation_steps
    # the ranks' shards may differ by an item: every rank takes the steps
    # that the smallest shard gives
    n_steps = min(host_all_gather(len(train_loader)))
    updates_per_epoch = max(n_steps // accum, 1)
    total_updates = updates_per_epoch * max(args.num_train_epochs, 1)
    lr_schedule = schedule_linear(args.learning_rate,
                                  int(0.1 * total_updates), total_updates)
    # UNITER optimizer convention (uniter_model/train_vqa.py:51-85,204-215):
    # betas (0.9, 0.98), the vendored AdamW's eps 1e-6, weight decay on the
    # non-bias/LN parameters, the post-increment schedule read; ONE
    # model-wide clip ahead of the (head-scaled) update (train_vqa.py:243)
    optimizer = make_optimizer(
        model, lr_schedule, betas=tuple(getattr(args, "betas", (0.9, 0.98))),
        adam_eps=getattr(args, "adam_eps", 1e-6),
        weight_decay=getattr(args, "weight_decay", 0.01),
        max_grad_norm=args.max_grad_norm, first_lr_step=1,
        lr_mul=({"vqa_output.": args.vqa_lr_mul}
                if args.vqa_lr_mul != 1.0 else None))
    train_step = make_vqa_train_step(model, optimizer, accum_steps=accum,
                                     device=device)
    model.train()

    best_acc = -1.0
    loss_meter = RunningMeter("loss")
    global_step = 0
    results = {}
    epochs = []
    for epoch in range(args.num_train_epochs):
        t0 = time.perf_counter()
        n_ex = 0
        # log the PREVIOUS interval's metrics, already computed, so the
        # loop never waits on the step just launched
        pending = None
        recycler = Recycler(enabled=device.type == "cuda")
        preempted = False
        steps = 0
        for step, batch in enumerate(DevicePrefetcher(train_loader,
                                                      put=stager)):
            if step == n_steps:
                break
            metrics = train_step(batch, step_generator(args.seed,
                                                       global_step, rank))
            global_step += 1
            steps += 1
            n_ex += batch["n_valid"]
            done = None
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            recycler.push(batch.host, ready=done)
            if guard.check(global_step):
                preempted = True
                break
            if (step + 1) % args.log_result_step == 0:
                if pending is not None:
                    loss = float(pending["loss"])
                    loss_meter(loss)
                    LOGGER.info(
                        "Epoch %d: step %d/%d, loss=%.4f score=%.4f "
                        "(%.1f ex/s)", epoch, step + 1, len(train_loader),
                        loss, float(pending["score"]),
                        n_ex / max(time.perf_counter() - t0, 1e-6))
                    TB_LOGGER.set_step(global_step)
                    TB_LOGGER.log_metric("loss_train", loss)
                pending = metrics
        recycler.flush()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        train_s = time.perf_counter() - t0
        if preempted or guard.sync():
            # the accumulation window's mean is not saved: the weights are
            # those of the last update, as JAX's MultiSteps snapshot
            if is_main_process():
                save_checkpoint(os.path.join(args.output_dir, "vqa.last"),
                                model=model, step=global_step, epoch=epoch)
            barrier()
            LOGGER.warning("exiting after preemption checkpoint at step %d",
                           global_step)
            break

        t0 = time.perf_counter()
        val = evaluate_vqa(model, val_loader, device=device)
        eval_s = time.perf_counter() - t0
        LOGGER.info("epoch %d: val loss=%.4f acc=%.4f", epoch, val["loss"],
                    val["acc"])
        TB_LOGGER.log_scalar_dict({"loss": val["loss"], "acc": val["acc"]},
                                  prefix="val")

        def ckpt(name):
            # rank 0 alone writes: the ranks hold the same weights
            if is_main_process():
                save_checkpoint(os.path.join(args.output_dir, f"vqa.{name}"),
                                model=model, step=global_step, epoch=epoch)

        # every rank evaluated the whole validation set with the same
        # weights, so every rank takes the same decision
        if val["acc"] > best_acc:
            best_acc = val["acc"]
            ckpt("best")
        ckpt("last")
        barrier()
        epochs.append(dict(epoch=epoch, steps=steps, train_s=train_s,
                           eval_s=eval_s, val_loss=val["loss"],
                           val_acc=val["acc"], answers=val["results"]))
        results = {"best_val_acc": best_acc, "last_val": {
            "loss": val["loss"], "acc": val["acc"]}}

    print(json.dumps(results, default=float))
    if epochs:
        results["epochs"] = epochs
    return results, model


if __name__ == "__main__":
    main()
