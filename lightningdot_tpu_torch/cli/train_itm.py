"""ITM fine-tuning driver (the port's ``train_itm``,
lightningdot_tpu/cli/train_itm.py:62-355; reference train_itm.py):
per-epoch hard-negative resampling, the bidirectional in-batch NCE (with
optional caption blending), AdamW under a linear warmup over 10 % of the
updates, gradient accumulation, per-epoch validation with best/last
checkpoints, a preemption snapshot, and an optional final test evaluation.

It runs on the card by default, or on the CPU with ``--device cpu``.
Batches are staged one ahead through pinned buffers on a side stream
(``DevicePrefetcher`` + ``PinnedStager``), and a spent batch's host arrays
return to the buffer pool once an event recorded after its step has
passed. The dropout masks of step N come from a generator derived from
(seed, N) (``utils/runtime.step_generator``), the counterpart of JAX's
``fold_in(rng, global_step)``. Evaluation and hard-negative mining put the
model in eval mode; the driver turns training mode back on after each.
Caption blending (``--itm_global_file``) needs ``--vocab_file``, as the
port's ``eval_itm`` does. ``--teacher_checkpoint`` (a cross-encoder
teacher directory) adds the distillation term (``--T``,
``--kd_loss_weight``): each batch carries the teacher's pair grid of its
texts against its first ``min(10, batch)`` images (``make_teacher_batch``,
tiled into the page-locked pool and staged with the batch); the teacher
computes in float32 whatever ``--compute_dtype`` is, as JAX's
(cli/train_itm.py:54-59), and stays in eval mode. Across processes the
term is that of the global batch (``min(10, global batch)`` images), and
its grid is built on the device inside the step (``make_kd_fn``), where
its collectives run on the step's thread.

Under ``torchrun`` each process trains on its card (``cuda:LOCAL_RANK``
unless ``--device`` names one; ``--dist_backend gloo`` lets two ranks
share one card) over its rank-strided shard of the training DBs, with
global in-batch negatives and summed gradients (``make_itm_train_step``).
The weights are checked equal across ranks at the start, every rank runs
the same number of steps per epoch (the fewest any rank's shard gives),
the preemption flag is OR-reduced every ``--preempt_check_steps``, rank 0
alone logs metrics and writes checkpoints, and every rank evaluates on the
whole validation set, as the JAX driver does. With a teacher, its
weights are checked equal across ranks too.

Usage (reference-compatible config JSONs):
  python -m lightningdot_tpu_torch.cli.train_itm \\
      --config configs/coco_ft.json --itm_global_file "" \\
      --img_checkpoint /path/uniter-base.pt --output_dir out/coco-ft
  python -m torch.distributed.run --nproc_per_node 2 \\
      -m lightningdot_tpu_torch.cli.train_itm ...   # a card per rank, NCCL
"""
from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np
import torch

from lightningdot_tpu_torch.cli.eval_itm import _load_caption_meta
from lightningdot_tpu_torch.config import (add_dist_params, add_itm_params,
                                           add_kd_params, add_logging_params,
                                           default_params, parse_with_config,
                                           print_args)
from lightningdot_tpu_torch.data.feat_db import ImageDbGroup
from lightningdot_tpu_torch.data.itm import (CollateConfig, itm_fast_collate,
                                            make_teacher_batch)
from lightningdot_tpu_torch.data.loader import DevicePrefetcher, PinnedStager
from lightningdot_tpu_torch.data.padding import Recycler
from lightningdot_tpu_torch.models.factory import (build_biencoder,
                                                   load_cross_encoder)
from lightningdot_tpu_torch.parallel.mesh import (assert_same_across_hosts,
                                                  is_main_process,
                                                  process_count,
                                                  process_index, setup_process)
from lightningdot_tpu_torch.training import hn as hn_mod
from lightningdot_tpu_torch.training.checkpoints import save_checkpoint
from lightningdot_tpu_torch.training.evaluator import eval_model_on_dataloader
from lightningdot_tpu_torch.training.itm_step import (make_itm_train_step,
                                                      make_kd_fn)
from lightningdot_tpu_torch.training.optim import (make_fused_adamw,
                                                   make_optimizer,
                                                   schedule_linear)
from lightningdot_tpu_torch.training.trainer_utils import (build_dataloader,
                                                           load_dataset)
from lightningdot_tpu_torch.utils.logging import (LOGGER, TB_LOGGER,
                                                  RunningMeter)
from lightningdot_tpu_torch.utils.misc import host_all_gather, state_digest
from lightningdot_tpu_torch.utils.preemption import PreemptionGuard
from lightningdot_tpu_torch.utils.runtime import setup_runtime, step_generator


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser("train_itm", allow_abbrev=False)
    default_params(parser)
    add_itm_params(parser)
    add_logging_params(parser)
    add_kd_params(parser)
    parser.add_argument("--vocab_file", default=None, type=str,
                        help="WordPiece vocab.txt for caption blending "
                             "(--itm_global_file)")
    add_dist_params(parser)
    return parser


def main(cmds=None):
    """Train; returns (results, model) and prints the results JSON last."""
    args = parse_with_config(build_parser(), cmds)
    os.makedirs(args.output_dir, exist_ok=True)
    # options safe guard (train_itm.py:68-71)
    if args.conf_th == -1:
        assert args.max_bb + args.max_txt_len + 2 <= 512
    else:
        assert args.num_bb + args.max_txt_len + 2 <= 512
    # installed before set-up: a signal during model or data construction
    # latches, and the loop checkpoints at its first boundary and exits
    guard = PreemptionGuard(sim_after_step=args.sim_preempt_step)
    with guard:
        return _main(args, guard)


def _main(args, guard):
    print_args(args, LOGGER.info)
    device = setup_process(args.device, args.dist_backend, args.dp_size)
    rank = process_index()
    if is_main_process():
        TB_LOGGER.create(os.path.join(args.output_dir, "metrics.jsonl"))
    setup_runtime(args)
    rng_py = random.Random(args.seed)

    if isinstance(args.train_txt_dbs, str):
        args.train_txt_dbs = [args.train_txt_dbs]
    if isinstance(args.train_img_dbs, str):
        args.train_img_dbs = [args.train_img_dbs]
    _load_caption_meta(args)
    if args.retrieval_mode != "both":
        # the reference raises for txt_only/img_only too (train_itm.py:212-219)
        raise ValueError("not supported anymore")

    model = build_biencoder(args, seed=args.seed).to(device)
    if process_count() > 1:
        assert_same_across_hosts(state_digest(model), "initial weights")
    args.vector_size = model.txt_cfg.out_size
    kd_fn = None
    # the N_EXAMPLES_TEACHER clamp, on the global batch
    n_teacher = min(10, args.train_batch_size * process_count())
    if args.teacher_checkpoint:
        LOGGER.info("teacher checkpoint provided, using KD framework")
        teacher = load_cross_encoder(args.teacher_checkpoint,
                                     model_config=args.img_model_config,
                                     compute_dtype=torch.float32,
                                     device=device)
        if process_count() > 1:
            assert_same_across_hosts(state_digest(teacher),
                                     "teacher weights")
        kd_fn = make_kd_fn(teacher, T=args.T, n_teacher=n_teacher,
                           caption_score_weight=args.caption_score_weight,
                           num_hard_negatives=args.num_hard_negatives)

    all_img_dbs = ImageDbGroup(args.conf_th, args.max_bb, args.min_bb,
                               args.num_bb)
    (train_img2txt, train_txt2img, train_img2set, train_txt2set,
     train_set2img, train_set2txt) = hn_mod.get_img_txt_mappings(
        args.train_txt_dbs)
    collate_cfg = CollateConfig(fixed_batch=args.train_batch_size)
    collate = lambda items: itm_fast_collate(items, collate_cfg)  # noqa: E731
    eval_collate = lambda items: itm_fast_collate(  # noqa: E731
        items, CollateConfig(fixed_batch=args.valid_batch_size))
    # page-locks the buffer pool on the card before any loader starts
    stager = PinnedStager(device)
    if kd_fn is not None and process_count() == 1:
        # the teacher grid is built one batch ahead of the step, with the
        # batch's staging (cli/train_itm.py:229-233); across processes the
        # step builds it, since it gathers images from other ranks
        plain_stager = stager
        stager = lambda b: plain_stager(  # noqa: E731
            dict(b, teacher=make_teacher_batch(b, n_teacher)))
    train_dataset = load_dataset(all_img_dbs, args.train_txt_dbs,
                                 args.train_img_dbs, args, True)

    def mine():
        out = hn_mod.sampled_hard_negatives(
            model, train_dataset.datasets, eval_collate, args,
            train_img2txt, train_txt2img, rng=rng_py, device=device)
        model.train()   # mining encodes in eval mode
        return out

    t0 = time.perf_counter()
    if args.sample_init_hard_negatives:
        assert args.num_hard_negatives > 0
        hard_neg_txt, hard_neg_img = mine()
    elif args.num_hard_negatives > 0 and \
            args.hard_negatives_sampling == "random":
        hard_neg_img = hn_mod.random_hard_neg(
            train_txt2img, args.num_hard_negatives, train_txt2set,
            train_set2img, rng=rng_py)
        hard_neg_txt = hn_mod.random_hard_neg(
            train_img2txt, args.num_hard_negatives, train_img2set,
            train_set2txt, rng=rng_py)
    else:
        hard_neg_txt, hard_neg_img = None, None
    init_mine_s = time.perf_counter() - t0

    train_dataloader = build_dataloader(train_dataset, collate, True, args)
    LOGGER.info("train dataset len = %d, dataloader len = %d",
                len(train_dataset), len(train_dataloader))
    val_dataset = load_dataset(all_img_dbs, args.val_txt_db, args.val_img_db,
                               args, is_train=False)
    val_dataset.new_epoch()
    val_dataloader = build_dataloader(val_dataset, eval_collate, False, args)
    val_img2txt = val_dataset.txt_db.img2txts

    # optimizer + schedule (train_itm.py:125,172-175)
    accum = args.gradient_accumulation_steps
    updates_per_epoch = max(len(train_dataloader) // accum, 1)
    total_updates = updates_per_epoch * args.num_train_epochs
    lr_schedule = schedule_linear(args.learning_rate,
                                  int(0.1 * total_updates), total_updates)
    if args.optim_state_dtype == "bfloat16" and accum == 1:
        optimizer = make_fused_adamw(model, lr_schedule,
                                     max_grad_norm=args.max_grad_norm,
                                     state_dtype=torch.bfloat16)
    else:
        if args.optim_state_dtype == "bfloat16":
            # as the JAX driver, whose optax.MultiSteps wraps only the
            # float32 optimizer (cli/train_itm.py:166-177)
            LOGGER.warning("optim_state_dtype=bfloat16 requires "
                           "gradient_accumulation_steps=1; using float32")
        optimizer = make_optimizer(model, lr_schedule,
                                   max_grad_norm=args.max_grad_norm)
    train_step = make_itm_train_step(
        model, optimizer, caption_score_weight=args.caption_score_weight,
        num_hard_negatives=args.num_hard_negatives, kd_fn=kd_fn,
        kd_loss_weight=args.kd_loss_weight, accum_steps=accum,
        device=device)
    model.train()

    best_eval_metric = 0.0
    loss_meter = RunningMeter("loss")
    global_step = 0
    epochs = []
    # the OR-reduce cadence across processes: a multiple of the
    # accumulation window, so that every rank leaves on an update boundary
    check_every = max(args.preempt_check_steps, accum)
    guard.check_every = check_every + (-check_every) % accum
    guard.__enter__()   # re-enter main()'s guard around the hot loop
    try:
        for epoch in range(args.num_train_epochs):
            LOGGER.info("*" * 70)
            t0 = time.perf_counter()
            train_dataset.new_epoch(hard_neg_img, hard_neg_txt)
            # a fresh seed per epoch: one seed would replay the shuffle
            train_dataloader = build_dataloader(
                train_dataset, collate, True, args,
                seed=(args.seed or 0) + epoch)
            # the ranks' shards may differ by an item: every rank takes
            # the steps that the smallest shard gives
            n_steps = min(host_all_gather(len(train_dataloader)))
            n_ex = 0
            # log the PREVIOUS interval's metrics, already computed, so the
            # loop never waits on the step just launched
            pending = None
            recycler = Recycler(enabled=device.type == "cuda")
            steps = 0
            for step, batch in enumerate(DevicePrefetcher(train_dataloader,
                                                          put=stager)):
                if step == n_steps:
                    break
                metrics = train_step(batch, step_generator(
                    args.seed, global_step, rank))
                global_step += 1
                steps += 1
                n_ex += batch["n_valid"]
                done = None
                if device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
                recycler.push(batch.host, ready=done)
                if (step + 1) % args.log_result_step == 0:
                    if pending is not None:
                        loss = float(pending["loss"])
                        loss_meter(loss)
                        lr = lr_schedule(global_step // accum)
                        LOGGER.info(
                            "Epoch %d: step %d/%d, loss=%.4f (smoothed "
                            "%.4f) acc=%.4f lr=%.2e (%.1f ex/s)", epoch,
                            step + 1, len(train_dataloader), loss,
                            loss_meter.val, float(pending["acc"]), lr,
                            n_ex / max(time.perf_counter() - t0, 1e-6))
                        TB_LOGGER.set_step(global_step)
                        TB_LOGGER.log_metric("loss_train", loss)
                        TB_LOGGER.log_metric("lr", lr)
                    pending = metrics
                if guard.check(global_step):
                    break
            recycler.flush()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            train_s = time.perf_counter() - t0
            if guard.sync():
                # weights-only warm start: relaunch with
                # --biencoder_checkpoint <output_dir>/biencoder.preempt
                # (epochs and the schedule restart, as the reference's)
                LOGGER.warning("preempted at step %d (epoch %d): saving "
                               "biencoder.preempt and exiting", global_step,
                               epoch)
                if is_main_process():
                    save_checkpoint(
                        os.path.join(args.output_dir, "biencoder.preempt"),
                        model=model, step=global_step, epoch=epoch)
                break

            # eval and save (train_itm.py:313-349)
            t0 = time.perf_counter()
            result = eval_model_on_dataloader(
                model, val_dataloader, img2txt=val_img2txt,
                vector_size=args.vector_size,
                caption_score_weight=args.caption_score_weight,
                hnsw=args.hnsw_index, device=device)
            model.train()   # the evaluator encodes in eval mode
            eval_s = time.perf_counter() - t0
            recall_txt, recall_img = result.recall
            recall_val = {t: (recall_txt[t] + recall_img[t]) / 2
                          for t in recall_txt}
            current = float(np.mean(list(recall_val.values())))
            LOGGER.info("epoch %d: val loss=%.4f recall=%s (mean %.4f)",
                        epoch, result.loss, recall_val, current)
            TB_LOGGER.log_scalar_dict(
                {f"R@{k}": v for k, v in recall_val.items()}, prefix="val")

            def ckpt(name):
                # rank 0 alone writes (train_itm.py:343-349): the ranks
                # hold the same weights
                if is_main_process():
                    save_checkpoint(
                        os.path.join(args.output_dir, f"biencoder.{name}"),
                        model=model, step=global_step, epoch=epoch)

            if current > best_eval_metric:
                best_eval_metric = current
                ckpt("best")
            ckpt("last")
            if args.save_all_epochs:
                ckpt(str(epoch))

            # re-mine hard negatives for the NEXT epoch (train_itm.py:
            # 351-358; not after the last one, whose result nothing reads)
            t0 = time.perf_counter()
            if (args.num_hard_negatives > 0
                    and epoch < args.num_train_epochs - 1):
                hard_neg_txt, hard_neg_img = mine()
            elif args.num_hard_negatives == 0:
                assert args.hard_negatives_sampling in ("none", "random")
            # seconds of the epoch's steps, its evaluation, and the mining
            # after it; the recall is that of the weights in biencoder.last
            epochs.append(dict(epoch=epoch, steps=steps, train_s=train_s,
                               eval_s=eval_s,
                               mine_s=time.perf_counter() - t0,
                               val_recall_mean=current,
                               recall_txt=recall_txt,
                               recall_img=recall_img))
    finally:
        guard.__exit__()  # restore SIGTERM even if an epoch raises
    results = {"best_val_recall_mean": best_eval_metric,
               "init_mine_s": init_mine_s, "epochs": epochs}
    if guard.sync():  # skip the final test sweep in the grace window
        return results, model
    if args.test_txt_db:
        test_dataset = load_dataset(all_img_dbs, args.test_txt_db,
                                    args.test_img_db, args, is_train=False)
        test_dataset.new_epoch()
        test_loader = build_dataloader(test_dataset, eval_collate, False,
                                       args)
        res = eval_model_on_dataloader(
            model, test_loader, img2txt=test_dataset.txt_db.img2txts,
            vector_size=args.vector_size,
            caption_score_weight=args.caption_score_weight, device=device)
        LOGGER.info("test: loss=%.4f recall_txt=%s recall_img=%s",
                    res.loss, res.recall[0], res.recall[1])
        results["test"] = {"recall_txt": res.recall[0],
                           "recall_img": res.recall[1]}
    print(json.dumps(results, default=float))
    return results, model


if __name__ == "__main__":
    main()
