"""Multi-task pre-training driver (the port's ``pretrain``,
lightningdot_tpu/cli/pretrain.py; reference pretrain.py): per-dataset task
lists with ``mix_ratio`` (the config/pretrain-alldata-base.json schema),
``MetaLoader`` task sampling per accumulation window, per-task losses (MLM,
MRFR, MRC-kl, ITM), AdamW under ``get_lr_sched``, validation and a
step-numbered checkpoint every ``valid_steps``, auto-resume from the newest
checkpoint (the port's, or the JAX driver's ``.npz`` with its optax state),
and a preemption checkpoint (pretrain.py:246-536,906-917).

It runs on the card by default, or on the CPU with ``--device cpu``. Each
task's batches come from a ``TokenBucketSampler`` loader; batches are
staged one ahead through pinned buffers on a side stream, and a spent
batch returns to the buffer pool once an event recorded after its step has
passed. A ``teacher_checkpoint`` directory (``config.json`` + the
one-tower ``UniterForPretraining``'s ``model.pt``, or the JAX package's
``model.npz``) adds the distillation term to every non-itm task
(``kd_loss``, ``T``, ``kd_loss_weight``); its joint sub-batches
(``_teacher_fields``) ride in the training batches, and it computes in
the student's dtype (JAX's in float32).

Under ``torchrun`` each process trains on its card (``cuda:LOCAL_RANK``
unless ``--device`` names one; ``--dist_backend gloo`` for ranks that
share a card) over its rank-strided shard of the training DBs, in batches
of a host-agreed static shape: one top bucket per axis and a fixed row
count from the token budget (the JAX driver's cli/pretrain.py:145-180),
so that every rank steps on the same task at the same shape. Rank 0's
resume step is every rank's (broadcast, then each waits for its files),
the task of every accumulation window is checked equal across ranks,
rank 0 alone writes checkpoints and metrics, and every rank validates on
the whole validation set.

Usage:
  python -m lightningdot_tpu_torch.cli.pretrain \\
      --config configs/pretrain_alldata_base.json
  python -m torch.distributed.run --nproc_per_node 2 \\
      -m lightningdot_tpu_torch.cli.pretrain --config ...
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from collections import defaultdict
from typing import Any, Dict

import torch

from lightningdot_tpu_torch.config import (add_dist_params, parse_with_config,
                                           print_args)
from lightningdot_tpu_torch.const import BUCKET_SIZE, IMG_LABEL_DIM
from lightningdot_tpu_torch.data.feat_db import ImageDbGroup
from lightningdot_tpu_torch.data.loader import (DataLoader, DevicePrefetcher,
                                                DistributedSampler,
                                                MetaLoader, PinnedStager,
                                                TokenBucketSampler)
from lightningdot_tpu_torch.data.padding import Recycler, bucket_len
from lightningdot_tpu_torch.data.pretrain import (ItmPreDataset, MlmDataset,
                                                  MrcDataset, MrfrDataset,
                                                  PretrainCollateConfig,
                                                  itm_pre_collate,
                                                  mlm_collate, mrc_collate,
                                                  mrfr_collate)
from lightningdot_tpu_torch.data.txt_db import TxtTokDb
from lightningdot_tpu_torch.models.bi_encoder import (BiEncoder,
                                                      BiEncoderForPretraining,
                                                      init_pretrain_heads_)
from lightningdot_tpu_torch.models.encoder import init_tower_
from lightningdot_tpu_torch.models.factory import (_overlay,
                                                   resolve_encoder_config)
from lightningdot_tpu_torch.models.uniter_pretrain import UniterForPretraining
from lightningdot_tpu_torch.models.weights import (load_torch_state_dict,
                                                   pretrain_keys)
from lightningdot_tpu_torch.parallel.mesh import (assert_same_across_hosts,
                                                  barrier,
                                                  broadcast_one_to_all,
                                                  is_main_process,
                                                  process_count,
                                                  process_index, setup_process)
from lightningdot_tpu_torch.training.checkpoints import (
    latest_step_checkpoint, load_checkpoint, load_state_dict_strict,
    rank_saver, read_checkpoint, save_training_meta)
from lightningdot_tpu_torch.training.optim import get_lr_sched, make_optimizer
from lightningdot_tpu_torch.training.pretrain_step import (make_pretrain_step,
                                                           make_validate_fn)
from lightningdot_tpu_torch.training.trainer_utils import ConcatDataset
from lightningdot_tpu_torch.utils.logging import (LOGGER, TB_LOGGER,
                                                  RunningMeter)
from lightningdot_tpu_torch.utils.preemption import PreemptionGuard
from lightningdot_tpu_torch.utils.runtime import setup_runtime, step_generator


def build_parser():
    p = argparse.ArgumentParser("pretrain", allow_abbrev=False)
    p.add_argument("--config", required=True)
    p.add_argument("--output_dir", default=None)
    p.add_argument("--num_train_steps", type=int, default=None)
    p.add_argument("--valid_steps", type=int, default=None)
    p.add_argument("--async_checkpoint", type=int, default=1,
                   help="write step checkpoints on a background thread "
                        "(the weights are copied to the host first)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sim_preempt_step", type=int, default=None,
                   help="fault injection: act as if SIGTERM arrived at "
                        "this global step")
    p.add_argument("--preempt_check_steps", type=int, default=25,
                   help="cadence of the preemption OR-reduce across "
                        "processes, in optimizer updates")
    p.add_argument("--compute_dtype", default="bf16",
                   choices=["bf16", "f32"])
    add_dist_params(p, dp_size=False)
    return p


def _build_task(task: str, txt_dbs, img_dbs, args, collate_cfg, is_train,
                fixed_rows: int = 0):
    """pretrain.py:79-221's build_*_dataset (cli/pretrain.py:73-144): one
    task's loader over a token-budget sampler, or, with ``fixed_rows`` > 0
    (training across processes), over batches of that many examples: the
    ranks must step on the same shapes, which token-budget batches would
    not give."""
    datasets = []
    for txt_db, img_db in zip(txt_dbs, img_dbs):
        if task.startswith("mlm"):
            datasets.append(MlmDataset(txt_db, img_db, seed=args.seed))
            collate = lambda items: mlm_collate(items, collate_cfg)  # noqa
        elif task.startswith("mrfr"):
            datasets.append(MrfrDataset(args.mrm_prob, txt_db, img_db,
                                        seed=args.seed))
            collate = lambda items: mrfr_collate(items, collate_cfg)  # noqa
        elif task.startswith("mrc"):
            datasets.append(MrcDataset(args.mrm_prob, txt_db, img_db,
                                       seed=args.seed))
            collate = lambda items: mrc_collate(items, collate_cfg)  # noqa
        elif task.startswith("itm"):
            datasets.append(ItmPreDataset(txt_db, img_db, args.itm_neg_prob,
                                          seed=args.seed))
            collate = lambda items: itm_pre_collate(items,  # noqa: E731
                                                    collate_cfg)
        else:
            raise ValueError(f"Undefined task {task}")
    dataset = datasets[0] if len(datasets) == 1 else ConcatDataset(datasets)

    def on_epoch():
        # resample the ITM pairings every epoch (itm_pre.py:20-29) and
        # advance the per-item mask salt so MLM/MRFR/MRC draw fresh masks
        for d in datasets:
            if hasattr(d, "new_epoch"):
                d.new_epoch()
            if hasattr(d, "advance_epoch"):
                d.advance_epoch()
        if isinstance(sampler, DistributedSampler):
            sampler.set_epoch(sampler.epoch + 1)
        else:
            sampler._lens = [l for d in datasets for l in d.lens]

    if fixed_rows and is_train:
        if len(dataset) < fixed_rows:
            raise ValueError(
                f"task {task}: {len(dataset)} examples on this rank < the "
                f"fixed batch of {fixed_rows} rows: lower train_batch_size "
                f"or use fewer processes")
        # the DBs are rank-sharded already: the sampler fixes the rows
        sampler = DistributedSampler(len(dataset), num_replicas=1, rank=0,
                                     batch_size=fixed_rows, shuffle=True,
                                     drop_last=True, seed=args.seed or 0)
    else:
        sampler = TokenBucketSampler(
            [l for d in datasets for l in d.lens], bucket_size=BUCKET_SIZE,
            batch_size=(args.train_batch_size if is_train
                        else args.val_batch_size),
            droplast=is_train, seed=args.seed)
    return DataLoader(dataset, sampler=sampler, collate_fn=collate,
                      on_epoch=on_epoch,
                      num_workers=(getattr(args, "loader_workers", 1)
                                   if is_train else 1))


def create_dataloaders(dataset_specs, is_train, args, all_img_dbs,
                       collate_cfg):
    """pretrain.py:165-221 (cli/pretrain.py:147-188). Across processes
    the training DBs shard rank-strided and the batches take a
    host-agreed static shape: one top bucket per axis, and a fixed row
    count from the token budget at the longest sequences; validation stays
    whole on every rank."""
    loaders = {}
    rank, world = (process_index(), process_count()) if is_train else (0, 1)
    fixed_rows = 0
    if world > 1:
        txt_top = bucket_len(args.max_txt_len + 2, collate_cfg.txt_buckets)
        img_top = bucket_len(args.max_bb + 1, collate_cfg.img_buckets)
        fixed_rows = max(8, args.train_batch_size // (txt_top + img_top)
                         // 8 * 8)
        # a batch_pad of 8 divides fixed_rows: full batches stay unpadded
        collate_cfg = dataclasses.replace(
            collate_cfg, txt_buckets=(txt_top,), img_buckets=(img_top,),
            batch_pad=8)
        LOGGER.info("static shapes across processes: txt=%d img=%d "
                    "rows=%d/rank", txt_top, img_top, fixed_rows)
    for dset in dataset_specs:
        img_dbs = [all_img_dbs[p] for p in dset["img"]]
        for i, t in enumerate(dset["tasks"]):
            task = f"{t}_{dset['name']}"
            max_len = args.max_txt_len if is_train else -1
            txt_dbs = [TxtTokDb(p, max_len, rank=rank, world_size=world)
                       for p in dset["db"]]
            LOGGER.info("Loading %s %s dataset %s", task,
                        "train" if is_train else "val", dset["db"])
            loader = _build_task(t, txt_dbs, img_dbs, args, collate_cfg,
                                 is_train, fixed_rows=fixed_rows)
            if is_train:
                loaders[task] = (loader, dset["mix_ratio"][i])
            else:
                loaders[task] = loader
    return loaders


def _agreed_resume(output_dir: str):
    """The newest step checkpoint that rank 0 finds, on every rank: each
    other rank waits up to two minutes for its files on the shared
    ``output_dir`` (cli/pretrain.py:336-370)."""
    resume = latest_step_checkpoint(os.path.join(output_dir, "ckpt"))
    if process_count() == 1:
        return resume
    step = broadcast_one_to_all(resume[1] if resume else -1)
    if step < 0:
        return None
    path = os.path.join(output_dir, "ckpt", f"model_step_{step}")
    deadline = time.time() + 120
    while not (os.path.exists(path + ".json")
               and (os.path.exists(path + ".pt")
                    or os.path.exists(path + ".npz"))):
        if time.time() > deadline:
            raise RuntimeError(f"rank 0 resumes from {path}, which this "
                               f"rank cannot see (a shared output_dir is "
                               f"required)")
        time.sleep(0.2)
    return path, step


def validate(val_loaders, validate_fn, global_step):
    """pretrain.py:527-536 + the validate_* functions: the mean of each
    metric over each task's validation batches."""
    out = {}
    for task_name, loader in val_loaders.items():
        task = task_name.split("_")[0]
        t0 = time.time()
        sums: Dict[str, Any] = defaultdict(float)
        n = 0
        for batch in loader:
            for k, v in validate_fn(batch, task).items():
                sums[k] = sums[k] + v    # summed on the device
            n += 1
        res = {k: float(v) / max(n, 1) for k, v in sums.items()}
        LOGGER.info("validate %s: %s (%.1fs)", task_name, res,
                    time.time() - t0)
        TB_LOGGER.log_scalar_dict(res, prefix=f"val_{task_name}")
        out[task_name] = res
    return out


def build_model(args, dtype: torch.dtype) -> BiEncoderForPretraining:
    """BiEncoderForPretraining (pretrain.py:313-314) with random weights
    from ``args.seed`` (the port's generator, not JAX's PRNGKey), the towers
    overlaid with ``img_checkpoint`` / ``txt_checkpoint`` where the files
    exist."""
    project_dim = getattr(args, "project_dim", 0)
    dropout = getattr(args, "dropout", 0.1)
    txt_cfg = resolve_encoder_config(args.txt_model_config,
                                     project_dim=project_dim, dropout=dropout)
    img_cfg = resolve_encoder_config(args.img_model_config,
                                     project_dim=project_dim, dropout=dropout)
    model = BiEncoderForPretraining(
        BiEncoder(txt_cfg, img_cfg, compute_dtype=dtype),
        cls_concat=getattr(args, "cls_concat", ""),
        img_label_dim=getattr(args, "img_label_dim", IMG_LABEL_DIM))
    gen = torch.Generator().manual_seed(args.seed)
    init_tower_(model.bert.txt_model, gen)
    init_tower_(model.bert.img_model, gen)
    init_pretrain_heads_(model, gen)

    def _maybe(p):
        return p if p and str(p).lower() != "none" and os.path.exists(p) \
            else None

    if _maybe(getattr(args, "img_checkpoint", None)):
        _overlay(model.bert.img_model,
                 load_torch_state_dict(args.img_checkpoint))
    if _maybe(getattr(args, "txt_checkpoint", None)):
        _overlay(model.bert.txt_model,
                 load_torch_state_dict(args.txt_checkpoint))
    return model


def load_teacher(args, dtype: torch.dtype,
                 device: torch.device) -> UniterForPretraining:
    """The one-tower KD teacher (cli/pretrain.py:286-312): its
    ``config.json`` (else ``model_config``, else ``img_model_config``), and ``model.pt`` under the
    reference's names or the JAX package's ``model.npz``; strict. Returned
    on ``device`` in eval mode."""
    t_dir = args.teacher_checkpoint
    cfg_path = os.path.join(t_dir, "config.json")
    cfg = resolve_encoder_config(
        cfg_path if os.path.exists(cfg_path)
        else getattr(args, "model_config", args.img_model_config))
    teacher = UniterForPretraining(
        cfg, img_label_dim=getattr(args, "img_label_dim", IMG_LABEL_DIM),
        compute_dtype=dtype)
    pt = os.path.join(t_dir, "model.pt")
    if os.path.exists(pt):
        sd = pretrain_keys(load_torch_state_dict(pt))
    else:
        sd, _, _ = read_checkpoint(os.path.join(t_dir, "model"))
    load_state_dict_strict(teacher, sd)
    LOGGER.info("pretrain KD enabled (teacher %s)", t_dir)
    return teacher.to(device).eval()


def build_optimizer(model, args):
    """(optimizer, schedule) of cli/pretrain.py:314-324:
    ``get_lr_sched``, betas (0.9, 0.98), eps 1e-6 (the vendored AdamW's
    default, uniter_model/optim/adamw.py:23), weight decay 0.01, clip 5.0,
    and ``first_lr_step=1``, the post-increment schedule read
    (pretrain.py:458-463)."""
    lr_fn = get_lr_sched(getattr(args, "decay", "linear"),
                         args.learning_rate, args.warmup_steps,
                         args.num_train_steps)
    optimizer = make_optimizer(
        model, lr_fn, betas=tuple(getattr(args, "betas", (0.9, 0.98))),
        adam_eps=getattr(args, "adam_eps", 1e-6),
        weight_decay=getattr(args, "weight_decay", 0.01),
        max_grad_norm=getattr(args, "grad_norm", 5.0), first_lr_step=1)
    return optimizer, lr_fn


def main(cmds=None):
    """Pre-train; returns (validation results, model)."""
    args = parse_with_config(build_parser(), cmds)
    # config safe guard (pretrain.py:919-923)
    if args.conf_th == -1:
        assert args.max_bb + args.max_txt_len + 2 <= 512
    else:
        assert args.num_bb + args.max_txt_len + 2 <= 512
    # the latch installs before set-up: a signal during data or model
    # construction is held until the loop's first update boundary
    guard = PreemptionGuard(
        sim_after_step=getattr(args, "sim_preempt_step", None),
        check_every=max(args.preempt_check_steps, 1))
    with guard:
        return _main(args, guard)


def _main(args, guard):
    print_args(args, LOGGER.info)
    os.makedirs(args.output_dir, exist_ok=True)
    device = setup_process(args.device, args.dist_backend)
    setup_runtime(args)
    if is_main_process():
        TB_LOGGER.create(os.path.join(args.output_dir, "metrics.jsonl"))
        save_training_meta(args.output_dir, args)
    dtype = torch.bfloat16 if args.compute_dtype == "bf16" else torch.float32
    model = build_model(args, dtype).to(device)
    teacher = (load_teacher(args, dtype, device)
               if getattr(args, "teacher_checkpoint", None) else None)

    optimizer, lr_fn = build_optimizer(model, args)
    accum = args.gradient_accumulation_steps
    step_for_task = make_pretrain_step(
        model, optimizer, accum_steps=accum, teacher=teacher,
        kd_loss_weight=getattr(args, "kd_loss_weight", 1.0),
        kd_T=getattr(args, "T", 1.0), device=device)

    # auto-resume (pretrain.py:320-328,906-917); across processes rank 0's
    # discovery is every rank's (its files are the only ones written)
    global_step = 0
    resume = _agreed_resume(args.output_dir)
    if resume is not None:
        path, global_step = resume
        LOGGER.info("auto-resume from %s (step %d)", path, global_step)
        # the port's checkpoints and the JAX driver's (its optax state)
        load_checkpoint(path, model=model, optimizer=optimizer,
                        accumulator=step_for_task.accumulator)

    # page-locks the buffer pool on the card before any loader starts
    stager = PinnedStager(device)
    all_img_dbs = ImageDbGroup(args.conf_th, args.max_bb, args.min_bb,
                               args.num_bb)
    train_loaders = create_dataloaders(
        args.train_datasets, True, args, all_img_dbs,
        PretrainCollateConfig(with_teacher=teacher is not None))
    # validation never runs the teacher: no teacher sub-batches
    val_loaders = create_dataloaders(args.val_datasets, False, args,
                                     all_img_dbs, PretrainCollateConfig())
    meta_loader = MetaLoader(train_loaders, accum_steps=accum,
                             seed=args.seed)
    if global_step:
        # continue the task stream where the interrupted run stopped
        meta_loader.fast_forward(global_step * accum)
    validate_fn = make_validate_fn(model, device=device)
    saver = rank_saver(os.path.join(args.output_dir, "ckpt"),
                       async_save=bool(getattr(args, "async_checkpoint", 0)))

    LOGGER.info("start pre-training: %d steps, tasks=%s",
                args.num_train_steps, list(train_loaders))
    model.train()
    with guard:  # re-enter main()'s guard around the hot loop
        results, global_step, last_validated, preempted = _train_loop(
            args, meta_loader, stager, step_for_task, guard, lr_fn,
            val_loaders, validate_fn, saver, model, optimizer, global_step,
            device)
    if last_validated != global_step:  # no second sweep of one step
        saver.save(model, global_step, optimizer=optimizer)
        results = validate(val_loaders, validate_fn, global_step)
    saver.wait()  # drain the background writer before returning
    barrier()     # rank 0's files are written before any rank reads them
    if preempted:
        LOGGER.warning("exiting after preemption checkpoint at step %d "
                       "(resume by re-running the same command)",
                       global_step)
    return results, model


def _train_loop(args, meta_loader, stager, step_for_task, guard, lr_fn,
                val_loaders, validate_fn, saver, model, optimizer,
                global_step, device):
    """The hot loop (cli/pretrain.py:453-524's ``_train_loop``)."""
    accum = args.gradient_accumulation_steps
    task2loss = {t: RunningMeter(f"loss/{t}")
                 for t in meta_loader.name2loader}
    pending_loss: Dict[str, Any] = {}
    n_examples: Dict[str, int] = defaultdict(int)
    log_every = min(100, max(args.valid_steps, 1))
    start = time.time()
    micro_step = global_step * accum
    last_validated = -1
    results: Dict[str, Any] = {}
    preempted = False
    recycler = Recycler(enabled=device.type == "cuda")

    rank = process_index()

    def put(item):
        name, batch = item
        staged = stager(batch)
        staged.task = name
        return staged

    try:
        for batch in DevicePrefetcher(meta_loader, put=put):
            name = batch.task
            if micro_step % accum == 0:
                # every rank steps on the same task (pretrain.py:392)
                assert_same_across_hosts((name, micro_step), "pretrain task")
            n_examples[name] += batch["n_valid"]
            metrics = step_for_task(name.split("_")[0])(
                batch, step_generator(args.seed, micro_step, rank))
            done = None
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            recycler.push(batch.host, ready=done)
            micro_step += 1
            # the loss stays on the device until the logging interval
            pending_loss[name] = metrics["loss"]
            if micro_step % accum == 0:
                global_step += 1
                if global_step % log_every == 0:
                    for t, dev_loss in pending_loss.items():
                        task2loss[t](float(dev_loss))
                    pending_loss.clear()
                    elapsed = time.time() - start
                    LOGGER.info("========= Step %d =========", global_step)
                    for t, meter in task2loss.items():
                        LOGGER.info("%s: %d ex at %d ex/s, %s: %.4f", t,
                                    n_examples[t],
                                    int(n_examples[t] / elapsed),
                                    meter.name, meter.val)
                    TB_LOGGER.set_step(global_step)
                    TB_LOGGER.log_metric("lr", lr_fn(global_step))
                    for t, meter in task2loss.items():
                        TB_LOGGER.log_metric(meter.name, meter.val)
                # preemption before the periodic validation: a signal on a
                # valid_steps boundary must not spend the grace window on
                # a validation sweep
                if guard.check(global_step):
                    LOGGER.warning("preempted at step %d: saving and "
                                   "exiting", global_step)
                    saver.save(model, global_step, optimizer=optimizer)
                    last_validated = global_step
                    preempted = True
                    break
                if global_step % args.valid_steps == 0:
                    results = validate(val_loaders, validate_fn,
                                       global_step)
                    last_validated = global_step
                    saver.save(model, global_step, optimizer=optimizer)
            if global_step >= args.num_train_steps:
                break
    finally:
        recycler.flush()
    return results, global_step, last_validated, preempted
