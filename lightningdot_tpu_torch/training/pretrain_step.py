"""Multi-task pre-training steps (counterpart of
lightningdot_tpu/training/pretrain_step.py).

Parity: the pretrain.py hot loop (pretrain.py:388-536): per-task losses
reduced as the mean over loss units (pretrain.py:399-406), gradient
accumulation over a window of micro-batches of one task (the mean of their
gradients, ``optax.MultiSteps``), then clip + AdamW with the schedule read
once per update; optionally the one-tower teacher's distillation on the
non-itm tasks (``kd_loss``, pretrain.py:409-428).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from lightningdot_tpu_torch.data.loader import host_tensor
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.models.bi_encoder import BiEncoderForPretraining
from lightningdot_tpu_torch.ops.matmul import require_full_f32
from lightningdot_tpu_torch.parallel.mesh import (all_reduce_grads_,
                                                  global_count, global_sums,
                                                  local_scope)
from lightningdot_tpu_torch.training.itm_step import (GradAccumulator,
                                                      pass_generators)
from lightningdot_tpu_torch.training.optim import FusedAdamW

# host-only fields of a collated pre-training batch
_HOST_KEYS = ("n_valid", "sample_size")


def weighted_mean(loss: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mean over the valid loss units (``weighted_mean``,
    pretrain_step.py:24-30: ``loss.mean()`` on the reference's
    dynamic-shape tensors, pretrain.py:399-406). In a process group the
    count is the global batch's, so that the ranks' values sum to the mean
    over the global batch (the JAX step sees the global batch)."""
    while weights.dim() < loss.dim():
        weights = weights[..., None]
    denom = torch.clamp(global_count(
        weights.sum() * (loss.numel() / weights.numel())), min=1.0)
    return (loss * weights).sum() / denom


def _global_ratio(count: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``count`` over the weights' sum of the global batch."""
    return count / torch.clamp(global_count(weights.sum()), min=1)


def task_loss(model: BiEncoderForPretraining, batch: Dict[str, Any],
              task: str, generators=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """The weighted scalar loss of one task, its metrics (``task_loss``,
    pretrain_step.py:33-66), and the head's output with the loss weights
    (JAX's ``_logits`` / ``_weights``), the KD term's input; None for
    itm."""
    out = None
    if task == "mlm":
        nll, lg, w = model.forward_mlm(batch, generators)
        loss = weighted_mean(nll, w)
        labels = torch.as_tensor(batch["masked_labels"],
                                 device=lg.device).reshape(-1)
        correct = ((lg.argmax(-1).reshape(-1) == labels).float() * w).sum()
        metrics = {"loss": loss, "acc": _global_ratio(correct, w)}
        out = (lg, w)
    elif task == "mrfr":
        mse, pred, w = model.forward_mrfr(batch, generators)
        loss = weighted_mean(mse, w)
        metrics = {"loss": loss}
        out = (pred, w)
    elif task.startswith("mrc"):
        kl, lg, w = model.forward_mrc(batch, task, generators)
        loss = weighted_mean(kl, w)
        pred = lg[:, :, 1:].argmax(-1) + 1
        tgt = torch.as_tensor(batch["label_targets"],
                              device=lg.device)[:, :, 1:].argmax(-1) + 1
        acc = _global_ratio(((pred == tgt).float() * w).sum(), w)
        metrics = {"loss": loss, "acc": acc}
        out = (lg, w)
    elif task == "itm":
        nll, _, correct = model.forward_itm(batch, generators,
                                            compute_loss=False)
        w = torch.as_tensor(batch["weights"], device=nll.device).float()
        loss = weighted_mean(nll, w)
        metrics = {"loss": loss, "acc": _global_ratio(correct, w)}
    else:
        raise ValueError(f"invalid task {task}")
    return loss, metrics, out


def kd_loss(teacher, batch: Dict[str, Any], task: str,
            student_logits: torch.Tensor, weights: torch.Tensor, *,
            T: float, kd_loss_weight: float) -> torch.Tensor:
    """Pre-training distillation (``kd_loss``, pretrain_step.py:69-87;
    pretrain.py:409-428): the teacher (``UniterForPretraining``) runs on
    the joint sub-batch ``batch['teacher']`` in eval mode without a
    gradient; squared error for mrfr's feature regression, KL x T²
    otherwise, each as the weighted mean over the loss units."""
    teacher.eval()
    with torch.no_grad():
        t_logits = teacher.task_logits(batch["teacher"], task)
    if task == "mrfr":
        sq = torch.square(t_logits / T - student_logits / T)
        return kd_loss_weight * weighted_mean(sq, weights)
    logp = torch.log_softmax(student_logits / T, dim=-1)
    q = torch.softmax(t_logits.float() / T, dim=-1)
    pos = q > 0
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    safe_logq = torch.where(pos, torch.log(torch.clamp(q, min=1e-30)), zero)
    kl = torch.where(pos, q * (safe_logq - logp), zero)
    if task == "mlm":
        # [B, M, V] against the flat [B * M] weights
        kl = kl.reshape(weights.shape[0], -1)
    return kd_loss_weight * T * T * weighted_mean(kl, weights)


def pretrain_batch_to_device(batch: Dict[str, Any], device: torch.device
                             ) -> Dict[str, Any]:
    """A collated pre-training batch's arrays as tensors on ``device``
    (nested dicts included); host-only fields are dropped."""

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            # a pooled array goes through its page-locked tensor: a
            # copy from a bare view of it would be untracked, and the
            # block could be handed out again while the copy still reads
            x = host_tensor(x)
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        return x

    return {k: put(v) for k, v in batch.items() if k not in _HOST_KEYS}


def make_pretrain_step(model: BiEncoderForPretraining,
                       optimizer: FusedAdamW, accum_steps: int = 1, *,
                       teacher=None, kd_loss_weight: float = 1.0,
                       kd_T: float = 1.0,
                       device: Optional[torch.device] = None
                       ) -> Callable[[str], Callable]:
    """``step_for_task(task) -> step(batch, generator=None) -> metrics``
    (``make_pretrain_step``, pretrain_step.py:90-136).

    The model moves to ``device`` (``None``: the card, raising where there
    is none). A step is one micro-batch: its gradients join the running
    mean, and every ``accum_steps``-th step updates the weights. The model
    runs in whatever mode it is in (``train()`` for dropout, seeded from
    ``generator``, a CPU ``torch.Generator``). With a ``teacher``
    (``UniterForPretraining`` on ``device``), every non-itm task whose
    batch carries ``teacher`` adds :func:`kd_loss` (pretrain_step.py:
    109-121). The metrics stay on the device. ``step_for_task.accumulator``
    is the gradient accumulator that the steps share.

    In a process group every rank steps on its own batch of the same task
    and shape: each task's loss is divided by the global batch's count,
    the itm task scores against the global batch (``forward_itm``), the
    gradients are summed over the ranks once per update before the clip,
    and the metrics are the global values (pretrain_step.py:140-170 under
    the JAX mesh)."""
    device = resolve_device(device)
    model.to(device)
    accumulator = GradAccumulator(optimizer.params, accum_steps)

    def step_for_task(task: str) -> Callable:
        def step(batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
            require_full_f32(device, model.compute_dtype)
            optimizer.zero_grad()
            dev_batch = pretrain_batch_to_device(batch, device)
            loss, metrics, out = task_loss(
                model, dev_batch, task, pass_generators(generator, device))
            if teacher is not None and task != "itm" \
                    and "teacher" in dev_batch:
                kd = kd_loss(teacher, dev_batch, task, *out, T=kd_T,
                             kd_loss_weight=kd_loss_weight)
                loss = loss + kd
                metrics["kd_loss"] = kd
                metrics["loss"] = loss
            loss.backward()
            if accumulator.add():
                all_reduce_grads_(optimizer.params)
                optimizer.step()
            return global_sums(metrics)

        return step

    step_for_task.accumulator = accumulator   # a resumed window goes here
    return step_for_task


def make_validate_fn(model: BiEncoderForPretraining,
                     device: Optional[torch.device] = None) -> Callable:
    """``validate_batch(batch, task) -> metrics``: the per-task forward
    without dropout or gradient (``make_validate_fn``,
    pretrain_step.py:139-170). The model runs in eval mode and goes back to
    the mode it was in. In a process group every rank validates alone on
    the whole batch (JAX replicates it), so the metrics agree across
    ranks."""
    device = resolve_device(device)

    @torch.no_grad()
    def validate_batch(batch: Dict[str, Any], task: str):
        was_training = model.training
        model.eval()
        try:
            with local_scope():   # the whole validation set on every rank
                _, metrics, _ = task_loss(
                    model, pretrain_batch_to_device(batch, device), task)
        finally:
            model.train(was_training)
        return metrics

    return validate_batch
