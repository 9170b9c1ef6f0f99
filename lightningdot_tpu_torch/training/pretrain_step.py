"""Multi-task pre-training steps (counterpart of
lightningdot_tpu/training/pretrain_step.py).

Parity: the pretrain.py hot loop (pretrain.py:388-536): per-task losses
reduced as the mean over loss units (pretrain.py:399-406), gradient
accumulation over a window of micro-batches of one task (the mean of their
gradients, ``optax.MultiSteps``), then clip + AdamW with the schedule read
once per update. The teacher's distillation (pretrain.py:409-428) comes
with the cross-encoder (ROADMAP A9).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.models.bi_encoder import BiEncoderForPretraining
from lightningdot_tpu_torch.training.itm_step import (GradAccumulator,
                                                      pass_generators)
from lightningdot_tpu_torch.training.optim import FusedAdamW

# host-only fields of a collated pre-training batch
_HOST_KEYS = ("n_valid", "sample_size", "teacher")


def weighted_mean(loss: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Mean over the valid loss units (``weighted_mean``,
    pretrain_step.py:24-30: ``loss.mean()`` on the reference's
    dynamic-shape tensors, pretrain.py:399-406)."""
    while weights.dim() < loss.dim():
        weights = weights[..., None]
    denom = torch.clamp(weights.sum() * (loss.numel() / weights.numel()),
                        min=1.0)
    return (loss * weights).sum() / denom


def task_loss(model: BiEncoderForPretraining, batch: Dict[str, Any],
              task: str, generators=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The weighted scalar loss of one task, and its metrics (``task_loss``,
    pretrain_step.py:33-66)."""
    if task == "mlm":
        nll, logits, w = model.forward_mlm(batch, generators)
        loss = weighted_mean(nll, w)
        labels = torch.as_tensor(batch["masked_labels"],
                                 device=logits.device).reshape(-1)
        correct = ((logits.argmax(-1).reshape(-1) == labels).float()
                   * w).sum()
        return loss, {"loss": loss,
                      "acc": correct / torch.clamp(w.sum(), min=1)}
    if task == "mrfr":
        mse, _, w = model.forward_mrfr(batch, generators)
        loss = weighted_mean(mse, w)
        return loss, {"loss": loss}
    if task.startswith("mrc"):
        kl, logits, w = model.forward_mrc(batch, task, generators)
        loss = weighted_mean(kl, w)
        pred = logits[:, :, 1:].argmax(-1) + 1
        tgt = torch.as_tensor(batch["label_targets"],
                              device=logits.device)[:, :, 1:].argmax(-1) + 1
        acc = ((pred == tgt).float() * w).sum() / torch.clamp(w.sum(), min=1)
        return loss, {"loss": loss, "acc": acc}
    if task == "itm":
        nll, _, correct = model.forward_itm(batch, generators,
                                            compute_loss=False)
        w = torch.as_tensor(batch["weights"], device=nll.device).float()
        loss = weighted_mean(nll, w)
        return loss, {"loss": loss,
                      "acc": correct / torch.clamp(w.sum(), min=1)}
    raise ValueError(f"invalid task {task}")


def pretrain_batch_to_device(batch: Dict[str, Any], device: torch.device
                             ) -> Dict[str, Any]:
    """A collated pre-training batch's arrays as tensors on ``device``
    (nested dicts included); host-only fields are dropped."""

    def put(x):
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items()}
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, torch.Tensor):
            return x.to(device, non_blocking=True)
        return x

    return {k: put(v) for k, v in batch.items() if k not in _HOST_KEYS}


def make_pretrain_step(model: BiEncoderForPretraining,
                       optimizer: FusedAdamW, accum_steps: int = 1, *,
                       teacher=None, device: Optional[torch.device] = None
                       ) -> Callable[[str], Callable]:
    """``step_for_task(task) -> step(batch, generator=None) -> metrics``
    (``make_pretrain_step``, pretrain_step.py:90-136).

    The model moves to ``device`` (``None``: the card, raising where there
    is none). A step is one micro-batch: its gradients join the running
    mean, and every ``accum_steps``-th step updates the weights. The model
    runs in whatever mode it is in (``train()`` for dropout, seeded from
    ``generator``, a CPU ``torch.Generator``). The metrics stay on the
    device."""
    if teacher is not None:
        raise NotImplementedError(
            "pre-training knowledge distillation needs the one-tower "
            "teacher (models/uniter_pretrain.py), which comes with the "
            "cross-encoder (ROADMAP A9)")
    device = resolve_device(device)
    model.to(device)
    accumulator = GradAccumulator(optimizer.params, accum_steps)

    def step_for_task(task: str) -> Callable:
        def step(batch: Dict[str, Any],
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
            if (device.type == "cuda"
                    and model.compute_dtype == torch.float32
                    and torch.backends.cuda.matmul.allow_tf32):
                raise RuntimeError("float32 training with TF32 products on: "
                                   "set torch.backends.cuda.matmul."
                                   "allow_tf32 = False")
            optimizer.zero_grad()
            loss, metrics = task_loss(
                model, pretrain_batch_to_device(batch, device), task,
                pass_generators(generator, device))
            loss.backward()
            if accumulator.add():
                optimizer.step()
            return {k: v.detach() for k, v in metrics.items()}

        return step

    return step_for_task


def make_validate_fn(model: BiEncoderForPretraining,
                     device: Optional[torch.device] = None) -> Callable:
    """``validate_batch(batch, task) -> metrics``: the per-task forward
    without dropout or gradient (``make_validate_fn``,
    pretrain_step.py:139-170). The model runs in eval mode and goes back to
    the mode it was in."""
    device = resolve_device(device)

    @torch.no_grad()
    def validate_batch(batch: Dict[str, Any], task: str):
        was_training = model.training
        model.eval()
        try:
            _, metrics = task_loss(
                model, pretrain_batch_to_device(batch, device), task)
        finally:
            model.train(was_training)
        return metrics

    return validate_batch
