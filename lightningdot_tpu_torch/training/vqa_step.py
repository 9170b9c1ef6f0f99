"""The VQA fine-tuning step and evaluation (counterpart of
lightningdot_tpu/training/vqa_step.py).

Parity: uniter_model/train_vqa.py:175-311 adapted to the bi-encoder VQA
head (dvl/models/bi_encoder.py:683-734):
  * instance-level BCE: the elementwise BCE-with-logits summed over the
    answers, averaged over the batch's real rows (``loss.mean() *
    targets.size(1)``, train_vqa.py:188; fixed-batch pad rows count
    nothing);
  * the VQA score: the soft target at the argmax answer
    (compute_score_with_logits, train_vqa.py:305-311).
The step is one forward, a backward and :class:`~lightningdot_tpu_torch.
training.optim.FusedAdamW`'s update (every ``accum_steps`` micro-batches:
the mean of their gradients, as ``optax.MultiSteps``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from lightningdot_tpu_torch.data.loader import DevicePrefetcher, PinnedStager
from lightningdot_tpu_torch.data.padding import Recycler
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.models.vqa import BiEncoderForVQA, bce_with_logits
from lightningdot_tpu_torch.ops.matmul import require_full_f32
from lightningdot_tpu_torch.parallel.mesh import (all_reduce_grads_,
                                                  global_count, global_sums)
from lightningdot_tpu_torch.training.itm_step import (GradAccumulator,
                                                      batch_to_device,
                                                      pass_generators)
from lightningdot_tpu_torch.training.optim import FusedAdamW


def vqa_batch_to_device(batch: Dict[str, Any], device: torch.device
                        ) -> Dict[str, Any]:
    """The model inputs of a ``vqa_collate`` batch (``txts``, ``imgs``,
    ``targets``, ``valid_mask``) as tensors on ``device``."""
    return batch_to_device(batch, device,
                           keys=("txts", "imgs", "targets", "valid_mask"))


def vqa_score(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The soft target at each row's argmax answer (``vqa_score``,
    vqa_step.py:50-54); ties take the lower index, as ``jnp.argmax``."""
    pred = scores.argmax(dim=-1)
    return targets.float().gather(1, pred[:, None])[:, 0]


def vqa_loss_fn(model: BiEncoderForVQA, batch: Dict[str, Any],
                generators=None) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """Masked instance-level BCE (``vqa_loss_fn``, vqa_step.py:26-47) on a
    batch of device tensors -> (loss, metrics{loss, score}).

    In a process group the mean is over the GLOBAL valid count
    (``global_count``): the ranks' losses sum to one process's loss of the
    global batch and their gradients (summed, ``all_reduce_grads_``) to its
    gradient. The metrics are the global values (``global_sums``), the
    same bits on every rank."""
    scores = model.apply(batch, generators)
    t = batch["targets"].float()
    elem = bce_with_logits(scores, t)
    valid = batch.get("valid_mask")
    valid = (torch.ones(elem.shape[0], device=elem.device) if valid is None
             else valid.to(device=elem.device, dtype=torch.float32))
    per_row = elem.sum(dim=1)
    n_valid = torch.clamp(global_count(valid.sum()), min=1.0)
    loss = (per_row * valid).sum() / n_valid
    score = (vqa_score(scores.detach(), t) * valid).sum() / n_valid
    return loss, global_sums({"loss": loss, "score": score})


def make_vqa_train_step(model: BiEncoderForVQA, optimizer: FusedAdamW, *,
                        accum_steps: int = 1,
                        device: Optional[torch.device] = None) -> Callable:
    """Build ``step(batch, generator=None) -> metrics``
    (``make_vqa_train_step``, vqa_step.py:57-89).

    The model moves to ``device`` (``None``: the card, raising where there
    is none; ``"cpu"`` runs the plain PyTorch path) and runs in whatever
    mode it is in (``train()`` turns dropout on, seeded from ``generator``,
    a CPU ``torch.Generator``, as JAX splits one key). The metrics (loss,
    score, the pre-clip ``grad_norm`` of the last update) stay on the
    device.

    In a process group every rank calls the step with its own batch: the
    loss is its share of the global batch's (:func:`vqa_loss_fn`), and the
    gradients are summed over the ranks once per update, after the
    accumulation and before the clip, so that every rank takes the same
    update (the head's learning-rate factor included)."""
    device = resolve_device(device)
    model.to(device)
    accumulator = GradAccumulator(optimizer.params, accum_steps)
    last_norm = [torch.zeros((), device=device)]

    def step(batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        require_full_f32(device, model.compute_dtype)
        optimizer.zero_grad()
        loss, metrics = vqa_loss_fn(model, vqa_batch_to_device(batch, device),
                                    pass_generators(generator, device))
        loss.backward()
        if accumulator.add():
            all_reduce_grads_(optimizer.params)
            last_norm[0] = optimizer.step()
        metrics["grad_norm"] = last_norm[0]
        return metrics

    return step


@torch.no_grad()
def evaluate_vqa(model: BiEncoderForVQA, dataloader,
                 device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The validation sweep (``evaluate_vqa``, vqa_step.py:120-140;
    train_vqa.py:268-302): in eval mode without a gradient, the
    sum-reduced BCE per example, the VQA score and the qid -> argmax answer
    dict, over each batch's ``n_valid`` real rows. Batches are staged one
    ahead (``PinnedStager``). The model goes back to training mode
    afterwards: the drivers train after each evaluation."""
    device = resolve_device(device)
    model.eval()
    recycler = Recycler(enabled=device.type == "cuda")
    tot_loss = tot_score = n_ex = 0.0
    results: Dict[str, int] = {}
    try:
        for batch in DevicePrefetcher(dataloader, put=PinnedStager(device)):
            host = batch.host
            scores = model.apply(batch).cpu().numpy()
            recycler.push(host, ready=batch.event)
            n_valid = int(host["n_valid"])
            scores = scores[:n_valid]
            targets = np.asarray(host["targets"][:n_valid], np.float32)
            # sum-reduction BCE (train_vqa.py:280-282)
            tot_loss += float(np.sum(np.maximum(scores, 0) - scores * targets
                                     + np.log1p(np.exp(-np.abs(scores)))))
            pred = scores.argmax(axis=-1)
            tot_score += float(targets[np.arange(n_valid), pred].sum())
            for qid, a in zip(host["qids"], pred.tolist()):
                results[qid] = int(a)
            n_ex += n_valid
    finally:
        recycler.flush()
        model.train()
    n_ex = max(n_ex, 1.0)
    return {"loss": tot_loss / n_ex, "acc": tot_score / n_ex,
            "n_ex": int(n_ex), "results": results}
