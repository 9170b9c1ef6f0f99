"""The ITM fine-tuning step (counterpart of
lightningdot_tpu/training/itm_step.py).

Parity: the train_itm.py hot loop (train_itm.py:191-289): the
bidirectional in-batch NCE loss (txt->img and img->txt averaged,
train_itm.py:197-222) with the fixed-batch padding rules, the hard-negative
layout and optional caption-score blending; then global-norm clipping,
AdamW and the schedule (:class:`~lightningdot_tpu_torch.training.optim.
FusedAdamW`), and optionally knowledge distillation against a
cross-encoder teacher (``make_kd_fn``, train_itm.py:224-239).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from lightningdot_tpu_torch.data.loader import host_tensor
from lightningdot_tpu_torch.device import resolve_device
from lightningdot_tpu_torch.models.bi_encoder import BiEncoder
from lightningdot_tpu_torch.ops.matmul import mm_f32, require_full_f32
from lightningdot_tpu_torch.parallel.mesh import (all_gather_rows,
                                                  all_reduce_grads_,
                                                  gather_batch_rows,
                                                  gather_rows, global_max,
                                                  global_sums,
                                                  process_count,
                                                  process_index)
from lightningdot_tpu_torch.training.optim import FusedAdamW
from lightningdot_tpu_torch.utils import tracing

NEG_INF = -1e30


def _scores(q: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
    """q [n1, D] x ctx [n2, D] -> float32 [n1, n2], float32 accumulation
    (``jnp.dot(..., precision=HIGHEST)``)."""
    return mm_f32(q, ctx.t())


def itm_loss_fn(model: BiEncoder, batch: Dict[str, Any], generators=None, *,
                caption_score_weight: float = 0.0,
                num_hard_negatives: int = 0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Tuple]:
    """Bidirectional NCE (``itm_loss_fn``, itm_step.py:51-121) on a batch of
    device tensors -> (loss, metrics). With hard negatives, txts and imgs
    carry bs positives followed by bs * num_hard_negatives negatives, item
    by item (``itm_fast_collate``); queries are the positives, contexts are
    all rows. ``valid_mask`` [bs] marks real items: a padded row is no
    query, and a padded column (with its negatives) is no context except at
    its own diagonal. The third value is the (txt, img, cap) vectors, the
    KD term's input (JAX's aux).

    In a process group (``parallel.mesh``) the contexts are the GLOBAL
    batch, laid out as one process's collate would lay it out
    (:func:`~lightningdot_tpu_torch.parallel.mesh.gather_batch_rows`), and
    the positives are global row indices (rank x bs + arange): each rank
    scores its own queries against every rank's contexts over the global
    valid count, so the ranks' losses sum to the one-process loss of the
    global batch and their gradients (summed, ``all_reduce_grads_``) to
    its gradient. The metrics are the global values, the same bits on
    every rank."""
    txt, img, cap = model.apply(batch, generators)
    bs = txt.shape[0] // (1 + num_hard_negatives)
    dev = txt.device
    valid = batch.get("valid_mask")
    valid = (torch.ones(bs, device=dev) if valid is None
             else valid.to(device=dev, dtype=torch.float32))
    txt_all, img_all, cap_all = gather_batch_rows((txt, img, cap), bs)
    valid_all = gather_rows(valid)
    n_pos = valid_all.shape[0]
    pos_idx = process_index() * bs + torch.arange(bs, device=dev)
    n_valid = torch.clamp(valid_all.sum(), min=1.0)

    def masked_calc(q, ctx, cap_ctx):
        scores = _scores(q, ctx)
        if cap_ctx is not None and caption_score_weight != 0:
            scores = ((1 - caption_score_weight) * scores
                      + caption_score_weight * _scores(q, cap_ctx))
        n_ctx = ctx.shape[0]
        ctx_valid = torch.ones(n_ctx, device=dev)
        ctx_valid[:n_pos] = valid_all
        k = (n_ctx - n_pos) // n_pos
        if k > 0:
            neg_valid = valid_all.repeat_interleave(k)
            ctx_valid[n_pos:n_pos + neg_valid.shape[0]] = neg_valid
        col_mask = (1.0 - ctx_valid)[None, :] * NEG_INF
        diag = torch.nn.functional.one_hot(pos_idx, n_ctx).float()
        scores = scores + col_mask * (1.0 - diag)
        logp = torch.log_softmax(scores, dim=1)
        nll = -logp.gather(1, pos_idx[:, None])[:, 0]
        loss = (nll * valid).sum() / n_valid
        correct = ((logp.argmax(dim=1) == pos_idx).float() * valid).sum()
        return loss, correct

    loss1, correct1 = masked_calc(img[:bs], txt_all, cap_all)   # img -> txt
    loss2, correct2 = masked_calc(txt[:bs], img_all, cap_all)   # txt -> img
    loss = 0.5 * loss1 + 0.5 * loss2
    metrics = global_sums({"loss": loss, "loss_img2txt": loss1,
                           "loss_txt2img": loss2,
                           "acc": (correct1 + correct2) / (2.0 * n_valid)})
    return loss, metrics, (txt, img, cap)


def _pad_dim1(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` [B, m, ...] zero-padded along dim 1 to ``n`` (the collate's
    padding: id 0, mask 0, zero features)."""
    return torch.nn.functional.pad(
        x, (0, 0) * (x.dim() - 2) + (0, n - x.shape[1]))


def global_teacher_grid(batch: Dict[str, Any], n_teacher: int,
                        bs: int) -> Dict[str, Any]:
    """This rank's block of the global KD pair grid, on the device: its
    ``bs`` positive texts against the first ``n_teacher`` images of the
    GLOBAL batch (rank-major positives), text-major (text i x n_teacher +
    image j), as ``make_teacher_batch`` lays out one process's grid. The
    ranks' blocks, in rank order, are that grid's rows.

    Texts and regions are padded to their largest length over the ranks,
    which is the padding one process's collate gives the global batch; the
    image side's [CLS] mask column is dropped (``make_teacher_batch``).
    The first images may live on several ranks (``bs < n_teacher``): every
    rank sends its first ``min(bs, n_teacher)`` image rows, packed into one
    float32 gather. Collectives: one max and one all-gather, issued from
    the step's thread (a collective from the loader's prefetch thread
    could interleave with the step's in another order on another rank)."""
    txts, imgs = batch["txts"], batch["imgs"]
    ids = txts["input_ids"][:bs]
    txt_mask = txts["attention_mask"][:bs]
    feat, pos = imgs["img_feat"][:bs], imgs["img_pos_feat"][:bs]
    img_mask = imgs["attention_mask"][:bs, 1:]
    length, regions = global_max((ids.shape[1], feat.shape[1]))
    k = min(bs, n_teacher)
    d_feat, d_pos = feat.shape[2], pos.shape[2]
    packed = torch.cat([_pad_dim1(feat[:k].float(), regions),
                        _pad_dim1(pos[:k].float(), regions),
                        _pad_dim1(img_mask[:k], regions)[..., None].float()],
                       dim=2)
    first = all_gather_rows(packed)[:n_teacher]
    img_feat = first[..., :d_feat].to(feat.dtype)
    img_pos = first[..., d_feat:d_feat + d_pos].to(pos.dtype)
    img_mask = first[..., -1].to(img_mask.dtype)
    ids = _pad_dim1(ids, length).repeat_interleave(n_teacher, dim=0)
    txt_mask = _pad_dim1(txt_mask, length).repeat_interleave(n_teacher,
                                                             dim=0)
    return {
        "input_ids": ids,
        "position_ids": torch.arange(length, dtype=ids.dtype,
                                     device=ids.device).expand(
            ids.shape[0], length),
        "img_feat": img_feat.repeat(bs, 1, 1),
        "img_pos_feat": img_pos.repeat(bs, 1, 1),
        "attn_masks": torch.cat([txt_mask, img_mask.repeat(bs, 1)], dim=1),
        "gather_index": None,
    }


def make_kd_fn(teacher, *, T: float = 1.0, n_teacher: int = 10,
               caption_score_weight: float = 0.0,
               num_hard_negatives: int = 0) -> Callable:
    """The distillation term ``kd_fn(batch, (txt, img, cap)) -> loss``
    (``make_kd_fn``, itm_step.py:124-166; train_itm.py:224-239).

    Student: the symmetrized blend of the two directions' in-batch score
    matrices over the positives (each with the caption term where
    ``caption_score_weight`` > 0), its first ``n_teacher`` rows. Teacher:
    the cross-encoder's rank logits on the ``batch['teacher']`` pair grid
    (``make_teacher_batch``: text i x image j), run in eval mode without a
    gradient, as [n_teacher, bs]. Returns KL(softmax(teacher / T) ||
    log_softmax(student / T)) x T², the elementwise mean (``nn.KLDivLoss``);
    entries where the teacher's probability is 0 count as 0.

    Across W processes the term is one process's on the global batch of
    G = W x bs positives, the same value on every rank: the student's
    rows are scored against every rank's positives (``gather_batch_rows``,
    which puts them first also with ``num_hard_negatives``), [n_teacher,
    G], and the teacher scores each rank's texts against the first
    ``n_teacher`` global images (:func:`global_teacher_grid`, built here
    from the batch's device tensors; ``batch['teacher']`` is not read),
    whose blocks are gathered in rank order. The step adds 1/W of it on
    each rank (:func:`make_itm_train_step`)."""

    def teacher_scores(grid, bs):
        teacher.eval()      # the students' train() never reaches it
        with torch.no_grad():
            t = teacher.rank_scores(grid)
        return t.reshape(bs, n_teacher).t().float()

    def kd_fn(batch: Dict[str, Any], embs) -> torch.Tensor:
        txt, img, cap = embs
        if process_count() > 1:
            bs = txt.shape[0] // (1 + num_hard_negatives)
            with torch.no_grad():
                block = teacher_scores(
                    global_teacher_grid(batch, n_teacher, bs), bs)
                t_scores = all_gather_rows(block.t().contiguous()).t()
        else:
            bs = batch["teacher"]["input_ids"].shape[0] // n_teacher
            t_scores = teacher_scores(batch["teacher"], bs)
        txt, img, cap = gather_batch_rows(
            (txt[:bs], img[:bs], None if cap is None else cap[:bs]), bs)

        def blended(q, ctx):
            s = _scores(q, ctx)
            if cap is not None and caption_score_weight != 0:
                s = ((1 - caption_score_weight) * s
                     + caption_score_weight * _scores(q, cap))
            return s

        student = (0.5 * blended(img, txt)
                   + 0.5 * blended(txt, img))[:n_teacher]
        logp = torch.log_softmax(student / T, dim=1)
        q = torch.softmax(t_scores / T, dim=1)
        pos = q > 0
        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        safe_logq = torch.where(pos, torch.log(torch.clamp(q, min=1e-30)),
                                zero)
        kl = torch.where(pos, q * (safe_logq - logp), zero)
        return kl.mean() * T * T

    return kd_fn


MODEL_KEYS = ("txts", "imgs", "caps", "valid_mask", "teacher")


def batch_to_device(batch: Dict[str, Any], device: torch.device,
                    keys=MODEL_KEYS) -> Dict[str, Any]:
    """The model inputs of a collated batch (``keys``: by default ``txts``,
    ``imgs``, ``caps``, ``valid_mask`` and the KD ``teacher`` grid) as
    tensors on ``device``; host-only fields are dropped
    (``jit_train_step``'s ``model_batch``, itm_step.py:230-244)."""

    def put(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: put(v) for k, v in x.items() if v is not None}
        if isinstance(x, np.ndarray):
            # a pooled array goes through its page-locked tensor: a
            # copy from a bare view of it would be untracked, and the
            # block could be handed out again while the copy still reads
            x = host_tensor(x)
        return x.to(device, non_blocking=True)

    return {k: put(batch.get(k)) for k in keys}


def pass_generators(generator: Optional[torch.Generator],
                    device: torch.device
                    ) -> Optional[List[torch.Generator]]:
    """The (txt, img, cap) generators of one step on ``device``, seeded
    from a step's CPU ``generator`` (None: no dropout draws), as JAX splits
    one key three ways."""
    if generator is None:
        return None
    seeds = torch.randint(0, 2 ** 62, (3,), generator=generator)
    return [torch.Generator(device=device).manual_seed(int(s))
            for s in seeds]


class GradAccumulator:
    """``optax.MultiSteps`` (use_grad_mean) over a model's ``.grad``: each
    micro-batch's gradients go into a running mean, ``acc + (g - acc) /
    (n + 1)`` as optax computes it (None counts as zeros), and on the
    ``accum_steps``-th the mean is handed to the optimizer as the
    parameters' ``.grad`` and the mean starts again from zero. The schedule
    and the clip thus see the mean, and the optimizer's count advances once
    per update."""

    def __init__(self, params, accum_steps: int):
        if accum_steps < 1:
            raise ValueError(f"accum_steps {accum_steps} < 1")
        self.params = list(params)
        self.accum_steps = accum_steps
        self.mini_step = 0
        self.acc: Optional[list] = None

    def load_window(self, mini_step: int, acc: List[torch.Tensor]) -> None:
        """Resume a window: ``mini_step`` micro-batches folded into the
        running mean ``acc`` (one tensor per parameter, in order), as a JAX
        ``MultiSteps`` state holds them."""
        if not 0 <= mini_step < self.accum_steps:
            raise ValueError(f"mini_step {mini_step} outside a window of "
                             f"{self.accum_steps}")
        if len(acc) != len(self.params) or any(
                a.shape != p.shape for a, p in zip(acc, self.params)):
            raise ValueError("the running mean does not match the "
                             "parameters")
        self.mini_step = mini_step
        self.acc = [a.to(p.device, torch.float32).clone()
                    for a, p in zip(acc, self.params)] if mini_step else None

    @torch.no_grad()
    def add(self) -> bool:
        """Fold the current ``.grad`` in; True when the mean is ready in
        ``.grad`` for an update."""
        if self.accum_steps == 1:
            return True
        if self.acc is None:
            self.acc = [torch.zeros_like(p, dtype=torch.float32)
                        for p in self.params]
        n = self.mini_step
        grads = [torch.zeros_like(a) if p.grad is None else p.grad
                 for p, a in zip(self.params, self.acc)]
        # multi-tensor ops: a few launches for all parameters
        step = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(step, float(n + 1))
        torch._foreach_add_(self.acc, step)
        for p in self.params:
            p.grad = None
        self.mini_step = (n + 1) % self.accum_steps
        if self.mini_step:
            return False
        for p, a in zip(self.params, self.acc):
            p.grad = a
        self.acc = None
        return True


def make_itm_train_step(model: BiEncoder, optimizer: FusedAdamW, *,
                        caption_score_weight: float = 0.0,
                        num_hard_negatives: int = 0,
                        kd_fn: Optional[Callable] = None,
                        kd_loss_weight: float = 1.0,
                        accum_steps: int = 1,
                        device: Optional[torch.device] = None) -> Callable:
    """Build ``step(batch, generator=None) -> metrics``
    (``make_itm_train_step``, itm_step.py:172-216).

    The model moves to ``device`` (``None``: the card, raising where there is
    none; ``"cpu"`` runs the plain PyTorch path) and takes one optimizer step
    per call (per ``accum_steps`` calls: the mean of their gradients, as
    ``optax.MultiSteps`` wraps the JAX optimizer, cli/train_itm.py:178-183)
    in whatever mode it is in: ``model.train()`` turns dropout on, and
    ``generator`` (a CPU ``torch.Generator``) then seeds the three passes'
    generators, as JAX splits one key three ways. ``batch`` is a collated
    batch (numpy or tensors). ``kd_fn(batch, embeddings)`` (``make_kd_fn``)
    adds ``kd_loss_weight`` x its distillation term; the batch then
    carries ``teacher``. The metrics (loss, acc, grad_norm of the last
    update, both directions' losses, kd_loss) stay on the device.

    In a process group every rank calls the step with its own batch: the
    loss takes the global in-batch negatives (:func:`itm_loss_fn`), and the
    gradients are summed over the ranks once per update, after the
    accumulation and before the clip, so that the clip reads the global
    batch's norm and every rank takes the same update. The KD term there is
    the global batch's, the same on every rank (``make_kd_fn``); each rank
    adds 1/W of it to the loss it differentiates, since the gathers'
    backward sums the ranks' cotangents (a full term on every rank would
    give W times one process's gradient), and reports it whole.

    float32 compute on the card refuses TF32 products
    (``ops.matmul.require_full_f32``).

    Each call is a ``step`` span (``utils/tracing.py``) around its phases:
    ``step.to_device``, ``step.forward`` (the loss), ``step.kd``,
    ``step.backward`` and ``step.optimizer`` (accumulation, the all-reduce
    and the update).
    """
    device = resolve_device(device)
    model.to(device)
    accumulator = GradAccumulator(optimizer.params, accum_steps)
    last_norm = [torch.zeros((), device=device)]

    def step(batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        require_full_f32(device, model.compute_dtype)
        with tracing.span("step"):
            optimizer.zero_grad()
            with tracing.span("step.to_device"):
                dev_batch = batch_to_device(batch, device)
            with tracing.span("step.forward"):
                loss, metrics, embs = itm_loss_fn(
                    model, dev_batch, pass_generators(generator, device),
                    caption_score_weight=caption_score_weight,
                    num_hard_negatives=num_hard_negatives)
            if kd_fn is not None:
                with tracing.span("step.kd"):
                    kd = kd_fn(dev_batch, embs)
                world = process_count()
                loss = loss + kd_loss_weight * (kd / world if world > 1
                                                else kd)
                # the global values: the KD term is already the same on
                # every rank, so it does not go through global_sums
                metrics["kd_loss"] = kd.detach()
                metrics["loss"] = (metrics["loss"]
                                   + kd_loss_weight * kd.detach())
            with tracing.span("step.backward"):
                loss.backward()
            with tracing.span("step.optimizer"):
                if accumulator.add():
                    all_reduce_grads_(optimizer.params)
                    last_norm[0] = optimizer.step()
            metrics["grad_norm"] = last_norm[0]
        return metrics

    return step
