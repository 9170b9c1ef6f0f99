"""AdamW with global-norm clipping, and the linear schedule (counterpart of
lightningdot_tpu/training/optim.py).

The update is the reference's AdamW (transformers-2.x, vendored at
uniter_model/optim/adamw.py:75-103): eps is added to the uncorrected
sqrt(v), the bias correction goes into the step size, and decoupled decay
multiplies the post-step parameter by the plain schedule lr.
``torch.optim.AdamW`` computes another function (eps on the corrected
sqrt(v), decay of the pre-step parameter), so it is not used.

:class:`FusedAdamW` is ``FusedAdamW``/``make_fused_adamw`` (:186-303): the
pre-clip global norm, the clip scale and every parameter's update in one
pass (the ``adamw`` kernel on the card), ``state_dtype`` float32 or a
bfloat16 first moment, and ``first_lr_step``. :func:`make_optimizer`
(:147-176) returns the same object with float32 state: its math is the
same (tests/test_loss.py::test_fused_adamw_matches_optax).

``lr_mul`` gives the parameters under a name prefix a learning-rate
factor, in the step size and in the decay: the port's form of the VQA
driver's ``optax.multi_transform`` over {body, head} under one clip
(cli/train_vqa.py:131-149), still one AdamW launch a step.

Schedules (``schedule_linear``, and ``get_lr_sched`` over ``warmup_linear``,
``noam_schedule`` and ``vqa_schedule``, optim.py:322-370) are evaluated on
the host in float32 at the 0-based update index (torch LambdaLR
convention); ``first_lr_step=1`` shifts them for the UNITER post-increment
convention. :meth:`FusedAdamW.state_dict` gives the update count and both
moments for a checkpoint.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from lightningdot_tpu_torch.models.encoder import LayerNorm
from lightningdot_tpu_torch.ops.adamw import adamw_

LearningRate = Union[float, Callable[[int], float]]


def schedule_linear(learning_rate: float, warmup_steps: int,
                    training_steps: int) -> Callable[[int], float]:
    """Linear warmup, then linear decay to 0 (``schedule_linear``,
    optim.py:308-319; reference get_schedule_linear, bi_encoder.py:668-680),
    in float32 as the JAX function computes it."""
    f32 = np.float32

    def lr(step: int) -> float:
        step = f32(step)
        if step < warmup_steps:
            frac = step / f32(max(1, warmup_steps))
        else:
            frac = max(f32(0.0), (f32(training_steps) - step)
                       / f32(max(1, training_steps - warmup_steps)))
        return float(f32(learning_rate) * f32(frac))

    return lr


def noam_schedule(step: int, warmup_step: int = 4000) -> float:
    """sched.py:7-10 (``noam_schedule``, optim.py:322), float32."""
    f32 = np.float32
    step = f32(step)
    if step <= warmup_step:
        return float(step / f32(warmup_step))
    return float(f32(warmup_step ** 0.5) * max(step, f32(1.0)) ** f32(-0.5))


def warmup_linear(step: int, warmup_step: int, tot_step: int) -> float:
    """sched.py:13-16 (``warmup_linear``, optim.py:329), float32."""
    f32 = np.float32
    step = f32(step)
    if step < warmup_step:
        return float(step / f32(max(1, warmup_step)))
    return float(max(f32(0.0), (f32(tot_step) - step)
                     / f32(max(1, tot_step - warmup_step))))


def vqa_schedule(step: int, warmup_interval: int, decay_interval: int,
                 decay_start: int, decay_rate: float) -> float:
    """sched.py:19-31 (``vqa_schedule``, optim.py:337-347), float32: a
    stepped warm-up (0.25, 0.5, 0.75 over three intervals), then 1, then
    ``decay_rate`` to the number of decay intervals begun since
    ``decay_start``."""
    f32 = np.float32
    step = f32(step)
    if step < warmup_interval:
        return 0.25
    if step < 2 * warmup_interval:
        return 0.5
    if step < 3 * warmup_interval:
        return 0.75
    if step >= decay_start:
        num_decay = np.ceil((step - f32(decay_start)) / f32(decay_interval))
        return float(f32(decay_rate) ** f32(num_decay))
    return 1.0


def get_lr_sched(decay: str, learning_rate: float, warmup_steps: int,
                 num_train_steps: int, **vqa_kwargs) -> Callable[[int],
                                                                 float]:
    """sched.py:35-52 (``get_lr_sched``, optim.py:350-370) with the <= 0
    -> 1e-8 guard: ``linear``, ``invsqrt``, ``constant`` or ``vqa`` (with
    ``warm_int``, ``decay_int``, ``decay_st`` and ``decay_rate``)."""
    f32 = np.float32
    if decay not in ("linear", "invsqrt", "constant", "vqa"):
        raise ValueError(f"unknown decay {decay}")

    def lr(step: int) -> float:
        if decay == "linear":
            v = f32(learning_rate) * f32(warmup_linear(step, warmup_steps,
                                                       num_train_steps))
        elif decay == "invsqrt":
            v = f32(learning_rate) * f32(noam_schedule(step, warmup_steps))
        elif decay == "vqa":
            v = f32(learning_rate) * f32(vqa_schedule(
                step, vqa_kwargs["warm_int"], vqa_kwargs["decay_int"],
                vqa_kwargs["decay_st"], vqa_kwargs["decay_rate"]))
        else:
            v = f32(learning_rate)
        return float(max(v, f32(1e-8)))

    return lr


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """{parameter name: True where weight decay applies}: every bias and
    every LayerNorm parameter is exempt, leaf for leaf as JAX's
    ``_is_no_decay`` (optim.py:32-49) over the mapped tree. That exempts
    ``img_layer_norm`` and ``pos_layer_norm`` too, which the reference's
    substring rule ``['bias', 'LayerNorm.weight']`` decays (ROADMAP C)."""
    exempt = {f"{mod_name}.{p_name}" if mod_name else p_name
              for mod_name, mod in model.named_modules()
              if isinstance(mod, LayerNorm)
              for p_name, _ in mod.named_parameters(recurse=False)}
    return {name: not (name in exempt or name.rsplit(".", 1)[-1] == "bias")
            for name, _ in model.named_parameters()}


class FusedAdamW:
    """Single-pass clip + AdamW over a model's parameters.

    ``step()`` reads each parameter's ``.grad`` (None counts as zeros, as
    JAX differentiates every leaf), measures the pre-clip global norm,
    scales by ``min(1, max_grad_norm / max(norm, max_grad_norm))`` and
    updates every parameter, first and second moment in place, all without
    a host synchronization; it returns the pre-clip norm as a device
    tensor. The moments are made at the first step, on the parameters'
    device. Afterwards every parameter's version counter is moved, so that
    cached casts (``Dense.kernel``) see the new weights: the kernel writes
    through raw pointers, which the counter does not see. ``lr_mul``
    ({name prefix: factor}) multiplies the learning rate of the parameters
    under a prefix, in their step size and in their decay.
    """

    def __init__(self, model: nn.Module, learning_rate: LearningRate, *,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 0.0,
                 state_dtype: torch.dtype = torch.float32,
                 first_lr_step: int = 0,
                 lr_mul: Optional[Dict[str, float]] = None):
        if state_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"state_dtype {state_dtype}: float32 or "
                             f"bfloat16 (the first moment only; the second "
                             f"stays float32, a bfloat16 v would freeze)")
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        mask = decay_mask(model) if weight_decay else {}
        self.wds = [float(weight_decay) if mask.get(n) else 0.0
                    for n in self.names]
        self.lr_muls = [next((float(f) for prefix, f in (lr_mul or {}).items()
                              if n.startswith(prefix)), 1.0)
                        for n in self.names]
        self.learning_rate = learning_rate
        self.b1, self.b2 = betas
        self.eps = eps
        self.max_grad_norm = max_grad_norm
        self.state_dtype = state_dtype
        self.first_lr_step = first_lr_step
        self.count = 0
        self.m: Optional[List[torch.Tensor]] = None
        self.v: Optional[List[torch.Tensor]] = None

    def lr(self, count: int) -> float:
        """The schedule at update ``count`` (1-based), as float32."""
        if callable(self.learning_rate):
            return float(np.float32(self.learning_rate(
                count - 1 + self.first_lr_step)))
        return float(np.float32(self.learning_rate))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _clip_scale(self, grads: Iterable[torch.Tensor],
                    device: torch.device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        grads = [g for g in grads if g is not None]
        if grads:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
        else:
            norm = torch.zeros((), device=device)
        if self.max_grad_norm and self.max_grad_norm > 0:
            scale = torch.clamp(
                self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm),
                max=1.0)
        else:
            scale = torch.ones((), device=device)
        return norm, scale

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        params = self.params
        if self.m is None:
            self.m = [torch.zeros_like(p, dtype=self.state_dtype)
                      for p in params]
            self.v = [torch.zeros_like(p) for p in params]
        grads = [p.grad for p in params]
        for g in grads:
            if g is not None and g.dtype != torch.float32:
                raise TypeError(f"gradients must be float32 (the masters' "
                                f"dtype), got {g.dtype}")
        norm, scale = self._clip_scale(grads, params[0].device)
        self.count += 1
        f32 = np.float32
        lr = f32(self.lr(self.count))
        t = f32(self.count)
        c1 = f32(1.0) - f32(self.b1) ** t
        c2 = f32(1.0) - f32(self.b2) ** t
        step_size = float(lr * np.sqrt(c2) / c1)
        adamw_(params, grads, self.m, self.v, self.wds, scale,
               step_size=step_size, lr=float(lr), b1=self.b1, b2=self.b2,
               eps=self.eps, lr_muls=self.lr_muls)
        torch.autograd.graph.increment_version(params)
        return norm

    def state_dict(self) -> Dict[str, object]:
        """{"count", "m", "v"}: the update count and the moments by
        parameter name (None before the first update), on their device."""
        def named(ts):
            return None if ts is None else dict(zip(self.names, ts))

        return {"count": self.count, "m": named(self.m), "v": named(self.v)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Restore :meth:`state_dict`'s output, strictly: every moment by
        name and shape, the first in ``state_dtype``."""
        self.count = int(state["count"])
        if state["m"] is None:
            self.m = self.v = None
            return
        for key in ("m", "v"):
            got = state[key]
            if set(got) != set(self.names):
                raise KeyError(f"optimizer state {key!r} names other "
                               f"parameters than the model's")
        dev = self.params[0].device
        self.m = [state["m"][n].to(dev, self.state_dtype).clone()
                  for n in self.names]
        self.v = [state["v"][n].to(dev, torch.float32).clone()
                  for n in self.names]
        for n, p, m in zip(self.names, self.params, self.m):
            if m.shape != p.shape:
                raise ValueError(f"optimizer state of {n} has shape "
                                 f"{tuple(m.shape)}, the parameter "
                                 f"{tuple(p.shape)}")


def make_fused_adamw(model: nn.Module, learning_rate: LearningRate, *,
                     adam_eps: float = 1e-8, weight_decay: float = 0.0,
                     betas: Tuple[float, float] = (0.9, 0.999),
                     max_grad_norm: float = 0.0,
                     state_dtype: torch.dtype = torch.float32,
                     first_lr_step: int = 0,
                     lr_mul: Optional[Dict[str, float]] = None
                     ) -> FusedAdamW:
    """``make_fused_adamw`` (optim.py:284-303): ``first_lr_step`` 0 is the
    DPR/LambdaLR convention, 1 the UNITER post-increment one."""
    return FusedAdamW(model, learning_rate, betas=betas, eps=adam_eps,
                      weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                      state_dtype=state_dtype, first_lr_step=first_lr_step,
                      lr_mul=lr_mul)


def make_optimizer(model: nn.Module, learning_rate: LearningRate, *,
                   adam_eps: float = 1e-8, weight_decay: float = 0.0,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   max_grad_norm: float = 0.0,
                   first_lr_step: int = 0,
                   lr_mul: Optional[Dict[str, float]] = None) -> FusedAdamW:
    """``make_optimizer`` (optim.py:147-176): clip + the reference AdamW
    with float32 state, the same math as :func:`make_fused_adamw`."""
    return make_fused_adamw(model, learning_rate, adam_eps=adam_eps,
                            weight_decay=weight_decay, betas=betas,
                            max_grad_norm=max_grad_norm,
                            first_lr_step=first_lr_step, lr_mul=lr_mul)
