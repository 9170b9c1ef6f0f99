"""Checkpoint save and load (counterpart of
lightningdot_tpu/training/checkpoints.py:83-234).

Two layouts, as the reference's (SURVEY.md §5):

  * the fine-tune ``CheckpointState`` (dvl/trainer.py:18-63):
    ``biencoder.{best,last,N,preempt}``;
  * the pre-training ``ModelSaver`` (uniter_model/utils/save.py:55-76):
    ``model_step_{N}``, with auto-resume from the newest step
    (pretrain.py:906-917).

A checkpoint ``<path>`` is two files. ``<path>.pt`` is a torch
``CheckpointState`` dict: the model's state dict under the reference's
names in ``model_dict`` (the layout of the JAX package's
``models/checkpoint_torch.py::save_biencoder_pt``, :440-447, so the JAX
package's ``load_biencoder_checkpoint`` and ``map_pretrain_model`` read it)
and the optimizer's update count and moments in ``optimizer_dict``.
``<path>.json`` is the manifest (step, offset, epoch, extra), written
last: the data file is renamed into place first, so a save that is cut
off never truncates a good checkpoint, and discovery keys off the
manifest. :func:`load_checkpoint` also reads the JAX package's checkpoints
(``<path>.npz`` of ``model/...`` flattened leaves beside the same
``.json``), their optax state (``opt/...``) included: the update count and
both moments of the chains the JAX drivers write (``make_optimizer``'s
clip + ``scale_by_ref_adamw``, under ``optax.MultiSteps`` or the VQA
driver's ``multi_transform``, and ``make_fused_adamw``'s state,
lightningdot_tpu/training/optim.py:147-303), each moment by the port's
parameter name through the map the weights take; a ``MultiSteps`` window
left mid-way carries into the step's ``GradAccumulator``. Every load is
strict: a missing or extra parameter, or another shape, raises (the JAX
package's ``unflatten_like``, :38-80).
"""
from __future__ import annotations

import glob
import json
import os
import re
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from lightningdot_tpu_torch.models.weights import (
    biencoder_state_dict_from_jax, cross_encoder_fast_state_dict_from_jax,
    cross_encoder_state_dict_from_jax, pretrain_state_dict_from_jax,
    uniter_pretrain_state_dict_from_jax, unflatten_jax,
    vqa_state_dict_from_jax)
from lightningdot_tpu_torch.parallel.mesh import is_main_process

SEP = "/"


def _cpu_state(model) -> Dict[str, torch.Tensor]:
    """A copy on the host of a module's state dict (or of a state dict)."""
    sd = model.state_dict() if isinstance(model, nn.Module) else model
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def _cpu_tree(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):
        return {k: _cpu_tree(v) for k, v in x.items()}
    return x


def save_checkpoint(path: str, *, model, optimizer=None, step: int = 0,
                    offset: int = 0, epoch: int = 0,
                    extra: Optional[dict] = None) -> str:
    """Write ``<path>.pt`` then ``<path>.json`` (``CheckpointState``),
    each to a temporary name renamed into place. ``model`` is a module or
    a state dict; ``optimizer`` a :class:`~lightningdot_tpu_torch.training.
    optim.FusedAdamW` or its ``state_dict()``."""
    if optimizer is not None and hasattr(optimizer, "state_dict"):
        optimizer = optimizer.state_dict()
    data = {"model_dict": _cpu_state(model),
            "optimizer_dict": _cpu_tree(optimizer),
            "scheduler_dict": None, "offset": offset, "epoch": epoch,
            "encoder_params": None}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".pt.tmp"
    torch.save(data, tmp)
    os.replace(tmp, path + ".pt")
    meta = {"step": step, "offset": offset, "epoch": epoch,
            "extra": extra or {}}
    tmp_json = path + ".json.tmp"
    with open(tmp_json, "w") as f:
        json.dump(meta, f)
    os.replace(tmp_json, path + ".json")
    return path


def _jax_state_dict(flat: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The model leaves of a JAX ``.npz`` as a state dict under the port's
    names: a bi-encoder ({txt_model, img_model}), the VQA model
    ({biencoder, vqa_output}), a pre-training model
    ({bert, heads}), a cross-encoder ({uniter, itm_output, rank_output}),
    the Fast cross-encoder ({bert, img_bert, ...}), the one-tower
    pre-training teacher ({uniter, heads}), or any other tree leaf by leaf
    ('/' -> '.')."""
    tree = unflatten_jax(flat)
    if set(tree) == {"txt_model", "img_model"}:
        return biencoder_state_dict_from_jax(tree)
    if set(tree) == {"biencoder", "vqa_output"}:
        return vqa_state_dict_from_jax(tree)
    if set(tree) == {"bert", "heads"}:
        return pretrain_state_dict_from_jax(tree)
    if set(tree) == {"uniter", "heads"}:
        return uniter_pretrain_state_dict_from_jax(tree)
    if "uniter" in tree:
        return cross_encoder_state_dict_from_jax(tree)
    if {"bert", "img_bert"} <= set(tree):
        return cross_encoder_fast_state_dict_from_jax(tree)
    return {k.replace(SEP, "."): np.asarray(v) for k, v in flat.items()}


def _as_float(a: np.ndarray) -> np.ndarray:
    """An ``.npz`` leaf as a numeric array: JAX's bfloat16 leaves come
    back as 2-byte void values, read here as bfloat16 widened to
    float32."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return (a.view(np.uint16).astype(np.uint32) << 16).view(np.float32)
    return a


_OPT_LEAF = re.compile(r"(?:^|/)\.(mu|nu|acc_grads)/(.+)$")


def _jax_optimizer_state(flat: Mapping[str, np.ndarray]) -> Optional[dict]:
    """The optax state of a JAX ``.npz`` (its ``opt/`` leaves, flattened by
    ``flatten_tree``) as :meth:`FusedAdamW.state_dict`'s {"count", "m",
    "v"} under the port's names, or None where it holds no moments. The
    moments sit under ``.mu/<param path>`` and ``.nu/<param path>`` at any
    depth of the chain (``0/.grad_norm`` then ``1/.count``, ``1/.mu/...``
    for the clip chain; ``.inner_opt_state/...`` under ``MultiSteps``;
    ``.inner_states/<group>/.inner_state/...`` under ``multi_transform``,
    each group holding its own parameters); every ``.count`` must agree.
    Under ``MultiSteps`` the state also gets "accum": {"mini_step", "acc"},
    the running mean of the window begun (``.mini_step``,
    ``.acc_grads/<param path>``)."""
    parts: Dict[str, Dict[str, np.ndarray]] = {"mu": {}, "nu": {},
                                               "acc_grads": {}}
    counts = set()
    mini_step = None
    for key, value in flat.items():
        m = _OPT_LEAF.search(key)
        if m:
            parts[m.group(1)][m.group(2)] = _as_float(value)
        elif key.rsplit("/", 1)[-1] == ".count":
            counts.add(int(np.asarray(value)))
        elif key == ".mini_step":
            mini_step = int(np.asarray(value))
    if not parts["mu"] or not parts["nu"]:
        return None
    if len(counts) != 1:
        raise ValueError(f"optax state with update counts {sorted(counts)}: "
                         f"one count expected")

    def named(leaves):
        return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32))
                for k, v in _jax_state_dict(leaves).items()}

    state: Dict[str, Any] = {"count": counts.pop(), "m": named(parts["mu"]),
                             "v": named(parts["nu"])}
    if mini_step is not None:
        state["accum"] = {"mini_step": mini_step,
                          "acc": named(parts["acc_grads"])}
    return state


def read_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[dict], dict]:
    """(model state dict, optimizer state or None, manifest) of the port's
    ``<path>.pt`` or, where there is none, the JAX package's
    ``<path>.npz`` (its optax state read by
    :func:`_jax_optimizer_state`)."""
    with open(path + ".json") as f:
        meta = json.load(f)
    if os.path.exists(path + ".pt"):
        data = torch.load(path + ".pt", map_location="cpu",
                          weights_only=True)
        return data["model_dict"], data.get("optimizer_dict"), meta
    if not os.path.exists(path + ".npz"):
        raise FileNotFoundError(f"{path}: neither {path}.pt nor {path}.npz")
    with np.load(path + ".npz") as data:
        mp, op = f"model{SEP}", f"opt{SEP}"
        flat = {k[len(mp):]: data[k] for k in data.files if k.startswith(mp)}
        opt = {k[len(op):]: data[k] for k in data.files if k.startswith(op)}
    return _jax_state_dict(flat), _jax_optimizer_state(opt), meta


def load_state_dict_strict(model: nn.Module, sd: Mapping[str, Any]) -> None:
    """Copy ``sd`` (tensors or arrays) into ``model``'s parameters and
    buffers: a parameter the checkpoint lacks, one the model lacks, or
    another shape raises, naming the key."""
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    if missing:
        more = f" (and {len(missing) - 1} more)" if len(missing) > 1 else ""
        raise KeyError(f"checkpoint missing parameter {missing[0]}{more}")
    extra = sorted(set(sd) - set(own))
    if extra:
        raise KeyError(
            f"checkpoint has {len(extra)} parameters the model does "
            f"not: {extra[:5]}{'...' if len(extra) > 5 else ''}")
    cast = {}
    for k, v in sd.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(v))
        if tuple(t.shape) != tuple(own[k].shape):
            raise ValueError(
                f"checkpoint leaf {k} has shape {tuple(t.shape)}, model "
                f"expects {tuple(own[k].shape)}")
        cast[k] = t.to(own[k].dtype)
    model.load_state_dict(cast)


def load_checkpoint(path: str, *, model: nn.Module, optimizer=None,
                    accumulator=None) -> dict:
    """Load ``<path>`` into ``model`` (strictly) and, where given, into
    ``optimizer``; returns the manifest. Resuming an optimizer from a
    checkpoint that holds no optimizer state (a save without one, or a JAX
    ``.npz`` without moments) raises: a fresh update count would restart
    the learning-rate schedule and the bias correction. A JAX
    ``optax.MultiSteps`` window left mid-way goes into ``accumulator`` (the
    step's :class:`~lightningdot_tpu_torch.training.itm_step.
    GradAccumulator`), and raises where none is given or it takes fewer
    micro-batches."""
    sd, opt, meta = read_checkpoint(path)
    if optimizer is not None and opt is None:
        raise ValueError(
            f"{path}: no optimizer state in the checkpoint (saved without "
            "one); cannot resume the optimizer from it")
    accum = (opt or {}).get("accum") if optimizer is not None else None
    if accum and accum["mini_step"]:
        k = accum["mini_step"]
        if accumulator is None or accumulator.accum_steps <= k:
            raise ValueError(
                f"{path}: the JAX optax.MultiSteps window stands at "
                f"micro-batch {k}; resuming it needs the step's gradient "
                f"accumulator with more than {k} micro-batches per update")
    load_state_dict_strict(model, sd)
    if optimizer is not None:
        optimizer.load_state_dict(opt)
        if accum and accum["mini_step"]:
            accumulator.load_window(
                accum["mini_step"], [accum["acc"][n].to(p.device)
                                     for n, p in zip(optimizer.names,
                                                     optimizer.params)])
    return meta


def save_training_meta(output_dir: str, args) -> None:
    """Dump hps.json + git info (uniter_model/utils/save.py:15-52)."""
    import subprocess

    os.makedirs(os.path.join(output_dir, "log"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "ckpt"), exist_ok=True)
    hps = {k: v for k, v in vars(args).items()
           if isinstance(v, (int, float, str, bool, list, dict, type(None)))}
    with open(os.path.join(output_dir, "log", "hps.json"), "w") as f:
        json.dump(hps, f, indent=4)
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True,
                             timeout=10).stdout.strip()
        status = subprocess.run(["git", "status", "--short"],
                                capture_output=True, text=True,
                                timeout=10).stdout
        with open(os.path.join(output_dir, "log", "git_info.json"),
                  "w") as f:
            json.dump({"git_sha": sha, "git_status": status}, f, indent=4)
    except Exception:
        pass


class ModelSaver:
    """Step-numbered saver (save.py:55-76).

    ``save`` copies the weights (and the optimizer's state) to the host
    before it returns, so a later step that updates them in place cannot
    reach the checkpoint. With ``async_save=True`` the file is written on
    a background thread, one save in flight at a time; ``wait()`` (also
    called by the next save) surfaces the writer's exception.
    """

    def __init__(self, output_dir: str, prefix: str = "model_step",
                 async_save: bool = False):
        self.output_dir = output_dir
        self.prefix = prefix
        os.makedirs(output_dir, exist_ok=True)
        self._executor = (ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-save")
            if async_save else None)
        self._pending = None

    def save(self, model, step: int, optimizer=None) -> str:
        path = os.path.join(self.output_dir, f"{self.prefix}_{step}")
        model = _cpu_state(model)
        if optimizer is not None:
            optimizer = _cpu_tree(optimizer.state_dict()
                                  if hasattr(optimizer, "state_dict")
                                  else optimizer)
        if self._executor is None:
            return save_checkpoint(path, model=model, optimizer=optimizer,
                                   step=step)
        self.wait()
        self._pending = self._executor.submit(
            save_checkpoint, path, model=model, optimizer=optimizer,
            step=step)
        return path

    def wait(self) -> None:
        """Block until the save in flight (if any) has finished."""
        if self._pending is not None:
            pending, self._pending = self._pending, None
            pending.result()


class NoOpSaver:
    """Non-zero-rank saver (reference ``NoOp``, uniter misc.py:14-19):
    rank 0 writes the checkpoints."""

    def save(self, model, step: int, optimizer=None) -> str:
        return ""

    def wait(self) -> None:
        pass


def rank_saver(output_dir: str, **kwargs):
    """A :class:`ModelSaver` on rank 0 and a :class:`NoOpSaver` on the
    other ranks (cli/pretrain.py:403-409): one writer per checkpoint. Call
    :func:`~lightningdot_tpu_torch.parallel.mesh.barrier` after its
    ``wait()`` before any rank reads what it wrote."""
    if is_main_process():
        return ModelSaver(output_dir, **kwargs)
    return NoOpSaver()


def latest_step_checkpoint(output_dir: str, prefix: str = "model_step"
                           ) -> Optional[Tuple[str, int]]:
    """Auto-resume discovery (pretrain.py:906-917): the newest
    ``<prefix>_<N>`` whose manifest and data file both exist. The
    manifest is renamed into place last, so a checkpoint cut off mid-write
    is never selected."""
    pat = re.compile(rf"{re.escape(prefix)}_(\d+)\.json$")
    best = None
    for f in glob.glob(os.path.join(output_dir, f"{prefix}_*.json")):
        m = pat.search(f)
        stem = f[:-len(".json")]
        if m and (os.path.exists(stem + ".pt")
                  or os.path.exists(stem + ".npz")):
            step = int(m.group(1))
            if best is None or step > best[1]:
                best = (stem, step)
    return best
