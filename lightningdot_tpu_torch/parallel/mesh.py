"""Data parallelism over ``torch.distributed``, and device meshes for the
sharded corpus (counterpart of lightningdot_tpu/parallel/mesh.py).

The JAX package spans hosts with one mesh: ``jax.distributed`` joins the
processes, the jitted step sees the global batch, and XLA inserts the
row gathers of the in-batch score matrix and the gradient psum. The port
keeps both of its forms, each in PyTorch's idiom:

* **one process per card** for training. :func:`initialize_distributed`
  joins the default process group: NCCL where each rank owns a card, gloo
  on the CPU and for ranks that share one card. The steps call what XLA
  gave JAX for free: :func:`gather_rows` (an ``all_gather`` in rank order
  whose backward sums the cotangent over the ranks and keeps this rank's
  rows) for the global in-batch negatives, :func:`all_reduce_grads_` (one
  flat buffer per dtype, summed) once per update before the clip, and
  :func:`global_sums` for metrics that every rank reports alike.
* **one process over a list of devices** for the corpus: a
  :class:`DeviceMesh`, on which ``DenseShardedIndex`` and
  ``Retriever(mesh=)`` place one shard per entry. A device may repeat, so
  one card can hold several shards.

Collectives are issued on the caller's current CUDA stream: NCCL's and
gloo's own streams wait on it, and ``wait()`` (implicit in the synchronous
calls here) makes it wait on them in turn. The training loop's stream
already waits on the ``DevicePrefetcher``'s copy event before the step
reads a batch, so a collective never reads a batch still in flight.

No form falls back: a launcher's process (``WORLD_SIZE`` set) without a
group raises, and a collective that fails raises.
"""
from __future__ import annotations

import contextlib
import datetime
import hashlib
import os
import pickle
import threading
from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from lightningdot_tpu_torch.device import resolve_device

BACKENDS = ("nccl", "gloo")
_LOCAL = threading.local()


@contextlib.contextmanager
def local_scope():
    """Inside, this process computes alone: no collective, rank 0 of 1
    (pre-training's validation, which every rank runs on the whole
    validation set, as the JAX driver's replicated sweep)."""
    depth = getattr(_LOCAL, "depth", 0)
    _LOCAL.depth = depth + 1
    try:
        yield
    finally:
        _LOCAL.depth = depth


def in_group() -> bool:
    """Whether a process group is up (and not set aside by
    :func:`local_scope`); raises where a launcher started this process as
    one of several and no group was joined (no rank may run alone by
    accident)."""
    if getattr(_LOCAL, "depth", 0):
        return False
    if dist.is_available() and dist.is_initialized():
        return True
    launched = int(os.environ.get("WORLD_SIZE", "1"))
    if launched > 1:
        raise RuntimeError(
            f"this process is one of {launched} (WORLD_SIZE) but joined no "
            f"process group: call initialize_distributed first")
    return False


def initialize_distributed(backend: str, *, init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           timeout_s: float = 1800.0) -> bool:
    """Join the default process group (replaces ``jax.distributed.
    initialize``; reference ``hvd.init()``, pretrain.py:247). ``backend``
    is ``"nccl"`` or ``"gloo"``, named by the caller. The ranks come from
    the arguments, else from ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``). Returns False, and
    joins nothing, where neither names a world size (one process); a
    group already joined is kept."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"a {dist.get_backend()} group is already "
                               f"up; {backend} was asked for")
        return True
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def local_rank() -> int:
    """This process's index on its host (``LOCAL_RANK``; 0 alone)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def setup_process(device: Optional[str], backend: Optional[str] = None,
                  dp_size: int = 0) -> torch.device:
    """The drivers' start: this process's device, after joining the
    launcher's group where ``torchrun`` started several processes. The
    device is ``device`` where given, else the card of ``LOCAL_RANK`` (one
    process: the card, as ``resolve_device``); the backend ``backend``
    where given (``--dist_backend``; gloo lets two ranks share one card),
    else NCCL on a card and gloo on the CPU. ``dp_size`` > 0 must equal
    the number of processes (``--dp_size``; 0 takes the launcher's)."""
    launched = "WORLD_SIZE" in os.environ or dist.is_initialized()
    if not launched:
        if dp_size > 1:
            raise ValueError(f"dp_size {dp_size}: start one process per "
                             f"rank (torchrun --nproc_per_node {dp_size})")
        return resolve_device(device)
    dev = resolve_device(device if device is not None
                         else f"cuda:{local_rank()}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local_rank())
        torch.cuda.set_device(dev)
    initialize_distributed(backend or ("nccl" if dev.type == "cuda"
                                       else "gloo"))
    if dp_size and dp_size != process_count():
        raise ValueError(f"dp_size {dp_size} != {process_count()} processes")
    return dev


def process_count() -> int:
    return dist.get_world_size() if in_group() else 1


def process_index() -> int:
    """Rank of this process (replaces ``hvd.rank()``)."""
    return dist.get_rank() if in_group() else 0


def is_main_process() -> bool:
    """dvl/utils.py:187-188."""
    return process_index() == 0


def _collective_device() -> torch.device:
    """Where small control tensors live: this rank's card under NCCL, the
    host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier() -> None:
    """Every process reaches this point before any leaves it (one small
    all-reduce, read back on the host)."""
    if process_count() > 1:
        t = torch.zeros(1, device=_collective_device())
        dist.all_reduce(t)
        t.item()


def broadcast_one_to_all(value: Any) -> Any:
    """Rank 0's ``value`` on every process (any picklable object)."""
    if process_count() == 1:
        return value
    box = [value]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def assert_same_across_hosts(value: Any, what: str = "value") -> None:
    """Raise, on every process, unless all hold the same ``value`` (any
    picklable object): the processes exchange a 32-bit digest of its
    pickle (mesh.py:118-143; the reference's same-task assertion,
    pretrain.py:392)."""
    if process_count() == 1:
        return
    digest = int.from_bytes(
        hashlib.sha256(pickle.dumps(value)).digest()[:4], "big")
    mine = torch.tensor([digest], dtype=torch.int64,
                        device=_collective_device())
    parts = [torch.empty_like(mine) for _ in range(process_count())]
    dist.all_gather(parts, mine)
    got = [int(p.item()) for p in parts]
    if any(d != digest for d in got):
        raise RuntimeError(
            f"processes out of sync on {what} (digests {got}): every rank "
            f"must enter the collectives together (check seeds and data "
            f"sharding)")


class _GatherRows(torch.autograd.Function):
    """all_gather in rank order; the backward all-reduces the whole
    cotangent and keeps this rank's rows (every backend takes both, where
    a reduce-scatter is not on gloo's CUDA path)."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        ctx.rank = dist.get_rank()
        return all_gather_rows(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows]


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` [n, ...] stacked in rank order along the rows
    (one all-gather), without a gradient; without a group, ``x``. Every
    rank passes the same shape."""
    if not in_group():
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def global_max(values: Sequence[int]) -> List[int]:
    """Each of the host integers ``values``, its largest over the processes
    (one all-reduce): the common padding of tensors whose shapes differ
    from rank to rank."""
    if not in_group():
        return list(values)
    t = torch.tensor(list(values), dtype=torch.int64,
                     device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [int(v) for v in t.tolist()]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` [n, ...] stacked in rank order along the rows
    -> [world * n, ...], differentiable: the gradient that reaches ``x`` is
    the sum over the ranks of their gradients of its rows (XLA's
    all-gather and its transpose under the JAX mesh). Every rank passes
    the same shape."""
    return _GatherRows.apply(x) if in_group() else x


@torch.no_grad()
def all_reduce_grads_(params: Sequence[torch.Tensor]) -> None:
    """Sum the parameters' ``.grad`` over the processes in place: one flat
    buffer per dtype, one all-reduce each (the reference's flat-buffer
    allreduce, pretrain.py:449-451). Parameters without a gradient are
    skipped; every rank runs the same model, so the same ones are."""
    if not in_group():
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch._utils._flatten_dense_tensors(grads)
        dist.all_reduce(flat)
        for g, r in zip(grads,
                        torch._utils._unflatten_dense_tensors(flat, grads)):
            g.copy_(r)


def global_sums(values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each scalar of ``values`` summed over the processes in rank order:
    one all-gather, and the same bits on every rank."""
    if not in_group() or not values:
        return {k: v.detach() for k, v in values.items()}
    keys = list(values)
    vec = torch.stack([values[k].detach().float().reshape(()) for k in keys])
    parts = [torch.empty_like(vec) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, vec)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return dict(zip(keys, total.unbind()))


def global_count(x: torch.Tensor) -> torch.Tensor:
    """A count (a sum of weights) over every process: the denominator of a
    mean over the global batch. Carries no gradient."""
    if not in_group():
        return x
    x = x.detach().clone()
    dist.all_reduce(x)
    return x


class DeviceMesh:
    """The devices a corpus is sharded over, in shard order (the port's
    ``Mesh(('dp',))`` for one process). A device may repeat: one card can
    hold several shards."""

    def __init__(self, devices: Sequence[Union[str, torch.device]]):
        if not devices:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(torch.device(d) for d in devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __iter__(self) -> Iterator[torch.device]:
        return iter(self.devices)


def data_parallel_mesh(dp_size: int = 0) -> DeviceMesh:
    """A mesh over the first ``dp_size`` cards (0: all of them)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: build a DeviceMesh of the "
                           "devices to use (DeviceMesh(['cpu'] * 8) on the "
                           "CPU)")
    if dp_size > n:
        raise ValueError(f"dp_size {dp_size} > {n} cards")
    return DeviceMesh([f"cuda:{i}" for i in range(dp_size or n)])


def gather_batch_rows(tensors: Sequence[Optional[torch.Tensor]],
                      n_pos: int) -> List[Optional[torch.Tensor]]:
    """The global batch's rows of each of ``tensors`` (each [rows, D_i],
    one dtype; None stays None), laid out as one process's collate lays
    out the whole batch: the ``n_pos`` positives of every rank in rank
    order, then every rank's negatives in rank order (``itm_fast_collate``
    is item-major, so the negatives stay item-major). One differentiable
    gather for all of them. Without a group the tensors come back as
    they are."""
    live = [t for t in tensors if t is not None]
    if not in_group() or not live:
        return list(tensors)
    rows = live[0].shape[0]
    world = dist.get_world_size()
    packed = torch.cat(live, dim=1) if len(live) > 1 else live[0]
    full = gather_rows(packed).reshape(world, rows, -1)
    glob = full[:, :n_pos].reshape(world * n_pos, -1)
    if rows > n_pos:
        glob = torch.cat([glob, full[:, n_pos:].reshape(
            world * (rows - n_pos), -1)])
    parts = iter(torch.split(glob, [t.shape[1] for t in live], dim=1))
    return [next(parts) if t is not None else None for t in tensors]
