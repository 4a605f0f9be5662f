"""Process group, mesh and the port's collectives — counterpart of
``cmrtpu/parallel/mesh.py``.

cmrtpu runs one program over a ``jax.sharding.Mesh`` and XLA places the
collectives; here each process drives one device and the collectives are
explicit ``torch.distributed`` calls, all of them in this module:

    all_agree         AND of a flag over the ranks (the packing decisions)
    all_reduce_sum    differentiable sum (BatchNorm's global statistics)
    gather_batch      differentiable all-gather along the batch axis
    grad_mean_        the step's one gradient reduction, in a given dtype
    mean_over_ranks   a plain mean (BN running averages, logs)
    broadcast_        rank 0's tensors to every rank
    all_to_all_rows   rows to their new ranks (the cache reshuffle)

Each call appends its name to the list ``record_collectives`` yields, so a
test can list what one step communicates.

The backward of ``all_reduce_sum`` and ``gather_batch`` sums the
gradient over the ranks: every rank computes the same global loss, so the
sum over ranks of its gradients is W times the gradient of that loss, and
``grad_mean_`` divides by W.

``initialize_distributed`` takes cmrtpu's coordinator variables
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID) or torchrun's
(MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK): nccl on a CUDA
device, gloo on the CPU. A mesh is distributed whenever a process group
exists, at world size 1 too (the collectives then run over one rank);
without one every function here is the identity and no collective runs.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# seconds a rendezvous or a collective may wait before it fails
DEFAULT_TIMEOUT_S = 1800.0

_RECORD: Optional[List[str]] = None


@contextlib.contextmanager
def record_collectives():
    """Yield a list that receives the name of every collective this module
    runs inside the block, in order."""
    global _RECORD
    outer, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = outer


def _note(name: str, tensor: Optional[torch.Tensor] = None) -> None:
    if _RECORD is not None:
        _RECORD.append(name if tensor is None
                       else f"{name}:{str(tensor.dtype).split('.')[-1]}")


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        value = os.environ.get(name)
        if value not in (None, ""):
            return int(value)
    return None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           device="cuda",
                           timeout_s: Optional[float] = None) -> bool:
    """Join the process group once, before the mesh is made. Without a
    coordinator (argument, JAX_COORDINATOR_ADDRESS, or MASTER_ADDR and
    MASTER_PORT) this is a no-op that returns False, so every entry point
    can call it. ``coordinator_address`` is ``host:port`` or an init URL
    (``tcp://...``, ``file://...``). A CUDA ``device`` takes nccl and
    the rank's card (LOCAL_RANK, else the rank modulo the cards); the CPU
    takes gloo. ``timeout_s`` (CMRTPU_DIST_TIMEOUT_S, default 1800) bounds
    the rendezvous and every collective, so a hang fails the run."""
    if dist.is_initialized():
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if not coordinator_address and os.environ.get("MASTER_ADDR") \
            and os.environ.get("MASTER_PORT"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE") or 1
    if process_id is None:  # explicit 0 must not fall through to the env
        process_id = _env_int("JAX_PROCESS_ID", "RANK") or 0
    if timeout_s is None:
        timeout_s = float(os.environ.get("CMRTPU_DIST_TIMEOUT_S",
                                         DEFAULT_TIMEOUT_S))
    dev = torch.device(device)
    kwargs = {}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "initialize_distributed: a CUDA device was asked for but "
                "torch.cuda.is_available() is False; pass device='cpu' for "
                "gloo on the CPU")
        local = _env_int("LOCAL_RANK")
        if local is None:
            local = int(process_id) % torch.cuda.device_count()
        torch.cuda.set_device(local)
        backend = "nccl"
        kwargs["device_id"] = torch.device("cuda", local)
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"initialize_distributed: no backend for {dev}")
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id),
                            timeout=datetime.timedelta(seconds=timeout_s),
                            **kwargs)
    logging.info("initialize_distributed: rank %d of %d over %s (%s)",
                 dist.get_rank(), dist.get_world_size(), backend, url)
    return True


def shutdown_distributed() -> None:
    """Leave the process group (no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def data_axis_size(batch: int, n_devices: int) -> int:
    """cmrtpu's data axis without MESH_SHAPE: the largest count <= the
    devices that divides BATCHSIZE (all devices when BATCHSIZE is 0)."""
    n = int(n_devices)
    if batch:
        while n > 1 and batch % n:
            n -= 1
    return n


def mesh_shape(config: Optional[Dict], n_devices: int):
    """(data, model) of cmrtpu's ``create_mesh`` over ``n_devices``:
    MESH_SHAPE when set (its product must equal the devices: cmrtpu's
    message), else (``data_axis_size``, 1)."""
    shape = (config or {}).get("MESH_SHAPE") or None
    if shape:
        shape = tuple(int(s) for s in shape)
        if int(np.prod(shape)) != n_devices:
            raise ValueError(f"MESH_SHAPE {shape} != #devices {n_devices}")
        return (shape + (1,))[:2]
    batch = int((config or {}).get("BATCHSIZE") or 0)
    return data_axis_size(batch, n_devices), 1


@dataclass
class Mesh:
    """A (data, model) mesh seen from one rank: rank r sits at (r // model,
    r % model), so model-axis replicas get the same data block. ``group``
    is the data axis's process group (None: the whole world);
    ``distributed`` is True when a process group exists."""
    data: int = 1
    model: int = 1
    rank: int = 0
    block: int = 0
    group: Any = None
    distributed: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.data, MODEL_AXIS: self.model}

    @property
    def world(self) -> int:
        return self.data * self.model


def create_mesh(config: Optional[Dict] = None,
                world_size: Optional[int] = None,
                rank: Optional[int] = None) -> Mesh:
    """The mesh over the process group's ranks (one device each), or over
    ``world_size`` ranks seen from ``rank`` (a pure layout, no group).
    cmrtpu shrinks the data axis to the largest divisor of BATCHSIZE and
    leaves devices idle; a rank cannot idle, so here a BATCHSIZE that does
    not divide the ranks raises."""
    distributed = world_size is None and dist.is_initialized()
    if world_size is None:
        world_size = dist.get_world_size() if distributed else 1
        rank = dist.get_rank() if distributed else 0
    rank = int(rank or 0)
    data, model = mesh_shape(config, int(world_size))
    if data * model != world_size:
        batch = int((config or {}).get("BATCHSIZE") or 0)
        raise ValueError(
            f"create_mesh: BATCHSIZE {batch} does not divide the "
            f"{world_size} ranks (cmrtpu would train on {data} device(s) and "
            f"leave {world_size - data} idle); pick a BATCHSIZE divisible by "
            "the rank count")
    group = None
    if distributed and model > 1:
        # every rank makes every group, in the same order
        for j in range(model):
            g = dist.new_group([b * model + j for b in range(data)])
            if rank % model == j:
                group = g
    return Mesh(data=data, model=model, rank=rank, block=rank // model,
                group=group, distributed=distributed)


def local_batch_size(global_batch: int, mesh: Mesh) -> int:
    n = mesh.data
    if global_batch % n:
        raise ValueError(
            f"BATCHSIZE {global_batch} must divide the data-mesh size {n}")
    return global_batch // n


def local_rows(n_rows: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of ``n_rows``: the contiguous
    data block ``mesh.block`` (cmrtpu's sharding of the leading axis)."""
    local = local_batch_size(n_rows, mesh)
    return slice(mesh.block * local, (mesh.block + 1) * local)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global host batch (arrays, tensors, or a
    tuple / list / dict of them), split along the leading axis."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if mesh.data == 1 or batch is None:
        return batch
    return batch[local_rows(batch.shape[0], mesh)]


# -- collectives ---------------------------------------------------------

def _comm_device(mesh: Mesh) -> torch.device:
    if dist.get_backend(mesh.group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_agree(flag: bool, mesh: Optional[Mesh] = None) -> bool:
    """AND of a per-rank flag over every rank (the flag itself without a
    process group, or on a mesh that is not distributed): decisions that
    must be one for every shard."""
    if not dist.is_initialized() or (mesh is not None
                                     and not mesh.distributed):
        return bool(flag)
    _note("all_agree")
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=_comm_device(mesh or Mesh()))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def any_rank(flag: bool) -> bool:
    """OR of a per-rank flag over every rank."""
    return not all_agree(not flag)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        _note("all_reduce_sum", out)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        _note("all_reduce_sum.backward", out)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of ``x`` over the data axis, differentiable (the backward sums
    the gradient over the ranks)."""
    if not mesh.distributed:
        return x
    return _AllReduceSum.apply(x, mesh.group)


# torch renamed all_gather_into_tensor; take whichever this build has
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


class _GatherBatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = x.shape[0]
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                          + tuple(x.shape[1:]))
        _note("all_gather", x)
        _all_gather_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        _note("all_gather.backward", grad)
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank * ctx.n:(ctx.rank + 1) * ctx.n], None


def gather_batch(x, mesh: Mesh):
    """The global batch from every rank's rows (a tensor or a dict of
    them), in rank order, differentiable: the backward gives each rank the
    sum over ranks of its rows' gradients."""
    if isinstance(x, dict):
        return {k: gather_batch(v, mesh) for k, v in x.items()}
    if not mesh.distributed:
        return x
    return _GatherBatch.apply(x, mesh.group)


def _flat(tensors: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    """One buffer of every tensor's elements in ``dtype`` (one cat, one
    cast: few launches on the step's host-bound path)."""
    return torch.cat([t.reshape(-1) for t in tensors]).to(dtype)


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    """Views of ``flat`` shaped as ``like``."""
    return [v.view(t.shape) for v, t in
            zip(flat.split([t.numel() for t in like]), like)]


@torch.no_grad()
def grad_mean_(model: torch.nn.Module, mesh: Mesh,
               dtype: torch.dtype = torch.float32) -> None:
    """Every parameter's gradient, in place: cast to ``dtype``, one
    all-reduce (sum) of all of them over the data axis, divided by the
    data size in ``dtype``, back to the gradient's dtype (cmrtpu's
    ``pmean(g.astype(dtype))``). Without a process group only the cast
    remains."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    if not mesh.distributed:
        if dtype != torch.float32:
            for g in grads:
                g.copy_(g.to(dtype))
        return
    flat = _flat(grads, dtype)
    _note("grad_mean", flat)
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.data)
    torch._foreach_copy_(grads, _split(flat.to(grads[0].dtype), grads))


@torch.no_grad()
def mean_over_ranks(tensors: Sequence[torch.Tensor], mesh: Mesh,
                    name: str = "mean_over_ranks",
                    dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """The mean over the data axis of each tensor, through one all-reduce
    in ``dtype``; new tensors in each input's dtype (the inputs without a
    process group)."""
    tensors = list(tensors)
    if not mesh.distributed or not tensors:
        return tensors
    flat = _flat(tensors, dtype)
    _note(name, flat)
    dist.all_reduce(flat, group=mesh.group)
    flat.div_(mesh.data)
    return [v.to(t.dtype) for v, t in zip(_split(flat, tensors), tensors)]


@torch.no_grad()
def broadcast_(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Rank 0's values of ``tensors`` on every rank, in place."""
    if not mesh.distributed:
        return
    for t in tensors:
        _note("broadcast", t)
        dist.broadcast(t, src=0)


def broadcast_object(obj, mesh: Mesh):
    """Rank 0's picklable ``obj`` on every rank."""
    if not mesh.distributed:
        return obj
    _note("broadcast_object")
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh: Mesh) -> None:
    if mesh.distributed:
        _note("barrier")
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


@torch.no_grad()
def all_to_all_rows(x: torch.Tensor, send_counts: Sequence[int],
                    recv_counts: Sequence[int], mesh: Mesh) -> torch.Tensor:
    """Rows of ``x`` (already ordered by destination rank, ``send_counts``
    rows to each) to their ranks; returns the received rows ordered by
    source rank (``recv_counts`` from each). The rows travel as bytes, so
    any dtype goes."""
    rows = x.reshape(x.shape[0], -1).contiguous().view(torch.uint8)
    width = rows.shape[1]
    out = rows.new_empty((int(sum(recv_counts)), width))
    _note("all_to_all", x)
    dist.all_to_all_single(out, rows, [int(c) for c in recv_counts],
                           [int(c) for c in send_counts], group=mesh.group)
    return out.view(x.dtype).reshape((out.shape[0],) + tuple(x.shape[1:]))


_BN_MESH: Optional[Mesh] = None


@contextlib.contextmanager
def global_batch_stats(mesh: Optional[Mesh]):
    """Inside the block, BatchNorm in train mode takes its statistics over
    the global batch of ``mesh``'s data axis (a no-op without a process
    group)."""
    global _BN_MESH
    outer = _BN_MESH
    _BN_MESH = mesh if mesh is not None and mesh.distributed else None
    try:
        yield
    finally:
        _BN_MESH = outer


def batch_stats_mesh() -> Optional[Mesh]:
    """The mesh BatchNorm reduces its statistics over, or None (local)."""
    return _BN_MESH


def multi_process() -> bool:
    """True over a process group of more than one rank."""
    return dist.is_initialized() and dist.get_world_size() > 1


def is_main_process() -> bool:
    """True on rank 0 (and without a process group): the rank that writes
    the run's files."""
    return not dist.is_initialized() or dist.get_rank() == 0
