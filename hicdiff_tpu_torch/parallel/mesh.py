"""Data parallelism across processes (port of hicdiff_tpu/parallel/mesh.py).

The JAX package shards a batch over a 1-D `data` mesh of devices and lets
XLA insert the gradient psum. The port follows PyTorch's idiom: one process
per rank over `torch.distributed`, each rank with its device, the batch
split by rows, the parameters and Adam state broadcast from rank 0, and the
collectives written out (`all_reduce_`, `all_gather_rows`). NCCL is the
default when each rank has a GPU of its own, gloo on the CPU or when the
caller names it (two ranks on one card: NCCL refuses a GPU shared by two
ranks, and the mesh raises rather than switch backend). A world of 1 makes
no collective call at all.

The names a reader of the JAX package looks for are kept: `make_mesh`,
`pad_batch` (the same numpy, the same weight mask), `process_slice` (a
rank's [lo, hi) of a padded global batch, with the same assertion),
`shard_batch_local` (the rank's rows on its device) and `replicate`.
`shard_rows` gives a rank its rows of a global batch with rows = (lo, n),
the argument by which the engine and the distiller draw what the whole
batch draws and keep the rank's rows (the engine's `draw_rows`);
`reduce_step` sums a step's gradients and loss over the ranks;
`run_sharded` runs a sampler on the rank's rows and gathers the output;
`broadcast_header` and `broadcast_array` carry rank 0's work to the other
ranks (the sharded daemon's chunks, `serve.py`).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "Mesh",
    "make_mesh",
    "pad_batch",
    "process_slice",
    "shard_batch_local",
    "replicate",
    "all_reduce_",
    "all_gather_rows",
    "rank_device",
    "run_sharded",
    "barrier",
    "mesh_from_launcher",
    "sharded",
    "is_main",
    "shard_rows",
    "reduce_step",
    "broadcast_header",
    "broadcast_array",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel world: its rank, the world
    size, its device and the process group (the default group)."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Optional[dist.ProcessGroup] = None

    def close(self) -> None:
        """Tear the process group down."""
        if dist.is_initialized():
            dist.destroy_process_group()


def sharded(mesh: Optional[Mesh]) -> bool:
    """Whether a batch is split over more than one rank."""
    return mesh is not None and mesh.world_size > 1


def is_main(mesh: Optional[Mesh]) -> bool:
    """The rank that writes checkpoints and logs (the only one without a mesh)."""
    return mesh is None or mesh.rank == 0


def rank_device(device: str | torch.device, local_rank: int) -> torch.device:
    """The device of a rank: `cuda` without an index names the rank's own
    GPU, cuda:LOCAL_RANK, which must exist; anything else is taken as given
    (`cuda:0` for ranks sharing one card, `cpu`)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(f"local rank {local_rank} has no GPU of its own ({count} visible); "
                           "pass an indexed device (cuda:0) and backend='gloo' to share one")
    return torch.device("cuda", local_rank)


def _check_nccl(device: torch.device, local_world_size: int) -> None:
    """NCCL needs a GPU per rank: it refuses two ranks on one device."""
    if device.type != "cuda":
        raise ValueError(f"the nccl backend runs on CUDA devices, got {device}")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_world_size > count:
        raise ValueError(f"nccl: {local_world_size} ranks on this host but {count} GPUs; NCCL "
                         "refuses a GPU shared by two ranks: use backend='gloo' to share a card")


def make_mesh(device: str | torch.device = "cuda", *, backend: Optional[str] = None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None) -> Mesh:
    """Join (or start) the process group and return this rank's Mesh.

    rank and world_size default to the RANK and WORLD_SIZE that torchrun
    sets, init_method to env:// (torchrun's MASTER_ADDR and MASTER_PORT);
    a launcher of its own passes tcp://localhost:<port>. The backend is
    nccl for a CUDA device, gloo for the CPU, or the one named."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
    world_size = int(os.environ.get("WORLD_SIZE", 1)) if world_size is None else int(world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = rank_device(device, local_rank)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        _check_nccl(device, int(os.environ.get("LOCAL_WORLD_SIZE", world_size)))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        kw = dict(device_id=device) if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size, **kw)
    if dist.get_world_size() != world_size or dist.get_rank() != rank:
        raise RuntimeError(f"the process group is rank {dist.get_rank()} of "
                           f"{dist.get_world_size()}, not {rank} of {world_size}")
    return Mesh(rank, world_size, device, backend, dist.group.WORLD)


def mesh_from_launcher(device: str | torch.device = "cuda",
                       backend: Optional[str] = None) -> Optional[Mesh]:
    """The mesh of a process that torchrun started (it sets WORLD_SIZE),
    else None: a CLI launched plainly runs on one device without a mesh."""
    if "WORLD_SIZE" not in os.environ:
        return None
    return make_mesh(device, backend=backend)


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank; nothing happens in a world of 1."""
    if mesh is not None and mesh.world_size > 1:
        dist.barrier(group=mesh.group)


def pad_batch(arrays: Tuple[np.ndarray, ...], multiple: int
              ) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
    """Zero-pad each array's batch dim to a multiple of `multiple`; returns the
    padded arrays plus a (padded_b,) weight mask (1 real / 0 padding)."""
    b = arrays[0].shape[0]
    target = -(-b // multiple) * multiple
    pad = target - b
    if pad == 0:
        return arrays, np.ones(b, np.float32)
    out = []
    for a in arrays:
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, widths))
    weights = np.concatenate([np.ones(b, np.float32), np.zeros(pad, np.float32)])
    return tuple(out), weights


def process_slice(n_global: int, mesh: Optional[Mesh] = None) -> Tuple[int, int]:
    """[lo, hi) of the global batch this rank owns: the whole batch without
    a mesh. n_global must divide evenly by the world size (callers pad to a
    multiple of it first)."""
    rank, nproc = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    assert n_global % nproc == 0, (n_global, nproc)
    per = n_global // nproc
    lo = rank * per
    return lo, lo + per


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def shard_rows(mesh: Mesh, *arrays) -> tuple:
    """This rank's part of a global batch (numpy arrays or tensors): each
    array padded to a multiple of the world size, the rank's rows of it and
    of the weight mask on its device. Returns (rows, *tensors, weights) with
    rows = (the first row, the batch's real rows): what `rows=` of the
    engine's draws reads."""
    n = arrays[0].shape[0]
    padded, weights = pad_batch(tuple(_host(a) for a in arrays), mesh.world_size)
    lo, hi = process_slice(weights.shape[0], mesh)
    return ((lo, n), *shard_batch_local(mesh, *(a[lo:hi] for a in padded), weights[lo:hi]))


def reduce_step(mesh: Mesh, params, loss: torch.Tensor) -> torch.Tensor:
    """After a rank's backward of its part of the loss: the gradients of
    `params` and the loss summed over the ranks, in one collective. Returns
    the whole batch's loss."""
    loss = loss.detach().reshape(1).clone()
    all_reduce_(mesh, [p.grad for p in params if p.grad is not None] + [loss])
    return loss[0]


def shard_batch_local(mesh: Mesh, *local_arrays) -> tuple:
    """The rank's rows (its `process_slice` of each padded global array,
    numpy or tensor) as tensors on its device."""
    out = []
    for a in local_arrays:
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
        out.append(t.to(mesh.device))
    return tuple(out)


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> None:
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


def all_reduce_(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, in one collective over a
    flat float32 buffer. Nothing happens in a world of 1."""
    if mesh is None or mesh.world_size == 1 or not tensors:
        return
    flat = _flat([t.float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
    _unflat_(flat, tensors)


def all_gather_rows(mesh: Optional[Mesh], x: torch.Tensor, n_global: int) -> torch.Tensor:
    """The whole batch from each rank's equal block of rows, cut to its
    n_global real rows; every rank receives it. A world of 1 returns x[:n_global]."""
    if mesh is None or mesh.world_size == 1:
        return x[:n_global]
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.world_size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)[:n_global]


def replicate(mesh: Optional[Mesh], module: torch.nn.Module,
              optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Make every rank hold rank 0's parameters, buffers and Adam state
    (its step count and moments), by broadcast. Nothing happens in a world
    of 1."""
    if mesh is None or mesh.world_size == 1:
        return
    tensors = [t.data for t in module.parameters()] + list(module.buffers())
    if optimizer is not None:
        params = [p for group in optimizer.param_groups for p in group["params"]]
        step = torch.tensor([float(optimizer.state[params[0]]["step"])
                             if optimizer.state.get(params[0]) else 0.0], device=mesh.device)
        dist.broadcast(step, src=0, group=mesh.group)
        if step.item() > 0:
            for p in params:
                state = optimizer.state[p]
                if not state:
                    state.update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                                 exp_avg_sq=torch.zeros_like(p))
                state["step"].fill_(step.item())
                tensors += [state["exp_avg"], state["exp_avg_sq"]]
        else:
            optimizer.state.clear()
    for t in tensors:
        dist.broadcast(t, src=0, group=mesh.group)


def run_sharded(mesh: Mesh, fn, x) -> torch.Tensor:
    """fn(x_rows, rows) over this rank's rows of the batch x (numpy or a CPU
    tensor, padded to a multiple of the world size), gathered: the whole
    batch's output, on every rank. rows = (first row, rows of x) tells fn's
    draws which rows of the whole batch's draws to keep. In a world of 1 it
    is fn(x on the rank's device, None)."""
    if mesh.world_size == 1:
        return fn(torch.from_numpy(np.ascontiguousarray(_host(x))).to(mesh.device), None)
    rows, local, _ = shard_rows(mesh, x)
    return all_gather_rows(mesh, fn(local, rows), rows[1])


def _wire(mesh: Mesh) -> torch.device:
    """Where a broadcast's tensor lives: NCCL moves device tensors, gloo
    host tensors."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


HEADER_LEN = 8


def broadcast_header(mesh: Mesh, values: Optional[Sequence[int]] = None) -> List[int]:
    """Rank 0's HEADER_LEN int64 values (values zero-padded), on every rank;
    the other ranks pass None."""
    head = torch.zeros(HEADER_LEN, dtype=torch.int64)
    if mesh.rank == 0:
        if len(values) > HEADER_LEN:
            raise ValueError(f"a header holds at most {HEADER_LEN} values, got {len(values)}")
        head[:len(values)] = torch.tensor([int(v) for v in values], dtype=torch.int64)
    head = head.to(_wire(mesh))
    dist.broadcast(head, src=0, group=mesh.group)
    return head.cpu().tolist()


def broadcast_array(mesh: Mesh, a: Optional[np.ndarray], shape: Sequence[int],
                    dtype) -> np.ndarray:
    """Rank 0's array `a` (of `shape` and `dtype`, which every rank knows,
    e.g. from a header), on every rank; the other ranks pass None."""
    if mesh.rank == 0:
        t = torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"broadcast of a {tuple(t.shape)} array announced as {tuple(shape)}")
    else:
        t = torch.empty(tuple(shape), dtype=torch.from_numpy(np.empty(0, dtype)).dtype)
    t = t.to(_wire(mesh))
    dist.broadcast(t, src=0, group=mesh.group)
    return t.cpu().numpy()
