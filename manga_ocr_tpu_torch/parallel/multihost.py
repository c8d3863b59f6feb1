"""Multi-process meshes on ``torch.distributed`` (counterpart of
``manga_ocr_tpu/parallel/multihost.py``).

``parallel.mesh`` covers the devices of one process; this module adds the
layer above: N processes (one per host, or several sharing a host), each
with its own local devices, forming ONE global mesh.  The coordination
plane is ``torch.distributed`` (NCCL where each rank has a CUDA device of
its own, gloo otherwise: the CPU tests, and ranks that share one card,
which NCCL refuses).  Serving needs no collective but the readback.

Deployment shape (one process per rank):

    from manga_ocr_tpu_torch.parallel import multihost as mh
    mh.initialize()                          # MASTER_ADDR/PORT, WORLD_SIZE, RANK
    mesh = mh.make_global_mesh(n_model=1)    # every rank's devices, data-major
    batch, offset = mh.global_batch(local_crops, mesh)  # this rank's rows
    out = model(batch)                                  # on this rank's device
    tokens = mh.gather_to_hosts(out)                    # every rank's rows, in order

Training on a global mesh (``train.make_train_step(cfg, mesh)``) passes each
rank's rows of the global batch to its step; the loss mask's sum, the
gradients and the reported loss cross the ranks through ``all_reduce_sum``
(the model axis stays inside a rank: ``make_global_mesh`` refuses model
blocks that cross processes).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from manga_ocr_tpu_torch.parallel.mesh import Mesh, local_rows


class RankDevice(NamedTuple):
    """A device of the global mesh: the rank that owns it and its device
    there (``process_index`` as JAX's devices name it)."""

    process_index: int
    device: torch.device


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
) -> None:
    """Join the process group (idempotent).  Arguments not given come from
    torch's own environment variables: ``MASTER_ADDR``:``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``.  ``backend`` defaults to NCCL where every rank
    of this host (``LOCAL_WORLD_SIZE``, else all of them) has a CUDA device
    of its own, else gloo; under NCCL each rank makes its device current."""
    if dist.is_initialized():
        return
    if coordinator_address is None and not {"MASTER_ADDR", "MASTER_PORT"} <= set(os.environ):
        raise ValueError("initialize: pass coordinator_address or set MASTER_ADDR and MASTER_PORT")
    addr = coordinator_address or f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if not addr.startswith("tcp://"):
        addr = f"tcp://{addr}"
    world = num_processes if num_processes is not None else int(os.environ["WORLD_SIZE"])
    rank = process_id if process_id is not None else int(os.environ["RANK"])
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        own_cards = torch.cuda.is_available() and torch.cuda.device_count() >= local
        backend = "nccl" if own_cards else "gloo"
    dist.init_process_group(backend, init_method=addr, world_size=world, rank=rank)
    if backend == "nccl":
        torch.cuda.set_device(_local_device())


def _local_device() -> torch.device:
    """This rank's device: CUDA device ``LOCAL_RANK`` (else the rank) modulo
    the visible count, so ranks that share a card share it; the CPU where
    CUDA is unavailable."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local_rank = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def _model_rows(devices: list, n_model: int) -> list[list]:
    """The mesh's rows from per-process blocks, NOT a flat reshape of the
    device list: with e.g. 4 local devices and n_model=3 a flat reshape
    would straddle one model shard across two hosts.  Each process's block
    must itself divide into model groups."""
    if n_model < 1 or len(devices) % n_model:
        raise ValueError(
            f"{len(devices)} global devices do not divide into model={n_model}"
        )
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    rows = []
    for pid in sorted(by_proc):
        block = by_proc[pid]
        if len(block) % n_model:
            raise ValueError(
                f"process {pid} has {len(block)} devices, not divisible by "
                f"model={n_model}: tensor-parallel shards must not cross hosts"
            )
        rows.extend(
            block[i : i + n_model] for i in range(0, len(block), n_model)
        )
    return rows


def make_global_mesh(n_model: int = 1, devices: list | None = None) -> Mesh:
    """A (data, model) mesh over EVERY rank's devices (``RankDevice``s,
    gathered from each rank's ``_local_device``), rank-major.  The model
    axis is kept within a process; the data axis spans them."""
    if devices is None:
        mine = (dist.get_rank(), str(_local_device()))
        gathered: list = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, mine)
        devices = [RankDevice(rank, torch.device(d)) for rank, d in gathered]
    rows = _model_rows(list(devices), n_model)
    grid = np.empty((len(rows), n_model), dtype=object)  # entries may be tuples
    for i, row in enumerate(rows):
        for j, d in enumerate(row):
            grid[i, j] = d
    return Mesh(grid)


def _row_counts(n: int) -> list[int]:
    """Every rank's row count, in rank order."""
    counts: list = [None] * dist.get_world_size()
    dist.all_gather_object(counts, int(n))
    return counts


def global_batch(local_array, mesh: Mesh) -> tuple[torch.Tensor, int]:
    """This rank's rows of the global batch -> (them on this rank's first
    data device of ``mesh``, their offset in the global batch: the rows of
    the ranks before it).  Every rank passes ITS rows; the global leading
    dim is the sum over ranks."""
    rank = dist.get_rank()
    mine = [d for d in mesh.data_devices if getattr(d, "process_index", 0) == rank]
    if not mine:
        raise ValueError(f"rank {rank} has no device in {mesh}")
    local = np.asarray(local_array)
    offset = sum(_row_counts(local.shape[0])[:rank])
    device = getattr(mine[0], "device", mine[0])
    return torch.from_numpy(np.ascontiguousarray(local)).to(device), offset


def gather_to_hosts(t) -> np.ndarray:
    """Every rank's rows of ``t`` (ranks may hold different counts), in rank
    order, as numpy on every rank: the readback of a sharded result.  Rows
    are padded to the largest count for the all-gather and cut after; under
    gloo the tensors cross through the CPU, under NCCL through this rank's
    card."""
    t = torch.as_tensor(t)
    counts = _row_counts(t.shape[0])
    t = t.to(_local_device() if dist.get_backend() == "nccl" else torch.device("cpu"))
    pad = max(counts) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
    parts = [torch.empty_like(t) for _ in counts]
    dist.all_gather(parts, t.contiguous())
    return np.concatenate([p[:c].cpu().numpy() for p, c in zip(parts, counts)])


def spans_processes(mesh: Mesh) -> bool:
    """Whether some data row of ``mesh`` belongs to another rank."""
    return len(local_rows(mesh)) < mesh.devices.shape[0]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over every rank of ``t`` (each rank's tensor of one shape and
    dtype), as a new tensor on ``t``'s device, the same values on every rank.
    Under gloo the sum crosses through the CPU, under NCCL through this
    rank's card; a failed collective raises."""
    where = _local_device() if dist.get_backend() == "nccl" else torch.device("cpu")
    buf = t.detach().to(where, copy=True)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    return buf.to(t.device)


def sync(name: str = "barrier") -> None:
    """A barrier across every rank (e.g. around checkpoint writes); ``name``
    labels it for the reader, as JAX's does."""
    del name
    dist.barrier()
