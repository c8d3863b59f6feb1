"""Device meshes and data-parallel dispatch on torch devices (counterpart of
``manga_ocr_tpu/parallel/mesh.py`` without its tensor-parallel half).

The JAX package shards over a ``jax.sharding.Mesh`` and lets XLA place the
pieces; here the pieces are explicit:

- a ``Mesh`` is a 2-D (data, model) grid of ``torch.device``;
- ``dp_replicate`` copies a parameter tree once to every data-row device;
- ``dp_shard_batch`` pads a host batch to a multiple of the data-axis size
  and sends one equal slice to each data-row device;
- the caller launches its model on every shard before reading any back
  (CUDA launches are asynchronous), and ``dp_gather`` reads every shard
  back in order and slices the padding off.

Serving has no collective: every shard is a whole batch of independent
rows.  A virtual mesh repeats one device (``[torch.device("cpu")] * 8`` in
the CPU tests, ``[torch.device("cuda:0")] * 2`` on one card): the same
code runs shard after shard there.  Not here: ``param_specs``,
``param_shardings`` and ``shard_params`` (tensor parallelism over the
model axis; ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """A 2-D (data, model) grid of torch devices: ``devices[i, j]`` is data
    row i, model column j.  ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does.  Strings become ``torch.device``;
    other entries are kept as given (``parallel.multihost``'s global mesh
    holds devices tagged with their process)."""

    def __init__(self, devices):
        grid = np.asarray(devices, dtype=object)
        if grid.ndim != 2 or 0 in grid.shape:
            raise ValueError(f"a mesh is a non-empty 2-D grid of devices, got shape {grid.shape}")
        self.devices = np.empty(grid.shape, dtype=object)
        for idx, d in np.ndenumerate(grid):
            self.devices[idx] = torch.device(d) if isinstance(d, str) else d

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.devices.shape[0], MODEL_AXIS: self.devices.shape[1]}

    @property
    def data_devices(self) -> list:
        """The device of each data row (its first model column), in order."""
        return list(self.devices[:, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(
    n_data: int | None = None,
    n_model: int = 1,
    devices: list | None = None,
) -> Mesh:
    """Build a 2-D (data, model) mesh.  Defaults to every visible CUDA
    device on the data axis; raises where fewer devices are given or visible
    than the mesh needs (none are visible without CUDA)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [d if isinstance(d, torch.device) else torch.device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    need = n_data * n_model
    if need <= 0:
        raise ValueError(f"mesh needs a positive device count, got {n_data}x{n_model}")
    if len(devices) < need:
        raise ValueError(
            f"mesh ({n_data} data x {n_model} model) needs {need} devices but only "
            f"{len(devices)} are visible; for a virtual mesh pass "
            f'devices=[torch.device("cpu")] * {need}, or [torch.device("cuda:0")] * {need}'
        )
    grid = np.empty((n_data, n_model), dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i // n_model, i % n_model] = d
    return Mesh(grid)


def serving_devices(mesh: Mesh | None, device, who: str) -> list:
    """The data devices a model serves on: ``[device]`` without a mesh, else
    the mesh's data devices, which must be of ``device``'s type, so that a
    CUDA request never runs on the CPU (nor the reverse)."""
    if mesh is None:
        return [torch.device(device)]
    kinds = sorted({d.type for d in mesh.data_devices})
    if kinds != [torch.device(device).type]:
        raise ValueError(f"{who}: mesh devices of type {kinds} do not match device={device!r}")
    return mesh.data_devices


def dp_size(mesh: Mesh) -> int:
    return mesh.shape[DATA_AXIS]


def splits(mesh: Mesh | None, n: int) -> bool:
    """Whether a batch of ``n`` rows is split across ``mesh``: one of at
    least the data-axis size.  A smaller one runs on the first device
    (padding it to the axis size would pay that many times the compute for
    the same rows)."""
    return mesh is not None and n >= dp_size(mesh)


def dispatch_slices(n: int, cap: int, mesh: Mesh | None) -> list[slice]:
    """``n`` items in dispatches of at most ``cap`` items a device: ``cap``
    times the data-axis size while at least one item a data device is
    left, then at most ``cap`` on one device."""
    n_dp = 1 if mesh is None else dp_size(mesh)
    out, at = [], 0
    while at < n:
        step = cap * n_dp if n - at >= n_dp else cap
        out.append(slice(at, at + step))
        at += step
    return out


def pad_batch_to_multiple(arr: np.ndarray, m: int) -> np.ndarray:
    """Zero-pad the leading dim up to a multiple of ``m`` (shard rows must
    divide evenly; padded rows are sliced off after the dispatch)."""
    pad = (-arr.shape[0]) % m
    if pad:
        arr = np.concatenate(
            [arr, np.zeros((pad, *arr.shape[1:]), arr.dtype)], axis=0
        )
    return arr


def dp_shard_batch(arr_np, mesh: Mesh) -> list[torch.Tensor]:
    """np batch -> one tensor per data-row device: the leading dim padded
    with zeros to a multiple of the data-axis size, then split evenly."""
    arr = pad_batch_to_multiple(np.asarray(arr_np), dp_size(mesh))
    rows = arr.shape[0] // dp_size(mesh)
    return [torch.from_numpy(np.ascontiguousarray(arr[i * rows:(i + 1) * rows])).to(
                dev, non_blocking=True)
            for i, dev in enumerate(mesh.data_devices)]


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def dp_replicate(tree, mesh: Mesh) -> list:
    """A parameter tree (dicts, lists and tuples of tensors, None kept) ->
    one tree per data-row device, in order, each leaf copied there once (at
    construction, not per dispatch).  A leaf already on a device stays that
    tensor there: the replicas of a virtual mesh that repeats one device
    share it."""
    return [_tree_to(tree, dev) for dev in mesh.data_devices]


def dp_gather(shards, n: int) -> np.ndarray:
    """The per-device outputs of one sharded dispatch (in data-row order)
    -> one host array of their rows in order, the padding past ``n`` rows
    sliced off.  Every shard was launched before this reads any back."""
    return np.concatenate([s.cpu().numpy() for s in shards], axis=0)[:n]
