"""Device meshes, data-parallel dispatch and tensor-parallel parameter
shardings on torch devices (counterpart of ``manga_ocr_tpu/parallel/mesh.py``).

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
code runs shard after shard there.

Tensor parallelism over the model axis: ``param_specs`` names, per leaf of
the parameter tree, the dimension split over the model axis (the JAX
package's ``PartitionSpec`` tree, leaf for leaf), and ``shard_params``
gives each data row one tree per model column whose split leaves are that
column's contiguous slice.  XLA partitions the JAX package's program from
those annotations; here the plain routes take a row's list of columns
(``parallel/tensor.py`` sets out how).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

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


# ---------------------------------------------------------------------------
# Parameter shardings (tensor parallelism over the model axis)
# ---------------------------------------------------------------------------


class PartitionSpec(tuple):
    """Per dimension of a leaf, the mesh axis it is split over, or None (as
    ``jax.sharding.PartitionSpec``; ``P()`` is replicated)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec


def _attn_spec(stacked: bool) -> dict:
    """q/k/v shard the head (output) dim; o shards its input dim."""
    lead = (None,) if stacked else ()  # leading stacked-layer axis
    # kernels are [L?, din, dout]
    qkv = P(*lead, None, MODEL_AXIS)
    o = P(*lead, MODEL_AXIS, None)
    qkv_b = P(*lead, MODEL_AXIS)
    o_b = P(*lead, None)
    return {
        "q": {"kernel": qkv, "bias": qkv_b},
        "k": {"kernel": qkv, "bias": qkv_b},
        "v": {"kernel": qkv, "bias": qkv_b},
        "o": {"kernel": o, "bias": o_b},
    }


def _mlp_spec(stacked: bool) -> dict:
    lead = (None,) if stacked else ()
    return {
        "fc1": {"kernel": P(*lead, None, MODEL_AXIS), "bias": P(*lead, MODEL_AXIS)},
        "fc2": {"kernel": P(*lead, MODEL_AXIS, None), "bias": P(*lead, None)},
    }


def _ln_spec(stacked: bool) -> dict:
    lead = (None,) if stacked else ()
    return {"scale": P(*lead, None), "bias": P(*lead, None)}


def param_specs() -> dict:
    """PartitionSpec tree matching ``models.params.init_params``' structure."""
    return {
        "encoder": {
            "patch_embed": {"kernel": P(None, None, None, MODEL_AXIS), "bias": P(MODEL_AXIS)},
            "cls_token": P(None, None, None),
            "pos_embed": P(None, None, None),
            "layers": {
                "ln1": _ln_spec(True),
                "attn": _attn_spec(True),
                "ln2": _ln_spec(True),
                "mlp": _mlp_spec(True),
            },
            "final_ln": _ln_spec(False),
        },
        "decoder": {
            "tok_embed": P(MODEL_AXIS, None),
            "pos_embed": P(None, None),
            "tok_type": P(None),
            "emb_ln": _ln_spec(False),
            "layers": {
                "self_attn": _attn_spec(True),
                "self_ln": _ln_spec(True),
                "cross_attn": _attn_spec(True),
                "cross_ln": _ln_spec(True),
                "mlp": _mlp_spec(True),
                "mlp_ln": _ln_spec(True),
            },
            "head": {
                "transform": {
                    "dense": {"kernel": P(None, None), "bias": P(None)},
                    "ln": _ln_spec(False),
                },
                "proj": {"kernel": P(None, MODEL_AXIS), "bias": P(MODEL_AXIS)},
            },
        },
    }


def param_shardings(mesh: Mesh) -> dict:
    """``param_specs`` with each spec on ``mesh``."""

    def place(tree):
        if isinstance(tree, dict):
            return {k: place(v) for k, v in tree.items()}
        return NamedSharding(mesh, tree)

    return place(param_specs())


def flat_specs() -> dict:
    """``param_specs`` by leaf path ("decoder/head/proj/kernel"), the paths
    the checkpoint files use."""
    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, path)
            else:
                out[path] = v

    walk(param_specs(), "")
    return out


def model_dim(spec: PartitionSpec) -> int | None:
    """The dimension ``spec`` splits over the model axis, or None."""
    return spec.index(MODEL_AXIS) if MODEL_AXIS in spec else None


def shard_leaf(full: torch.Tensor, spec: PartitionSpec, n_model: int, column: int,
               name: str = "leaf") -> torch.Tensor:
    """Model column ``column``'s part of the full leaf ``full`` under
    ``spec``: its contiguous slice of the split dimension (a view), or
    ``full`` itself where nothing is split.  Raises ``ValueError`` (naming
    ``name``) where the dimension does not divide by ``n_model``."""
    dim = model_dim(spec)
    if dim is None or n_model == 1:
        return full
    if full.ndim != len(spec) or full.shape[dim] % n_model:
        raise ValueError(
            f"shard_params: {name} of shape {tuple(full.shape)} cannot be split over a model "
            f"axis of {n_model} along dim {dim} (spec {spec})"
        )
    size = full.shape[dim] // n_model
    return full.narrow(dim, column * size, size)


def device_of(d) -> torch.device:
    """A mesh entry's torch device (``parallel.multihost``'s global mesh
    holds ``RankDevice``s: the rank and its device)."""
    return getattr(d, "device", d)


def local_rows(mesh: Mesh) -> list[int]:
    """The data rows whose devices belong to this process: every row of a
    mesh of plain devices; on a global mesh the rows of this rank."""
    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    return [i for i, row in enumerate(mesh.devices)
            if getattr(row[0], "process_index", rank) == rank]


def _check_specs(params, shardings, prefix: str = "") -> None:
    """Every leaf of ``params`` has a sharding and divides as it says."""
    if isinstance(params, dict):
        if not isinstance(shardings, dict) or set(params) - set(shardings):
            extra = (sorted(set(params) - set(shardings)) if isinstance(shardings, dict)
                     else sorted(params))
            raise ValueError(f"shard_params: no spec for {prefix or 'the tree'} {extra}")
        for k, v in params.items():
            _check_specs(v, shardings[k], f"{prefix}/{k}" if prefix else k)
        return
    if not isinstance(shardings, NamedSharding):
        raise ValueError(f"shard_params: {prefix} is a leaf where the specs hold a tree")
    n_model = shardings.mesh.shape[MODEL_AXIS]
    for c in range(n_model):
        shard_leaf(params, shardings.spec, n_model, c, prefix)


def _column_tree(params, shardings, column: int, device: torch.device):
    if isinstance(params, dict):
        return {k: _column_tree(v, shardings[k], column, device) for k, v in params.items()}
    piece = shard_leaf(params, shardings.spec, shardings.mesh.shape[MODEL_AXIS], column)
    out = torch.empty(piece.shape, dtype=piece.dtype, device=device)
    out.copy_(piece)
    return out


def shard_params(params: dict, mesh: Mesh) -> list:
    """Place a parameter tree onto ``mesh`` with ``param_shardings(mesh)``:
    for each data row of this process, one
    tree per model column (in column order), of the model's structure, whose
    split leaves are that column's contiguous slice and whose replicated
    leaves are whole; rows of other processes are None.  Every leaf of every
    tree is a tensor of its own on its column's device (never a view, nor a
    tensor shared with another row or column), so that training steps every
    replica and every shard as a leaf of its own.  A split dimension that
    does not divide by the model-axis size raises ``ValueError`` naming the
    leaf, before anything is copied.  With a model axis of 1 each row holds
    one whole copy (``dp_replicate``'s layout, unshared)."""
    shardings = param_shardings(mesh)
    _check_specs(params, shardings)
    mine = set(local_rows(mesh))
    with torch.no_grad():
        return [
            [_column_tree(params, shardings, c, device_of(d)) for c, d in enumerate(row)]
            if i in mine else None
            for i, row in enumerate(mesh.devices)
        ]


@torch.no_grad()
def unshard_params(columns: list, get=None):
    """One data row's column trees (``shard_params``) -> the full tree on
    column 0's device: each split leaf the concatenation of its columns'
    slices along its spec's dimension, in column order; a replicated leaf
    column 0's.  ``get`` maps each column's leaf to the tensor put together
    in its place (default: the leaf; e.g. its gradient or an optimizer
    moment)."""
    get = get or (lambda t: t)

    def walk(cols, spec):
        if isinstance(cols[0], dict):
            return {k: walk([c[k] for c in cols], spec[k]) for k in cols[0]}
        parts = [get(t) for t in cols]
        dim = model_dim(spec)
        if dim is None or len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(parts[0].device) for p in parts], dim=dim)

    return walk(columns, param_specs())
