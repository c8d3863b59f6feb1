"""A reader and writer of the safetensors format in NumPy alone.

The format (the one ``safetensors.numpy`` reads and writes): an 8-byte
little-endian header length ``n``, ``n`` bytes of a UTF-8 JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` with an
optional ``"__metadata__": {str: str}``, padded with spaces to a multiple of
8 bytes, then the tensors' raw little-endian bytes, the offsets counted from
the end of the header.  The port keeps its own copy because a machine that
runs it need not have the ``safetensors`` package; files written by either
read in the other.
"""

from __future__ import annotations

import json
import struct
from typing import Mapping

import numpy as np

# The dtypes ``safetensors.numpy`` maps to NumPy; any other (BF16, F8_*)
# has no NumPy dtype and is refused.
DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "I64": np.int64,
    "U64": np.uint64,
    "I32": np.int32,
    "U32": np.uint32,
    "I16": np.int16,
    "U16": np.uint16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
    "C64": np.complex64,
}
_NAMES = {np.dtype(t): name for name, t in DTYPES.items()}
METADATA = "__metadata__"
# the reference reader's own limit on the header
MAX_HEADER_BYTES = 100_000_000


def save_file(
    tensors: Mapping[str, np.ndarray], path: str, metadata: Mapping[str, str] | None = None
) -> None:
    """Write ``tensors`` (and the optional string ``metadata``) to ``path``."""
    arrays = {}
    for name, a in tensors.items():
        a = np.asarray(a)
        if a.dtype.newbyteorder("=") not in _NAMES:
            raise ValueError(f"safetensors: tensor {name!r} has dtype {a.dtype}, which the "
                             f"format's NumPy mapping lacks")
        arrays[name] = np.asarray(a, a.dtype.newbyteorder("<"), order="C")
    header: dict = {}
    if metadata is not None:
        header[METADATA] = {str(k): str(v) for k, v in metadata.items()}
    # the widest dtypes first, so every tensor starts aligned to its item size
    order = sorted(arrays, key=lambda n: (-arrays[n].dtype.itemsize, n))
    offset = 0
    for name in order:
        a = arrays[name]
        header[name] = {"dtype": _NAMES[a.dtype.newbyteorder("=")], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in order:
            f.write(arrays[name].tobytes())


def load_file(path: str) -> dict[str, np.ndarray]:
    """The tensors of ``path`` by name, each a view of one buffer read from
    the file.  A dtype without a NumPy mapping (BF16 among them) raises
    ``ValueError`` naming it and the tensor, as does a tensor whose offsets
    disagree with its shape or leave the file."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"safetensors: {path} is too short for a header")
        (n,) = struct.unpack("<Q", head)
        if n > MAX_HEADER_BYTES:
            raise ValueError(f"safetensors: {path} declares a header of {n} bytes")
        raw = f.read(n)
        if len(raw) != n:
            raise ValueError(f"safetensors: {path} ends inside its header")
        body = bytearray(f.read())
    header = json.loads(raw.decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError(f"safetensors: {path} has a header that is not a JSON object")
    out = {}
    for name, info in header.items():
        if name == METADATA:
            continue
        if info["dtype"] not in DTYPES:
            raise ValueError(f"safetensors: tensor {name!r} in {path} has dtype "
                             f"{info['dtype']}, which has no NumPy mapping")
        dtype = np.dtype(DTYPES[info["dtype"]]).newbyteorder("<")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        count = int(np.prod(shape, dtype=np.int64))
        if not 0 <= begin <= end <= len(body) or end - begin != count * dtype.itemsize:
            raise ValueError(f"safetensors: tensor {name!r} in {path} has offsets "
                             f"[{begin}, {end}] for shape {shape} of {info['dtype']}")
        flat = np.frombuffer(body, dtype, count, begin) if count else np.empty(0, dtype)
        out[name] = flat.reshape(shape)
    return out
