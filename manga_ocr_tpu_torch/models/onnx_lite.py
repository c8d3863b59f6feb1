"""Minimal pure-Python ONNX protobuf reader/writer (no ``onnx`` package):
the port's own copy of ``manga_ocr_tpu/models/onnx_lite.py``, byte for
byte in what it reads and writes (``tests/test_torch_isolation.py``).

The reference's first bubble-detector family is an ONNX U-Net run through
onnxruntime (``_run_onnx_inference``, ``main_window.py:6776-6815``, model
file registered at ``:514``).  Neither ``onnx`` nor ``onnxruntime`` is a
dependency, so this module implements just enough of the protobuf wire
format (varint + length-delimited fields, the stable public ``onnx.proto``
field numbers) to load real ``.onnx`` checkpoint graphs -- initializers,
nodes, attributes, and input/output shapes -- for the PyTorch executor in
``models/convert_onnx.py``.

A writer for the same subset exists for round-trip tests (and to author
tiny fixture models without torch's exporter, which requires ``onnx``).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Iterator

import numpy as np

# TensorProto.DataType enum (onnx.proto)
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64, DT_FLOAT16, DT_DOUBLE = (
    1,
    2,
    3,
    6,
    7,
    10,
    11,
)
_DTYPES = {
    DT_FLOAT: np.float32,
    DT_UINT8: np.uint8,
    DT_INT8: np.int8,
    DT_INT32: np.int32,
    DT_INT64: np.int64,
    DT_FLOAT16: np.float16,
    DT_DOUBLE: np.float64,
}
_DT_OF = {np.dtype(v): k for k, v in _DTYPES.items()}


# -- wire format --------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _fields(buf: bytes) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) triples."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wt = tag >> 3, tag & 7
        if wt == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wt == 1:  # 64-bit
            val = buf[pos : pos + 8]
            pos += 8
        elif wt == 2:  # length-delimited
            ln, pos = _read_varint(buf, pos)
            val = buf[pos : pos + ln]
            pos += ln
        elif wt == 5:  # 32-bit
            val = buf[pos : pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {field})")
        yield field, wt, val


def _write_varint(out: bytearray, v: int) -> None:
    # Negative ints must be encoded as 64-bit two's complement (protobuf
    # varint rule) — an arithmetic right shift on a negative value never
    # reaches 0 and would loop forever (e.g. axis=-1 attributes).
    if v < 0:
        v &= (1 << 64) - 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _write_field(out: bytearray, field: int, wt: int, val) -> None:
    _write_varint(out, (field << 3) | wt)
    if wt == 0:
        _write_varint(out, val)
    elif wt == 2:
        _write_varint(out, len(val))
        out.extend(val)
    else:
        out.extend(val)


# -- message dataclasses -------------------------------------------------------


@dataclasses.dataclass
class Attribute:
    name: str = ""
    f: float | None = None
    i: int | None = None
    s: bytes | None = None
    t: "Tensor | None" = None
    floats: list = dataclasses.field(default_factory=list)
    ints: list = dataclasses.field(default_factory=list)
    strings: list = dataclasses.field(default_factory=list)

    @property
    def value(self):
        for v in (self.f, self.i, self.s, self.t):
            if v is not None:
                return v
        for v in (self.floats, self.ints, self.strings):
            if v:
                return v
        return None


@dataclasses.dataclass
class Node:
    op_type: str = ""
    name: str = ""
    inputs: list = dataclasses.field(default_factory=list)
    outputs: list = dataclasses.field(default_factory=list)
    attrs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Tensor:
    name: str = ""
    array: np.ndarray | None = None


@dataclasses.dataclass
class ValueInfo:
    name: str = ""
    shape: list = dataclasses.field(default_factory=list)  # ints or None (dynamic)


@dataclasses.dataclass
class Graph:
    nodes: list = dataclasses.field(default_factory=list)
    initializers: dict = dataclasses.field(default_factory=dict)  # name -> ndarray
    inputs: list = dataclasses.field(default_factory=list)  # ValueInfo
    outputs: list = dataclasses.field(default_factory=list)


# -- parsing -------------------------------------------------------------------


def _parse_tensor(buf: bytes) -> Tensor:
    dims: list[int] = []
    data_type = DT_FLOAT
    raw = b""
    float_data: list[float] = []
    int32_data: list[int] = []
    int64_data: list[int] = []
    name = ""
    for field, wt, val in _fields(buf):
        if field == 1:
            if wt == 0:
                dims.append(val)
            else:  # packed
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    dims.append(v)
        elif field == 2:
            data_type = val
        elif field == 4:
            if wt == 2:
                float_data.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                float_data.append(struct.unpack("<f", val)[0])
        elif field == 5:
            if wt == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    # two's-complement sign fix (negative ints are encoded
                    # as 64-bit varints) — same as the attribute parser
                    int32_data.append(v if v < (1 << 63) else v - (1 << 64))
            else:
                int32_data.append(val if val < (1 << 63) else val - (1 << 64))
        elif field == 7:
            if wt == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int64_data.append(v if v < (1 << 63) else v - (1 << 64))
            else:
                int64_data.append(val if val < (1 << 63) else val - (1 << 64))
        elif field == 8:
            name = val.decode("utf-8")
        elif field == 9:
            raw = val
    dtype = _DTYPES.get(data_type, np.float32)
    if raw:
        arr = np.frombuffer(raw, dtype=dtype).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, np.float32).reshape(dims)
    elif int64_data:
        arr = np.asarray(int64_data, np.int64).reshape(dims)
    elif int32_data:
        if dtype == np.float16:
            # ONNX stores fp16 initializers as uint16 BIT PATTERNS in
            # int32_data — reinterpret, don't value-cast (0x3C00 is 1.0,
            # not 15360.0)
            arr = (
                np.asarray(int32_data, np.uint32)
                .astype(np.uint16)
                .view(np.float16)
                .reshape(dims)
            )
        else:
            arr = np.asarray(int32_data, np.int32).reshape(dims)
    else:
        arr = np.zeros(dims, dtype)
    return Tensor(name, np.asarray(arr, dtype))


def _parse_attribute(buf: bytes) -> Attribute:
    a = Attribute()
    for field, wt, val in _fields(buf):
        if field == 1:
            a.name = val.decode("utf-8")
        elif field == 2:
            a.f = struct.unpack("<f", val)[0]
        elif field == 3:
            a.i = val if val < (1 << 63) else val - (1 << 64)
        elif field == 4:
            a.s = val
        elif field == 5:
            a.t = _parse_tensor(val)
        elif field == 7:
            if wt == 2:
                a.floats.extend(struct.unpack(f"<{len(val) // 4}f", val))
            else:
                a.floats.append(struct.unpack("<f", val)[0])
        elif field == 8:
            if wt == 2:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    a.ints.append(v if v < (1 << 63) else v - (1 << 64))
            else:
                a.ints.append(val if val < (1 << 63) else val - (1 << 64))
        elif field == 9:
            a.strings.append(val)
    return a


def _parse_node(buf: bytes) -> Node:
    n = Node()
    for field, wt, val in _fields(buf):
        if field == 1:
            n.inputs.append(val.decode("utf-8"))
        elif field == 2:
            n.outputs.append(val.decode("utf-8"))
        elif field == 3:
            n.name = val.decode("utf-8")
        elif field == 4:
            n.op_type = val.decode("utf-8")
        elif field == 5:
            a = _parse_attribute(val)
            n.attrs[a.name] = a
    return n


def _parse_value_info(buf: bytes) -> ValueInfo:
    vi = ValueInfo()
    for field, wt, val in _fields(buf):
        if field == 1:
            vi.name = val.decode("utf-8")
        elif field == 2:  # TypeProto
            for f2, _, v2 in _fields(val):
                if f2 == 1:  # tensor_type
                    for f3, _, v3 in _fields(v2):
                        if f3 == 2:  # shape
                            for f4, _, v4 in _fields(v3):
                                if f4 == 1:  # dim
                                    dim_val = None
                                    for f5, w5, v5 in _fields(v4):
                                        if f5 == 1 and w5 == 0:
                                            dim_val = v5
                                    vi.shape.append(dim_val)
    return vi


def _parse_graph(buf: bytes) -> Graph:
    g = Graph()
    for field, wt, val in _fields(buf):
        if field == 1:
            g.nodes.append(_parse_node(val))
        elif field == 5:
            t = _parse_tensor(val)
            g.initializers[t.name] = t.array
        elif field == 11:
            g.inputs.append(_parse_value_info(val))
        elif field == 12:
            g.outputs.append(_parse_value_info(val))
    return g


def load_model(path_or_bytes) -> Graph:
    """Parse an ONNX ModelProto file/bytes into a Graph."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    for field, wt, val in _fields(buf):
        if field == 7:  # ModelProto.graph
            return _parse_graph(val)
    raise ValueError("no graph found in ONNX model")


# -- writing (tests/fixtures) ---------------------------------------------------


def _ser_tensor(t: Tensor) -> bytes:
    out = bytearray()
    arr = np.asarray(t.array)
    for d in arr.shape:
        _write_field(out, 1, 0, d)
    _write_field(out, 2, 0, _DT_OF[arr.dtype])
    _write_field(out, 8, 2, t.name.encode("utf-8"))
    _write_field(out, 9, 2, np.ascontiguousarray(arr).tobytes())
    return bytes(out)


def _ser_attribute(name: str, value) -> bytes:
    out = bytearray()
    _write_field(out, 1, 2, name.encode("utf-8"))
    if isinstance(value, float):
        _write_field(out, 2, 5, struct.pack("<f", value))
        _write_field(out, 20, 0, 1)  # type FLOAT
    elif isinstance(value, bool) or isinstance(value, int):
        _write_field(out, 3, 0, int(value))
        _write_field(out, 20, 0, 2)  # INT
    elif isinstance(value, (bytes, str)):
        _write_field(out, 4, 2, value.encode() if isinstance(value, str) else value)
        _write_field(out, 20, 0, 3)  # STRING
    elif isinstance(value, Tensor):
        _write_field(out, 5, 2, _ser_tensor(value))
        _write_field(out, 20, 0, 4)  # TENSOR
    elif isinstance(value, (list, tuple)) and value and isinstance(value[0], float):
        for v in value:
            _write_field(out, 7, 5, struct.pack("<f", v))
        _write_field(out, 20, 0, 6)  # FLOATS
    elif isinstance(value, (list, tuple)):
        for v in value:
            _write_field(out, 8, 0, int(v) & ((1 << 64) - 1))
        _write_field(out, 20, 0, 7)  # INTS
    else:
        raise TypeError(f"unsupported attribute value {value!r}")
    return bytes(out)


def _ser_node(n: Node) -> bytes:
    out = bytearray()
    for i in n.inputs:
        _write_field(out, 1, 2, i.encode("utf-8"))
    for o in n.outputs:
        _write_field(out, 2, 2, o.encode("utf-8"))
    _write_field(out, 3, 2, n.name.encode("utf-8"))
    _write_field(out, 4, 2, n.op_type.encode("utf-8"))
    for name, val in n.attrs.items():
        raw = val.value if isinstance(val, Attribute) else val
        _write_field(out, 5, 2, _ser_attribute(name, raw))
    return bytes(out)


def _ser_value_info(vi: ValueInfo) -> bytes:
    dims = bytearray()  # TensorShapeProto: repeated Dimension (field 1)
    for d in vi.shape:
        one = bytearray()
        _write_field(one, 1, 0, 0 if d is None else d)
        _write_field(dims, 1, 2, bytes(one))
    tensor_type = bytearray()
    _write_field(tensor_type, 1, 0, DT_FLOAT)  # elem_type
    _write_field(tensor_type, 2, 2, bytes(dims))  # shape
    type_proto = bytearray()
    _write_field(type_proto, 1, 2, bytes(tensor_type))
    out = bytearray()
    _write_field(out, 1, 2, vi.name.encode("utf-8"))
    _write_field(out, 2, 2, bytes(type_proto))
    return bytes(out)


def save_model(graph: Graph, path: str) -> None:
    g = bytearray()
    for n in graph.nodes:
        _write_field(g, 1, 2, _ser_node(n))
    for name, arr in graph.initializers.items():
        _write_field(g, 5, 2, _ser_tensor(Tensor(name, arr)))
    for vi in graph.inputs:
        _write_field(g, 11, 2, _ser_value_info(vi))
    for vi in graph.outputs:
        _write_field(g, 12, 2, _ser_value_info(vi))
    model = bytearray()
    _write_field(model, 1, 0, 8)  # ir_version
    _write_field(model, 7, 2, bytes(g))
    with open(path, "wb") as f:
        f.write(bytes(model))
