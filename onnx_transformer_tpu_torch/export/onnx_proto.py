"""Minimal ONNX protobuf writer/reader (a copy of
``onnx_transformer_tpu/export/onnx_proto.py``; no onnx package is needed).

ONNX models are protobufs; the wire format is simple (tag varints +
length-delimited submessages), and the ONNX IR field numbers are stable
public API (onnx/onnx.proto, IR version 8).  This module implements just
enough of both directions to emit QDQ ``.onnx`` files any ONNX runtime can
load, and to re-parse our own emission for the round-trip evaluator test
(``tests/test_torch_onnx_export.py``) — the same dual-executor oracle the
reference uses between qonnx and onnxruntime (SURVEY.md §4).

Field numbers used (onnx.proto):
  ModelProto:   ir_version=1 producer_name=2 producer_version=3 domain=4
                model_version=5 doc_string=6 graph=7 opset_import=8
  OperatorSetIdProto: domain=1 version=2
  GraphProto:   node=1 name=2 initializer=5 doc_string=10 input=11
                output=12 value_info=13
  NodeProto:    input=1 output=2 name=3 op_type=4 attribute=5 domain=7
  AttributeProto: name=1 f=2 i=3 s=4 t=5 floats=7 ints=8 type=20
                (type enum: FLOAT=1 INT=2 STRING=3 TENSOR=4 FLOATS=6 INTS=7)
  TensorProto:  dims=1 data_type=2 name=8 raw_data=9
                (data_type enum: FLOAT=1 UINT8=2 INT8=3 INT32=6 INT64=7
                 BOOL=9)
  ValueInfoProto: name=1 type=2
  TypeProto: tensor_type=1;  TypeProto.Tensor: elem_type=1 shape=2
  TensorShapeProto: dim=1;  Dimension: dim_value=1 dim_param=2
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np

# ------------------------------------------------------------- wire writer

F32, U8, I8, I32, I64, BOOL = 1, 2, 3, 6, 7, 9

_NP2ONNX = {np.dtype(np.float32): F32, np.dtype(np.uint8): U8,
            np.dtype(np.int8): I8, np.dtype(np.int32): I32,
            np.dtype(np.int64): I64, np.dtype(np.bool_): BOOL}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fieldno: int, wiretype: int) -> bytes:
    return _varint((fieldno << 3) | wiretype)


def enc_varint(fieldno: int, value: int) -> bytes:
    return _tag(fieldno, 0) + _varint(value)


def enc_bytes(fieldno: int, value: bytes) -> bytes:
    return _tag(fieldno, 2) + _varint(len(value)) + value


def enc_str(fieldno: int, value: str) -> bytes:
    return enc_bytes(fieldno, value.encode())


def enc_float(fieldno: int, value: float) -> bytes:
    return _tag(fieldno, 5) + struct.pack("<f", value)


# ------------------------------------------------------------ ONNX pieces


def tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    out = b""
    for d in arr.shape:
        out += enc_varint(1, d)
    out += enc_varint(2, _NP2ONNX[arr.dtype])
    out += enc_str(8, name)
    out += enc_bytes(9, arr.tobytes())
    return out


def _attr(name: str, value) -> bytes:
    out = enc_str(1, name)
    if isinstance(value, float):
        out += enc_float(2, value) + enc_varint(20, 1)
    elif isinstance(value, bool) or isinstance(value, (int, np.integer)):
        out += enc_varint(3, int(value)) + enc_varint(20, 2)
    elif isinstance(value, str):
        out += enc_bytes(4, value.encode()) + enc_varint(20, 3)
    elif isinstance(value, np.ndarray):
        out += enc_bytes(5, tensor_proto(name + "_value", value))
        out += enc_varint(20, 4)
    elif isinstance(value, (list, tuple)) and not value:
        # an empty list is type-ambiguous on the wire (INTS vs FLOATS);
        # no emitted attribute is empty today, so fail loudly
        raise TypeError(f"attr {name}: empty sequence has no ONNX type")
    elif isinstance(value, (list, tuple)) and isinstance(
            value[0], (int, np.integer)):
        for v in value:
            out += enc_varint(8, int(v))
        out += enc_varint(20, 7)
    elif isinstance(value, (list, tuple)):
        for v in value:
            out += enc_float(7, float(v))
        out += enc_varint(20, 6)
    else:
        raise TypeError(f"attr {name}: {type(value)}")
    return out


def node_proto(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
               name: str = "", **attrs) -> bytes:
    out = b""
    for i in inputs:
        out += enc_str(1, i)
    for o in outputs:
        out += enc_str(2, o)
    if name:
        out += enc_str(3, name)
    out += enc_str(4, op_type)
    for k, v in attrs.items():
        out += enc_bytes(5, _attr(k, v))
    return out


def value_info(name: str, elem_type: int,
               shape: Sequence[Union[int, str]]) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += enc_bytes(1, enc_str(2, d))
        else:
            dims += enc_bytes(1, enc_varint(1, int(d)))
    ttype = enc_varint(1, elem_type) + enc_bytes(2, dims)
    return enc_str(1, name) + enc_bytes(2, enc_bytes(1, ttype))


def graph_proto(name: str, nodes: Sequence[bytes],
                initializers: Sequence[bytes], inputs: Sequence[bytes],
                outputs: Sequence[bytes]) -> bytes:
    out = b""
    for n in nodes:
        out += enc_bytes(1, n)
    out += enc_str(2, name)
    for t in initializers:
        out += enc_bytes(5, t)
    for i in inputs:
        out += enc_bytes(11, i)
    for o in outputs:
        out += enc_bytes(12, o)
    return out


def model_proto(graph: bytes, opset: int = 13,
                producer: str = "onnx-transformer-tpu") -> bytes:
    opset_id = enc_str(1, "") + enc_varint(2, opset)
    return (enc_varint(1, 8)                 # ir_version 8
            + enc_str(2, producer)
            + enc_str(3, "0.4")
            + enc_bytes(7, graph)
            + enc_bytes(8, opset_id))


# ------------------------------------------------------------- wire reader


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def parse_message(buf: bytes) -> dict[int, list]:
    """Generic wire parse: field number -> list of raw values (int for
    varint, bytes for length-delimited, bytes for fixed32/64)."""
    fields: dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        fno, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = buf[pos:pos + 4]
            pos += 4
        elif wt == 1:
            v = buf[pos:pos + 8]
            pos += 8
        else:
            raise ValueError(f"wiretype {wt}")
        fields.setdefault(fno, []).append(v)
    return fields


@dataclass
class PNode:
    op_type: str
    inputs: list
    outputs: list
    attrs: dict = field(default_factory=dict)


@dataclass
class PGraph:
    nodes: list
    initializers: dict          # name -> np.ndarray
    inputs: list                # names
    outputs: list               # names


def parse_tensor(buf: bytes) -> tuple[str, np.ndarray]:
    f = parse_message(buf)
    dims = [int(d) for d in f.get(1, [])]
    dt = _ONNX2NP[int(f[2][0])]
    name = f[8][0].decode()
    arr = np.frombuffer(f[9][0], dtype=dt).reshape(dims)
    return name, arr


def _parse_attr(buf: bytes):
    f = parse_message(buf)
    name = f[1][0].decode()
    atype = int(f[20][0]) if 20 in f else None
    if atype == 1:
        return name, struct.unpack("<f", f[2][0])[0]
    if atype == 2:
        v = int(f[3][0])
        return name, v - (1 << 64) if v >= (1 << 63) else v
    if atype == 3:
        return name, f[4][0].decode()
    if atype == 4:
        return name, parse_tensor(f[5][0])[1]
    if atype == 7:
        return name, [int(v) - (1 << 64) if int(v) >= (1 << 63) else int(v)
                      for v in f.get(8, [])]
    if atype == 6:
        return name, [struct.unpack("<f", v)[0] for v in f.get(7, [])]
    raise ValueError(f"attr type {atype}")


def parse_model(buf: bytes) -> PGraph:
    m = parse_message(buf)
    g = parse_message(m[7][0])
    nodes = []
    for nb in g.get(1, []):
        f = parse_message(nb)
        attrs = dict(_parse_attr(a) for a in f.get(5, []))
        nodes.append(PNode(
            op_type=f[4][0].decode(),
            inputs=[x.decode() for x in f.get(1, [])],
            outputs=[x.decode() for x in f.get(2, [])],
            attrs=attrs,
        ))
    inits = dict(parse_tensor(t) for t in g.get(5, []))

    def vi_name(b):
        return parse_message(b)[1][0].decode()

    return PGraph(
        nodes=nodes,
        initializers=inits,
        inputs=[vi_name(b) for b in g.get(11, [])],
        outputs=[vi_name(b) for b in g.get(12, [])],
    )
