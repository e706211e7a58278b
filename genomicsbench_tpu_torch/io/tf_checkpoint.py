"""TensorFlow v2-format checkpoint (tensor bundle) reader, numpy only.

A copy of genomicsbench_tpu/io/tf_checkpoint.py.  The reference nn-variant
benchmark restores Clair weights with `tf.train.Saver.restore`
(clair/model.py:1030, prediction.py:66) from a TF 1.13 "V2" checkpoint: a
tensor bundle of

  {prefix}.index               an LSSTable (leveldb table) mapping
                               tensor name -> BundleEntryProto
  {prefix}.data-NNNNN-of-MMMMM raw little-endian tensor bytes at
                               (offset, size) per entry

This module reads that format without TensorFlow: a minimal leveldb
table parser (block handles, prefix-compressed entries, restart arrays,
snappy decompression) plus a minimal protobuf varint decoder for
BundleHeaderProto / BundleEntryProto (tensorflow/core/protobuf/
tensor_bundle.proto).  No real Clair checkpoint ships with the reference
(its weights are stripped), so the parser is written to the documented
format and tested on fixtures that an independent encoder writes from the
same spec.  Big-endian bundles are refused; sliced (partitioned) tensors
and non-numeric ones are skipped.

Public surface:
  read_tensor_bundle(prefix) -> {name: np.ndarray}
  list_tensors(prefix)       -> {name: (dtype, shape)}
"""

from __future__ import annotations

import os
import struct

import numpy as np

_TABLE_MAGIC = 0xDB4775248B80FB57

# tensorflow/core/framework/types.proto enum DataType -> numpy
_DTYPES = {
    1: np.dtype("<f4"),   # DT_FLOAT
    2: np.dtype("<f8"),   # DT_DOUBLE
    3: np.dtype("<i4"),   # DT_INT32
    4: np.dtype("<u1"),   # DT_UINT8
    5: np.dtype("<i2"),   # DT_INT16
    6: np.dtype("<i1"),   # DT_INT8
    9: np.dtype("<i8"),   # DT_INT64
    10: np.dtype("?"),    # DT_BOOL
    14: np.dtype("<u2"),  # DT_BFLOAT16 (bit pattern; widened below)
    17: np.dtype("<u2"),  # DT_UINT16
    19: np.dtype("<f2"),  # DT_HALF
    22: np.dtype("<u4"),  # DT_UINT32
    23: np.dtype("<u8"),  # DT_UINT64
}
_DT_BFLOAT16 = 14


# ---------------------------------------------------------------------------
# varint / protobuf primitives
# ---------------------------------------------------------------------------

def _uvarint(buf: bytes, pos: int):
    """LEB128 unsigned varint -> (value, next_pos)."""
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _proto_fields(buf: bytes):
    """Iterate (field_number, wire_type, value) over a protobuf message.
    wire 0 -> int, wire 1 -> 8 raw bytes, wire 2 -> bytes, wire 5 -> 4
    raw bytes."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _uvarint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _uvarint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _uvarint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_shape(buf: bytes):
    """TensorShapeProto: repeated Dim dim = 2; Dim.size = 1 (may be
    zigzag-free int64; sizes are non-negative for saved tensors)."""
    dims = []
    for field, _wire, val in _proto_fields(buf):
        if field == 2:  # Dim message
            size = 0
            for f2, _w2, v2 in _proto_fields(val):
                if f2 == 1:
                    size = v2
            dims.append(int(size))
    return tuple(dims)


def _parse_entry(buf: bytes):
    """BundleEntryProto: dtype=1, shape=2, shard_id=3, offset=4, size=5,
    crc32c=6, slices=7 (unsupported)."""
    ent = {"dtype": 0, "shape": (), "shard_id": 0, "offset": 0, "size": 0,
           "sliced": False}
    for field, _wire, val in _proto_fields(buf):
        if field == 1:
            ent["dtype"] = int(val)
        elif field == 2:
            ent["shape"] = _parse_shape(val)
        elif field == 3:
            ent["shard_id"] = int(val)
        elif field == 4:
            ent["offset"] = int(val)
        elif field == 5:
            ent["size"] = int(val)
        elif field == 7:
            # partitioned (sliced) tensor: reassembly unsupported —
            # the loader skips it (a consumer missing a required tensor
            # raises a KeyError naming it)
            ent["sliced"] = True
    return ent


def _parse_header(buf: bytes):
    """BundleHeaderProto: num_shards=1, endianness=2, version=3."""
    hdr = {"num_shards": 1, "endianness": 0}
    for field, _wire, val in _proto_fields(buf):
        if field == 1:
            hdr["num_shards"] = int(val)
        elif field == 2:
            hdr["endianness"] = int(val)
    return hdr


# ---------------------------------------------------------------------------
# snappy block decompression (format description in google/snappy
# format_description.txt; only needed if the table was compressed)
# ---------------------------------------------------------------------------

def _snappy_decompress(buf: bytes) -> bytes:
    out_len, pos = _uvarint(buf, 0)
    out = bytearray()
    n = len(buf)
    while pos < n:
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(buf[pos:pos + nb], "little")
                pos += nb
            ln += 1
            out += buf[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 7) + 4
            off = ((tag & 0xE0) << 3) | buf[pos]
            pos += 1
        elif kind == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(buf[pos:pos + 4], "little")
            pos += 4
        start = len(out) - off
        if start < 0:
            raise ValueError("snappy: bad copy offset")
        for _ in range(ln):  # may overlap itself: byte-at-a-time
            out.append(out[start])
            start += 1
    if len(out) != out_len:
        raise ValueError("snappy: length mismatch")
    return bytes(out)


# ---------------------------------------------------------------------------
# leveldb table (SSTable)
# ---------------------------------------------------------------------------

def _read_block(data: bytes, offset: int, size: int) -> bytes:
    """Block contents at a BlockHandle; the 5-byte trailer after it is
    1 compression byte + 4-byte masked crc32c (crc not verified — the
    bundle entries carry their own per-tensor crc32c)."""
    raw = data[offset:offset + size]
    comp = data[offset + size]
    if comp == 0:
        return raw
    if comp == 1:
        return _snappy_decompress(raw)
    raise NotImplementedError(f"block compression type {comp}")


def _block_entries(block: bytes):
    """Iterate (key, value) with leveldb prefix compression."""
    if len(block) < 4:
        return
    n_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    end = len(block) - 4 - 4 * n_restarts
    pos = 0
    key = b""
    while pos < end:
        shared, pos = _uvarint(block, pos)
        non_shared, pos = _uvarint(block, pos)
        vlen, pos = _uvarint(block, pos)
        key = key[:shared] + block[pos:pos + non_shared]
        pos += non_shared
        value = block[pos:pos + vlen]
        pos += vlen
        yield key, value


def _read_table(path: str):
    """All (key, value) pairs of a leveldb-format table file."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 48:
        raise ValueError(f"{path}: too short for an SSTable")
    footer = data[-48:]
    magic = struct.unpack_from("<Q", footer, 40)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad table magic {magic:#x}")
    pos = 0
    _meta_off, pos = _uvarint(footer, pos)
    _meta_sz, pos = _uvarint(footer, pos)
    idx_off, pos = _uvarint(footer, pos)
    idx_sz, pos = _uvarint(footer, pos)
    index = _read_block(data, idx_off, idx_sz)
    out = []
    for _last_key, handle in _block_entries(index):
        hpos = 0
        boff, hpos = _uvarint(handle, hpos)
        bsz, hpos = _uvarint(handle, hpos)
        out.extend(_block_entries(_read_block(data, boff, bsz)))
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _entries(prefix: str):
    idx = prefix + ".index"
    if not os.path.exists(idx):
        raise FileNotFoundError(idx)
    header = None
    tensors = {}
    for key, value in _read_table(idx):
        if key == b"":
            header = _parse_header(value)
        else:
            tensors[key.decode()] = _parse_entry(value)
    if header is None:
        # legal: single-shard bundles always write the header, but be
        # permissive for hand-built fixtures
        header = {"num_shards": 1, "endianness": 0}
    return header, tensors


def list_tensors(prefix: str):
    """{name: (numpy dtype, shape)} without reading tensor data."""
    _header, tensors = _entries(prefix)
    return {
        name: (_DTYPES.get(e["dtype"]), e["shape"])
        for name, e in tensors.items()
    }


def read_tensor_bundle(prefix: str):
    """Load every numeric tensor of the bundle as {name: np.ndarray}.

    Tensors with unsupported dtypes (DT_STRING bookkeeping variables
    etc.) are skipped rather than failing the whole restore — consumers
    like `clair_flat_from_tf` pick the numeric tensors they need by
    name and will raise a KeyError if a required one is missing."""
    header, tensors = _entries(prefix)
    if header["endianness"] != 0:
        raise NotImplementedError(
            "big-endian tensor bundle (BundleHeaderProto.endianness=1): "
            "decoding it as little-endian would silently scramble weights")
    ns = header["num_shards"]
    shard_paths = [f"{prefix}.data-{i:05d}-of-{ns:05d}" for i in range(ns)]
    shards = {}
    out = {}
    for name, ent in sorted(tensors.items()):
        dt = _DTYPES.get(ent["dtype"])
        if dt is None or ent["sliced"]:
            continue  # non-numeric bookkeeping variable / partitioned
        sid = ent["shard_id"]
        if sid not in shards:
            with open(shard_paths[sid], "rb") as f:
                shards[sid] = f.read()
        raw = shards[sid][ent["offset"]:ent["offset"] + ent["size"]]
        want = int(np.prod(ent["shape"], dtype=np.int64)) * dt.itemsize
        if len(raw) != want:
            raise ValueError(
                f"{name}: {len(raw)} data bytes, expected {want}")
        arr = np.frombuffer(raw, dt).reshape(ent["shape"])
        if ent["dtype"] == _DT_BFLOAT16:
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out
