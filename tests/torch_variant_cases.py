"""Inputs of the nn-variant port's tests and of chip_smoke.py's nn-variant
phases.

Plain numpy and the port's constants: nothing here imports JAX, so the
card's tests and chip_smoke.py take these too.

* `jax_tree`: a Clair parameter tree in the JAX package's layout ({layer:
  {name: array}}, float32), drawn with numpy from a seed with the JAX
  init's std but nonzero biases, so that both packages can be handed the
  same weights (the port through `params_from_jax`, JAX as it is).
* `normal_inputs`: rng.normal float32 tensors (B, 33, 8, 4), which
  `_narrow_transport` ships as float32.
* `count_inputs`: integral pileup counts as the reference ships them,
  float32 holding integers: base counts in channel 0 and count deltas in
  channels 1-3 (clair/plot_tensor.py:65-68), in int8 range (`wide=False`)
  or past it (`wide=True`, int16 transport).
* `main_batches`: the chip's main path: `n_batches` mini-batches of
  `batch` tensors of int8-range counts (seed 0), float32 as the h5 files
  hold them; the reference's batch is 1,000 (param.py:16), and 263 of them
  (263,000 samples) are run.
* The TF V2 tensor-bundle encoder of tests/test_tf_checkpoint.py
  (:24-145, the leveldb table and BundleEntryProto writers, and :223-256,
  the Clair tree to TF variables), copied so that no file of the card's
  imports JAX: `write_bundle`, `write_table`, `entry_proto`,
  `tree_to_tf_bundle`.
"""

from __future__ import annotations

import struct

import numpy as np

from genomicsbench_tpu_torch.models.variant_caller import (HEAD_NAMES, _TF_HEAD_VARS,
                                                           ClairConfig, flat_shapes)

# mini-batches in the chip's main path: BASELINE.md:87's 10^6 samples cut to
# 263,000 (four 65,536-sample slabs and a part), for chip_smoke.py's time
# limit: at 10^6 its two nn-variant phases took 92 s
MAIN_BATCHES = 263
MAIN_BATCH = 1_000          # tensors a mini-batch (param.py:16)
MAIN_SEED = 0


def jax_tree(cfg: ClairConfig, seed: int, bias_std: float = 0.1) -> dict:
    """{layer: {name: float32 array}} with JAX's shapes and init std
    (`_init_params_impl`), biases drawn at `bias_std`."""
    rng = np.random.default_rng(seed)
    tree: dict = {}
    for path, shape in flat_shapes(cfg).items():
        layer, name = path.split("/")
        if name == "b":
            std = bias_std
        elif layer.startswith("lstm"):
            std = (1.0 / (shape[0] if name == "wx" else cfg.lstm_units)) ** 0.5
        elif layer == "l3":
            std = (2.0 / cfg.seq_len) ** 0.5
        else:
            std = (2.0 / shape[0]) ** 0.5
        tree.setdefault(layer, {})[name] = (rng.standard_normal(shape) * std).astype(np.float32)
    return tree


def normal_inputs(rng, b: int, cfg: ClairConfig) -> np.ndarray:
    return rng.normal(size=(b, cfg.seq_len, cfg.rows, cfg.channels)).astype(np.float32)


def count_inputs(rng, b: int, cfg: ClairConfig, wide: bool = False) -> np.ndarray:
    """Integral counts, float32: channel 0 base counts 0-60 (0-400 wide),
    channels 1-3 deltas -20..20 (-300..300 wide)."""
    top, d = (400, 300) if wide else (60, 20)
    base = rng.integers(0, top + 1, (b, cfg.seq_len, cfg.rows, 1), dtype=np.int16)
    delta = rng.integers(-d, d + 1, (b, cfg.seq_len, cfg.rows, cfg.channels - 1),
                         dtype=np.int16)
    return np.concatenate([base, delta], axis=-1).astype(np.float32)


def main_batches(n_batches: int = MAIN_BATCHES, batch: int = MAIN_BATCH,
                 seed: int = MAIN_SEED, cfg: ClairConfig = ClairConfig()):
    """The main path's mini-batches: int8-range counts drawn as int8 in one
    array, then each batch widened to float32."""
    rng = np.random.default_rng(seed)
    shape = (n_batches * batch, cfg.seq_len, cfg.rows)
    counts = np.empty(shape + (cfg.channels,), np.int8)
    counts[..., 0] = rng.integers(0, 61, shape, dtype=np.int8)
    counts[..., 1:] = rng.integers(-20, 21, shape + (cfg.channels - 1,), dtype=np.int8)
    return [counts[i * batch:(i + 1) * batch].astype(np.float32) for i in range(n_batches)]


# ------------------------------------------------------------------------
# TF V2 tensor-bundle encoder (copied from tests/test_tf_checkpoint.py)
# ------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _leveldb_block(entries, restart_interval=4) -> bytes:
    """entries: sorted [(key bytes, value bytes)]; shared-prefix coding
    with a restart point every `restart_interval` entries."""
    out = bytearray()
    restarts = []
    prev = b""
    for i, (key, val) in enumerate(entries):
        if i % restart_interval == 0:
            restarts.append(len(out))
            shared = 0
        else:
            shared = 0
            while (shared < len(prev) and shared < len(key)
                   and prev[shared] == key[shared]):
                shared += 1
        out += _varint(shared) + _varint(len(key) - shared) + _varint(len(val))
        out += key[shared:] + val
        prev = key
    for r in restarts:
        out += struct.pack("<I", r)
    out += struct.pack("<I", len(restarts))
    return bytes(out)


def write_table(path, entries, block_size=2, compress=False, restart_interval=4):
    """leveldb table: data blocks of `block_size` entries, an index block
    of last-key -> BlockHandle, an (empty) metaindex block, footer."""
    blob = bytearray()

    def emit_block(block: bytes):
        payload, ctype = (_snappy_compress(block), 1) if compress else (block, 0)
        off = len(blob)
        blob.extend(payload)
        blob.append(ctype)
        blob.extend(b"\x00\x00\x00\x00")  # crc (unverified by the reader)
        return _varint(off) + _varint(len(payload))

    index_entries = []
    for i in range(0, len(entries), block_size):
        chunk = entries[i:i + block_size]
        handle = emit_block(_leveldb_block(chunk, restart_interval))
        index_entries.append((chunk[-1][0], handle))
    meta_handle = emit_block(_leveldb_block([]))
    index_handle = emit_block(_leveldb_block(index_entries))
    footer = meta_handle + index_handle
    footer += b"\x00" * (40 - len(footer))
    footer += struct.pack("<Q", 0xDB4775248B80FB57)
    blob.extend(footer)
    with open(path, "wb") as f:
        f.write(blob)


def _snappy_compress(data: bytes) -> bytes:
    """All-literal snappy stream (valid, uncompressed-size encoding)."""
    out = bytearray(_varint(len(data)))
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + 60]
        out.append((len(chunk) - 1) << 2)  # literal tag, len <= 60
        out += chunk
        pos += len(chunk)
    return bytes(out)


_TF_DTYPE = {np.dtype("float32"): 1, np.dtype("float64"): 2,
             np.dtype("int32"): 3, np.dtype("int64"): 9}


def entry_proto(arr: np.ndarray, shard, offset) -> bytes:
    shape = b""
    for d in arr.shape:
        dim = b"\x08" + _varint(d)          # Dim.size = 1
        shape += b"\x12" + _varint(len(dim)) + dim  # TensorShapeProto.dim = 2
    out = b"\x08" + _varint(_TF_DTYPE[arr.dtype])   # dtype = 1
    out += b"\x12" + _varint(len(shape)) + shape    # shape = 2
    if shard:
        out += b"\x18" + _varint(shard)             # shard_id = 3
    if offset:
        out += b"\x20" + _varint(offset)            # offset = 4
    out += b"\x28" + _varint(arr.nbytes)            # size = 5
    return out


def write_bundle(prefix, tensors: dict, compress=False, block_size=2):
    """tensors: {name: np.ndarray}; single-shard TF V2 checkpoint."""
    data = bytearray()
    entries = [(b"", b"\x08" + _varint(1))]  # header: num_shards = 1
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        entries.append((name.encode(), entry_proto(arr, 0, len(data))))
        data += arr.tobytes()
    write_table(prefix + ".index", entries, block_size=block_size, compress=compress)
    with open(prefix + ".data-00000-of-00001", "wb") as f:
        f.write(bytes(data))


def tree_to_tf_bundle(tree: dict, cfg: ClairConfig) -> dict:
    """A JAX-layout tree as Clair's TF variables (the inverse of the
    converter, from TF's documented layout): fused kernel rows [inputs;
    recurrent], gate blocks (i, j, f, o)."""
    H = cfg.lstm_units
    inv = np.concatenate([  # ours (i,f,g,o) -> TF (i,j,f,o)
        np.arange(0, H), np.arange(2 * H, 3 * H),
        np.arange(H, 2 * H), np.arange(3 * H, 4 * H)])
    bundle = {}
    for li, scope in ((1, "LSTM1"), (2, "LSTM2")):
        for d in ("fw", "bw"):
            p = tree[f"lstm{li}_{d}"]
            k = np.concatenate([np.asarray(p["wx"]), np.asarray(p["wh"])])
            base = (f"{scope}/stack_bidirectional_rnn/cell_0/"
                    f"bidirectional_rnn/{d}/cudnn_compatible_lstm_cell")
            bundle[f"{base}/kernel"] = k[:, inv]
            bundle[f"{base}/bias"] = np.asarray(p["b"])[inv]
    w3, b3 = np.asarray(tree["l3"]["w"]), np.asarray(tree["l3"]["b"])
    for i in range(2 * H):
        bundle[f"L3/Unit_{i}/kernel"] = w3[i]
        bundle[f"L3/Unit_{i}/bias"] = b3[i]
    bundle["L4/kernel"] = np.asarray(tree["l4"]["w"])
    bundle["L4/bias"] = np.asarray(tree["l4"]["b"])
    for i, name in enumerate(HEAD_NAMES):
        bundle[f"L5_{i+1}/kernel"] = np.asarray(tree[f"l5_{name}"]["w"])
        bundle[f"L5_{i+1}/bias"] = np.asarray(tree[f"l5_{name}"]["b"])
        bundle[f"Prediction/{_TF_HEAD_VARS[i]}/kernel"] = np.asarray(tree[f"head_{name}"]["w"])
        bundle[f"Prediction/{_TF_HEAD_VARS[i]}/bias"] = np.asarray(tree[f"head_{name}"]["b"])
    return bundle
