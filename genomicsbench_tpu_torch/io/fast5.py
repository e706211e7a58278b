"""fast5 (HDF5) raw nanopore signal reader: the port's copy of
genomicsbench_tpu/io/fast5.py (read_fast5, read_fast5_dir, write_fast5,
fast5_available).  h5py is imported inside the functions only, so the port
imports where h5py is missing.

Capability target: the reference's fast5 ingest — f5c's fast5lite.h
(HDF5 Raw/Reads/Read_*/Signal + channel_id scaling attributes) and
bonito's ont-fast5-api usage (basecall.py:343-364: signal =
scaling * (raw + offset), scaling = range / digitisation).

Supports both layouts:
* single-read: /Raw/Reads/Read_<n>/Signal with
  /UniqueGlobalKey/channel_id attributes
* multi-read:  /read_<uuid>/Raw/Signal with per-read channel_id group

Reading and writing need h5py; callers gate on `fast5_available()`.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np


def fast5_available() -> bool:
    try:
        import h5py  # noqa: F401

        return True
    except ImportError:
        return False


@dataclasses.dataclass
class Fast5Read:
    read_id: str
    signal: np.ndarray  # float32, pA-scaled
    raw: np.ndarray  # int16 DAC values
    digitisation: float
    offset: float
    range: float
    sample_rate: float


def _scale(raw, dig, off, rng):
    scaling = rng / dig
    return (scaling * (raw.astype(np.float32) + off)).astype(np.float32)


def _attr(grp, name, default=0.0):
    v = grp.attrs.get(name, default)
    return float(v)


def read_fast5(path):
    """Yield Fast5Read for every read in a fast5 file."""
    import h5py

    with h5py.File(path, "r") as f:
        if "Raw" in f:  # single-read layout
            ch = f["UniqueGlobalKey/channel_id"]
            dig, off = _attr(ch, "digitisation", 8192.0), _attr(ch, "offset", 0.0)
            rng, sr = _attr(ch, "range", 1400.0), _attr(ch, "sampling_rate", 4000.0)
            for name, grp in f["Raw/Reads"].items():
                raw = np.asarray(grp["Signal"], np.int16)
                rid = grp.attrs.get("read_id", name)
                rid = rid.decode() if isinstance(rid, bytes) else str(rid)
                yield Fast5Read(rid, _scale(raw, dig, off, rng), raw, dig, off, rng, sr)
        else:  # multi-read layout
            for name in f:
                if not name.startswith("read"):
                    continue
                grp = f[name]
                ch = grp["channel_id"]
                dig, off = _attr(ch, "digitisation", 8192.0), _attr(ch, "offset", 0.0)
                rng, sr = _attr(ch, "range", 1400.0), _attr(ch, "sampling_rate", 4000.0)
                raw = np.asarray(grp["Raw/Signal"], np.int16)
                rid = grp.attrs.get("read_id", name.replace("read_", ""))
                rid = rid.decode() if isinstance(rid, bytes) else str(rid)
                yield Fast5Read(rid, _scale(raw, dig, off, rng), raw, dig, off, rng, sr)


def read_fast5_dir(directory, limit=None):
    """All reads from every .fast5 under a directory (the reference
    benchmarks take fast5 dirs: run-gpu.sh:28,34)."""
    out = []
    for p in sorted(pathlib.Path(directory).glob("**/*.fast5")):
        for r in read_fast5(p):
            out.append(r)
            if limit and len(out) >= limit:
                return out
    return out


def write_fast5(path, reads, multi=True):
    """Write reads (id -> int16 raw or (raw, attrs)) in multi-read layout —
    used for fixtures/tests."""
    import h5py

    with h5py.File(path, "w") as f:
        for rid, raw in reads.items():
            attrs = dict(digitisation=8192.0, offset=0.0, range=1400.0, sampling_rate=4000.0)
            if isinstance(raw, tuple):
                raw, extra = raw
                attrs.update(extra)
            g = f.create_group(f"read_{rid}")
            g.attrs["read_id"] = rid
            g.create_dataset("Raw/Signal", data=np.asarray(raw, np.int16))
            ch = g.create_group("channel_id")
            for k, v in attrs.items():
                ch.attrs[k] = v
