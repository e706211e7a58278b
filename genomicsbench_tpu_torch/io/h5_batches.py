"""HDF5 mini-batch I/O for the nn-variant workload.

A copy of genomicsbench_tpu/io/h5_batches.py (`write_batches` :17,
`read_batches` :30).  The reference (benchmarks/nn-variant/prediction.py:
14-16) loads deepdish-written HDF5 files holding a list of mini-batches,
each an (X, position-array) pair with X of shape (batch, 33, 8, 4).
deepdish serialises a python list as groups 'data'/'i0', 'i1', ... with
each tuple element under 'i0/i0', 'i0/i1' (pytables layout); both that
layout and a plain {batch_00000/X, ...} layout are read, and the plain
layout is written.

h5py is imported inside the functions, so the port imports where h5py is
missing; there a call raises ImportError naming the package, and nothing
else is tried.
"""

from __future__ import annotations

import numpy as np


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("nn-variant's HDF5 mini-batches need the h5py package, which is "
                          "not installed") from e
    return h5py


def write_batches(path: str, batches):
    """Write a list of X arrays (or (X, aux) tuples) to HDF5."""
    h5py = _h5py()
    with h5py.File(path, "w") as f:
        for i, b in enumerate(batches):
            x = b[0] if isinstance(b, (tuple, list)) else b
            g = f.create_group(f"batch_{i:05d}")
            g.create_dataset("X", data=np.asarray(x))
            if isinstance(b, (tuple, list)) and len(b) > 1:
                g.create_dataset("aux", data=np.asarray(b[1]))


def read_batches(path: str):
    """Read mini-batches; returns a list of (X, aux or None)."""
    h5py = _h5py()
    out = []
    with h5py.File(path, "r") as f:
        if "data" in f:  # deepdish/pytables list layout
            data = f["data"]
            for key in sorted(data.keys()):
                item = data[key]
                if hasattr(item, "keys"):
                    sub = sorted(item.keys())
                    x = np.asarray(item[sub[0]])
                    aux = np.asarray(item[sub[1]]) if len(sub) > 1 else None
                else:
                    x, aux = np.asarray(item), None
                out.append((x, aux))
        else:
            for key in sorted(f.keys()):
                g = f[key]
                aux = np.asarray(g["aux"]) if "aux" in g else None
                out.append((np.asarray(g["X"]), aux))
    return out
