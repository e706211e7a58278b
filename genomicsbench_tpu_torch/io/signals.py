"""Raw nanopore signals by read name (genomicsbench_tpu/cli.py:41-51
`_load_signals`)."""

from __future__ import annotations

import os

import numpy as np


def load_signals(path) -> dict:
    """{read name: raw signal} from an .npz of one array per read, or from a
    fast5 file or a directory of them (the reference's input format,
    run-gpu.sh:28,34; pA-scaled float32 signals keyed by read id).  fast5
    needs h5py: without it this raises RuntimeError."""
    if str(path).endswith(".npz"):
        with np.load(path) as z:
            return {name: z[name] for name in z.files}
    from genomicsbench_tpu_torch.io.fast5 import fast5_available, read_fast5, read_fast5_dir

    if not fast5_available():
        raise RuntimeError(f"{path}: fast5 input needs h5py, which is not installed; "
                           "convert the signals to an .npz of one array per read")
    reads = read_fast5_dir(path) if os.path.isdir(path) else list(read_fast5(path))
    return {r.read_id: r.signal for r in reads}
