"""Raw nanopore signals by read name (the `.npz` branch of
genomicsbench_tpu/cli.py:41-51 `_load_signals`)."""

from __future__ import annotations

import numpy as np


def load_signals(path) -> dict:
    """{read name: raw signal} from an .npz of one array per read.  fast5
    input (the reference's format) needs h5py and is not ported yet."""
    if not str(path).endswith(".npz"):
        raise NotImplementedError(
            f"{path}: only .npz signals are supported; fast5 input is not ported yet")
    with np.load(path) as z:
        return {name: z[name] for name in z.files}
