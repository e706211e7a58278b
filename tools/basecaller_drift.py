"""How far the basecaller's bf16 forwards drift at the full config's depth.

For random weights as tests/torch_basecaller_cases.py's `calibrated_tree`
makes them for the tests, and the same with all its gains at 1 (BatchNorm
statistics calibrated either way), the same standard-normal chunks
go through the JAX package's `forward` (bf16 convs, XLA on the CPU), the
port's `Basecaller` (its plain versions on the CPU) and the same network in
float64 (torch, no rounding to bf16).  For each pair it prints the largest
posterior difference and the frame argmax agreement, the two numbers of the
JAX package's crosscheck bound (0.05, 0.98;
tests/test_fast5_and_weights.py:196-199).

    JAX_PLATFORMS=cpu python tools/basecaller_drift.py [--batch 2] [--samples 1200]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax                                                    # noqa: E402
import jax.numpy as jnp                                       # noqa: E402
import torch                                                  # noqa: E402

import genomicsbench_tpu.models.basecaller as J               # noqa: E402
import genomicsbench_tpu_torch.models.basecaller as T         # noqa: E402
from torch_basecaller_cases import calibrated_tree, float_forward  # noqa: E402


def compare(a, b):
    pa, pb = np.exp(np.asarray(a, np.float64)), np.exp(np.asarray(b, np.float64))
    return float(np.abs(pa - pb).max()), float((pa.argmax(-1) == pb.argmax(-1)).mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--samples", type=int, default=1_200)
    ap.add_argument("--seed", type=int, default=21)
    args = ap.parse_args(argv)
    cfg, jcfg = T.BasecallerConfig(), J.BasecallerConfig()
    x = np.random.default_rng(args.seed + 1).normal(
        size=(args.batch, args.samples)).astype(np.float32)
    jax_forward = jax.jit(J.forward, static_argnames=("cfg",))
    for what, gains in (("gains 1", dict(residual_gain=1.0, bn_gain=1.0, decoder_gain=1.0)),
                        ("the tests' gains", {})):
        tree = calibrated_tree(cfg, seed=args.seed, **gains)
        jx = np.asarray(jax_forward(jax.tree_util.tree_map(jnp.asarray, tree),
                                    jnp.asarray(x), jcfg))
        with torch.no_grad():
            port = T.build_model(T.params_from_jax(tree, cfg), cfg, "cpu")(
                torch.from_numpy(x)).numpy()
        exact = float_forward(tree, cfg, x, torch.float64).numpy()
        for name, (a, b) in (("JAX vs float64", (jx, exact)), ("port vs float64", (port, exact)),
                             ("port vs JAX", (port, jx))):
            err, agree = compare(a, b)
            print(f"{what}: {name}: posteriors max |diff| {err:.4f}, "
                  f"frame argmax agreement {agree:.4f} (B {args.batch}, T {args.samples})")


if __name__ == "__main__":
    main()
