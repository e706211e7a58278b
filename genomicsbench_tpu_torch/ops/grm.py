"""Genetic relationship matrix (plink2 --make-grm-bin, the grm workload) in
PyTorch.

The port of genomicsbench_tpu/ops/grm.py: the GCTA relationship matrix over
standardised dosages,

    x_ij = (g_ij - 2 p_j) / sqrt(2 p_j (1 - p_j)),  missing -> 0
    GRM_ik = (1 / M_ik) * sum_j x_ij x_kj
    M_ik   = #variants observed in both i and k

over the variants that pass the MAF filter on observed allele frequencies.

Device part, as the JAX package's `_grm_scan` and `_grm_tril` compute it:
two functions, each with its hand-written kernel in `csrc/grm.cu` (CUDA
tensors) and its plain PyTorch version (CPU tensors), with the products
between them on cuBLAS:

* `grm_standardize` (gb_grm_standardize): one block of 2-bit packed
  variants to the standardised dosages x and the observed mask w, (Mb, Nb)
  f32 each (`_grm_block_body`'s elementwise part, :29-48 and :56).  The
  kernel and the plain version agree bit for bit: the same f32 operations
  in the same order, no FMA;
* the products `num += x^T x` and `den += w^T w`: `torch.addmm_` in full
  f32 with TF32 off (`full_f32_matmul`), accumulated over blocks of variants
  as the JAX package's scan does, so no x plane outgrows one block;
* `grm_finish` (gb_grm_finish): `num / max(den, 1)` and `den` gathered into
  the row-major lower triangle (`_grm_tril`, :89), fetched in one
  page-locked copy and mirrored on the host as the JAX package does.

The MAF filter stays the host's float64 test (the JAX package's
grm.py:103-108): a variant whose p sits exactly on the threshold, one het
among 50 observed samples at maf 0.01, would flip under an f32 test.

The workload has no weights: genotypes cross from the JAX package as the
(M, N) uint8 arrays of io/plink.py (0/1/2 dosage, 3 missing) and the
sample ids as strings, so nothing converts between the packages.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from genomicsbench_tpu_torch import resolve_device
from genomicsbench_tpu_torch._kernels import check_device as _check_device
from genomicsbench_tpu_torch._kernels import check_tensor as _check
from genomicsbench_tpu_torch._kernels import launch as _launch

BLOCK = 2048                # variants per standardise launch (the JAX package's block)
SAMPLE_PAD = 128            # samples padded to a multiple of this, all missing
_U8, _F32 = torch.uint8, torch.float32


@contextlib.contextmanager
def full_f32_matmul():
    """cuBLAS f32 products in full f32 inside the block: TF32 off, through
    the one global setter that keeps PyTorch's legacy and per-backend
    precision flags consistent (torch 2.9 and later refuse to read a mix
    of the two), and the caller's setting restored on the way out."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise RuntimeError("TF32 is still on for float32 products")
        yield
    finally:
        torch.set_float32_matmul_precision(old)


# ------------------------------------------------------------- host prep
def maf_filter(geno: np.ndarray, maf: float) -> np.ndarray:
    """(M,) bool: the variants whose observed minor allele frequency, in
    float64, is at least `maf` and that have an observed sample (JAX
    grm.py:103-108)."""
    miss = geno == 3
    n_obs = (~miss).sum(1)
    alt = np.where(miss, 0, geno).sum(1)
    p = alt / np.maximum(2 * n_obs, 1)
    return (np.minimum(p, 1 - p) >= maf) & (n_obs > 0)


def pack_genotypes(geno: np.ndarray) -> np.ndarray:
    """(M, N) dosage codes to (M, Nb / 4) uint8, four 2-bit codes a byte,
    LSB first, the samples padded to Nb, a multiple of SAMPLE_PAD, with
    code 3 (missing)."""
    M, N = geno.shape
    Nb = -(-max(N, 1) // SAMPLE_PAD) * SAMPLE_PAD
    pad = np.full((M, Nb), 3, np.uint8)
    pad[:, :N] = geno
    q = pad.reshape(M, Nb // 4, 4)
    return (q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)).astype(np.uint8)


# ------------------------------------------------------------ standardise
def _check_standardize(packed, maf_ok):
    _check("packed", packed, _U8, 2)
    _check("maf_ok", maf_ok, torch.bool, 1)
    _check_device(packed.device, maf_ok)
    if maf_ok.shape[0] != packed.shape[0]:
        raise ValueError(f"maf_ok has {maf_ok.shape[0]} variants, packed {packed.shape[0]}")
    if not 1 <= packed.shape[1] < 1 << 28:
        raise ValueError(f"packed rows must hold 1 to 2^28 - 1 bytes, got {packed.shape[1]}")


def grm_standardize_reference(packed: torch.Tensor, maf_ok: torch.Tensor):
    """The plain version of gb_grm_standardize: `_grm_block_body`'s
    elementwise part, one torch op per rounding, in its order."""
    Mb = packed.shape[0]
    codes = torch.stack([(packed >> (2 * lane)) & 3 for lane in range(4)], dim=2).reshape(Mb, -1)
    miss = codes == 3
    obs = (~miss).to(_F32)
    g = torch.where(miss, 0, codes).to(_F32)
    n_obs = obs.sum(1)
    p = g.sum(1) / torch.clamp(2.0 * n_obs, min=1.0)
    denom = torch.sqrt(torch.clamp(2.0 * p * (1.0 - p), min=1e-30))
    x = (g - 2.0 * p[:, None]) / denom[:, None]
    use = (maf_ok & (n_obs > 0))[:, None].to(_F32)
    return x * use * obs, obs * use


def grm_standardize(packed: torch.Tensor, maf_ok: torch.Tensor):
    """packed (Mb, Nb / 4) uint8 and maf_ok (Mb,) bool to x and w, (Mb, Nb)
    f32 each.  Checks its inputs on the host before any build or launch;
    CPU tensors take the plain version, CUDA tensors one launch on the
    current stream, without synchronising."""
    _check_standardize(packed, maf_ok)
    if packed.device.type == "cpu":
        return grm_standardize_reference(packed, maf_ok)
    Mb, nbytes = packed.shape
    x = torch.empty(Mb, 4 * nbytes, dtype=_F32, device=packed.device)
    w = torch.empty_like(x)
    if Mb:
        _launch(packed.device, "gb_grm_standardize", packed.data_ptr(), maf_ok.data_ptr(), Mb,
                nbytes, x.data_ptr(), w.data_ptr())
        grm_standardize.launches += 1
    return x, w


grm_standardize.launches = 0    # kernel launches, counted where they happen


# ----------------------------------------------------------------- finish
def _check_finish(num, den, N):
    _check("num", num, _F32, 2)
    _check("den", den, _F32, 2)
    _check_device(num.device, den)
    if num.shape != den.shape or num.shape[0] != num.shape[1]:
        raise ValueError(f"num and den must be one square shape, got {tuple(num.shape)} and "
                         f"{tuple(den.shape)}")
    if not 0 <= N <= num.shape[0]:
        raise ValueError(f"N must lie in 0..{num.shape[0]}, got {N}")


def grm_finish_reference(num: torch.Tensor, den: torch.Tensor, N: int) -> torch.Tensor:
    """The plain version of gb_grm_finish: the divided and the count planes'
    lower triangles, row-major, as one (2, N (N + 1) / 2) f32 tensor."""
    lower = torch.ones(N, N, dtype=torch.bool, device=num.device).tril()
    d = den[:N, :N]
    return torch.stack([(num[:N, :N] / torch.clamp(d, min=1.0))[lower], d[lower]])


def grm_finish(num: torch.Tensor, den: torch.Tensor, N: int) -> torch.Tensor:
    """num and den (Nb, Nb) f32, the accumulated products, to (2, N (N + 1)
    / 2) f32: row 0 the relationship entries num / max(den, 1), row 1 the
    pair counts, each in the row-major lower-triangle order of .grm.bin.
    CPU tensors take the plain version, CUDA tensors one launch."""
    _check_finish(num, den, N)
    if num.device.type == "cpu":
        return grm_finish_reference(num, den, N)
    out = torch.empty(2, N * (N + 1) // 2, dtype=_F32, device=num.device)
    if N:
        _launch(num.device, "gb_grm_finish", num.data_ptr(), den.data_ptr(), num.shape[1], N,
                out.data_ptr())
        grm_finish.launches += 1
    return out


grm_finish.launches = 0


# ------------------------------------------------------------ entry point
def grm(geno: np.ndarray, maf: float = 0.01, block: int = BLOCK, device="cuda", stats=None):
    """geno (M, N) uint8: 0/1/2 dosage of the counted allele, 3 = missing.

    Returns (grm (N, N) float32, nobs (N, N) float32), numpy, symmetric,
    mirrored from the lower triangle as the JAX package's `grm` does.  On
    `cuda` (the default) the kernels run on the card; `cpu` takes their
    plain versions.  With a dict as `stats`, each stage is waited for and
    its seconds stored under filter_pack, upload, standardize, products,
    finish, fetch and mirror."""
    dev = resolve_device(device)
    geno = np.asarray(geno)
    if geno.ndim != 2 or geno.dtype != np.uint8:
        raise ValueError(f"geno must be an (M, N) uint8 array, got {geno.dtype} {geno.shape}")
    if block < 1:
        raise ValueError(f"block must be positive, got {block}")
    M, N = geno.shape
    cuda = dev.type == "cuda"
    clock = time.perf_counter
    stamp = [clock()]

    def lap(name):
        if stats is not None:
            if cuda:
                torch.cuda.synchronize(dev)
            now = clock()
            stats[name] = stats.get(name, 0.0) + now - stamp[0]
            stamp[0] = now

    maf_ok = maf_filter(geno, maf)
    packed = pack_genotypes(geno)
    Nb = packed.shape[1] * 4
    lap("filter_pack")
    pk = torch.from_numpy(packed).to(dev)
    ok = torch.from_numpy(maf_ok).to(dev)
    num = torch.zeros(Nb, Nb, dtype=_F32, device=dev)
    den = torch.zeros(Nb, Nb, dtype=_F32, device=dev)
    lap("upload")
    with full_f32_matmul():
        for s in range(0, M, block):
            x, w = grm_standardize(pk[s:s + block], ok[s:s + block])
            lap("standardize")
            num.addmm_(x.T, x)
            den.addmm_(w.T, w)
            lap("products")
    tri = grm_finish(num, den, N)
    lap("finish")
    if cuda:
        host = torch.empty(tri.shape, dtype=_F32, pin_memory=True)
        host.copy_(tri, non_blocking=True)
        torch.cuda.synchronize(dev)
        tri = host
    tri_o, tri_d = tri.numpy()
    lap("fetch")
    rr, cc = np.tril_indices(N)
    out = np.zeros((N, N), np.float32)
    nobs = np.zeros((N, N), np.float32)
    out[rr, cc] = tri_o
    out[cc, rr] = tri_o
    nobs[rr, cc] = tri_d
    nobs[cc, rr] = tri_d
    lap("mirror")
    return out, nobs


def write_grm_bin(prefix: str, grm_mat: np.ndarray, nobs: np.ndarray, ids):
    """plink --make-grm-bin output files: lower triangle row-major float32
    (.grm.bin), pair counts (.grm.N.bin), sample ids (.grm.id)."""
    N = grm_mat.shape[0]
    tri = np.concatenate(
        [grm_mat[i, : i + 1] for i in range(N)]
    ).astype("<f4")
    trin = np.concatenate(
        [nobs[i, : i + 1] for i in range(N)]
    ).astype("<f4")
    tri.tofile(prefix + ".grm.bin")
    trin.tofile(prefix + ".grm.N.bin")
    with open(prefix + ".grm.id", "w") as f:
        for s in ids:
            f.write(f"{s}\t{s}\n")
