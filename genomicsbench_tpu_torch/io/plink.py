"""plink genotype input (.bed / .pgen) for the grm pipeline.

The port's copy of genomicsbench_tpu/io/plink.py, numpy only and unchanged
in what it reads and writes: the two packages hand genotypes to each other
as these (M, N) uint8 arrays and the sample ids as strings, so nothing
converts between them.

The reference invokes plink2 on .pgen (run-cpu.sh:53); this loader covers
the plink1 .bed layout (which plink2 also consumes), the fixed-width
uncompressed .pgen subtype (mode 0x02), and the standard variable-width
modes 0x10/0x11 that real-world phase3 files use (difflist / LD /
1-bit-compressed variant records; see _read_pgen_standard for the record
grammar).  Genotypes come out as (M variants, N samples) uint8 with
0/1/2 = ALT dosage and 3 = missing.
"""

from __future__ import annotations

import numpy as np

# .bed 2-bit codes (variant-major): 0=hom A1(alt*2), 1=missing, 2=het, 3=hom A2
_BED_TO_DOSAGE = np.array([2, 3, 1, 0], dtype=np.uint8)


def read_bed(prefix: str, n_samples: int | None = None, n_variants: int | None = None):
    """Read plink1 .bed(+.fam/.bim for dimensions).  Returns (geno, ids)."""
    if n_samples is None:
        with open(prefix + ".fam") as f:
            ids = [line.split()[1] for line in f if line.strip()]
        n_samples = len(ids)
    else:
        ids = [f"S{i}" for i in range(n_samples)]
    if n_variants is None:
        with open(prefix + ".bim") as f:
            n_variants = sum(1 for line in f if line.strip())
    raw = np.fromfile(prefix + ".bed", dtype=np.uint8)
    assert raw[0] == 0x6C and raw[1] == 0x1B, "not a .bed file"
    assert raw[2] == 0x01, "only variant-major .bed supported"
    body = raw[3:]
    bpv = -(-n_samples // 4)
    body = body[: n_variants * bpv].reshape(n_variants, bpv)
    # unpack 2-bit codes, little-endian within byte
    codes = np.zeros((n_variants, bpv * 4), np.uint8)
    for k in range(4):
        codes[:, k::4] = (body >> (2 * k)) & 3
    return _BED_TO_DOSAGE[codes[:, :n_samples]], ids


def write_bed(prefix: str, geno: np.ndarray, ids=None):
    """geno (M, N) uint8 dosage codes (3 = missing) -> .bed/.bim/.fam."""
    inv = np.array([3, 2, 0, 1], dtype=np.uint8)  # dosage -> bed code
    M, N = geno.shape
    bpv = -(-N // 4)
    codes = np.ones((M, bpv * 4), np.uint8)  # pad slots = bed 01 = missing
    codes[:, :N] = inv[geno]
    body = np.zeros((M, bpv), np.uint8)
    for k in range(4):
        body |= (codes[:, k::4] & 3) << (2 * k)
    with open(prefix + ".bed", "wb") as f:
        f.write(bytes([0x6C, 0x1B, 0x01]))
        f.write(body.tobytes())
    if ids is None:
        ids = [f"S{i}" for i in range(N)]
    with open(prefix + ".fam", "w") as f:
        for s in ids:
            f.write(f"{s} {s} 0 0 0 -9\n")
    with open(prefix + ".bim", "w") as f:
        for j in range(M):
            f.write(f"1\tv{j}\t0\t{j+1}\tA\tC\n")


# ---------------------------------------------------------------------------
# plink2 .pgen / .pvar / .psam (the canonical grm invocation consumes
# chrN_phase3.pgen — run-cpu.sh:53,84)
# ---------------------------------------------------------------------------

def read_psam(path: str):
    """Sample IDs from .psam (header #FID/#IID; IID column)."""
    ids = []
    iid_col = 0
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            if line.startswith("#"):
                cols = line[1:].split("\t") if "\t" in line else line[1:].split()
                iid_col = cols.index("IID") if "IID" in cols else 0
                continue
            toks = line.split()
            ids.append(toks[iid_col])
    return ids


def read_pvar(path: str):
    """Variant IDs from .pvar (skips ## metadata and the #CHROM header)."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip() or line.startswith("#"):
                continue
            toks = line.split()
            out.append(toks[2] if len(toks) > 2 else toks[0])
    return out


def read_pgen(prefix: str):
    """Read a .pgen(+.pvar/.psam) genotype matrix.

    Supported storage modes: 0x01 (embedded plink1 variant-major .bed
    payload), 0x02 (PLINK 2 fixed-width unphased hardcalls, 2-bit codes
    0/1/2 = ALT dosage, 3 = missing), and the standard variable-width
    modes 0x10/0x11 (per-variant record types: dense 2-bit, difflist,
    LD-compressed, 1-bit; see _read_pgen_standard).  Returns
    (geno (M, N) uint8 dosages with 3 = missing, sample ids)."""
    import struct

    ids = read_psam(prefix + ".psam")
    n_samples = len(ids)
    n_variants = len(read_pvar(prefix + ".pvar"))
    raw = np.fromfile(prefix + ".pgen", dtype=np.uint8)
    assert raw[0] == 0x6C and raw[1] == 0x1B, "not a .pgen file"
    mode = raw[2]
    if mode == 0x01:
        body = raw[3:]
        bpv = -(-n_samples // 4)
        body = body[: n_variants * bpv].reshape(n_variants, bpv)
        codes = np.zeros((n_variants, bpv * 4), np.uint8)
        for k in range(4):
            codes[:, k::4] = (body >> (2 * k)) & 3
        return _BED_TO_DOSAGE[codes[:, :n_samples]], ids
    if mode == 0x02:
        vc, sc = struct.unpack_from("<II", raw.tobytes(), 3)
        assert vc == n_variants, f".pvar has {n_variants} variants, header {vc}"
        assert sc == n_samples, f".psam has {n_samples} samples, header {sc}"
        body = raw[11:]
        bpv = -(-n_samples // 4)
        body = body[: n_variants * bpv].reshape(n_variants, bpv)
        codes = np.zeros((n_variants, bpv * 4), np.uint8)
        for k in range(4):
            codes[:, k::4] = (body >> (2 * k)) & 3
        return codes[:, :n_samples].copy(), ids  # pgen codes ARE alt dosages
    if mode in (0x10, 0x11):
        return _read_pgen_standard(raw, n_variants, n_samples), ids
    raise NotImplementedError(
        f".pgen storage mode 0x{mode:02x} is not supported; re-encode with "
        "plink2 --make-pgen 'format=fixed'"
    )


# ---------------------------------------------------------------------------
# Standard variable-width .pgen (modes 0x10/0x11) — the storage the canonical
# chrN_phase3.pgen inputs use (run-cpu.sh:53,84).  Layout per the PGEN file
# format specification (plink-ng pgen_spec; submodule is empty in the
# reference snapshot, so this is built from the published spec):
#
#   header:  magic 6C 1B | mode | u32 variant_ct | u32 sample_ct |
#            control byte: bits 0-3 = vrtype/record-length widths
#            (values 0-3: 4-bit vrtypes, (v&3)+1-byte lengths; 4-7: 8-bit
#            vrtypes), bits 4-5 = allele-count width (0 = absent),
#            bits 6-7 = nonref-flag storage (3 = explicit bitarray)
#   then:    u64 file offset of the first variant record of each 2^16-variant
#            block; then per block: packed vrtypes, record lengths,
#            [allele counts], [nonref flags]
#   records: main hardcall track first (phase/dosage tracks, flagged by
#            vrtype bits 3+, follow it and are skipped — hardcalls only)
#
# vrtype low 3 bits select the main-track encoding:
#   0       dense 2-bit, LSB-first within byte (plink order)
#   1       1-bit: common2 byte (two most frequent genotypes), ceil(N/8)
#           selector bits, then a difflist of the remaining samples
#   2 / 3   LD: difflist of differences vs the most recent non-LD variant
#           (3 = that base complemented: dosage 0 <-> 2)
#   4..7    difflist over a constant base genotype (vrtype & 3)
#
# A difflist = vint length | raw sample id per 64-entry group
# (sample_id_byte_ct bytes each) | vint deltas for within-group entries |
# packed 2-bit genotype values.  vint = LEB128 (7 data bits/byte).
# ---------------------------------------------------------------------------

_GROUP = 64  # difflist group size (spec: sample ids stored raw every 64 entries)


def _sample_id_byte_ct(n_samples: int) -> int:
    return max(1, (int(n_samples).bit_length() + 7) // 8)


def _read_vint(buf, pos):
    val = 0
    shift = 0
    while True:
        b = int(buf[pos])
        pos += 1
        val |= (b & 0x7F) << shift
        if not (b & 0x80):
            return val, pos
        shift += 7


def _write_vint(val: int) -> bytes:
    out = bytearray()
    while True:
        b = val & 0x7F
        val >>= 7
        if val:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _unpack2(packed: np.ndarray, n: int) -> np.ndarray:
    codes = np.empty(len(packed) * 4, np.uint8)
    for k in range(4):
        codes[k::4] = (packed >> (2 * k)) & 3
    return codes[:n]


def _pack2(vals: np.ndarray) -> bytes:
    n = len(vals)
    full = np.zeros(-(-n // 4) * 4, np.uint8)
    full[:n] = vals
    out = np.zeros(len(full) // 4, np.uint8)
    for k in range(4):
        out |= (full[k::4] & 3) << (2 * k)
    return out.tobytes()


def _read_difflist(buf, pos, sibc):
    dlen, pos = _read_vint(buf, pos)
    if dlen == 0:
        return np.empty(0, np.int64), np.empty(0, np.uint8), pos
    ids = np.empty(dlen, np.int64)
    n_groups = -(-dlen // _GROUP)
    for g in range(n_groups):
        ids[g * _GROUP] = int.from_bytes(bytes(buf[pos : pos + sibc]), "little")
        pos += sibc
    for g in range(n_groups):
        for k in range(g * _GROUP + 1, min((g + 1) * _GROUP, dlen)):
            d, pos = _read_vint(buf, pos)
            ids[k] = ids[k - 1] + d
    nb = -(-dlen // 4)
    vals = _unpack2(np.frombuffer(bytes(buf[pos : pos + nb]), np.uint8), dlen)
    pos += nb
    return ids, vals, pos


def _write_difflist(ids: np.ndarray, vals: np.ndarray, sibc) -> bytes:
    out = bytearray(_write_vint(len(ids)))
    if len(ids) == 0:
        return bytes(out)
    n_groups = -(-len(ids) // _GROUP)
    for g in range(n_groups):
        out += int(ids[g * _GROUP]).to_bytes(sibc, "little")
    for g in range(n_groups):
        for k in range(g * _GROUP + 1, min((g + 1) * _GROUP, len(ids))):
            out += _write_vint(int(ids[k] - ids[k - 1]))
    out += _pack2(np.asarray(vals, np.uint8))
    return bytes(out)


def _difflist_nbytes(dlen: int, sibc: int, ids=None) -> int:
    """Size of a difflist without materializing it (writer cost model)."""
    if dlen == 0:
        return 1
    n_groups = -(-dlen // _GROUP)
    size = len(_write_vint(dlen)) + n_groups * sibc + -(-dlen // 4)
    if ids is not None:
        for g in range(n_groups):
            lo, hi = g * _GROUP + 1, min((g + 1) * _GROUP, dlen)
            for k in range(lo, hi):
                size += len(_write_vint(int(ids[k] - ids[k - 1])))
    else:
        size += max(0, dlen - n_groups)  # assume 1-byte deltas
    return size


_LD_INVERT = np.array([2, 1, 0, 3], dtype=np.uint8)  # dosage complement


def _read_pgen_standard(raw: np.ndarray, n_variants: int, n_samples: int):
    import struct

    vc, sc = struct.unpack_from("<II", raw.tobytes(), 3)
    assert vc == n_variants, f".pvar has {n_variants} variants, header {vc}"
    assert sc == n_samples, f".psam has {n_samples} samples, header {sc}"
    ctrl = int(raw[11])
    vr_storage = ctrl & 0x0F
    if vr_storage >= 8:
        raise NotImplementedError(
            f".pgen constant-vrtype header compression (control {vr_storage}) "
            "is not supported"
        )
    vrtype_bytes = 1 if vr_storage >= 4 else 0  # 0 => 4-bit nibbles
    len_bytes = (vr_storage & 3) + 1
    ac_width = (ctrl >> 4) & 3
    nonref_mode = (ctrl >> 6) & 3
    n_blocks = -(-n_variants // 65536)
    pos = 12
    # u64 per-block first-record offsets (used as a consistency check only —
    # we decode sequentially)
    block_offsets = [
        int.from_bytes(bytes(raw[pos + 8 * b : pos + 8 * b + 8]), "little")
        for b in range(n_blocks)
    ]
    pos += 8 * n_blocks
    vrtypes = np.empty(n_variants, np.uint8)
    vrlens = np.empty(n_variants, np.int64)
    for b in range(n_blocks):
        nb_var = min(65536, n_variants - b * 65536)
        s = b * 65536
        if vrtype_bytes:
            vrtypes[s : s + nb_var] = raw[pos : pos + nb_var]
            pos += nb_var
        else:
            packed = raw[pos : pos + -(-nb_var // 2)]
            pos += -(-nb_var // 2)
            nib = np.empty(len(packed) * 2, np.uint8)
            nib[0::2] = packed & 0x0F
            nib[1::2] = packed >> 4
            vrtypes[s : s + nb_var] = nib[:nb_var]
        chunk = raw[pos : pos + nb_var * len_bytes].reshape(nb_var, len_bytes)
        vrlens[s : s + nb_var] = (
            chunk.astype(np.int64) << (8 * np.arange(len_bytes, dtype=np.int64))
        ).sum(1)
        pos += nb_var * len_bytes
        if ac_width:
            pos += nb_var * ac_width  # allele counts: biallelic GRM path skips
        if nonref_mode == 3:
            pos += -(-nb_var // 8)  # nonref flag bitarray: not used downstream
    sibc = _sample_id_byte_ct(n_samples)
    geno = np.empty((n_variants, n_samples), np.uint8)
    ld_base = None
    for v in range(n_variants):
        if v % 65536 == 0 and block_offsets[v // 65536] != pos:
            raise ValueError(
                f".pgen block {v // 65536} offset {block_offsets[v // 65536]} "
                f"!= decoded position {pos}"
            )
        rec = raw[pos : pos + vrlens[v]]
        pos += int(vrlens[v])
        enc = vrtypes[v] & 7
        p = 0
        if enc == 0:
            nby = -(-n_samples // 4)
            row = _unpack2(rec[:nby], n_samples)
        elif enc == 1:
            common2 = int(rec[0])
            lo, hi = common2 & 3, (common2 >> 2) & 3
            nsel = -(-n_samples // 8)
            bits = np.unpackbits(
                np.asarray(rec[1 : 1 + nsel], np.uint8), bitorder="little"
            )[:n_samples]
            row = np.where(bits == 0, lo, hi).astype(np.uint8)
            ids, vals, _ = _read_difflist(rec, 1 + nsel, sibc)
            row[ids] = vals
        elif enc in (2, 3):
            if ld_base is None:
                raise ValueError(".pgen LD-compressed record with no base")
            row = _LD_INVERT[ld_base] if enc == 3 else ld_base.copy()
            ids, vals, _ = _read_difflist(rec, 0, sibc)
            row[ids] = vals
        else:  # 4..7: difflist over constant base (vrtype & 3)
            row = np.full(n_samples, vrtypes[v] & 3, np.uint8)
            ids, vals, _ = _read_difflist(rec, 0, sibc)
            row[ids] = vals
        geno[v] = row
        if enc not in (2, 3):
            ld_base = row
    return geno


def _encode_pgen_record(row: np.ndarray, ld_base, sibc: int):
    """Choose the smallest main-track encoding for one variant (what plink2's
    writer does).  Returns (vrtype, record bytes, new ld_base)."""
    n = len(row)
    counts = np.bincount(row, minlength=4)
    dense_sz = -(-n // 4)
    # difflist over the most common constant base
    base = int(np.argmax(counts))
    dl_ids = np.nonzero(row != base)[0]
    dl_sz = _difflist_nbytes(len(dl_ids), sibc, dl_ids)
    # LD vs previous non-LD variant (plain and inverted)
    ld_sz = inv_sz = 1 << 30
    if ld_base is not None:
        ld_ids = np.nonzero(row != ld_base)[0]
        ld_sz = _difflist_nbytes(len(ld_ids), sibc, ld_ids)
        inv_ids = np.nonzero(row != _LD_INVERT[ld_base])[0]
        inv_sz = _difflist_nbytes(len(inv_ids), sibc, inv_ids)
    # 1-bit: two most common genotypes as selector bits + exception difflist
    order = np.argsort(-counts, kind="stable")
    lo, hi = int(order[0]), int(order[1])
    ob_ids = np.nonzero((row != lo) & (row != hi))[0]
    onebit_sz = 1 + -(-n // 8) + _difflist_nbytes(len(ob_ids), sibc, ob_ids)
    best = min(dense_sz, dl_sz, ld_sz, inv_sz, onebit_sz)
    if best == ld_sz:
        return 2, _write_difflist(ld_ids, row[ld_ids], sibc), ld_base
    if best == inv_sz:
        return 3, _write_difflist(inv_ids, row[inv_ids], sibc), ld_base
    if best == dl_sz:
        return 4 + base, _write_difflist(dl_ids, row[dl_ids], sibc), row
    if best == onebit_sz:
        sel = np.zeros(-(-n // 8) * 8, np.uint8)
        sel[:n] = (row != lo).astype(np.uint8)  # exceptions also read as hi,
        rec = bytes([lo | (hi << 2)])           # then overwritten by difflist
        rec += np.packbits(sel, bitorder="little").tobytes()
        rec += _write_difflist(ob_ids, row[ob_ids], sibc)
        return 1, rec, row
    return 0, _pack2(row), row


def write_pgen(prefix: str, geno: np.ndarray, ids=None, mode: int = 0x02):
    """Write .pgen/.pvar/.psam.  mode 0x02 = fixed-width (default); 0x01 =
    embedded plink1 payload; 0x10/0x11 = standard variable-width records
    (0x11 additionally stores a nonref-flag bitarray, all-zero here)."""
    import struct

    M, N = geno.shape
    bpv = -(-N // 4)
    if mode in (0x10, 0x11):
        sibc = _sample_id_byte_ct(N)
        vrtypes, recs = [], []
        ld_base = None
        for v in range(M):
            if v % 65536 == 0:
                ld_base = None  # block-local LD bases: blocks decode standalone
            t, rec, ld_base = _encode_pgen_record(
                np.asarray(geno[v], np.uint8), ld_base, sibc)
            vrtypes.append(t)
            recs.append(rec)
        max_len = max((len(r) for r in recs), default=0)
        len_bytes = max(1, (max_len.bit_length() + 7) // 8)
        assert len_bytes <= 4
        # hardcall-only vrtypes are 0..7 -> 4-bit nibble storage
        ctrl = (len_bytes - 1) | (0x03 << 6 if mode == 0x11 else 0)
        n_blocks = -(-M // 65536)
        header = bytearray()
        for b in range(n_blocks):
            nb_var = min(65536, M - b * 65536)
            vt = vrtypes[b * 65536 : b * 65536 + nb_var]
            nib = bytearray()
            for i in range(0, nb_var - 1, 2):
                nib.append(vt[i] | (vt[i + 1] << 4))
            if nb_var % 2:
                nib.append(vt[nb_var - 1])
            header += nib
            for r in recs[b * 65536 : b * 65536 + nb_var]:
                header += len(r).to_bytes(len_bytes, "little")
            if mode == 0x11:
                header += bytes(-(-nb_var // 8))  # nonref flags: all zero
        body_start = 12 + 8 * n_blocks + len(header)
        offsets = bytearray()
        off = body_start
        for b in range(n_blocks):
            offsets += off.to_bytes(8, "little")
            off += sum(len(r) for r in
                       recs[b * 65536 : min((b + 1) * 65536, M)])
        with open(prefix + ".pgen", "wb") as f:
            f.write(bytes([0x6C, 0x1B, mode]))
            f.write(struct.pack("<II", M, N))
            f.write(bytes([ctrl]))
            f.write(bytes(offsets))
            f.write(bytes(header))
            for r in recs:
                f.write(r)
    else:
        if mode == 0x02:
            codes = np.full((M, bpv * 4), 3, np.uint8)
            codes[:, :N] = geno
        elif mode == 0x01:
            inv = np.array([3, 2, 0, 1], dtype=np.uint8)
            codes = np.ones((M, bpv * 4), np.uint8)
            codes[:, :N] = inv[geno]
        else:
            raise NotImplementedError(f"mode 0x{mode:02x}")
        body = np.zeros((M, bpv), np.uint8)
        for k in range(4):
            body |= (codes[:, k::4] & 3) << (2 * k)
        with open(prefix + ".pgen", "wb") as f:
            f.write(bytes([0x6C, 0x1B, mode]))
            if mode == 0x02:
                f.write(struct.pack("<II", M, N))
            f.write(body.tobytes())
    if ids is None:
        ids = [f"S{i}" for i in range(N)]
    with open(prefix + ".psam", "w") as f:
        f.write("#IID\tSEX\n")
        for s in ids:
            f.write(f"{s}\tNA\n")
    with open(prefix + ".pvar", "w") as f:
        f.write("#CHROM\tPOS\tID\tREF\tALT\n")
        for j in range(M):
            f.write(f"1\t{j+1}\tv{j}\tA\tC\n")
