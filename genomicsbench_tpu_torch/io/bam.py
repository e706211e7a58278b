"""BAM/BGZF reader and writer, BAI index and FASTA index.

The port's copy of genomicsbench_tpu/io/bam.py: BAM records with their
name, flag, ref_id, 0-based pos, mapq, cigar [(op, len)], seq codes (0..4
via ACGT/N), quals and raw tags; BGZF through the standard library's zlib.
`read_bam` reads the whole file, record by record, which gives the records
and their order of the JAX package's readers.  `IndexedBam` is the region
reader over a BAM and its `.bai` (htslib's bam_index_load/hts_itr path,
debruijn.cpp:1458-1462, medaka_bamiter.c): it inflates only the BGZF blocks
that a region's index chunks cover and parses them with the host library's
batch parser (`native.bam_parse`) into arrays (`fetch_soa_chunks`), or
into records (`fetch`).  `write_bai` indexes a BAM that `write_bam` wrote,
and `FastaIndex` serves reference slices (faidx).
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

from genomicsbench_tpu_torch import native

import numpy as np

CIGAR_OPS = "MIDNSHP=X"
# 4-bit nibble code -> our 0..4 coding
_NIB16 = "=ACMGRSVTWYHKDBN"
NIB_TO_CODE = np.full(16, 4, dtype=np.uint8)
for _i, _ch in enumerate(_NIB16):
    if _ch in "ACGT":
        NIB_TO_CODE[_i] = "ACGT".index(_ch)
_CODE_TO_NIB = np.array([1, 2, 4, 8, 15], np.uint8)  # A C G T N
_ARRAY_FMTS = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I", "f": "f"}
_ARRAY_SIZES = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}


@dataclasses.dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int
    mapq: int
    cigar: list            # [(op_char, length)]
    seq: np.ndarray        # uint8 codes 0..4
    qual: np.ndarray       # uint8
    tags: bytes = b""
    end: int | None = None  # precomputed reference end, if the reader knows it

    @property
    def is_unmapped(self):
        return bool(self.flag & 4)

    @property
    def is_reverse(self):
        return bool(self.flag & 16)

    @property
    def is_secondary(self):
        return bool(self.flag & 256)

    @property
    def is_supplementary(self):
        return bool(self.flag & 2048)

    @property
    def is_dup(self):
        return bool(self.flag & 1024)

    @property
    def is_qcfail(self):
        return bool(self.flag & 512)

    def get_array_tag(self, name: str):
        """Parse a 'B'-type aux array tag (e.g. medaka's WL/WK float arrays,
        medaka_counts.c:236-259).  Returns a numpy array or None; a scalar
        numeric tag of that name comes back as a one-element array."""
        t = self.tags
        i = 0
        while i + 3 <= len(t):
            tag = t[i : i + 2].decode()
            typ = chr(t[i + 2])
            i += 3
            if typ == "B":
                sub = chr(t[i])
                n = struct.unpack_from("<I", t, i + 1)[0]
                payload = i + 5
                if tag == name:
                    return np.frombuffer(
                        t[payload : payload + n * _ARRAY_SIZES[sub]],
                        dtype="<" + _ARRAY_FMTS[sub]).copy()
                i = payload + n * _ARRAY_SIZES[sub]
            elif typ in "cCsSiIf":
                if tag == name:
                    return np.array([struct.unpack_from("<" + _ARRAY_FMTS[typ], t, i)[0]])
                i += _ARRAY_SIZES[typ]
            elif typ in ("Z", "H"):
                i = t.index(b"\x00", i) + 1
            elif typ == "A":
                i += 1
            else:
                break
        return None

    def end_pos(self):
        """Reference end (exclusive) from the CIGAR."""
        if self.end is not None:
            return self.end
        end = self.pos
        for op, ln in self.cigar:
            if op in "MDN=X":
                end += ln
        return end


def _bgzf_block_size(data: bytes, pos: int) -> int:
    """The total size of the BGZF block at `pos` (its BC extra field)."""
    xlen = struct.unpack_from("<H", data, pos + 10)[0]
    extra = data[pos + 12 : pos + 12 + xlen]
    e = 0
    while e < xlen:
        si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from("<H", extra, e + 2)[0]
        if si1 == 66 and si2 == 67:
            return struct.unpack_from("<H", extra, e + 4)[0] + 1
        e += 4 + slen
    raise ValueError("missing BGZF BSIZE")


def _bgzf_inflate(data: bytes, pos: int, bsize: int) -> bytes:
    xlen = struct.unpack_from("<H", data, pos + 10)[0]
    return zlib.decompress(data[pos + 12 + xlen : pos + bsize - 8], -15)


def _bgzf_blocks(data: bytes) -> list:
    """(offset, size) of every BGZF block of a file."""
    blocks, pos = [], 0
    while pos + 18 <= len(data):
        bsize = _bgzf_block_size(data, pos)
        blocks.append((pos, bsize))
        pos += bsize
    return blocks


def bgzf_decompress(data: bytes) -> bytes:
    """Decompress a BGZF (blocked gzip) byte string, block by block."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError("bad BGZF magic")
        bsize = _bgzf_block_size(data, pos)
        out.append(_bgzf_inflate(data, pos, bsize))
        pos += bsize
    return b"".join(out)


def bgzf_compress(raw: bytes, block_size: int = 60000) -> bytes:
    out = []
    for s in range(0, max(len(raw), 1), block_size):
        chunk = raw[s : s + block_size]
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        comp = co.compress(chunk) + co.flush()
        bsize = len(comp) + 25 + 1
        hdr = struct.pack(
            "<BBBBIBBHBBHH", 31, 139, 8, 4, 0, 0, 255, 6, 66, 67, 2, bsize - 1
        )
        out.append(hdr + comp + struct.pack("<II", zlib.crc32(chunk), len(chunk)))
    # EOF block
    out.append(bytes.fromhex(
        "1f8b08040000000000ff0600424302001b0003000000000000000000"
    ))
    return b"".join(out)


@dataclasses.dataclass
class BamFile:
    header_text: str
    ref_names: list
    ref_lens: list
    records: list

    def fetch(self, ref_name: str, start: int, stop: int):
        """Records overlapping [start, stop) on ref_name (0-based)."""
        rid = self.ref_names.index(ref_name)
        for r in self.records:
            if r.ref_id != rid or r.is_unmapped:
                continue
            if r.pos < stop and r.end_pos() > start:
                yield r


def _parse_record(body: bytes) -> BamRecord:
    (ref_id, pos, l_rn, mapq, _bin, n_cig, flag, l_seq, _nr, _np, _tl) = (
        struct.unpack_from("<iiBBHHHiiii", body, 0)
    )
    p = 32
    name = body[p : p + l_rn - 1].decode()
    p += l_rn
    cig = []
    for i in range(n_cig):
        v = struct.unpack_from("<I", body, p + 4 * i)[0]
        cig.append((CIGAR_OPS[v & 15], v >> 4))
    p += 4 * n_cig
    nseq = (l_seq + 1) // 2
    packed = np.frombuffer(body[p : p + nseq], dtype=np.uint8)
    codes = np.empty(nseq * 2, np.uint8)
    codes[0::2] = NIB_TO_CODE[packed >> 4]
    codes[1::2] = NIB_TO_CODE[packed & 15]
    seq = codes[:l_seq].copy()
    p += nseq
    qual = np.frombuffer(body[p : p + l_seq], dtype=np.uint8).copy()
    p += l_seq
    return BamRecord(name=name, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
                     cigar=cig, seq=seq, qual=qual, tags=bytes(body[p:]))


def read_bam(path: str) -> BamFile:
    with open(path, "rb") as f:
        raw = bgzf_decompress(f.read())
    if raw[:4] != b"BAM\x01":
        raise ValueError(f"{path}: not a BAM file")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    text = raw[8 : 8 + l_text].decode(errors="replace")
    names, lens, off = _parse_header(raw)
    records = []
    n = len(raw)
    while off < n:
        block_size = struct.unpack_from("<i", raw, off)[0]
        records.append(_parse_record(raw[off + 4 : off + 4 + block_size]))
        off += 4 + block_size
    return BamFile(header_text=text, ref_names=names, ref_lens=lens, records=records)


def write_bam(path: str, bam: BamFile):
    out = [b"BAM\x01"]
    text = bam.header_text.encode()
    out.append(struct.pack("<i", len(text)))
    out.append(text)
    out.append(struct.pack("<i", len(bam.ref_names)))
    for nm, ln in zip(bam.ref_names, bam.ref_lens):
        nb = nm.encode() + b"\x00"
        out.append(struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln))
    for r in bam.records:
        nb = r.name.encode() + b"\x00"
        cig = b"".join(
            struct.pack("<I", (ln << 4) | CIGAR_OPS.index(op)) for op, ln in r.cigar
        )
        l_seq = len(r.seq)
        # two 4-bit codes per byte, the first in the high nibble
        nib = _CODE_TO_NIB[np.minimum(np.asarray(r.seq, np.int64), 4)]
        if l_seq % 2:
            nib = np.append(nib, np.uint8(0))
        packed = ((nib[0::2] << 4) | nib[1::2]).astype(np.uint8)
        body = struct.pack(
            "<iiBBHHHiiii", r.ref_id, r.pos, len(nb), r.mapq,
            0, len(r.cigar), r.flag, l_seq, -1, -1, 0,
        ) + nb + cig + packed.tobytes() + r.qual.astype(np.uint8).tobytes() + r.tags
        out.append(struct.pack("<i", len(body)) + body)
    with open(path, "wb") as f:
        f.write(bgzf_compress(b"".join(out)))


def encode_array_tag(name: str, sub: str, values) -> bytes:
    """Encode a 'B'-type aux array tag (test/fixture helper)."""
    vals = list(values)
    body = b"".join(struct.pack("<" + _ARRAY_FMTS[sub], v) for v in vals)
    return name.encode() + b"B" + sub.encode() + struct.pack("<I", len(vals)) + body


def _records_from_soa(soa, raw, indices=None):
    """BamRecords (seq and qual as views into the arrays) of the rows
    `indices` (default: all) of a native.bam_parse batch of `raw`."""
    cig_all = soa["cigars"]
    if len(cig_all):
        ops_all = np.array(list(CIGAR_OPS))[cig_all & 15]
        lens_all = (cig_all >> 4).astype(np.int64)
    else:
        ops_all = lens_all = np.empty(0, np.int64)
    co, so, no = soa["cig_off"], soa["seq_off"], soa["name_off"]
    seqs, quals, names = soa["seqs"], soa["quals"], soa["names"]
    out = []
    for r in (range(soa["n_rec"]) if indices is None else indices):
        c0, c1 = int(co[r]), int(co[r + 1])
        out.append(BamRecord(
            name=names[int(no[r]) : int(no[r + 1])].tobytes().decode(),
            flag=int(soa["flag"][r]), ref_id=int(soa["ref_id"][r]),
            pos=int(soa["pos"][r]), mapq=int(soa["mapq"][r]),
            cigar=list(zip(ops_all[c0:c1].tolist(), lens_all[c0:c1].tolist())),
            seq=seqs[int(so[r]) : int(so[r + 1])],
            qual=quals[int(so[r]) : int(so[r + 1])],
            tags=bytes(raw[int(soa["tag_beg"][r]) : int(soa["tag_end"][r])]),
            end=int(soa["end_pos"][r]),
        ))
    return out


def _parse_header(raw: bytes):
    """(reference names, reference lengths, offset of the first record) of a
    decompressed BAM stream."""
    if raw[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    l_text = struct.unpack_from("<i", raw, 4)[0]
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, off)[0]
    off += 4
    names, lens = [], []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, off)[0]
        names.append(raw[off + 4 : off + 4 + l_name - 1].decode())
        lens.append(struct.unpack_from("<i", raw, off + 4 + l_name)[0])
        off += 8 + l_name
    return names, lens, off


# ---------------------------------------------------------------- FASTA
class FastaIndex:
    """In-memory faidx: loads the FASTA once and serves region queries as
    uint8 code arrays (0..4)."""

    def __init__(self, path: str):
        from genomicsbench_tpu_torch.io.seqio import BASE_CODE, read_fastx

        self.seqs = {name: BASE_CODE[np.frombuffer(seq, dtype=np.uint8)]
                     for name, seq in read_fastx(path)}

    def fetch(self, name: str, start: int, stop: int) -> np.ndarray:
        return self.seqs[name][start:stop]

    def length(self, name: str) -> int:
        return len(self.seqs[name])


# ------------------------------------------------------------------ BAI
def reg2bins(beg: int, end: int):
    """Every BAI bin overlapping [beg, end) (the 5-level binning scheme)."""
    end -= 1
    bins = [0]
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


def reg2bin(beg: int, end: int) -> int:
    """The smallest bin that holds [beg, end) (the SAM spec's reg2bin)."""
    end -= 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return base + (beg >> shift)
    return 0


def read_bai(path: str):
    """A .bai: per reference ({bin: [(chunk_beg, chunk_end) virtual
    offsets]}, linear index)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"BAI\x01":
        raise ValueError(f"{path}: not a BAI index")
    n_ref = struct.unpack_from("<i", raw, 4)[0]
    off = 8
    refs = []
    for _ in range(n_ref):
        n_bin = struct.unpack_from("<i", raw, off)[0]
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", raw, off)
            off += 8
            bins[b] = [struct.unpack_from("<QQ", raw, off + 16 * c) for c in range(n_chunk)]
            off += 16 * n_chunk
        n_intv = struct.unpack_from("<i", raw, off)[0]
        off += 4
        refs.append((bins, list(struct.unpack_from(f"<{n_intv}Q", raw, off))))
        off += 8 * n_intv
    return refs


class IndexedBam:
    """Region reader over a BAM and its `.bai`: inflates only the BGZF blocks
    that the region's index chunks cover (each block once, then kept)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            self.data = f.read()
        self.index = read_bai(path + ".bai")
        self._block_at = {}        # compressed offset -> inflated block
        self._blocks = [pos for pos, _ in _bgzf_blocks(self.data)]
        self._block_index = {c: i for i, c in enumerate(self._blocks)}
        # the header: inflate leading blocks until the references parse
        hdr_raw = b""
        for coff in self._blocks:
            hdr_raw += self._read_block(coff)
            try:
                self.ref_names, self.ref_lens, self._hdr_end = _parse_header(hdr_raw)
                break
            except (struct.error, IndexError):
                continue
        else:
            raise ValueError(f"{path}: the BAM header runs past the end of the file")

    def _read_block(self, coff: int) -> bytes:
        got = self._block_at.get(coff)
        if got is None:
            got = self._block_at[coff] = _bgzf_inflate(self.data, coff,
                                                       _bgzf_block_size(self.data, coff))
        return got

    def fetch_soa_chunks(self, ref_name: str, start: int, stop: int):
        """The records overlapping [start, stop) on ref_name (0-based), chunk
        by chunk, as (soa, buf, hit) triples: a native.bam_parse batch of the
        inflated buffer `buf` (which its tag offsets index) and the rows of
        it that are this region's, each record once, in file order."""
        rid = self.ref_names.index(ref_name)
        bins, _linear = self.index[rid]
        chunks = sorted(c for b in reg2bins(start, stop) for c in bins.get(b, []))
        seen = set()
        for cbeg, cend in chunks:
            got = self._chunk_buffer(cbeg, cend)
            if got is None:
                continue
            buf, uoff, raw_starts, block_coffs = got
            soa = native.bam_parse(buf, uoff)
            n_rec = soa["n_rec"]
            if not n_rec:
                continue
            # each record's absolute virtual offset: the key shared across chunks
            rec_start = np.empty(n_rec, np.int64)
            rec_start[0] = uoff
            rec_start[1:] = soa["tag_end"][:-1]
            ks = np.searchsorted(raw_starts, rec_start, side="right") - 1
            voff = (np.asarray(block_coffs, np.int64)[ks] << 16) | (
                rec_start - np.asarray(raw_starts, np.int64)[ks])
            valid = (soa["ref_id"] == rid) & ((soa["flag"] & 4) == 0)
            past = np.nonzero(valid & (soa["pos"] >= stop))[0]
            cut = int(past[0]) if len(past) else n_rec
            fresh = np.fromiter((v not in seen for v in voff[:cut].tolist()), bool, count=cut)
            seen.update(voff[:cut].tolist())
            hit = np.nonzero(fresh & valid[:cut] & (soa["end_pos"][:cut] > start))[0]
            yield soa, buf, hit
            if cut < n_rec:
                return

    def _chunk_buffer(self, cbeg, cend):
        """The inflated blocks that one BAI chunk covers: (buf, offset of the
        chunk in it, each block's offset in buf, each block's compressed
        offset), or None for a chunk that starts at no block."""
        coff, uoff = cbeg >> 16, cbeg & 0xFFFF
        bi = self._block_index.get(coff)
        if bi is None:
            return None
        parts, raw_starts, block_coffs, size = [], [], [], 0
        while True:
            raw_starts.append(size)
            block_coffs.append(self._blocks[bi])
            part = self._read_block(self._blocks[bi])
            parts.append(part)
            size += len(part)
            # stop once the buffer passes the chunk's end
            if self._blocks[bi] > (cend >> 16) or bi + 1 >= len(self._blocks):
                break
            bi += 1
        return b"".join(parts), uoff, raw_starts, block_coffs

    def fetch(self, ref_name: str, start: int, stop: int):
        """The records overlapping [start, stop) (0-based), through the BAI."""
        for soa, buf, hit in self.fetch_soa_chunks(ref_name, start, stop):
            yield from _records_from_soa(soa, buf, indices=hit)


def _reg2bin_vec(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """reg2bin of every [beg, end) pair."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        here = ~done & ((beg >> shift) == (end >> shift))
        out[here] = base + (beg[here] >> shift)
        done |= here
    return out


def write_bai(bam_path: str):
    """Write `bam_path + ".bai"` for a BAM whose records are sorted by
    position (as `write_bam` writes them): the bins with their merged
    chunks and the 16 kb linear index, each record's virtual offsets taken
    from the BGZF blocks it lies in."""
    with open(bam_path, "rb") as f:
        data = f.read()
    blocks = _bgzf_blocks(data)
    parts = [_bgzf_inflate(data, pos, bsize) for pos, bsize in blocks]
    raw_starts = np.concatenate([[0], np.cumsum([len(p) for p in parts])])[:-1].astype(np.int64)
    block_coffs = np.array([pos for pos, _ in blocks], np.int64)
    raw = b"".join(parts)
    names, _lens, off = _parse_header(raw)
    n_ref = len(names)
    soa = native.bam_parse(raw, off)
    n_rec = soa["n_rec"]
    rec_beg = np.concatenate([[off], soa["tag_end"][:-1]]).astype(np.int64)[:n_rec]
    rec_end = soa["tag_end"].astype(np.int64)

    def voffset(raw_off):
        bi = np.searchsorted(raw_starts, raw_off, side="right") - 1
        return (block_coffs[bi] << 16) | (raw_off - raw_starts[bi])

    v_beg, v_end = voffset(rec_beg), voffset(rec_end)
    mapped = soa["ref_id"] >= 0
    rid = soa["ref_id"][mapped].astype(np.int64)
    pos = soa["pos"][mapped].astype(np.int64)
    end = np.maximum(soa["end_pos"][mapped].astype(np.int64), pos + 1)
    v_beg, v_end = v_beg[mapped], v_end[mapped]
    bins = _reg2bin_vec(pos, end)
    # the linear index: each 16 kb window's least record start
    w0, w1 = pos >> 14, (end - 1) >> 14
    nwin = w1 - w0 + 1
    win_rec = np.repeat(np.arange(len(pos)), nwin)
    win = np.repeat(w0, nwin) + (np.arange(int(nwin.sum()))
                                 - np.repeat(np.cumsum(nwin) - nwin, nwin))
    out = [b"BAI\x01", struct.pack("<i", n_ref)]
    for r in range(n_ref):
        mine = rid == r
        b_r, cb_r, ce_r = bins[mine], v_beg[mine], v_end[mine]
        order = np.lexsort((ce_r, cb_r, b_r))
        b_r, cb_r, ce_r = b_r[order], cb_r[order], ce_r[order]
        ubins, first = np.unique(b_r, return_index=True)
        out.append(struct.pack("<i", len(ubins)))
        for b, lo, hi in zip(ubins.tolist(), first.tolist(),
                             np.append(first[1:], len(b_r)).tolist()):
            cb, ce = cb_r[lo:hi], ce_r[lo:hi]
            # merge each chunk into the one before when it starts at or
            # before the furthest end seen so far in this bin
            reach = np.maximum.accumulate(ce)
            new = np.ones(len(cb), bool)
            new[1:] = cb[1:] > reach[:-1]
            starts = np.nonzero(new)[0]
            ends = np.append(starts[1:], len(cb)) - 1
            out.append(struct.pack("<Ii", b, len(starts)))
            out.append(np.stack([cb[starts], reach[ends]], 1).astype("<u8").tobytes())
        wr = win[mine[win_rec]]
        if len(wr):
            nv = int(wr.max()) + 1
            lin = np.full(nv, np.iinfo(np.int64).max, np.int64)
            np.minimum.at(lin, wr, v_beg[win_rec[mine[win_rec]]])
            have = lin != np.iinfo(np.int64).max
            last = np.maximum.accumulate(np.where(have, np.arange(nv), -1))
            lin = np.where(last >= 0, lin[np.maximum(last, 0)], 0)
        else:
            nv, lin = 0, np.zeros(0, np.int64)
        out.append(struct.pack("<i", nv))
        out.append(lin.astype("<u8").tobytes())
    with open(bam_path + ".bai", "wb") as f:
        f.write(b"".join(out))
