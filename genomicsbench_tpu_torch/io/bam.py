"""Minimal BAM/BGZF reader and writer.

The port's copy of genomicsbench_tpu/io/bam.py's whole-file path: BAM
records with their name, flag, ref_id, 0-based pos, mapq, cigar
[(op, len)], seq codes (0..4 via ACGT/N), quals and raw tags; BGZF through
the standard library's zlib.  `read_bam` reads the whole file, record by
record, which gives the records and their order of the JAX package's
readers.  Its native BGZF inflate and record parser, and the indexed
(`.bai`) region reader, are speed paths of the same records that the port
has not copied yet.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib

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


def bgzf_decompress(data: bytes) -> bytes:
    """Decompress a BGZF (blocked gzip) byte string, block by block."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        if data[pos : pos + 2] != b"\x1f\x8b":
            raise ValueError("bad BGZF magic")
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        extra = data[pos + 12 : pos + 12 + xlen]
        bsize = None
        e = 0
        while e < xlen:
            si1, si2, slen = extra[e], extra[e + 1], struct.unpack_from("<H", extra, e + 2)[0]
            if si1 == 66 and si2 == 67:
                bsize = struct.unpack_from("<H", extra, e + 4)[0] + 1
            e += 4 + slen
        if bsize is None:
            raise ValueError("missing BGZF BSIZE")
        comp = data[pos + 12 + xlen : pos + bsize - 8]
        out.append(zlib.decompress(comp, -15))
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
    off = 8 + l_text
    n_ref = struct.unpack_from("<i", raw, off)[0]
    off += 4
    names, lens = [], []
    for _ in range(n_ref):
        l_name = struct.unpack_from("<i", raw, off)[0]
        names.append(raw[off + 4 : off + 4 + l_name - 1].decode())
        lens.append(struct.unpack_from("<i", raw, off + 4 + l_name)[0])
        off += 8 + l_name
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
