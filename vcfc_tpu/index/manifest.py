"""Block manifest (.vcfcm): filesystem-independent random access.

The reference's random-access structures depend on filesystem holes and
SEEK_DATA probing (SURVEY.md §3.4) — OS-coupled and pointer-chasing.
The manifest replaces them with three dense numpy arrays over all data
lines, memory-mapped for O(log n) binary search with zero scanning:

  header:  magic "VCFM" | u32 version | u64 line count
  arrays (little-endian, contiguous):
    ref_idx  u8[L]    chromosome ordinal
    pos      u32[L]   POS
    end      u32[L]   SV-aware end position
    offset   u64[L]   absolute byte offset of the compressed line
    length   u32[L]   line_length header value (skip = 4 + length)
  cummax_end u32[L]   running max of `end` per ref (overlap queries)

Query: bisect on (ref_idx, pos) for the range end; for the start, bisect
on cummax_end (monotone per ref) so overlapping long variants (deletions
spanning the query start) are found without the reference's
scan-from-previous-bin heuristic.  One decode per matching line.
"""

from __future__ import annotations

import struct

import numpy as np

from ..format.lines import decode_data_line
from ..format.vcf import parse_metadata_headers
from ..query.coordinate import CoordinateQuery
from ..utils.refmap import reference_to_int
from .scan import scan_lines

MAGIC = b"VCFM"
VERSION = 1
MANIFEST_EXTENSION = ".vcfcm"


def build_manifest(vcfc: bytes) -> bytes:
    recs = list(scan_lines(vcfc))
    L = len(recs)
    ref_idx = np.fromiter(
        (reference_to_int(r.chrom) for r in recs), np.uint8, count=L
    )
    pos = np.fromiter((r.pos for r in recs), np.uint32, count=L)
    end = np.fromiter((r.end_position() for r in recs), np.uint32, count=L)
    offset = np.fromiter((r.offset for r in recs), np.uint64, count=L)
    length = np.fromiter((r.line_length for r in recs), np.uint32, count=L)
    # running max of end within each ref run: vectorized accumulate per
    # segment (segments = contiguous ref runs, a handful per file)
    cummax_end = end.copy()
    if L:
        bounds = np.flatnonzero(
            np.concatenate([[True], ref_idx[1:] != ref_idx[:-1]])
        ).tolist() + [L]
        for s, e in zip(bounds[:-1], bounds[1:]):
            cummax_end[s:e] = np.maximum.accumulate(end[s:e])
    head = MAGIC + struct.pack("<IQ", VERSION, L)
    return head + b"".join(
        a.tobytes() for a in (ref_idx, pos, end, offset, length, cummax_end)
    )


class Manifest:
    def __init__(self, data: bytes):
        if data[:4] != MAGIC:
            raise ValueError("not a .vcfcm manifest")
        version, L = struct.unpack_from("<IQ", data, 4)
        if version != VERSION:
            raise ValueError(f"unsupported manifest version {version}")
        # 25 bytes per line (u8 ref + u32 pos/end + u64 offset + u32
        # length/cummax_end): a truncated or L-inflated file would
        # otherwise yield silently short/misaligned arrays (np views
        # clamp) and wrong query results
        if len(data) != 16 + 25 * L:
            raise ValueError(
                f"corrupt .vcfcm: {len(data)} bytes for {L} lines"
            )
        off = 16
        buf = np.frombuffer(data, np.uint8, offset=off)

        def take(dtype, count):
            nonlocal buf
            n = np.dtype(dtype).itemsize * count
            out = buf[:n].view(dtype)
            buf = buf[n:]
            return out

        self.n_lines = L
        self.ref_idx = take(np.uint8, L)
        self.pos = take(np.uint32, L)
        self.end = take(np.uint32, L)
        self.offset = take(np.uint64, L)
        self.length = take(np.uint32, L)
        self.cummax_end = take(np.uint32, L)

    def select(self, query: CoordinateQuery) -> np.ndarray:
        """Indices of candidate lines for the query (overlap semantics)."""
        q_ref = reference_to_int(query.reference_name)
        # ref slice
        lo = int(np.searchsorted(self.ref_idx, q_ref, "left"))
        hi = int(np.searchsorted(self.ref_idx, q_ref, "right"))
        if lo == hi:
            return np.empty(0, np.int64)
        if not query.has_start and not query.has_end:
            return np.arange(lo, hi, dtype=np.int64)
        pos = self.pos[lo:hi]
        cme = self.cummax_end[lo:hi]
        # lines starting after query end are out
        last = int(np.searchsorted(pos, query.end_position, "right"))
        # lines whose running-max end is before query start can't overlap
        first = int(np.searchsorted(cme, query.start_position, "left"))
        if first >= last:
            return np.empty(0, np.int64)
        idx = np.arange(lo + first, lo + last, dtype=np.int64)
        # exact overlap filter
        keep = (self.end[idx] >= query.start_position) & (
            self.pos[idx] <= query.end_position
        )
        return idx[keep]


from collections import namedtuple

_Hit = namedtuple("_Hit", ["offset", "line_length"])


def query_manifest(vcfc: bytes, manifest: Manifest, query: CoordinateQuery):
    """Yield decompressed matching lines via manifest lookup.  Hits
    decode in batches through the native pipeline (query/bulk.py —
    per-line oracle decode costs ~0.4 ms/2,504-sample line, so a
    2,500-line range would spend ~1 s there)."""
    from ..query.bulk import HitBuffer

    header = parse_metadata_headers(vcfc)
    buf = HitBuffer(vcfc, header)
    for i in manifest.select(query):
        yield from buf.add(_Hit(int(manifest.offset[i]), int(manifest.length[i])))
    yield from buf.flush()
