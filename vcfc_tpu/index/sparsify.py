"""Offset-as-index sparse files ("sparsify" / "sparse-query").

A .vcfc is rewritten into a filesystem-sparse file where each compressed
line lives at a deterministic offset computed from its (CHROM, POS)
(sparse.cpp:290-580):

  file layout:
    [meta/header lines verbatim]
    [8B first-line offset slot]            <- variant offset of first line,
                                              native little-endian u64 (the
                                              reference writes the raw u64,
                                              sparse.cpp:511)
    ... holes ...
    at data_start + offset(chrom,pos):
      [8B distance_to_previous, big-endian]
      [8B distance_to_next, big-endian]    <- 0 for the last line
      [compressed line bytes]

Queries either seek straight to offset(chrom,pos) for single-variant
lookups or use SEEK_DATA + linear next-distance hops for ranges
(query_sparse_file_fd, main.cpp:235-582).

The design is intentionally OS-coupled (EXT4/XFS holes); we reproduce it
for drop-in compatibility.  The filesystem-independent replacement is the block
manifest in ``vcfc_tpu.index.manifest``.
"""

from __future__ import annotations

import os
import struct

from ..format.headers import decode_line_headers
from ..format.lines import decode_data_line
from ..format.vcf import parse_metadata_headers
from ..query.coordinate import CoordinateQuery
from ..utils.config import SparseConfig
from ..utils.timing import timing_probe

_BE = struct.Struct(">Q")
_LE = struct.Struct("<Q")


def sparsify_file(vcfc: bytes, out_path: str, config: SparseConfig | None = None) -> None:
    """Write the offset-as-index sparse file for a .vcfc stream."""
    config = config or SparseConfig()
    header = parse_metadata_headers(vcfc)

    with open(out_path, "wb") as f:
        for line in header.meta_lines:
            f.write(line)
        f.write(header.header_line)
        f.write(b"\x00" * 8)  # first-line offset slot, backpatched below
        data_start = f.tell()

        offset = header.data_offset
        n = len(vcfc)
        prev_file_offset = data_start
        first = True
        while offset < n:
            line_length, required_length = decode_line_headers(vcfc, offset)
            blob = vcfc[offset + 8 : offset + 8 + required_length]
            cols = blob.split(b"\t", 2)
            chrom, pos = cols[0], int(cols[1])

            variant_offset = config.compute_sparse_offset(chrom, pos)
            file_offset = data_start + variant_offset

            # Distances are u64; like the reference's unsigned arithmetic
            # they wrap silently if positions regress (offset-as-index
            # files are per-chromosome by design; sparse.hpp:15).
            dist = (file_offset - prev_file_offset) & 0xFFFF_FFFF_FFFF_FFFF
            if first:
                f.seek(data_start - 8)
                f.write(_LE.pack(variant_offset))  # native-endian quirk preserved
                first = False
            else:
                # backpatch previous line's distance_to_next
                f.seek(prev_file_offset + 8)
                f.write(_BE.pack(dist))

            f.seek(file_offset)
            f.write(_BE.pack(dist))  # distance_to_previous
            f.write(_BE.pack(0))  # distance_to_next (backpatched by successor)
            f.write(vcfc[offset : offset + 4 + line_length])

            prev_file_offset = file_offset
            offset += 4 + line_length


def query_sparse_file(path: str, query: CoordinateQuery, config: SparseConfig | None = None):
    """Yield decompressed matching lines from a sparsified file."""
    config = config or SparseConfig()
    with open(path, "rb") as f:
        # grow the header read until the #CHROM line fits (wide cohorts can
        # exceed 1 MiB of meta+header; the reference reads unboundedly)
        head_size = 1 << 20
        while True:
            f.seek(0)
            raw_head = f.read(head_size)
            try:
                header = parse_metadata_headers(raw_head)
                break
            except Exception:
                if len(raw_head) < head_size:
                    raise  # whole file read and still malformed
                head_size *= 4
        sample_count = header.schema.sample_count
        data_start = header.data_offset + 8
        f.seek(header.data_offset)
        (first_line_offset,) = _LE.unpack(f.read(8))

        fd = f.fileno()
        step = config.multiplication_factor * config.block_size

        def read_line_at(off: int) -> tuple[bytes, int] | None:
            """Decode the compressed line at absolute offset `off` (past the
            16B distance prefix)."""
            f.seek(off)
            hdr = f.read(8)
            if len(hdr) < 8:
                return None
            line_length, _ = decode_line_headers(hdr)
            f.seek(off)
            buf = f.read(4 + line_length)
            return decode_data_line(buf, 0, sample_count)

        if query.has_criteria() and query.start_position == query.end_position:
            # single-variant lookup: direct seek + hole heuristic
            # (main.cpp:277-333)
            target = data_start + config.compute_sparse_offset(
                query.reference_name, query.start_position
            )
            f.seek(target)
            prefix = f.read(16)
            if len(prefix) < 16:
                return
            (dist_prev,) = _BE.unpack(prefix[:8])
            if dist_prev == 0 and target != data_start + first_line_offset:
                return  # hole: no such variant
            got = read_line_at(target + 16)
            if got:
                yield got[0]
            return

        if not query.has_criteria():
            raise NotImplementedError("sparse query with no filter is not yet implemented")

        # range lookup (main.cpp:335-566)
        target = data_start + config.compute_sparse_offset(
            query.reference_name, query.start_position
        )
        with timing_probe("decompress_seeking"):
            try:
                pos = os.lseek(fd, target, os.SEEK_DATA)
            except OSError:
                return  # beyond EOF: nothing at or after the requested start
            if pos != target:
                # landed after a hole; realign to the next viable line slot
                rem = (pos - data_start) % step
                if rem:
                    pos += step - rem
            # probe forward until a real line (distance_to_previous != 0)
            while True:
                f.seek(pos)
                prefix = f.read(16)
                if len(prefix) < 16:
                    return
                (dist_prev,) = _BE.unpack(prefix[:8])
                if dist_prev == 0 and pos != data_start + first_line_offset:
                    pos += step
                    continue
                break

        # linear traversal over next-distance hops; the match predicate
        # reads CHROM/POS from the uncompressed required-columns region,
        # so hits buffer as raw blobs and decode in batches through the
        # native pipeline (query/bulk.py)
        from ..query.bulk import BULK_CHUNK, decode_hit_blobs

        header_blob = raw_head[: header.data_offset]
        pending: list[bytes] = []
        while True:
            f.seek(pos)
            prefix = f.read(16)
            if len(prefix) < 16:
                break
            (dist_prev,) = _BE.unpack(prefix[:8])
            (dist_next,) = _BE.unpack(prefix[8:])
            if dist_prev == 0 and dist_next == 0:
                raise ValueError("No previous or next distance values")
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            line_length, req_len = decode_line_headers(hdr)
            f.seek(pos + 16)
            buf = f.read(4 + line_length)
            if len(buf) < 4 + line_length or len(buf) < 8 + req_len:
                break  # truncated file: clean end of results (as before)
            cols = buf[8 : 8 + req_len].split(b"\t", 2)
            if len(cols) < 2:
                break
            chrom, pos_str = cols[:2]
            vpos = int(pos_str)
            if chrom.decode() == query.reference_name and vpos <= query.end_position:
                pending.append(buf)
                if len(pending) >= BULK_CHUNK:
                    yield from decode_hit_blobs(header_blob, header, pending)
                    pending = []
                if dist_next == 0:
                    break  # end of reference chain
                if vpos >= query.end_position:
                    break
                pos += dist_next
            else:
                break
        yield from decode_hit_blobs(header_blob, header, pending)
