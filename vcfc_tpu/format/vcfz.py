"""`.vcfz` — entropy-coded extension container (beyond reference parity).

A lossless transcoding of `.vcfc`: the per-line sample stream (flag bytes
plus escape columns) becomes a symbol stream — symbols 0..255 are flag
bytes, 256+k is the k-th entry of a per-file escape-string dictionary
(first-occurrence order) — Huffman-coded with global canonical codebooks.
Version 1 uses ONE codebook; versions 2 and 3 (the default) use N_CTX=4
codebooks selected per symbol by the CLASS of the previous symbol (full
0|0 run / short 0|0 run / het run / escape;
ops/huffman.py::symbol_classes), which captures ~96% of the order-1
entropy gain.  Version 4 (opt-in) adds VERTICAL PREDICTION: per block,
each line is coded as a residual against the previous line — cells equal
to the cell above collapse into MATCH-run symbols (band m_base + len,
m_base = 256 + n_escapes; 5th context class) — 2.4x smaller than v3 on
LD-correlated cohorts (62x vs VCF at mutation rate 0.03), identical
container layout otherwise.  Lines are grouped into blocks
that decode independently (each block's first symbol is coded in context
CTX_INIT), and a block table with (first/last position, per-block max end
position) lets queries prune to overlapping blocks in one linear pass
over the tiny table.  This is the "global codebook via
collectives" path of BASELINE.json: histograms come from the device mesh
(psum-merged), the codebooks are replicated, blocks are data-parallel.

Layout (little-endian):

  magic "VCFZ" | u32 version (1-8) | u8 max_code_len | u32 block_lines
  u64 n_lines | u32 n_samples
  u64 header_len | header blob (meta + #CHROM lines verbatim)
  u32 n_escapes | per escape: u16 len | bytes
  u32 n_symbols (v1-v3/v5/v8: 256 + n_escapes; v4/v6/v7: 256 + n_escapes +
                 n_samples + 1 — the vertical-match band)
  u8 lengths[n_symbols] x n_books                (canonical symbol codebooks;
                 n_books = 1 for v1/v5/v6, N_CTX=4 for v2/v3/v8,
                 N_CTX_V4=5 for v4/v7)
  [v3+] u8 req_lengths[256]                      (order-0 required-bytes book)
  u32 req_len[n_lines]                           (required-cols length)
  u32 nsym[n_lines]                              (symbols per line)
  u64 req_region_len |
      v1/v2: concatenated raw required-column blobs
      v3+: per-block order-0-coded required-column payloads
  u32 n_blocks | per block:
      u64 payload_len | u64 n_block_symbols | [v3+] u64 req_payload_len
      u8 ref_first | u32 pos_first | u8 ref_last | u32 pos_last | u32 cummax_end
      [v7] u32 ctx_nsym[5] | u32 ctx_plen[5]     (context sub-stream framing)
      [v8] u32 ctx_nsym[4] | u32 ctx_plen[4]     (literal-context framing)
  symbol payloads (bit-packed, byte-aligned per block; v7/v8: each block's
      payload is the concatenation of its per-context sub-payloads)
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

from ..ops.huffman import (
    CTX_INIT,
    MAX_CODE_LEN,
    N_CTX,
    N_CTX_V4,
    Codebook,
    context_codebooks,
    ctx_of_stream,
    pack_symbols,
    pack_symbols_ctx,
    symbol_classes,
    unpack_symbols,
    unpack_symbols_ctx,
)
from ..query.coordinate import CoordinateQuery
from ..utils.refmap import reference_to_int
from .headers import encode_length_header
from .lines import VcfValidationError
from .vcf import parse_metadata_headers

MAGIC = b"VCFZ"
# v1 = one global codebook; v2 = context-classed codebooks; v3 = v2 plus an
# order-0 codebook over the required-columns bytes (per-block payloads,
# 38-byte block entries); v4 = v3 plus vertical prediction (N_CTX_V4
# books, MATCH-run symbol band); v5 = v3's layout with ONE order-0
# symbol codebook — the opt-in device-decode container: order-0 streams
# are what the gather-free bit-parallel device decoder
# (ops/huffman_device.py) accepts, at a measured ~10-20% ratio cost vs
# v3's context books; v6 = v4's vertical prediction with v5's single
# order-0 book — the device-decodable container for LD-correlated
# cohorts; v7 = v4's exact compression (same books, same per-symbol
# codes, same vertical transform) with each block's stream SPLIT into
# per-context order-0 sub-payloads (symbol i's context = class of symbol
# i-1 is an elementwise shift, so the split is free at encode; decode
# re-merges with an O(symbols) automaton walk) — every sub-payload
# entropy-decodes block-parallel on device, eliminating v6's ~13% ratio
# price for device decodability at ~44 bytes/block of framing; v8 = the
# SAME context-split trick applied to v3's LITERAL streams (v3's books,
# per-symbol codes, and ratio — no vertical transform), so uncorrelated
# data keeps v3's ratio with block-parallel device decode, retiring v5's
# order-0 tax — the last cell of the {literal, vertical} x {context,
# order-0, split} matrix.  All
# versions read everywhere (incl.
# the native CLI); VERSION is the default write (v4 is opt-in: it wins
# big on LD-correlated cohorts but costs ~18% on uncorrelated data).
VERSION = 3
DEFAULT_BLOCK_LINES = 256
# v4 default: a point query decodes symbols (and resolves vertical rows)
# from the block start to the hit row, so the block height bounds the
# tail latency.  64 lines cuts the measured hit cost ~2.9x (11.2 -> 3.9
# ms on the uncorrelated eval cohort) for +0.4% size there and -3.7%
# ratio on the LD-correlated cohort (62.5x -> 60.2x) — the right trade
# for a random-access container; v3 rows are independent and keep 256.
DEFAULT_BLOCK_LINES_V4 = 64
_ESC_FLAG = 0xE1


def default_block_lines(version: int) -> int:
    return DEFAULT_BLOCK_LINES_V4 if version in (4, 6, 7) else DEFAULT_BLOCK_LINES


def _line_symbol_stream(raw, line_off, line_len, req_len, escape_dict):
    """Walk one compressed line's sample bytes into symbols (oracle walker,
    shared by build paths)."""
    body = raw[line_off + 8 + req_len : line_off + 4 + line_len - 1]
    symbols = []
    i = 0
    n = len(body)
    while i < n:
        f = body[i]
        i += 1
        if (f & 0xE0) == 0xE0:
            if (f & 0x1F) != 1:
                raise VcfValidationError("escape flag with count != 1")
            j = body.find(b"\t", i)
            if j < 0:
                j = n
            key = bytes(body[i:j])
            symbols.append(256 + escape_dict.setdefault(key, len(escape_dict)))
            i = j + 1 if j < n else n
        else:
            symbols.append(f)
    return symbols


def _symbol_streams_native(vcfc: bytes, parsed=None):
    """Vectorized symbol-stream extraction via the native .vcfc parser.

    Returns (all_syms int32, nsym int32 per line, escape list) or None when
    the native library is unavailable (caller falls back to the per-line
    oracle walker).  ~20x faster than the Python walk on cohort files.
    ``parsed`` may carry a pre-parsed NativeParsedVcfc (the device route
    shares one parse between symbol extraction and the kernels)."""
    from ..host import native as native_mod

    if not native_mod.available():
        return None
    from ..host.fast import parse_vcfc_native

    if parsed is None:
        parsed = parse_vcfc_native(vcfc)
    if parsed.oracle_line.any():
        # structurally irregular lines (never produced by our encoder)
        # would break first-occurrence escape-id ordering if spliced;
        # keep the byte contract by taking the oracle walk wholesale
        return None
    # per-line flag bytes in sample order (native compaction)
    nsym = parsed.nflags.astype(np.int32)
    values = native_mod.compact_flags(parsed.flags, nsym).astype(np.int32)

    # escape-dictionary coding: replace 0xE1 flags with 256 + id.  The
    # native escape side channel is ordered by (line, sample), matching
    # the nonzero traversal order exactly.
    esc_mask = (values & 0xE0) == 0xE0
    n_esc = int(esc_mask.sum())
    raw_np = np.frombuffer(vcfc, np.uint8)
    esc_list: list[bytes] = []
    if n_esc:
        off = parsed.esc_off
        ln = parsed.esc_len
        max_len = int(ln.max())
        if max_len <= 64:
            # fixed-width keys -> np.unique dedup, then remap the ids to
            # FIRST-OCCURRENCE order so the output bytes are identical to
            # the oracle walker's (CLAUDE.md byte contract: every fast
            # path must produce the same bytes as the fallback).  Short
            # escapes (the overwhelmingly common case: GT strings like
            # "2|0") pack into one u64 key — ~20x faster to unique than
            # a wide void dtype.
            kw = 8 if max_len <= 7 else max_len + 4
            keys = np.zeros((n_esc, kw), np.uint8)
            if max_len <= 7:
                keys[:, 0] = ln.astype(np.uint8)
                content_col = 1
            else:
                keys[:, :4] = ln.astype(np.uint32).view(np.uint8).reshape(-1, 4)
                content_col = 4
            gather = off[:, None] + np.arange(max_len)[None, :]
            valid = np.arange(max_len)[None, :] < ln[:, None]
            keys[:, content_col : content_col + max_len] = np.where(
                valid, raw_np[np.minimum(gather, len(raw_np) - 1)], 0
            )
            if max_len <= 7:
                key_view = keys.view(np.uint64).reshape(-1)
            else:
                key_view = keys.view([("k", np.uint8, keys.shape[1])]).reshape(-1)
            uniq, first_pos, inv = np.unique(
                key_view, return_index=True, return_inverse=True
            )
            order = np.argsort(first_pos, kind="stable")  # first-seen order
            rank = np.empty(len(uniq), np.int32)
            rank[order] = np.arange(len(uniq), dtype=np.int32)
            uniq_keys = uniq.view(np.uint8).reshape(len(uniq), keys.shape[1])[order]
            for k in uniq_keys:
                klen = int(k[0]) if max_len <= 7 else int(k[:4].view(np.uint32)[0])
                esc_list.append(bytes(k[content_col : content_col + klen]))
            values[esc_mask] = 256 + rank[inv]
        else:  # pragma: no cover - pathologically long escape strings
            d: dict[bytes, int] = {}
            ids = np.empty(n_esc, np.int32)
            for k in range(n_esc):
                key = vcfc[int(off[k]) : int(off[k]) + int(ln[k])]
                ids[k] = d.setdefault(key, len(d))
            esc_list = sorted(d, key=d.get)
            values[esc_mask] = 256 + ids

    return values, nsym, esc_list


def symbol_streams(vcfc: bytes, recs=None):
    """Symbol streams for every data line of a .vcfc stream.

    Returns (all_syms int32 concatenated, nsym uint32 per line, escape
    list in first-occurrence order).  Native fast path with a per-line
    oracle-walk fallback; both produce identical output."""
    fast = _symbol_streams_native(vcfc)
    if fast is not None:
        all_syms, nsym_i32, esc_list = fast
        return all_syms, nsym_i32.astype(np.uint32), esc_list
    if recs is None:
        from ..index.scan import scan_lines

        recs = list(scan_lines(vcfc))
    escape_dict: dict[bytes, int] = {}
    per_line_syms = [
        _line_symbol_stream(vcfc, r.offset, r.line_length, r.required_length, escape_dict)
        for r in recs
    ]
    all_syms = np.concatenate(
        [np.asarray(s, np.int32) for s in per_line_syms]
    ) if per_line_syms else np.zeros(0, np.int32)
    nsym = np.array([len(s) for s in per_line_syms], np.uint32)
    esc_list = sorted(escape_dict, key=escape_dict.get)
    return all_syms, nsym, esc_list


# --------------------------------------------------------------------------
# Version 4: vertical (cross-variant) prediction.  Real cohort data is
# strongly correlated row-to-row (linkage disequilibrium): consecutive
# variants carry near-identical genotype columns.  v4 keeps the v3
# container layout but replaces each block's symbol streams with
# residuals against the previous line: cells equal to the cell above
# become MATCH runs (symbols >= m_base = 256 + n_escapes encode a
# vertical-match run of `sym - m_base` samples), everything else stays
# literal (flag-byte / escape-dictionary symbols, exactly v3).  Each
# block's first line is always literal, so random access per block is
# preserved.  Escape cells never match (text equality is not implied by
# code equality).  The transform is a dense (lines x samples) rows
# comparison — the device-friendly formulation; the reference has no
# cross-variant modeling at all.

# single source of truth for the flag scheme: format/constants.py
from .constants import CODE_ESCAPE, CODE_FLAG_BASE, CODE_RUN_CAP

_FLAG_BASE_BY_CODE = tuple(CODE_FLAG_BASE[c] for c in range(4))
_RUN_CAP_BY_CODE = tuple(CODE_RUN_CAP[c] for c in range(4))
_CODE_MATCH = 5  # transient row code; never serialized directly


def _symbol_run_lens(symbols, is_esc, is_match=None, m_base=0):
    """Samples covered per symbol: flag bytes carry their count field,
    escape symbols cover one cell, MATCH symbols (v4) carry
    ``sym - m_base``.  Shared by the body builder and the row expander
    so the flag-band decode rules live in exactly one place."""
    run_len = np.where(
        is_esc,
        1,
        np.where(
            symbols < 0x80,
            symbols & 0x7F,
            np.where((symbols & 0xE0) == 0xE0, 1, symbols & 0x1F),
        ),
    )
    if is_match is not None:
        run_len = np.where(is_match, symbols - m_base, run_len)
    return run_len


def _expand_block_rows(symbols, nsym, S, m_base=None):
    """One block's symbols -> ((n, S) uint8 code rows, (n, S) int32
    escape-id grid with -1 elsewhere).  Codes: 0-3 phased GTs, 4 escape,
    5 MATCH (only when ``m_base`` is given, i.e. v4 streams)."""
    symbols = np.asarray(symbols, np.int64)
    nsym = np.asarray(nsym, np.int64)
    n = len(nsym)
    if S > 0 and n and (nsym <= 0).any():
        # every line covers S > 0 samples, so zero-symbol lines are
        # corrupt — and would negative-index the escape-base computation
        raise ValueError("corrupt .vcfz: zero-symbol line in a nonempty cohort")
    mb = m_base if m_base is not None else np.iinfo(np.int64).max
    is_match = symbols >= mb
    is_esc = (symbols >= 256) & ~is_match
    run_len = _symbol_run_lens(symbols, is_esc, is_match, mb)
    code = np.where(
        is_match,
        _CODE_MATCH,
        np.where(
            is_esc,
            CODE_ESCAPE,
            np.where(
                symbols < 0x80,
                0,
                np.where(
                    (symbols & 0xE0) == 0xA0,
                    1,
                    np.where((symbols & 0xE0) == 0xC0, 2, 3),
                ),
            ),
        ),
    ).astype(np.uint8)
    cells = np.repeat(code, run_len)
    if len(cells) != n * S:
        raise ValueError("corrupt .vcfz: block symbols do not cover the sample grid")
    rows = cells.reshape(n, S)
    esc_grid = np.full((n, S), -1, np.int32)
    k = np.flatnonzero(is_esc)
    if len(k):
        cum = np.cumsum(run_len)
        line_of = np.repeat(np.arange(n), nsym)
        line_end = np.cumsum(nsym)
        bases = np.concatenate([[0], cum[line_end[:-1] - 1]]) if n > 1 else np.zeros(1, np.int64)
        covered_after = cum - np.repeat(bases, nsym)
        esc_grid[line_of[k], covered_after[k] - 1] = (symbols[k] - 256).astype(np.int32)
    return rows, esc_grid


def _emit_row_symbols(work, esc_grid, m_base):
    """Horizontal RLE of code rows over {0-3, 4=escape, 5=MATCH} into
    symbol streams: flag bytes with the reference's greedy 127/31 caps,
    256+id per escape cell, m_base+len per MATCH run.  Returns
    (flat symbols int64, per-row counts uint32)."""
    n, S = work.shape
    counts = np.zeros(n, np.uint32)
    if S == 0:
        return np.zeros(0, np.int64), counts
    caps = _RUN_CAP_BY_CODE
    out: list[int] = []
    for i in range(n):
        r = work[i]
        is_esc = r == CODE_ESCAPE
        newrun = np.empty(S, bool)
        newrun[0] = True
        newrun[1:] = (r[1:] != r[:-1]) | is_esc[1:] | is_esc[:-1]
        starts = np.flatnonzero(newrun)
        lens = np.diff(np.append(starts, S))
        eg = esc_grid[i]
        before = len(out)
        for s, l in zip(starts.tolist(), lens.tolist()):
            v = int(r[s])
            if v == _CODE_MATCH:
                out.append(m_base + l)
            elif v == CODE_ESCAPE:
                out.append(256 + int(eg[s]))
            else:
                cap = caps[v]
                base = _FLAG_BASE_BY_CODE[v]
                nf, rem = divmod(l, cap)
                out.extend([base | cap] * nf)
                if rem:
                    out.append(base | rem)
        counts[i] = len(out) - before
    return np.array(out, np.int64), counts


def _require_greedy(symbols, nsym) -> None:
    """v4 re-emits greedy maximal capped runs, so it is byte-exact only
    for greedily encoded inputs (everything the reference encoder or any
    of ours produces).  A valid-but-non-greedy .vcfc (e.g. ten 0|0
    samples as [0x05, 0x05]) would be silently canonicalized — reject it
    so the lossless transcode contract cannot be broken quietly.  The
    non-greedy signature: a literal flag follows a same-code literal
    whose count is below the cap."""
    syms = np.asarray(symbols, np.int64)
    if len(syms) < 2:
        return
    lit = syms < 256
    code = np.where(
        syms < 0x80,
        0,
        np.where((syms & 0xE0) == 0xA0, 1, np.where((syms & 0xE0) == 0xC0, 2, 3)),
    )
    ln = np.where(syms < 0x80, syms & 0x7F, syms & 0x1F)
    cap = np.where(code == 0, 127, 31)
    first = np.zeros(len(syms), bool)
    nsym = np.asarray(nsym, np.int64)
    starts = np.concatenate([[0], np.cumsum(nsym)[:-1]])
    first[starts[nsym > 0]] = True
    bad = (
        ~first[1:]
        & lit[1:]
        & lit[:-1]
        & (code[1:] == code[:-1])
        & (ln[:-1] < cap[:-1])
    )
    if bad.any():
        raise ValueError(
            "non-greedy flag runs: .vcfz v4 requires canonically (greedily) "
            "encoded .vcfc input — use version 3 for byte-exact transcoding "
            "of non-canonical streams"
        )


def _v4_transform_block(symbols, nsym, S, m_base):
    """v3 symbol streams of one block -> v4 (vertical-residual) streams."""
    _require_greedy(symbols, nsym)
    rows, esc_grid = _expand_block_rows(symbols, nsym, S)
    work = rows.copy()
    if len(rows) > 1:
        match = (
            (rows[1:] == rows[:-1])
            & (rows[1:] != CODE_ESCAPE)
            & (rows[:-1] != CODE_ESCAPE)
        )
        work[1:][match] = _CODE_MATCH
    return _emit_row_symbols(work, esc_grid, m_base)


def _split_ctx_streams(symbols, classes, n_ctx=N_CTX_V4):
    """v7's encode-side stream split: symbol i belongs to sub-stream
    ctx(i) = class(symbol i-1) (CTX_INIT at block start) — an
    ELEMENTWISE shift, so the partition costs one vectorized pass.
    Each sub-stream is then order-0 under its own context codebook
    (identical per-symbol codes to v4's context-switched stream, so v7
    pays only per-block framing), and each decodes block-parallel on
    device because no bit depends on another stream."""
    symbols = np.asarray(symbols, np.int64)
    ctx = ctx_of_stream(symbols, classes)
    return [symbols[ctx == c] for c in range(n_ctx)]


def _merge_ctx_streams(subs, classes, total):
    """v7's decode-side inverse: replay the context automaton over the
    already-decoded sub-streams (take next symbol from stream[ctx];
    ctx = class(symbol)).  Sequential, but O(symbols) symbol-level work
    — the O(bits) entropy decode happened block-parallel before this —
    and the native runtime does it branch-free per block
    (vcfc_host.cpp::vcfz_merge_ctx); this numpy/python body is the
    oracle fallback."""
    from ..host import native

    total = int(total)
    ends = np.cumsum([len(s) for s in subs])
    if int(ends[-1]) != total:
        raise ValueError("corrupt .vcfz v7: sub-stream counts do not sum")
    if native.available():
        flat = np.concatenate([np.asarray(s, np.int32) for s in subs]) if total else np.zeros(0, np.int32)
        offsets = np.concatenate([[0], ends]).astype(np.int64)
        return native.vcfz_merge_ctx(flat, offsets, classes, CTX_INIT, total)
    out = np.empty(total, np.int64)
    idx = [0] * len(subs)
    ends_l = [len(s) for s in subs]
    ctx = CTX_INIT
    for i in range(total):
        k = idx[ctx]
        if k >= ends_l[ctx]:
            raise ValueError("corrupt .vcfz v7: context sub-stream underrun")
        s = int(subs[ctx][k])
        idx[ctx] = k + 1
        out[i] = s
        ctx = int(classes[s])
    return out


def _v4_block_to_v3(symbols, nsym, S, m_base):
    """Inverse of _v4_transform_block: resolve MATCH cells downward, then
    re-emit plain v3 streams (which the shared body builder consumes)."""
    rows, esc_grid = _expand_block_rows(symbols, nsym, S, m_base)
    if len(rows):
        if (rows[0] == _CODE_MATCH).any():
            raise ValueError("corrupt .vcfz v4: MATCH in a block's first line")
        for i in range(1, len(rows)):
            m = rows[i] == _CODE_MATCH
            rows[i][m] = rows[i - 1][m]
    return _emit_row_symbols(rows, esc_grid, m_base)


def serialize_prefix(
    version: int,
    block_lines: int,
    n_lines: int,
    n_samples: int,
    header_blob: bytes,
    esc_list: list[bytes],
    books: list[Codebook],
) -> bytes:
    """Container bytes before the req_lens array (magic through the
    canonical length tables) — identical on every host given the same
    global escape dictionary and codebooks.

    books: v1 = [symbol book]; v2 = N_CTX symbol books; v3 = N_CTX symbol
    books + the 256-entry required-bytes book; v4 = N_CTX_V4 symbol books
    + the required-bytes book (each book's length table is written
    verbatim; the reader knows the counts from the version and the
    alphabet size from the header field)."""
    out = bytearray()
    out += MAGIC + struct.pack("<IBI", version, MAX_CODE_LEN, block_lines)
    out += struct.pack("<QI", n_lines, n_samples)
    out += struct.pack("<Q", len(header_blob)) + header_blob
    out += struct.pack("<I", len(esc_list))
    for e in esc_list:
        if len(e) > 0xFFFF:
            # fail up front with a format-level message instead of a raw
            # struct.error mid-serialization (escape lengths ride as u16)
            raise ValueError(
                f"escape string of {len(e)} bytes exceeds the .vcfz 64 KB "
                "escape-length field"
            )
        out += struct.pack("<H", len(e)) + e
    # alphabet size from the symbol books themselves: 256 + n_escapes for
    # v1-v3, plus the S+1 vertical-match band for v4
    out += struct.pack("<I", len(books[0].lengths))
    for book in books:
        out += book.lengths.tobytes()
    return bytes(out)


def req_codebook(req_blob: bytes | np.ndarray) -> Codebook:
    """Order-0 canonical codebook over required-columns bytes (v3)."""
    arr = np.frombuffer(req_blob, np.uint8) if isinstance(req_blob, bytes) else req_blob
    return Codebook.from_frequencies(np.bincount(arr, minlength=256))


def pack_req(req_bytes: bytes, book: Codebook) -> bytes:
    """Pack raw required-columns bytes with the order-0 req codebook
    (native bit writer when available)."""
    from ..host import native

    syms = np.frombuffer(req_bytes, np.uint8).astype(np.int32)
    if native.available():
        return native.huffman_encode_ctx(
            syms,
            book.codes[None],
            book.lengths[None],
            np.zeros(256, np.uint8),
            0,
        )
    payload, _bits = pack_symbols(syms, book)
    return payload


def unpack_req(payload: bytes, n_bytes: int, book: Codebook,
               tables=None) -> bytes:
    """Inverse of pack_req."""
    from ..host import native

    if native.available():
        sym_t, len_t = tables if tables is not None else book.decode_table()
        return native.huffman_decode(payload, n_bytes, sym_t, len_t).astype(
            np.uint8
        ).tobytes()
    return unpack_symbols(payload, n_bytes, book).astype(np.uint8).tobytes()


@dataclass
class _Geometry:
    """Per-line container geometry shared by the host and device writers
    (one scan pass; every byte-emitting consumer reads the same arrays)."""

    header_blob: bytes
    S: int
    L: int
    recs: list
    req_blob: bytes
    req_lens: np.ndarray  # (L,) uint32
    positions: np.ndarray  # (L,) uint32
    refs: np.ndarray  # (L,) uint8
    ends: np.ndarray  # (L,) uint32


def _scan_geometry(vcfc: bytes) -> _Geometry:
    from ..index.scan import scan_lines

    header = parse_metadata_headers(vcfc)
    header_blob = b"".join(header.meta_lines) + header.header_line
    S = header.schema.sample_count

    recs = list(scan_lines(vcfc))
    L = len(recs)
    req_blobs = []
    req_lens = np.empty(L, np.uint32)
    positions = np.empty(L, np.uint32)
    refs = np.empty(L, np.uint8)
    ends = np.empty(L, np.uint32)
    for i, r in enumerate(recs):
        req_blobs.append(vcfc[r.offset + 8 : r.offset + 8 + r.required_length])
        req_lens[i] = r.required_length
        positions[i] = r.pos
        refs[i] = reference_to_int(r.chrom)
        ends[i] = r.end_position()
    return _Geometry(
        header_blob, S, L, recs, b"".join(req_blobs), req_lens, positions,
        refs, ends,
    )


def _assemble_container(
    version: int,
    block_lines: int,
    geo: _Geometry,
    esc_list: list[bytes],
    books: list[Codebook],
    req_book: Codebook | None,
    nsym: np.ndarray,
    block_ranges: list[tuple[int, int]],
    payloads: list[bytes],
    req_payloads: list[bytes],
    n_block_syms: list[int],
    ctx_meta: list[bytes] | None = None,
) -> bytes:
    """Serialize the container from fully materialized per-block payloads
    — the single byte-emitting tail behind the host and device writers.
    ``ctx_meta`` (v7): per block, the u32[n_ctx] sub-stream symbol counts
    followed by the u32[n_ctx] sub-payload byte lengths, appended verbatim
    after the standard block entry."""
    prefix_books = books + [req_book] if req_book is not None else books
    out = bytearray()
    out += serialize_prefix(
        version, block_lines, geo.L, geo.S, geo.header_blob, esc_list,
        prefix_books,
    )
    out += geo.req_lens.tobytes()
    out += np.asarray(nsym, np.uint32).tobytes()

    blocks = []
    for bi, (lo, hi) in enumerate(block_ranges):
        cummax_end = int(geo.ends[lo:hi].max())
        if version >= 3:
            entry = struct.pack(
                "<QQQBIBII",
                len(payloads[bi]),
                n_block_syms[bi],
                len(req_payloads[bi]),
                int(geo.refs[lo]),
                int(geo.positions[lo]),
                int(geo.refs[hi - 1]),
                int(geo.positions[hi - 1]),
                cummax_end,
            )
            if ctx_meta is not None:
                entry += ctx_meta[bi]
            blocks.append(entry)
        else:
            blocks.append(
                struct.pack(
                    "<QQBIBII",
                    len(payloads[bi]),
                    n_block_syms[bi],
                    int(geo.refs[lo]),
                    int(geo.positions[lo]),
                    int(geo.refs[hi - 1]),
                    int(geo.positions[hi - 1]),
                    cummax_end,
                )
            )

    if version >= 3:
        req_region = b"".join(req_payloads)
        out += struct.pack("<Q", len(req_region)) + req_region
    else:
        out += struct.pack("<Q", len(geo.req_blob)) + geo.req_blob
    out += struct.pack("<I", len(blocks))
    for b in blocks:
        out += b
    for p in payloads:
        out += p
    return bytes(out)


def vcfz_from_vcfc(
    vcfc: bytes,
    block_lines: int | None = None,
    version: int = VERSION,
    route: str | None = None,
) -> bytes:
    """Transcode .vcfc -> .vcfz (lossless).

    version 3 (default) codes each symbol with the codebook selected by
    the previous symbol's class (4 classes — ~96% of the order-1 entropy
    gain) and order-0-codes the required-column bytes per block;
    version 2 leaves required columns raw; version 1 uses one global
    symbol codebook.  version 4 (opt-in) adds vertical prediction:
    per-block residuals against the previous variant line with
    MATCH-run symbols — a large win on LD-correlated cohorts, a small
    cost on uncorrelated data (see _v4_transform_block).  version 7 =
    v4's books and transform with context-SPLIT per-block sub-payloads
    (device-decodable at v4's ratio; _split_ctx_streams); version 8 =
    the same split applied to v3's literal streams (device-decodable at
    v3's ratio — no vertical transform).

    ``route`` (default: the VCFZ_PACK env var) selects the entropy-coding
    backend: "device" runs symbol emission and Huffman bit packing as device
    kernels (ops/vcfz_device.py), byte-identical to the host writer;
    structurally unsupported inputs fall back to the host path."""
    if version not in (1, 2, 3, 4, 5, 6, 7, 8):
        raise ValueError(f"unsupported .vcfz version {version}")
    block_lines = block_lines or default_block_lines(version)
    if (route or os.environ.get("VCFZ_PACK")) == "device":
        from .vcfz_device import vcfz_from_vcfc_device

        out = vcfz_from_vcfc_device(vcfc, block_lines, version)
        if out is not None:
            return out

    geo = _scan_geometry(vcfc)
    S, L, req_lens = geo.S, geo.L, geo.req_lens

    all_syms, nsym, esc_list = symbol_streams(vcfc, geo.recs)
    n_symbols = 256 + len(esc_list)
    sym_ends = np.cumsum(nsym)

    def block_slice(lo, hi):
        s0 = 0 if lo == 0 else int(sym_ends[lo - 1])
        return all_syms[s0 : int(sym_ends[hi - 1])] if hi > lo else all_syms[:0]

    block_ranges = [
        (lo, min(lo + block_lines, L)) for lo in range(0, L, block_lines)
    ]
    req_blob = geo.req_blob
    classes = None
    if version in (4, 6, 7):
        # vertical-residual transform per block; MATCH runs live in the
        # symbol band [m_base, m_base + S].  v6 = the same transform with
        # ONE order-0 book (device-decodable; v4 keeps the context set)
        m_base = 256 + len(esc_list)
        n_symbols = m_base + S + 1
        per_block_syms = []
        nsym_v3 = nsym
        nsym = np.empty(L, np.uint32)
        for lo, hi in block_ranges:
            s4, counts = _v4_transform_block(
                block_slice(lo, hi), nsym_v3[lo:hi], S, m_base
            )
            per_block_syms.append(s4)
            nsym[lo:hi] = counts
        classes = symbol_classes(n_symbols, match_base=m_base)
        if version == 6:
            allv = (
                np.concatenate(per_block_syms)
                if per_block_syms
                else np.zeros(0, np.int64)
            )
            books = [
                Codebook.from_frequencies(
                    np.bincount(allv.astype(np.int64), minlength=n_symbols)
                )
            ]
        else:
            books = context_codebooks(per_block_syms, n_symbols, classes, N_CTX_V4)
    else:
        per_block_syms = [block_slice(lo, hi) for lo, hi in block_ranges]
        if version in (1, 5):
            books = [
                Codebook.from_frequencies(np.bincount(all_syms, minlength=n_symbols))
            ]
        else:
            books = context_codebooks(per_block_syms, n_symbols)
            if version == 8:
                classes = symbol_classes(n_symbols)
    req_book = req_codebook(req_blob) if version >= 3 else None

    req_starts = np.zeros(L + 1, np.int64)
    np.cumsum(req_lens, out=req_starts[1:])

    payloads = []
    req_payloads = []
    ctx_meta: list[bytes] | None = [] if version in (7, 8) else None
    for bi, (lo, hi) in enumerate(block_ranges):
        blk_syms = per_block_syms[bi]
        if version in (1, 5, 6):
            payload, _bits = pack_symbols(blk_syms, books[0])
        elif version in (7, 8):
            # context-SPLIT streams: same books and per-symbol codes as
            # v4 (v7) / v3 (v8) — the context chain is identical — but
            # each context's symbols pack into their own order-0
            # sub-payload so every one decodes block-parallel on device
            # (_split_ctx_streams)
            subs = _split_ctx_streams(
                blk_syms, classes, n_ctx=N_CTX_V4 if version == 7 else N_CTX
            )
            parts = [pack_symbols(s, books[c])[0] for c, s in enumerate(subs)]
            payload = b"".join(parts)
            ctx_meta.append(
                np.array([len(s) for s in subs], np.uint32).tobytes()
                + np.array([len(p) for p in parts], np.uint32).tobytes()
            )
        else:
            payload, _bits = pack_symbols_ctx(blk_syms, books, classes)
        payloads.append(payload)
        if version >= 3:
            req_payloads.append(
                pack_req(req_blob[int(req_starts[lo]) : int(req_starts[hi])], req_book)
            )

    return _assemble_container(
        version, block_lines, geo, esc_list, books, req_book, nsym,
        block_ranges, payloads, req_payloads,
        [len(s) for s in per_block_syms],
        ctx_meta=ctx_meta,
    )


class _FileRegion:
    """Read-only bytes-like view of a byte range of a file: slicing
    preads only the requested span, so the byte-range reader
    (``VcfzReader.parse_file``) keeps the payload/req regions on disk
    instead of in every process's memory (VERDICT r3 #2)."""

    __slots__ = ("_path", "_base", "_len")

    def __init__(self, path: str, base: int, length: int):
        self._path, self._base, self._len = path, base, length

    def __len__(self) -> int:
        return self._len

    def __getitem__(self, key):
        if not isinstance(key, slice):
            if key < 0:
                key += self._len
            piece = self[key : key + 1]
            if not piece:
                raise IndexError("_FileRegion index out of range")
            return piece[0]
        start, stop, step = key.indices(self._len)
        if step != 1:
            raise ValueError("_FileRegion supports contiguous slices only")
        out = bytearray()
        off, n = self._base + start, max(stop - start, 0)
        with open(self._path, "rb") as f:
            fd = f.fileno()
            while n > 0:
                piece = os.pread(fd, n, off)
                if not piece:
                    break
                out += piece
                off += len(piece)
                n -= len(piece)
        return bytes(out)


class _Cursor:
    """Sequential field reader over bytes or a file, so the container
    parse is written once and serves both the in-memory and the
    byte-range (pread) readers."""

    def __init__(self, data: bytes | None = None, path: str | None = None):
        self._data, self._path, self.off = data, path, 0
        if data is None:
            self._f = open(path, "rb")
            self.size = os.path.getsize(path)
        else:
            self.size = len(data)

    def take(self, n: int) -> bytes:
        if self._data is not None:
            out = self._data[self.off : self.off + n]
        else:
            out = bytearray()
            off, k = self.off, n
            while k > 0:
                piece = os.pread(self._f.fileno(), k, off)
                if not piece:
                    break
                out += piece
                off += len(piece)
                k -= len(piece)
            out = bytes(out)
        if len(out) != n:
            raise ValueError("truncated .vcfz container")
        self.off += n
        return out

    def unpack(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def take_np(self, dtype, count: int) -> np.ndarray:
        return np.frombuffer(self.take(count * np.dtype(dtype).itemsize), dtype)

    def region(self, n: int):
        """A bytes-like for the next n bytes: materialized for in-memory
        input, a lazy pread view for file input."""
        if self._data is not None:
            return self.take(n)
        r = _FileRegion(self._path, self.off, min(n, self.size - self.off))
        if len(r) != n:
            raise ValueError("truncated .vcfz container")
        self.off += n
        return r

    def whole(self):
        """Bytes-like over the ENTIRE input (for absolute-offset reads)."""
        if self._data is not None:
            return self._data
        return _FileRegion(self._path, 0, self.size)

    def close(self) -> None:
        if self._data is None:
            self._f.close()


@dataclass
class VcfzReader:
    raw: bytes  # whole container: bytes (parse) or lazy _FileRegion (parse_file)
    block_lines: int
    n_lines: int
    n_samples: int
    header_blob: bytes
    escapes: list[bytes]
    books: list[Codebook]  # 1 (v1) / N_CTX (v2/v3) / N_CTX_V4 (v4) symbol codebooks
    version: int
    req_lens: np.ndarray
    nsym: np.ndarray
    req_starts: np.ndarray  # per-line offsets into the RAW req bytes
    req_blob: bytes  # raw req bytes (v1/v2) or coded per-block region (v3)
    blocks: list[dict]
    payload_base: int
    req_book: Codebook | None = None  # v3 order-0 required-bytes codebook

    @classmethod
    def parse(cls, data: bytes) -> "VcfzReader":
        return cls._parse(_Cursor(data=data))

    @classmethod
    def parse_file(cls, path: str) -> "VcfzReader":
        """Byte-range parse (VERDICT r3 #2): only the container prefix
        (header, codebooks, per-line arrays, block table) is read into
        memory; the req region and block payloads stay on disk behind
        lazy pread views, so multihost readers never hold the whole
        container."""
        cur = _Cursor(path=path)
        try:
            return cls._parse(cur)
        finally:
            cur.close()

    @classmethod
    def _parse(cls, cur: "_Cursor") -> "VcfzReader":
        if cur.take(4) != MAGIC:
            raise ValueError("not a .vcfz container")
        version, max_len, block_lines = cur.unpack("<IBI")
        if version not in (1, 2, 3, 4, 5, 6, 7, 8) or max_len != MAX_CODE_LEN:
            raise ValueError("unsupported .vcfz version")
        L, S = cur.unpack("<QI")
        (hlen,) = cur.unpack("<Q")
        header_blob = cur.take(hlen)
        (n_esc,) = cur.unpack("<I")
        escapes = []
        for _ in range(n_esc):
            (elen,) = cur.unpack("<H")
            escapes.append(cur.take(elen))
        (n_symbols,) = cur.unpack("<I")
        # the alphabet size is fully determined by the header fields the
        # writer emits (256 literals + escapes [+ v4's S+1 match band]);
        # an untrusted container claiming anything else would drive
        # oversized codebook/decode allocations or band-arithmetic
        # index errors downstream
        want_symbols = 256 + len(escapes) + (S + 1 if version in (4, 6, 7) else 0)
        if n_symbols != want_symbols:
            raise ValueError(
                f"corrupt .vcfz: alphabet {n_symbols} != {want_symbols}"
            )
        books = []
        n_books = (
            1 if version in (1, 5, 6) else (N_CTX_V4 if version in (4, 7) else N_CTX)
        )
        for _ in range(n_books):
            books.append(Codebook.from_lengths(cur.take_np(np.uint8, n_symbols)))
        req_book = None
        if version >= 3:
            req_book = Codebook.from_lengths(cur.take_np(np.uint8, 256))
        req_lens = cur.take_np(np.uint32, L)
        nsym = cur.take_np(np.uint32, L)
        (req_blob_len,) = cur.unpack("<Q")
        req_blob = cur.region(req_blob_len)
        (n_blocks,) = cur.unpack("<I")
        blocks = []
        payload_off = 0
        req_payload_off = 0
        for _ in range(n_blocks):
            if version >= 3:
                plen, nsyms, rplen, rf, pf, rl, plast, cme = cur.unpack("<QQQBIBII")
            else:
                plen, nsyms, rf, pf, rl, plast, cme = cur.unpack("<QQBIBII")
                rplen = 0
            blk = dict(
                payload_len=plen, n_symbols=nsyms, ref_first=rf, pos_first=pf,
                ref_last=rl, pos_last=plast, cummax_end=cme, payload_off=payload_off,
                req_payload_len=rplen, req_payload_off=req_payload_off,
            )
            if version in (7, 8):
                n_split = N_CTX_V4 if version == 7 else N_CTX
                ctx_nsym = cur.take_np(np.uint32, n_split).astype(np.int64)
                ctx_plen = cur.take_np(np.uint32, n_split).astype(np.int64)
                # the sub-stream framing must tile the block's totals —
                # a corrupt split would otherwise mis-slice payload bytes
                if int(ctx_nsym.sum()) != int(nsyms) or int(ctx_plen.sum()) != int(plen):
                    raise ValueError(
                        "corrupt .vcfz v7: context sub-streams do not tile the block"
                    )
                blk["ctx_nsym"] = ctx_nsym
                blk["ctx_plen"] = ctx_plen
            blocks.append(blk)
            payload_off += plen
            req_payload_off += rplen
        # block table must tile the line range: a short/empty table would
        # silently decompress to truncated output (blocks are the only
        # iteration structure to_vcfc/query have)
        if block_lines == 0:
            raise ValueError("corrupt .vcfz: zero block_lines")
        if n_blocks != (L + block_lines - 1) // block_lines:
            raise ValueError(
                f"corrupt .vcfz: {n_blocks} blocks cannot cover {L} lines"
            )
        req_starts = np.zeros(L, np.int64)
        np.cumsum(req_lens[:-1], out=req_starts[1:])
        return cls(
            cur.whole(), block_lines, L, S, header_blob, escapes, books, version,
            req_lens.astype(np.int64), nsym.astype(np.int64), req_starts,
            req_blob, blocks, cur.off, req_book,
        )

    def _decode_block_symbols(self, b: int, n_take: int | None = None) -> np.ndarray:
        """Decode block b's symbol payload; ``n_take`` stops the sequential
        prefix decode after that many symbols (sub-block query reads)."""
        blk = self.blocks[b]
        payload = self.raw[
            self.payload_base + blk["payload_off"] :
            self.payload_base + blk["payload_off"] + blk["payload_len"]
        ]
        from ..host import native

        n = int(blk["n_symbols"]) if n_take is None else min(n_take, int(blk["n_symbols"]))
        if n > 8 * len(payload):
            # codes are >= 1 bit/symbol: a corrupt symbol count would
            # otherwise drive an unbounded decode allocation (same guard
            # as the req side, _block_req_bytes)
            raise ValueError("corrupt .vcfz: symbol count exceeds payload capacity")
        if self.version in (1, 5, 6):
            if native.available():
                sym_t, len_t = self._decode_tables()[0]
                return native.huffman_decode(payload, n, sym_t, len_t)
            return unpack_symbols(payload, n, self.books[0])
        if self.version in (7, 8):
            # per-context order-0 sub-payloads (each independently
            # decodable), then the O(symbols) context-automaton merge
            subs = []
            off = 0
            tables = self._decode_tables() if native.available() else None
            for c in range(N_CTX_V4 if self.version == 7 else N_CTX):
                pl = int(blk["ctx_plen"][c])
                ns = int(blk["ctx_nsym"][c])
                part = payload[off : off + pl]
                off += pl
                if ns > 8 * len(part):
                    raise ValueError(
                        "corrupt .vcfz: symbol count exceeds payload capacity"
                    )
                if tables is not None:
                    sym_t, len_t = tables[c]
                    subs.append(native.huffman_decode(bytes(part), ns, sym_t, len_t))
                else:
                    subs.append(unpack_symbols(bytes(part), ns, self.books[c]))
            merged = _merge_ctx_streams(subs, self._classes(), int(blk["n_symbols"]))
            return merged[:n]
        if native.available():
            sym_ts, len_ts, classes = self._ctx_tables()
            return native.huffman_decode_ctx(
                payload, n, sym_ts, len_ts, classes, CTX_INIT
            )
        return unpack_symbols_ctx(payload, n, self.books, self._classes())

    def _decode_tables(self):
        if not hasattr(self, "_decode_tables_cache"):
            self._decode_tables_cache = [b.decode_table() for b in self.books]
        return self._decode_tables_cache

    @property
    def _m_base(self) -> int:
        """First vertical-match symbol (v4): one past the escape band."""
        return 256 + len(self.escapes)

    def _classes(self) -> np.ndarray:
        return symbol_classes(
            len(self.books[0].lengths),
            match_base=self._m_base if self.version in (4, 6, 7) else None,
        )

    def _ctx_tables(self):
        """Stacked per-context decode tables + class map, built once per
        reader (they are invariant across blocks)."""
        if not hasattr(self, "_ctx_tables_cache"):
            tables = self._decode_tables()
            self._ctx_tables_cache = (
                np.ascontiguousarray(np.stack([t[0] for t in tables])),
                np.ascontiguousarray(np.stack([t[1] for t in tables])),
                self._classes(),
            )
        return self._ctx_tables_cache

    def block_lines_vcfc(
        self,
        b: int,
        want: np.ndarray | None = None,
        limit: int | None = None,
        req: tuple[bytes, int] | None = None,
        symbols: np.ndarray | None = None,
        symbols_v3: tuple[np.ndarray, np.ndarray] | None = None,
    ) -> list[bytes]:
        """Reconstruct .vcfc line bytes of block b (vectorized: one numpy
        pass over the block's symbols; Python loops only over escapes and
        lines).  ``limit`` bounds the lines considered to the block's
        first ``limit``; ``want`` (bool, relative to the block) selects
        which of those are materialized — sub-block query reads
        (VERDICT r1 #7) decode symbols and resolve v4 rows only up to
        the last line they need.  ``symbols`` hands in a pre-decoded
        symbol stream (>= the lines considered) so bulk decoders — the
        device entropy-decode route — skip the sequential host decode.
        ``symbols_v3`` hands in already-RESOLVED plain v3 streams as a
        (symbols, per-line counts) pair (the device vertical-match
        resolve, format/vcfz_device.py::_resolve_blocks_device), so
        v4/v6 blocks skip the host _v4_block_to_v3 entirely; it covers
        whole blocks only (not combinable with want/limit)."""
        lo = b * self.block_lines
        hi = min(lo + self.block_lines, self.n_lines)
        if limit is not None:
            hi = min(hi, lo + limit)
        if hi <= lo:
            return []
        S = self.n_samples
        if symbols_v3 is not None:
            symbols = np.asarray(symbols_v3[0], np.int64)
            nsym = np.asarray(symbols_v3[1], np.int64)
        else:
            nsym = self.nsym[lo:hi]
            if symbols is not None:
                symbols = np.asarray(symbols[: int(nsym.sum())], np.int64)
            else:
                symbols = np.asarray(
                    self._decode_block_symbols(b, int(nsym.sum())), np.int64
                )
            if self.version in (4, 6, 7):
                # resolve vertical-match runs into plain v3 streams first;
                # the body builder below is shared across versions
                symbols, nsym = _v4_block_to_v3(symbols, nsym, S, self._m_base)
                symbols = symbols.astype(np.int64)
                nsym = nsym.astype(np.int64)

        esc_mask = symbols >= 256
        # run length per symbol (escapes cover exactly one sample)
        run_len = _symbol_run_lens(symbols, esc_mask)
        # samples covered after each symbol, reset per line (empty lines
        # only occur when sample_count == 0, i.e. every line is empty)
        cum = np.cumsum(run_len)
        if len(symbols):
            if S > 0 and (nsym <= 0).any():
                # a zero-symbol line would negative-index `cum` below and
                # silently garble the escape tab placement
                raise ValueError(
                    "corrupt .vcfz: zero-symbol line in a nonempty cohort"
                )
            sym_line_end = np.cumsum(nsym.astype(np.int64))
            bases = np.concatenate([[0], cum[sym_line_end[:-1] - 1]])
            covered_after = cum - np.repeat(bases, nsym)
        else:
            covered_after = cum

        esc_len_tab = self._esc_len_arr
        sizes = np.ones(len(symbols), np.int64)
        esc_idx = symbols[esc_mask] - 256
        esc_tab = covered_after[esc_mask] < S  # '\t' unless final sample
        sizes[esc_mask] += esc_len_tab[esc_idx] + esc_tab
        offs = np.cumsum(sizes) - sizes
        total = int(sizes.sum())

        body = np.zeros(total, np.uint8)
        body[offs] = np.where(esc_mask, _ESC_FLAG, symbols).astype(np.uint8)
        esc_np = self._esc_np
        for k in np.flatnonzero(esc_mask):
            o = int(offs[k]) + 1
            e = esc_np[int(symbols[k]) - 256]
            body[o : o + len(e)] = e
            if covered_after[k] < S:
                body[o + len(e)] = 9  # '\t'

        # the query path hands in its pass-1 req decode (a superset
        # range) so the sequential Huffman work isn't paid twice
        req_bytes, req_base = (
            req if req is not None else self._block_req_bytes(b, lo, hi)
        )

        out = []
        spos = 0
        body_bytes = body.tobytes()
        boff = 0
        for i in range(lo, hi):
            n = int(nsym[i - lo])
            blen = int(sizes[spos : spos + n].sum())
            spos += n
            if want is not None and not want[i - lo]:
                boff += blen  # unmatched line: cursor advance only
                continue
            r0 = int(self.req_starts[i]) - req_base
            req = req_bytes[r0 : r0 + int(self.req_lens[i])]
            line = bytearray()
            line += encode_length_header(4 + len(req) + blen + 1)
            line += encode_length_header(len(req))
            line += req
            line += body_bytes[boff : boff + blen]
            line += b"\n"
            out.append(bytes(line))
            boff += blen
        return out

    def _block_req_bytes(self, b: int, lo: int, hi: int) -> tuple[bytes, int]:
        """Raw required-column bytes covering lines [lo, hi) and the raw
        offset they start at.  v1/v2 store them verbatim; v3 decodes the
        block's order-0-coded req payload."""
        if self.version < 3:
            return self.req_blob, 0
        blk = self.blocks[b]
        if hi <= lo:
            return b"", 0
        start = int(self.req_starts[lo])
        end = int(self.req_starts[hi - 1]) + int(self.req_lens[hi - 1])
        payload = self.req_blob[
            blk["req_payload_off"] : blk["req_payload_off"] + blk["req_payload_len"]
        ]
        if end - start > 8 * len(self.req_blob):
            # codes are >= 1 bit/byte: a corrupt req_len table would
            # otherwise drive an unbounded allocation
            raise ValueError("corrupt .vcfz required-column lengths")
        if not hasattr(self, "_req_tables_cache"):
            self._req_tables_cache = self.req_book.decode_table()
        return unpack_req(payload, end - start, self.req_book, self._req_tables_cache), start

    @property
    def _esc_len_arr(self) -> np.ndarray:
        if not hasattr(self, "_esc_len_cache"):
            self._esc_len_cache = np.array([len(e) for e in self.escapes], np.int64)
        return self._esc_len_cache

    @property
    def _esc_np(self) -> list[np.ndarray]:
        if not hasattr(self, "_esc_np_cache"):
            self._esc_np_cache = [np.frombuffer(e, np.uint8) for e in self.escapes]
        return self._esc_np_cache

    def to_vcfc(self) -> bytes:
        out = bytearray(self.header_blob)
        for b in range(len(self.blocks)):
            for line in self.block_lines_vcfc(b):
                out += line
        return bytes(out)

    def select_blocks(self, query: CoordinateQuery) -> list[int]:
        """Blocks that may contain lines overlapping the query."""
        q_ref = reference_to_int(query.reference_name)
        out = []
        for b, blk in enumerate(self.blocks):
            if blk["ref_last"] < q_ref or blk["ref_first"] > q_ref:
                continue
            if query.has_start or query.has_end:
                if blk["ref_first"] == q_ref and blk["pos_first"] > query.end_position:
                    if blk["ref_first"] == blk["ref_last"]:
                        continue
                if blk["ref_last"] == q_ref and blk["cummax_end"] < query.start_position:
                    if blk["ref_first"] == blk["ref_last"]:
                        continue
            out.append(b)
        return out


def decompress_vcfz(vcfz: bytes, route: str | None = None) -> bytes:
    """`.vcfz` -> VCF text (reconstruct the .vcfc, then the engine fast
    path decodes it; the oracle decoder remains the conformance anchor
    in tests).  ``route`` (default: the VCFZ_PACK env var) = "device"
    entropy-decodes order-0 streams (v1/v5/v6 payloads, v7/v8
    per-context sub-payloads) block-parallel on chip and resolves
    v4/v6/v7 vertical-match runs with the device scan middle
    (format/vcfz_device.py); v2/v3 fall back to the host path."""
    from .. import engine

    if (route or os.environ.get("VCFZ_PACK")) == "device":
        from .vcfz_device import vcfz_to_vcfc_device

        vcfc = vcfz_to_vcfc_device(vcfz)
        if vcfc is not None:
            return engine.decompress(vcfc)
    return engine.decompress(VcfzReader.parse(vcfz).to_vcfc())


def query_vcfz(vcfz: bytes, query: CoordinateQuery):
    """Yield decompressed matching lines (SV-aware overlap, like the
    binned-index query).

    Two-pass per candidate block (VERDICT r1 #7): the required-column
    bytes alone carry CHROM/POS/REF/ALT/INFO, so pass 1 evaluates the
    range test without touching the genotype-symbol payload (blocks with
    no matching line skip it entirely), and pass 2 materializes only the
    matched lines, decoding symbols — and resolving v4 vertical rows —
    only up to the last hit."""
    from .lines import decode_data_line
    from ..query.coordinate import compute_end_position

    reader = VcfzReader.parse(vcfz)
    S = reader.n_samples
    ref_only = not query.has_start and not query.has_end
    q_ref = reference_to_int(query.reference_name)
    for b in reader.select_blocks(query):
        lo = b * reader.block_lines
        hi = min(lo + reader.block_lines, reader.n_lines)
        req_bytes, req_base = reader._block_req_bytes(b, lo, hi)
        want = np.zeros(hi - lo, bool)
        past = False
        last = -1
        for i in range(lo, hi):
            r0 = int(reader.req_starts[i]) - req_base
            cols = req_bytes[r0 : r0 + int(reader.req_lens[i])].split(b"\t", 8)
            chrom, pos = cols[0], int(cols[1])
            if ref_only:
                # ref-only regions match every line of that reference
                # (full-scan semantics; the reference's binned engine
                # returns nothing here — a quirk we keep only there)
                line_ref = reference_to_int(chrom.decode())
                if line_ref == q_ref:
                    want[i - lo] = True
                    last = i - lo
                elif line_ref > q_ref:
                    past = True
                    break
                continue
            end = compute_end_position(pos, cols[3], cols[4], cols[7])
            cmp = query.compare_to_range(chrom.decode(), pos, end)
            if cmp == 0:
                want[i - lo] = True
                last = i - lo
            elif cmp < 0:
                past = True
                break
        if last >= 0:
            for line_bytes in reader.block_lines_vcfc(
                b, want=want, limit=last + 1, req=(req_bytes, req_base)
            ):
                line, _ = decode_data_line(line_bytes, 0, S)
                yield line
        if past:
            return
