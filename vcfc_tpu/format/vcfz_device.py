"""Device-route `.vcfz` writer (VERDICT r3 #1/#7).

Moves the container's two host-bound hot loops onto the chip while
keeping the output BYTE-IDENTICAL to the host writer (`vcfz.py`):

  symbol emission   v1-v3: the positional flag bytes already ARE the
                    symbol stream (escape flags swap to their dictionary
                    symbol) — one elementwise kernel, so non-greedy
                    streams transcode byte-exactly like the host walker.
                    v4: the vertical-prediction transform + re-emission
                    (host: Python row/run loops in
                    vcfz._v4_transform_block) runs as the fused
                    `ops.vcfz_device.sympos_v4` scan kernel.
  Huffman bit pack  `ops.vcfz_device.pack_cells`: per-block
                    (cumsum bit offsets -> word assembly by segmented
                    scan) for both the symbol payloads and the v3/v4
                    order-0 required-columns payloads.

Architecture follows ops/rle.py's positional contract: dense O(cells)
device work; the host performs only O(outputs) compactions (flatnonzero
over the positional word plane) plus the tiny codebook builds.  The
escape dictionary and per-(context, symbol) frequencies stay host-side
— they are O(symbols), not O(cells), and anchor the byte contract to
the same `context_codebooks` the host writer uses.

Returns None (caller falls back to the host writer) for structurally
unsupported inputs: no native library, zero lines/samples, or lines the
native parser routes to the oracle (escape flags with count != 1 —
never produced by any of our encoders or the reference's).

The DECODE direction lives here too (`vcfz_to_vcfc_device`): v1/v5/v6
symbol payloads, v7/v8 per-context sub-payloads, and v3+
required-columns payloads entropy-decode
block-parallel on device (ops/huffman_device.py), and v4/v6
vertical-match runs resolve on device
(`_resolve_blocks_device` -> ops/vcfz_device.py::resolve_match_grid),
so the dense O(lines x samples) middle of the decode never runs on the
host for those containers.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.huffman import (
    CTX_INIT,
    Codebook,
    N_CTX_V4,
    context_codebooks,
    symbol_classes,
)

# cells per pack dispatch: pack_cells holds ~15 int32 working planes, so
# 16M cells keeps the peak device footprint ~1 GB
_MAX_CELLS = 16 * 1024 * 1024
# symbol grids are kept device-resident between the emission and packing
# passes up to this total; beyond it they are re-emitted in pass 2 so
# device memory stays bounded regardless of input size
_MAX_RESIDENT_BYTES = 2 * 1024 * 1024 * 1024


def _lines_per_batch(block_lines: int, s_pad: int) -> int:
    per = max(_MAX_CELLS // max(s_pad, 1), block_lines)
    return (per // block_lines) * block_lines


def _split_blocks(flat: np.ndarray, counts: list[int]) -> list[np.ndarray]:
    out = []
    pos = 0
    for c in counts:
        out.append(flat[pos : pos + c])
        pos += c
    return out


class _BatchFeed:
    """Per-batch (flags, escape-id) planes, built lazily so the host
    never materializes an O(L * S_pad) int32 escape plane.  Escape
    occurrences arrive as (line, sample, id) triples sorted by line —
    ids from the compacted v3 symbol stream (first-occurrence order, the
    byte contract), positions from the native escape side channel, both
    enumerated in (line, sample) order."""

    def __init__(
        self, parsed, all_syms: np.ndarray, S_pad: int, lpb: int,
        device_eb: bool = False,
    ):
        self.flags = parsed.flags
        self.W = parsed.flags.shape[1]
        self.S_pad = S_pad
        self.lpb = lpb
        self.L = parsed.n_lines
        self.device_eb = device_eb
        self.esc_lines = np.repeat(
            np.arange(self.L, dtype=np.int64),
            parsed.esc_count.astype(np.int64),
        )
        self.esc_samples = parsed.esc_sample
        self.esc_ids = (all_syms[all_syms >= 256] - 256).astype(np.int32)

    def batch(self, b0: int):
        """(flag plane, escape-id plane, rows).  With ``device_eb`` the
        escape plane is scattered ON DEVICE from the sparse triples
        (O(escapes) H2D) instead of materializing + shipping a dense
        int32 plane (4 B/cell — the route's largest H2D transfer)."""
        b1 = min(b0 + self.lpb, self.L)
        n = b1 - b0
        fb = np.zeros((self.lpb, self.S_pad), np.uint8)
        fb[:n, : self.W] = self.flags[b0:b1]
        k0, k1 = np.searchsorted(self.esc_lines, [b0, b1])
        if self.device_eb:
            from ..ops.vcfz_device import esc_plane_device

            eb = esc_plane_device(
                (self.esc_lines[k0:k1] - b0).astype(np.int32),
                self.esc_samples[k0:k1].astype(np.int32),
                self.esc_ids[k0:k1],
                self.lpb,
                self.S_pad,
            )
            return fb, eb, n
        eb = np.zeros((self.lpb, self.S_pad), np.int32)
        if k1 > k0:
            eb[
                self.esc_lines[k0:k1] - b0, self.esc_samples[k0:k1]
            ] = self.esc_ids[k0:k1]
        return fb, eb, n


def vcfz_from_vcfc_device(
    vcfc: bytes, block_lines: int, version: int
) -> bytes | None:
    import jax.numpy as jnp

    from ..host import native as native_mod

    if not native_mod.available():
        return None
    from ..host.fast import parse_vcfc_native
    from ..ops.vcfz_device import (
        compact_payloads,
        compact_payloads_device,
        compact_symbols,
        compact_symbols_device,
        pack_cells,
        pack_entries,
        sympos_v3,
        sympos_v4,
    )

    # On-device compaction (sort_compact) makes the device->host
    # transfer O(outputs) — payload words and symbol streams — instead
    # of the dense O(cells) word/symbol planes, and the escape plane is
    # scattered on-device from sparse triples.  Byte-identical either
    # way; the backend picks the default (ops/vcfz_device.py::
    # device_compaction), VCFZ_COMPACT=device|host overrides it.
    from ..ops.vcfz_device import device_compaction

    dev_compact = device_compaction()
    if dev_compact:
        compact_payloads = compact_payloads_device

        def _compact_syms(sp_rows):
            return compact_symbols_device(sp_rows)
    else:

        def _compact_syms(sp_rows):
            return compact_symbols(np.asarray(sp_rows))
    from .vcfz import (
        _assemble_container,
        _require_greedy,
        _scan_geometry,
        _symbol_streams_native,
        req_codebook,
    )

    parsed = parse_vcfc_native(vcfc)
    L = parsed.n_lines
    S = parsed.header.schema.sample_count
    if L == 0 or S == 0 or parsed.oracle_line.any():
        return None
    fast = _symbol_streams_native(vcfc, parsed)
    if fast is None:  # pragma: no cover - native.available() checked above
        return None
    all_syms3, nsym3, esc_list = fast
    nsym3 = nsym3.astype(np.int64)
    if version in (4, 6, 7):
        # same guard as the host writer: v4 re-emits greedy maximal runs,
        # so non-canonical streams must be rejected, not canonicalized
        _require_greedy(all_syms3, nsym3)

    geo = _scan_geometry(vcfc)
    W = parsed.flags.shape[1]
    S_pad = (W + 127) // 128 * 128
    block_ranges = [
        (lo, min(lo + block_lines, L)) for lo in range(0, L, block_lines)
    ]
    n_blocks = len(block_ranges)
    lpb = _lines_per_batch(block_lines, S_pad)
    bpb = lpb // block_lines  # blocks per batch
    batch_starts = list(range(0, L, lpb))
    feed = _BatchFeed(parsed, all_syms3, S_pad, lpb, device_eb=dev_compact)

    m_base = 256 + len(esc_list)
    if version in (4, 6, 7):
        n_symbols = m_base + S + 1
        n_ctx = N_CTX_V4 if version in (4, 7) else 1
        classes = symbol_classes(n_symbols, match_base=m_base)
    else:
        n_symbols = 256 + len(esc_list)
        n_ctx = 1 if version in (1, 5) else 4
        classes = symbol_classes(n_symbols)

    block_first_np = np.zeros(lpb, bool)
    block_first_np[::block_lines] = True
    block_first_dev = jnp.asarray(block_first_np)

    def emit(b0: int):
        """Device-emit one batch's positional symbol grid (+ per-line
        symbol counts for v4)."""
        fb, eb, n = feed.batch(b0)
        if version in (4, 6, 7):
            sp, ns, decoded = sympos_v4(
                jnp.asarray(fb), jnp.asarray(eb), S, block_first_dev,
                m_base, n,
            )
            if (np.asarray(decoded) != S).any():
                raise ValueError(
                    "corrupt .vcfz: block symbols do not cover the sample grid"
                )
            return sp, np.asarray(ns)[:n]
        return sympos_v3(jnp.asarray(fb), jnp.asarray(eb)), None

    keep_resident = L * S_pad * 4 <= _MAX_RESIDENT_BYTES
    sym_grids: list = []

    # ---- pass 1 (device): symbol emission; host collects the compacted
    # streams (v4/v6 — the others already have them natively) to build
    # codebooks
    if version in (4, 6, 7):
        nsym = np.zeros(L, np.uint32)
        per_block_syms: list[np.ndarray] = []
        for b0 in batch_starts:
            b1 = min(b0 + lpb, L)
            sp, ns = emit(b0)
            nsym[b0:b1] = ns
            if keep_resident:
                sym_grids.append(sp)
            syms, _counts = _compact_syms(sp[: b1 - b0])
            per_block_syms.extend(
                _split_blocks(
                    syms,
                    [
                        int(ns[lo - b0 : hi - b0].sum())
                        for lo, hi in block_ranges[
                            b0 // block_lines : b0 // block_lines + bpb
                        ]
                    ],
                )
            )
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
            books = context_codebooks(per_block_syms, n_symbols, classes, n_ctx)
    else:
        nsym = nsym3.astype(np.uint32)
        sym_ends = np.cumsum(nsym3)
        per_block_syms = []
        for lo, hi in block_ranges:
            s0 = 0 if lo == 0 else int(sym_ends[lo - 1])
            per_block_syms.append(
                all_syms3[s0 : int(sym_ends[hi - 1])].astype(np.int64)
            )
        if keep_resident:
            for b0 in batch_starts:
                sym_grids.append(emit(b0)[0])
        if version in (1, 5):
            books = [
                Codebook.from_frequencies(
                    np.bincount(all_syms3, minlength=n_symbols)
                )
            ]
        else:
            books = context_codebooks(per_block_syms, n_symbols)

    # ---- pass 2 (device): Huffman bit packing of every block's cells
    payloads: list[bytes] = []
    ctx_meta: list[bytes] | None = [] if version in (7, 8) else None
    n_split = N_CTX_V4 if version == 7 else (4 if version == 8 else 0)
    if n_split:
        from ..ops.vcfz_device import ctx_plane

        entries_by_ctx = [jnp.asarray(pack_entries([bk])) for bk in books]
    else:
        entries = jnp.asarray(pack_entries(books))
    for gi, b0 in enumerate(batch_starts):
        sp = sym_grids[gi] if keep_resident else emit(b0)[0]
        cells = sp.reshape(bpb, block_lines * S_pad)
        take = min(n_blocks - gi * bpb, bpb)
        if n_split:
            # context-SPLIT packing: the ctx plane (same cummax pack_cells
            # uses) masks one pack per context, so each sub-payload is an
            # independent bitstream under its own (order-0) book
            present = cells != 0
            ctxp = ctx_plane(cells, present, m_base, CTX_INIT, v4=(version == 7))
            parts_by_ctx = []
            counts_by_ctx = []
            for c in range(n_split):
                mask = present & (ctxp == c)
                if dev_compact:
                    # compact-space pack per sub-stream (order-0, so no
                    # context carry): sort brings context-c symbols to
                    # the front in stream order, the lookup runs over
                    # O(sub-stream symbols) lanes
                    from ..ops.vcfz_device import (
                        _bucket,
                        pack_cells_compact,
                        sort_compact,
                    )

                    sc, cnt = sort_compact(cells, mask)
                    kb = _bucket(
                        int(np.asarray(cnt).max(initial=0)), cells.shape[1]
                    )
                    wv, emit_mask, tb, bad = pack_cells_compact(
                        sc[:, :kb], cnt, entries_by_ctx[c], m_base, 0,
                        n_ctx=1, v4=(version == 7),
                    )
                    counts_by_ctx.append(np.asarray(cnt))
                else:
                    wv, emit_mask, tb, bad = pack_cells(
                        cells, mask, entries_by_ctx[c], m_base, 0,
                        n_ctx=1, v4=(version == 7),
                    )
                    counts_by_ctx.append(np.asarray(mask.sum(axis=1)))
                if bool(np.asarray(bad).any()):  # pragma: no cover
                    raise RuntimeError("device packer: symbol without codeword")
                parts_by_ctx.append(compact_payloads(wv, emit_mask, tb))
            for k in range(take):
                parts = [parts_by_ctx[c][k] for c in range(n_split)]
                payloads.append(b"".join(parts))
                ctx_meta.append(
                    np.array(
                        [int(counts_by_ctx[c][k]) for c in range(n_split)],
                        np.uint32,
                    ).tobytes()
                    + np.array([len(p) for p in parts], np.uint32).tobytes()
                )
            continue
        if dev_compact:
            # compact-space pack: one sort front-compacts each block's
            # symbols, then the codeword lookup (the dense packer's
            # dominant per-cell cost)
            # runs over O(symbols) lanes instead of the full grid
            from ..ops.vcfz_device import _bucket, pack_cells_compact, sort_compact

            sc, cnt = sort_compact(cells, cells != 0)
            kb = _bucket(int(np.asarray(cnt).max(initial=0)), cells.shape[1])
            wv, emit_mask, tb, bad = pack_cells_compact(
                sc[:, :kb], cnt, entries, m_base, CTX_INIT,
                n_ctx=n_ctx, v4=(version in (4, 6)),
            )
        else:
            wv, emit_mask, tb, bad = pack_cells(
                cells, cells != 0, entries, m_base, CTX_INIT,
                n_ctx=n_ctx, v4=(version in (4, 6)),
            )
        if bool(np.asarray(bad).any()):  # pragma: no cover - books cover streams
            raise RuntimeError("device packer: symbol without codeword")
        payloads.extend(compact_payloads(wv, emit_mask, tb)[:take])

    # ---- required-columns payloads (v3/v4): order-0 device pack
    req_book = req_codebook(geo.req_blob) if version >= 3 else None
    req_payloads: list[bytes] = []
    if version >= 3:
        req_starts = np.zeros(L + 1, np.int64)
        np.cumsum(geo.req_lens, out=req_starts[1:])
        req_np = np.frombuffer(geo.req_blob, np.uint8)
        blk_req_len = np.array(
            [int(req_starts[hi] - req_starts[lo]) for lo, hi in block_ranges],
            np.int64,
        )
        R_pad = (int(blk_req_len.max()) + 127) // 128 * 128
        req_entries = jnp.asarray(pack_entries([req_book]))
        # req blocks are small (block_lines * ~40 B); batch them so the
        # dispatch count stays low without exceeding the cell budget
        rbpb = max(_MAX_CELLS // max(R_pad, 1), 1)
        for r0 in range(0, n_blocks, rbpb):
            r1 = min(r0 + rbpb, n_blocks)
            g = np.zeros((r1 - r0, R_pad), np.int32)
            v = np.zeros((r1 - r0, R_pad), bool)
            for k in range(r0, r1):
                lo, hi = block_ranges[k]
                n = int(blk_req_len[k])
                g[k - r0, :n] = req_np[int(req_starts[lo]) : int(req_starts[hi])]
                v[k - r0, :n] = True
            wv, emit_mask, tb, bad = pack_cells(
                jnp.asarray(g), jnp.asarray(v), req_entries, 0, 0,
                n_ctx=1, v4=False,
            )
            if bool(np.asarray(bad).any()):  # pragma: no cover
                raise RuntimeError("device packer: req byte without codeword")
            req_payloads.extend(compact_payloads(wv, emit_mask, tb))

    return _assemble_container(
        version, block_lines, geo, esc_list, books, req_book, nsym,
        block_ranges, payloads, req_payloads,
        [len(s) for s in per_block_syms],
        ctx_meta=ctx_meta,
    )


def vcfz_to_vcfc_device(vcfz: bytes) -> bytes | None:
    """Device DECODE route.

    Order-0 streams (v1/v5/v6 payloads, v7's per-context sub-payloads)
    — and the v3+ order-0 required-columns payloads — decode
    block-parallel through the gather-free bit-scan kernel
    (ops/huffman_device.py); v7's sub-streams re-merge on host with the
    O(symbols) context-automaton walk.
    Vertical-prediction containers (v4/v6/v7) additionally resolve their
    MATCH runs on device (_resolve_blocks_device -> resolve_match_grid:
    fill scan, log-depth row resolve, greedy flag re-emission), so the
    whole dense O(lines x samples) middle of the decode is
    device-resident; v4's context-chained symbol payloads entropy-decode
    host-side first (the transfer-matrix state would grow 15*n_ctx —
    docs/DESIGN.md).  Line assembly reuses the host reconstruction on
    the pre-resolved streams.  v2/v3 return None and take the host/
    native path."""
    import numpy as np

    from ..ops.huffman_device import device_unpack_symbols
    from .vcfz import VcfzReader

    reader = VcfzReader.parse(vcfz)
    if reader.version not in (1, 4, 5, 6, 7, 8):
        return None
    if reader.version == 4:
        # context-coded stream: host entropy decode, device resolve
        sym_lists = [
            np.asarray(reader._decode_block_symbols(b), np.int64)
            for b in range(len(reader.blocks))
        ]
    elif reader.version in (7, 8):
        # context-SPLIT streams: every (block, context) sub-payload is
        # order-0 under its own book, so ALL of them entropy-decode
        # block-parallel on device (grouped per book); the O(symbols)
        # context-automaton merge rejoins them on host
        from .vcfz import _merge_ctx_streams
        from ..ops.huffman import N_CTX as _NCTX8, N_CTX_V4 as _NCTX7A

        _NCTX7 = _NCTX7A if reader.version == 7 else _NCTX8
        classes = reader._classes()
        base = reader.payload_base
        per_ctx_payloads: list[list[bytes]] = [[] for _ in range(_NCTX7)]
        per_ctx_counts: list[list[int]] = [[] for _ in range(_NCTX7)]
        for blk in reader.blocks:
            off = base + blk["payload_off"]
            for c in range(_NCTX7):
                pl = int(blk["ctx_plen"][c])
                per_ctx_payloads[c].append(bytes(reader.raw[off : off + pl]))
                per_ctx_counts[c].append(int(blk["ctx_nsym"][c]))
                off += pl
        per_ctx_syms = [
            device_unpack_symbols(per_ctx_payloads[c], per_ctx_counts[c], reader.books[c])
            for c in range(_NCTX7)
        ]
        sym_lists = [
            _merge_ctx_streams(
                [per_ctx_syms[c][b] for c in range(_NCTX7)],
                classes,
                int(blk["n_symbols"]),
            )
            for b, blk in enumerate(reader.blocks)
        ]
    else:
        payloads = []
        n_syms = []
        base = reader.payload_base
        for blk in reader.blocks:
            payloads.append(
                bytes(reader.raw[base + blk["payload_off"] : base + blk["payload_off"] + blk["payload_len"]])
            )
            n_syms.append(int(blk["n_symbols"]))
        sym_lists = device_unpack_symbols(payloads, n_syms, reader.books[0])

    req_lists = None
    if reader.version >= 3:
        req_payloads = []
        n_req = []
        for b, blk in enumerate(reader.blocks):
            lo = b * reader.block_lines
            hi = min(lo + reader.block_lines, reader.n_lines)
            req_payloads.append(
                bytes(
                    reader.req_blob[
                        blk["req_payload_off"] : blk["req_payload_off"] + blk["req_payload_len"]
                    ]
                )
            )
            n_req.append(
                int(reader.req_starts[hi - 1]) + int(reader.req_lens[hi - 1]) - int(reader.req_starts[lo])
                if hi > lo
                else 0
            )
        req_lists = device_unpack_symbols(req_payloads, n_req, reader.req_book)

    resolved = None
    if reader.version in (4, 6, 7) and reader.n_samples > 0 and reader.n_lines > 0:
        resolved = _resolve_blocks_device(reader, sym_lists)

    out = bytearray(reader.header_blob)
    for b in range(len(reader.blocks)):
        req_arg = None
        if req_lists is not None:
            lo = b * reader.block_lines
            req_arg = (
                req_lists[b].astype(np.uint8).tobytes(),
                int(reader.req_starts[lo]) if reader.n_lines else 0,
            )
        if resolved is not None:
            lines = reader.block_lines_vcfc(b, req=req_arg, symbols_v3=resolved[b])
        else:
            lines = reader.block_lines_vcfc(b, req=req_arg, symbols=sym_lists[b])
        for line in lines:
            out += line
    return bytes(out)


# ---------------------------------------------------------------------------
# Device DECODE middle for v4/v6: vertical-match resolve on chip
# (ops/vcfz_device.py::resolve_match_grid — the inverse of symbol_grid's
# MATCH band).  The host's only jobs are the O(symbols) positional
# build below and the O(outputs) flag compaction afterwards.


def _block_classpos(symbols, nsym, S, S_pad, m_base):
    """One block's v4/v6 symbol streams -> ((n, S_pad) uint8 class grid
    with code + 1 at each symbol's last covered sample, 0 elsewhere; the
    escape ids in stream order).  Mirrors vcfz._expand_block_rows'
    classification exactly, but emits the positional form the device
    kernel consumes instead of materializing O(cells) rows on host."""
    from .vcfz import _symbol_run_lens

    symbols = np.asarray(symbols, np.int64)
    nsym = np.asarray(nsym, np.int64)
    n = len(nsym)
    if S > 0 and n and (nsym <= 0).any():
        raise ValueError("corrupt .vcfz: zero-symbol line in a nonempty cohort")
    is_match = symbols >= m_base
    is_esc = (symbols >= 256) & ~is_match
    run_len = _symbol_run_lens(symbols, is_esc, is_match, m_base)
    if (run_len <= 0).any():
        raise ValueError("corrupt .vcfz: empty symbol run")
    code = np.where(
        is_match,
        5,
        np.where(
            is_esc,
            4,
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
    )
    cum = np.cumsum(run_len)
    line_end = np.cumsum(nsym)
    bases = (
        np.concatenate([[0], cum[line_end[:-1] - 1]])
        if n > 1
        else np.zeros(max(n, 1), np.int64)
    )
    covered_after = cum - np.repeat(bases, nsym)
    if n and not (covered_after[line_end - 1] == S).all():
        raise ValueError("corrupt .vcfz: block symbols do not cover the sample grid")
    grid = np.zeros((n, S_pad), np.uint8)
    line_of = np.repeat(np.arange(n, dtype=np.int64), nsym)
    grid[line_of, covered_after - 1] = (code + 1).astype(np.uint8)
    return grid, (symbols[is_esc] - 256).astype(np.int64)


def _resolve_blocks_device(reader, sym_lists) -> list[tuple[np.ndarray, np.ndarray]]:
    """Resolve every block's v4/v6 vertical-match runs on device.

    ``sym_lists[b]`` is block b's decoded symbol stream (device
    entropy-decode for order-0 v6, host decode for context-coded v4).
    Returns one (plain v3 symbols, per-line counts) pair per block,
    byte-contract-equal to vcfz._v4_block_to_v3 + _emit_row_symbols."""
    import jax.numpy as jnp

    from ..ops.vcfz_device import resolve_match_grid

    S = reader.n_samples
    Lb = reader.block_lines
    S_pad = max(-(-S // 128) * 128, 128)
    n_blocks = len(reader.blocks)
    batch_b = max(1, _MAX_CELLS // (Lb * S_pad))
    m_base = reader._m_base

    grids = []
    escs = []
    nrows = []
    for b in range(n_blocks):
        lo = b * Lb
        hi = min(lo + Lb, reader.n_lines)
        g, e = _block_classpos(sym_lists[b], reader.nsym[lo:hi], S, S_pad, m_base)
        grids.append(g)
        escs.append(e)
        nrows.append(hi - lo)

    out: list[tuple[np.ndarray, np.ndarray]] = []
    for b0 in range(0, n_blocks, batch_b):
        chunk = grids[b0 : b0 + batch_b]
        batch = np.zeros((batch_b, Lb, S_pad), np.uint8)
        for k, g in enumerate(chunk):
            batch[k, : g.shape[0]] = g
        flagpos, _, bad = resolve_match_grid(jnp.asarray(batch), S)
        if bool(np.asarray(bad)):
            raise ValueError("corrupt .vcfz v4: MATCH in a block's first line")
        from ..ops.vcfz_device import device_compaction

        if device_compaction():
            # O(outputs) D2H: compact the positional flag plane on
            # device (sort_compact) instead of shipping the dense grid
            from ..ops.vcfz_device import compact_symbols_device

            fp32 = flagpos[: len(chunk)].reshape(len(chunk) * Lb, S_pad)[
                :, :S
            ].astype(jnp.int32)
            flat_syms, row_counts = compact_symbols_device(fp32)
            row_counts = row_counts.astype(np.int64).reshape(len(chunk), Lb)
            row_ends = np.cumsum(row_counts.reshape(-1))
            for k in range(len(chunk)):
                # pad rows (>= n) hold the resolve's garbage fill, same
                # as the host path's discarded rows — the row_ends
                # arithmetic steps OVER their symbols
                n = nrows[b0 + k]
                r0 = k * Lb
                s0 = int(row_ends[r0 - 1]) if r0 else 0
                s1 = int(row_ends[r0 + n - 1]) if n else s0
                syms = flat_syms[s0:s1].astype(np.int64)
                esc_ids = escs[b0 + k]
                esc_mask = syms == 0xE1
                if int(esc_mask.sum()) != len(esc_ids):
                    raise ValueError(
                        "corrupt .vcfz: escape cells diverge from the symbol stream"
                    )
                syms[esc_mask] = 256 + esc_ids
                out.append((syms, row_counts[k, :n]))
            continue
        flagpos = np.asarray(flagpos)
        for k in range(len(chunk)):
            n = nrows[b0 + k]
            sub = flagpos[k, :n, :S]
            lines, cols = np.nonzero(sub)
            syms = sub[lines, cols].astype(np.int64)
            esc_ids = escs[b0 + k]
            esc_mask = syms == 0xE1
            if int(esc_mask.sum()) != len(esc_ids):
                raise ValueError(
                    "corrupt .vcfz: escape cells diverge from the symbol stream"
                )
            syms[esc_mask] = 256 + esc_ids
            out.append((syms, np.bincount(lines, minlength=n).astype(np.int64)))
    return out
