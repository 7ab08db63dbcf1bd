"""Device-side `.vcfz` entropy coding (VERDICT r3 #1/#7).

Two kernels move the container's host-bound hot loops onto the device:

1. ``symbol_grid`` — the v3/v4 symbol-emission transform as a dense
   (lines x samples) positional kernel.  v4's vertical prediction
   (format/vcfz.py::_v4_transform_block) was the single slowest host
   phase of the transcode (Python row/run loops in _emit_row_symbols);
   here it is the existing RLE boundary-scan formulation (ops/rle.py)
   extended with a MATCH band: cells equal to the cell above collapse
   into uncapped match runs, everything else emits the reference's
   greedy capped flag runs (compress.cpp:124-186) or escape-dictionary
   symbols.  Output is *positional*: the symbol value at each
   emission's LAST sample position, 0 elsewhere (symbol 0 — flag byte
   0x00 — is never legal), exactly the flagpos contract.

2. ``pack_cells`` — the Huffman bit packer.  Each block's cells are
   flattened to one scan axis, so the whole pipeline is scans and
   arithmetic selects (the kernel invariant — no 2-D scatters, no lane
   gathers except the tiny (ctx, symbol) -> (length, code) table read):

     class/ctx       arithmetic selects + one packed exclusive cummax
     bit offsets     exclusive cumsum of code lengths
     word assembly   each symbol splits into its word's bits and the
                     spill into the next word (32-bit shifts only);
                     per-word OR == segmented SUM over the sorted word
                     ids (bits are disjoint), one associative scan
     emission        assembled word at each word's LAST cell, 0/ignored
                     elsewhere — positional again

   The host compacts the positional words exactly as it compacts
   positional flags (the architecture of ops/rle.py: dense O(cells)
   device work, tiny O(outputs) host transforms), yielding payload
   bytes byte-identical to the host/native packers
   (ops/huffman.py::pack_symbols_ctx).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..format.constants import CODE_ESCAPE
from .rle import _flag_base

_CODE_MATCH = 5  # transient cell value, mirrors format/vcfz.py


@functools.partial(jax.jit, static_argnames=("v4",))
def symbol_grid(codes, esc_ids, n_samples, block_first, m_base, *, v4: bool):
    """Emit `.vcfz` symbols for every data line, positionally.

    Args:
      codes:       (L, S_pad) uint8 genotype codes (0-3, 4=escape)
      esc_ids:     (L, S_pad) int32 escape-dictionary id at escape
                   cells (ignored elsewhere)
      n_samples:   traced scalar — true sample count
      block_first: (L,) bool — rows that start a block (v4's vertical
                   match never crosses into them)
      m_base:      traced scalar — first vertical-match symbol
                   (256 + n_escapes)
      v4:          static — enable the vertical-prediction MATCH band

    Returns:
      sympos: (L, S_pad) int32 — symbol value at each emission's last
              sample position, 0 elsewhere
      nsym:   (L,) int32 — symbols emitted per line
    """
    L, S_pad = codes.shape
    c = codes.astype(jnp.int32)
    idx = jnp.broadcast_to(jnp.arange(S_pad, dtype=jnp.int32)[None, :], (L, S_pad))

    if v4:
        above = jnp.pad(c[:-1], ((1, 0), (0, 0)), constant_values=-1)
        match = (
            (c == above)
            & (c != CODE_ESCAPE)
            & (above != CODE_ESCAPE)
            & ~block_first[:, None]
        )
        w = jnp.where(match, _CODE_MATCH, c)
    else:
        w = c

    esc = w == CODE_ESCAPE
    prev_w = jnp.pad(w[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    prev_esc = jnp.pad(esc[:, :-1], ((0, 0), (1, 0)), constant_values=False)
    new_run = (w != prev_w) | esc | prev_esc

    run_start = jax.lax.cummax(jnp.where(new_run, idx, -1), axis=1)
    d = idx - run_start
    # constant-divisor remainders (see ops/rle.py::rle_encode); match
    # runs are uncapped so their remainder is the raw in-run offset
    rem = jnp.where(w == 0, d % 127, jnp.where(w >= CODE_ESCAPE, d, d % 31))
    boundary = (rem == 0) & (idx < n_samples)
    next_boundary = jnp.pad(boundary[:, 1:], ((0, 0), (0, 1)), constant_values=False)
    last = next_boundary | (idx == n_samples - 1)

    symval = jnp.where(
        w == _CODE_MATCH,
        m_base + d + 1,
        jnp.where(esc, 256 + esc_ids, _flag_base(c) | (rem + 1)),
    )
    sympos = jnp.where(last, symval, 0)
    nsym = boundary.sum(axis=1, dtype=jnp.int32)
    return sympos, nsym


@jax.jit
def sympos_v3(flagpos, esc_grid):
    """v1-v3 positional symbols directly from positional FLAGS: the flag
    bytes ARE the symbols (so non-greedy runs transcode byte-exactly),
    with escape flags replaced by their dictionary symbol 256 + id."""
    f = flagpos.astype(jnp.int32)
    return jnp.where((f & 0xE0) == 0xE0, 256 + esc_grid, f)


@jax.jit
def sympos_v4(flagpos, esc_grid, n_samples, block_first, m_base, n_rows):
    """Fused v4 emission from positional FLAGS: RLE decode to the code
    grid, then the vertical-prediction symbol grid — one dispatch.
    Rows >= ``n_rows`` (a traced scalar: batch-tail padding) emit
    nothing and report decoded == n_samples."""
    from .rle import rle_decode

    codes, decoded = rle_decode(flagpos, n_samples)
    esc_ids = jnp.where(codes == CODE_ESCAPE, esc_grid, 0)
    sympos, nsym = symbol_grid(
        codes, esc_ids, n_samples, block_first, m_base, v4=True
    )
    row_valid = jnp.arange(sympos.shape[0], dtype=jnp.int32) < n_rows
    sympos = jnp.where(row_valid[:, None], sympos, 0)
    nsym = jnp.where(row_valid, nsym, 0)
    decoded = jnp.where(row_valid, decoded, n_samples)
    return sympos, nsym, decoded


def _cell_class(sym, m_base, *, v4: bool):
    """Alphabet class of a symbol (ops/huffman.py::symbol_classes), as
    arithmetic selects: 0 = full 0|0 run, 1 = short 0|0 run, 2 = het
    run, 3 = escape, 4 = vertical-match (v4)."""
    cls = jnp.where(
        sym == 0x7F,
        0,
        jnp.where(sym < 0x80, 1, jnp.where(sym < 0x100, 2, 3)),
    )
    if v4:
        cls = jnp.where(sym >= m_base, 4, cls)
    return cls


@functools.partial(jax.jit, static_argnames=("v4",))
def ctx_plane(sym, valid, m_base, ctx_init, *, v4: bool):
    """Per-cell coding context of a positional symbol grid (the same
    packed exclusive cummax pack_cells uses internally), exposed for
    v7's context-SPLIT packing: the caller masks each pack_cells call
    to one context's cells so every sub-payload gets its own bitstream."""
    n_blocks, B = sym.shape
    cidx = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[None, :], (n_blocks, B))
    cls = _cell_class(sym, m_base, v4=v4)
    packed = jnp.where(valid, (cidx << 3) | cls, -1)
    prev = jnp.pad(
        jax.lax.cummax(packed, axis=1)[:, :-1], ((0, 0), (1, 0)),
        constant_values=-1,
    )
    return jnp.where(prev < 0, ctx_init, prev & 7)


def pack_entries(books) -> np.ndarray:
    """(n_ctx * alphabet,) int32 packed (length << 16) | code lookup
    table for ``pack_cells`` (host-built, tiny)."""
    lengths = np.stack([b.lengths for b in books]).astype(np.int32)
    codes = np.stack([b.codes for b in books]).astype(np.int32)
    return ((lengths << 16) | codes).reshape(-1)


def _segmented_sum_scan(contrib, seg_start):
    """Inclusive segmented SUM along the last axis (reset at
    ``seg_start``), as a log-depth Hillis-Steele loop under
    ``lax.fori_loop``.

    Semantically identical to
    ``associative_scan((v,f),(v',f') -> (f' ? v' : v+v', f|f'))`` — but
    that lowering unrolls the recursive halving into a large HLO graph
    whose compile time grows with B; this body compiles once and runs
    the same log2(B) combine levels.
    Integer addition is associative, so the emitted values (and hence
    the container bytes) are unchanged.
    """
    n_rows, B = contrib.shape
    steps = max(1, int(B - 1).bit_length())

    def body(k, carry):
        val, flg = carry
        d = jnp.int32(1) << k
        # val[i-d] / flg[i-d]; out-of-range cells act as barriers
        vpad = jnp.pad(val, ((0, 0), (B, 0)))
        fpad = jnp.pad(flg, ((0, 0), (B, 0)), constant_values=True)
        v_sh = jax.lax.dynamic_slice(vpad, (0, B - d), (n_rows, B))
        f_sh = jax.lax.dynamic_slice(fpad, (0, B - d), (n_rows, B))
        return jnp.where(flg, val, val + v_sh), flg | f_sh

    val, _ = jax.lax.fori_loop(0, steps, body, (contrib, seg_start))
    return val


@functools.partial(jax.jit, static_argnames=("n_ctx", "v4"))
def pack_cells(sym, valid, entries, m_base, ctx_init, *, n_ctx: int, v4: bool):
    """Huffman-pack each block's symbol cells into positional 32-bit words.

    Args:
      sym:     (n_blocks, B) int32 cell symbols in stream order (B =
               block_lines * S_pad cells; invalid cells interleave)
      valid:   (n_blocks, B) bool — cells that hold a symbol
      entries: (n_ctx * alphabet,) int32 packed (len << 16) | code
      m_base:  traced scalar — first vertical-match symbol
      ctx_init: traced scalar — context of each block's first symbol
      n_ctx:   static — number of context codebooks (1 = order-0)
      v4:      static — classes include the match band

    Returns:
      word_val:   (n_blocks, B) int32 — assembled word at each word's
                  last cell (elsewhere: partial sums, masked by emit)
      emit:       (n_blocks, B) bool — cells holding a finished payload
                  word (host compaction: flatnonzero per row)
      total_bits: (n_blocks,) int32
      bad:        (n_blocks,) bool — a valid cell had no codeword
    """
    # one trailing invalid cell guarantees a landing site for the final
    # cell's cross-word spill (the injection below shifts by one cell)
    sym = jnp.pad(sym, ((0, 0), (0, 1)))
    valid = jnp.pad(valid, ((0, 0), (0, 1)))
    n_blocks, B = sym.shape
    A = entries.shape[0] // n_ctx
    cidx = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[None, :], (n_blocks, B))

    if n_ctx == 1:
        ctx = jnp.zeros_like(sym)
    else:
        cls = _cell_class(sym, m_base, v4=v4)
        # context = class of the previous symbol: packed exclusive cummax
        # (cell index << 3 | class); < 0 means "no previous symbol"
        packed = jnp.where(valid, (cidx << 3) | cls, -1)
        prev = jnp.pad(
            jax.lax.cummax(packed, axis=1)[:, :-1], ((0, 0), (1, 0)),
            constant_values=-1,
        )
        ctx = jnp.where(prev < 0, ctx_init, prev & 7)

    return _pack_from_ctx(sym, valid, ctx, entries, A)


def _pack_from_ctx(sym, valid, ctx, entries, A):
    """Shared bit-assembly tail of the packers: per-cell codeword lookup,
    exclusive bit offsets, cross-word spill injection, and the segmented
    word-sum.  Density-agnostic — `pack_cells` feeds it positional grids
    (invalid cells interleave), `pack_cells_compact` front-compacted
    symbol streams."""
    entry = jnp.take(entries, ctx * A + jnp.where(valid, sym, 0))
    length = jnp.where(valid, entry >> 16, 0)
    code = jnp.where(valid, entry & 0xFFFF, 0)
    bad = jnp.any(valid & (length == 0), axis=1)

    ends = jnp.cumsum(length, axis=1)
    off = ends - length  # exclusive bit offset
    total_bits = ends[:, -1]

    w_id = off >> 5
    sh = off & 31
    end = sh + length
    spill = jnp.maximum(end - 32, 0)  # bits landing in the next word
    n_hi = length - spill
    hi = jnp.where(valid, (code >> spill) << (32 - sh - n_hi), 0)
    lo = jnp.where(spill > 0, code << (32 - spill), 0)

    # a straddler's spill belongs to the NEXT word, whose segment begins
    # at the very next cell — inject it there (shift by one cell)
    lo_prev = jnp.pad(lo[:, :-1], ((0, 0), (1, 0)))
    contrib = hi | lo_prev

    # per-word OR == segmented SUM over sorted word ids (bits disjoint)
    prev_w = jnp.pad(w_id[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    seg_start = w_id != prev_w
    word_val = _segmented_sum_scan(contrib, seg_start)
    word_last = jnp.pad(
        seg_start[:, 1:], ((0, 0), (0, 1)), constant_values=True
    )
    # the trailing segment (cells past the final bit) owns no payload
    # word when the stream ends exactly on a word boundary — mask it so
    # the host compaction is a bare flatnonzero
    emit = word_last & (w_id * 32 < total_bits[:, None])
    return word_val, emit, total_bits, bad


@functools.partial(jax.jit, static_argnames=("n_ctx", "v4"))
def pack_cells_compact(sym_c, counts, entries, m_base, ctx_init, *, n_ctx: int, v4: bool):
    """`pack_cells` on a FRONT-COMPACTED symbol stream: each row holds
    its block's symbols contiguously (`sort_compact` output sliced to a
    bucketed width), so the per-cell codeword table lookup runs over
    O(symbols) cells instead of O(grid).  The context of each symbol is simply the
    previous lane's class (no packed cummax needed), and the emitted
    word stream is bit-for-bit the dense packer's (same cumsum offsets,
    same spill injection: the straddler's next cell IS the next symbol).

    Args:
      sym_c:  (n_blocks, k) int32 — symbols, front-compacted per row
      counts: (n_blocks,) int32 — valid symbols per row (<= k)
      rest as `pack_cells`.

    Returns the same (word_val, emit, total_bits, bad) tuple, in
    compact cell space — feed to compact_payloads{,_device} as usual.
    """
    # one trailing invalid cell guarantees a landing site for the final
    # cell's cross-word spill
    sym_c = jnp.pad(sym_c, ((0, 0), (0, 1)))
    n_blocks, B = sym_c.shape
    A = entries.shape[0] // n_ctx
    valid = (
        jax.lax.broadcasted_iota(jnp.int32, (n_blocks, B), 1)
        < counts[:, None]
    )
    if n_ctx == 1:
        ctx = jnp.zeros_like(sym_c)
    else:
        cls = _cell_class(sym_c, m_base, v4=v4)
        ctx = jnp.pad(cls[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
        ctx = jnp.where(ctx < 0, ctx_init, ctx)
    return _pack_from_ctx(sym_c, valid, ctx, entries, A)


def device_compaction() -> bool:
    """Whether `.vcfz` device routes compact on the device (sort_compact,
    O(outputs) transfers) instead of shipping dense planes to the host.

    `VCFZ_COMPACT=device|host` forces it either way; unset, the default
    follows the backend: ON for an accelerator, where the dense
    device->host copy is the cost compaction removes; OFF for the CPU
    backend, where that copy is free and the sort dominates.  Both
    settings write identical bytes."""
    mode = os.environ.get("VCFZ_COMPACT")
    if mode == "device":
        return True
    if mode == "host":
        return False
    return jax.default_backend() != "cpu"


@jax.jit
def sort_compact(values, mask):
    """Order-preserving DEVICE compaction: move each row's masked values
    to the front (original order kept) with one ``lax.sort_key_val`` —
    sorts and scans only, per the kernel invariant (no lane gathers, no
    2-D scatters).  The host then D2H-transfers ONLY a leading slice
    sized by the per-row counts instead of the full dense plane — the
    O(cells) -> O(outputs) transfer fix for the `.vcfz` device route
    (VERDICT r4 #2: per-batch compaction passes).

    Returns (front-compacted values, per-row masked counts)."""
    n = values.shape[-1]
    idx = jax.lax.broadcasted_iota(jnp.int32, values.shape, values.ndim - 1)
    key = jnp.where(mask, idx, jnp.int32(np.iinfo(np.int32).max))
    _k, v = jax.lax.sort_key_val(key, values, dimension=values.ndim - 1)
    return v, mask.sum(axis=-1, dtype=jnp.int32)


# D2H slice widths are bucketed to multiples of this so the eager slice
# executables (one per distinct width) stay few and cacheable
_SLICE_BUCKET = 4096


def _bucket(k: int, n: int) -> int:
    return min(n, -(-max(k, 1) // _SLICE_BUCKET) * _SLICE_BUCKET)


def compact_payloads_device(word_val, emit, total_bits) -> list[bytes]:
    """``compact_payloads`` twin that compacts ON DEVICE (sort_compact)
    and transfers only ceil(max_bits/32) words per block instead of the
    dense (n_blocks, B) word plane + emit mask.  Byte-identical output
    (tests/test_vcfz_device.py)."""
    wsorted, _ = sort_compact(word_val, emit)
    bits = np.asarray(total_bits)
    nwords = (bits.astype(np.int64) + 31) >> 5
    kb = _bucket(int(nwords.max(initial=0)), word_val.shape[1])
    host = np.asarray(wsorted[:, :kb])
    out = []
    for b in range(host.shape[0]):
        words = host[b, : nwords[b]].astype(">u4")
        out.append(words.tobytes()[: (int(bits[b]) + 7) >> 3])
    return out


def compact_symbols_device(sympos):
    """``compact_symbols`` twin with the same device-side compaction:
    D2H is O(symbols), not O(cells)."""
    ssorted, counts_dev = sort_compact(sympos, sympos != 0)
    counts = np.asarray(counts_dev)
    kb = _bucket(int(counts.max(initial=0)), sympos.shape[1])
    host = np.asarray(ssorted[:, :kb])
    syms = np.concatenate(
        [host[r, : counts[r]] for r in range(host.shape[0])]
    ).astype(np.int64) if host.shape[0] else np.zeros(0, np.int64)
    return syms, counts.astype(np.uint32)


def compact_payloads(word_val, emit, total_bits) -> list[bytes]:
    """Host compaction of positional words into per-block payload bytes
    (big-endian words, truncated to ceil(bits / 8)) — the O(outputs)
    host transform of the positional contract."""
    word_val = np.asarray(word_val)
    emit = np.asarray(emit)
    total_bits = np.asarray(total_bits)
    out = []
    for b in range(word_val.shape[0]):
        bits = int(total_bits[b])
        words = word_val[b, emit[b]].astype(">u4")
        out.append(words.tobytes()[: (bits + 7) >> 3])
    return out


@functools.partial(jax.jit, static_argnames=("shape",))
def _esc_scatter(lines, samples, ids, *, shape):
    # sparse scatter of O(escapes) points — not a per-cell kernel
    # scatter (the banned pattern); pad rows carry an out-of-range line
    # index and drop
    # NOTE: no unique_indices promise — the pad rows share one dropped
    # out-of-range index
    return jnp.zeros(shape, jnp.int32).at[lines, samples].set(ids, mode="drop")


def esc_plane_device(lines, samples, ids, lpb: int, s_pad: int):
    """Build one batch's (lpb, S_pad) escape-id plane ON DEVICE from the
    sparse (line, sample, id) triples, replacing the dense int32 H2D
    feed (4 B/cell — the encode route's largest host->device transfer).
    Triples are padded to a bucketed count so the jit cache stays small;
    pad entries scatter out of range and drop."""
    k = len(lines)
    kb = max(_bucket(k, k + _SLICE_BUCKET), _SLICE_BUCKET)
    lp = np.full(kb, lpb, np.int32)
    sp = np.zeros(kb, np.int32)
    ip = np.zeros(kb, np.int32)
    lp[:k] = lines
    sp[:k] = samples
    ip[:k] = ids
    return _esc_scatter(
        jnp.asarray(lp), jnp.asarray(sp), jnp.asarray(ip), shape=(lpb, s_pad)
    )


def compact_symbols(sympos, nsym=None):
    """Host compaction of a positional symbol grid into (flat symbols,
    per-row counts) — row-major nonzero walk, fully vectorized."""
    sympos = np.asarray(sympos)
    flat = sympos.reshape(-1)
    k = np.flatnonzero(flat)
    syms = flat[k].astype(np.int64)
    counts = np.count_nonzero(sympos, axis=1).astype(np.uint32)
    return syms, counts


@jax.jit
def resolve_match_grid(classpos, n_samples):
    """DECODE twin of ``symbol_grid(v4=True)``: resolve v4/v6 vertical
    MATCH runs into plain `.vcfc` positional flag bytes, on device.

    The host hands in the symbol streams *positionally* as a class grid
    (``_block_classpos`` in format/vcfz_device.py): ``code + 1`` at each
    symbol's LAST covered sample position, 0 elsewhere, where code is
    0-3 = phased GT, 4 = escape, 5 = MATCH.  The dense middle of the
    host decode path (format/vcfz.py::_v4_block_to_v3 — row loops over
    (lines x samples) cells) then becomes three scans:

      expand    next-set backward fill (the rle_decode fill scan)
      resolve   fill-forward down block rows: a MATCH cell takes the
                cell above it — "rightmost non-MATCH" is associative
                (MATCH is the identity), so one log-depth
                associative_scan along the row axis, elementwise
                selects only
      re-emit   ops/rle.py::rle_encode — the reference's greedy capped
                flag runs (compress.cpp:124-186), byte-identical to the
                host re-emission (_emit_row_symbols)

    Args:
      classpos:  (B, Lb, S_pad) uint8 — class-at-run-end grids, one
                 block per Lb-row slab (the resolve never crosses slab
                 boundaries); all-zero rows are padding
      n_samples: traced scalar — true sample count

    Returns:
      flagpos: (B, Lb, S_pad) uint8 positional `.vcfc` flag bytes
               (escape cells carry 0xE1; ids rejoin on the host)
      nseg:    (B, Lb) int32 flag bytes per row (garbage on pad rows)
      bad:     () bool — a MATCH survived the resolve (i.e. appeared in
               a block's first line: corrupt container)
    """
    B, Lb, S_pad = classpos.shape
    flat = classpos.reshape(B * Lb, S_pad)
    from .rle import _next_set_scan, rle_encode

    filled = _next_set_scan(flat, flat > 0)
    # covered cells hold class+1 (1..6) -> codes 0..5; cells past the
    # last symbol of padded rows/columns fill with garbage (254) that
    # rle_encode's n_samples bound and the host row slicing discard
    codes = (filled - 1).reshape(B, Lb, S_pad)
    resolved = jax.lax.associative_scan(
        lambda a, b: jnp.where(b == _CODE_MATCH, a, b), codes, axis=1
    )
    col_ok = jnp.arange(S_pad, dtype=jnp.int32)[None, None, :] < n_samples
    bad = jnp.any((resolved == _CODE_MATCH) & col_ok)
    flagpos, nseg = rle_encode(
        resolved.reshape(B * Lb, S_pad).astype(jnp.uint8), n_samples
    )
    return flagpos.reshape(B, Lb, S_pad), nseg.reshape(B, Lb), bad
