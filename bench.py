"""Benchmark entry point: prints ONE JSON line.  Needs an NVIDIA GPU.

Headline metric: steady-state device RLE encode+decode throughput on a
realistic 1000-Genomes-like genotype distribution (81% 0|0; escape
tail), in GB of genotype text (4 ASCII bytes per sample field) per
second per card.  The ``extra`` field adds:

  text_roundtrip_GBps   text->flags->text loop: ASCII classify + encode
                        + decode + render all on device (ops/rle.py
                        text kernels, the VCFC_PARSE=device route)
  wide_xla_GBps         the RLE kernels at S=16,384 and S=50,000
  vcfz_device_GBps      the device `.vcfz` v4 transcode pipeline (RLE
                        decode -> vertical-prediction symbol emission ->
                        context-classed Huffman bit packing on device;
                        ops/vcfz_device.py)
  vcfz_resolve_GBps     the device v4/v6 DECODE middle: vertical-match
                        resolve back to plain flags
                        (ops/vcfz_device.py::resolve_match_grid)

Method: K chained steps run inside ONE jitted ``lax.fori_loop`` and the
K=1 cost is subtracted, leaving per-step device time.  Lossless-roundtrip
correctness gates run after timing.

Baseline: the reference C++ binary (main_release, -O3) on a host CPU
compresses+decompresses a 2504-sample x 5000-variant synthetic VCF at a
combined 0.047 GB/s single-core (compress 0.063 GB/s + decompress
0.183 GB/s; see BASELINE.md).  vs_baseline is our combined throughput
over that anchor.
"""

from __future__ import annotations

import json
import time

import numpy as np

# reference main_release combined encode+decode GB/s on this machine
BASELINE_COMBINED_GBPS = 0.047


def _make_runner(jax, jnp, step):
    """step: (carry, i) -> (carry, int32) inside a jitted fori_loop."""

    def make(iters):
        @jax.jit
        def run(c):
            def body(i, st):
                c_in, acc = st
                c_out, a = step(c_in, i)
                return (c_out, acc ^ a ^ i)

            _, acc = jax.lax.fori_loop(0, iters, body, (c, jnp.int32(0)))
            return acc

        return run

    return make


def _timed(jax, fn, x, reps=3):
    """Best-of-reps: dispatch jitter would otherwise be amplified by the
    K=1 subtraction."""
    r = fn(x)
    jax.block_until_ready(r)  # warmup/compile
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(x))
        best = min(best, time.perf_counter() - t0)
    return best


def _measure(jax, jnp, step, x, K=51):
    mk = _make_runner(jax, jnp, step)
    dt_k = _timed(jax, mk(K), x)
    dt_1 = _timed(jax, mk(1), x)
    return (dt_k - dt_1) / (K - 1)  # per-step device time, dispatch excluded


def _opaque_mask(jnp, v):
    """Runtime-opaque always-zero uint8: XLA cannot fold `v == sentinel`
    (v is data), so XORing it into the carry defeats loop hoisting of an
    otherwise loop-invariant body."""
    return (v == jnp.int32(-0x7EAD)).astype(jnp.uint8)


def _gt_codes(L, S, seed=0):
    rng = np.random.default_rng(seed)
    # 1000G-like distribution incl. escape tail
    return rng.choice(
        5, size=(L, S), p=[0.81, 0.072, 0.072, 0.0264, 0.0196]
    ).astype(np.uint8)


def _codes_loop_gbps(jax, jnp, encode_fn, decode_fn, L, S, codes_np, K=51):
    codes = jax.device_put(codes_np)

    def step(c_in, i):
        flagpos, nseg = encode_fn(c_in, jnp.int32(S))
        dec_codes, decoded = decode_fn(flagpos, jnp.int32(S))
        # thread the (unchanged) codes through the carry via an
        # always-false mask XOR: a loop-INVARIANT body would let XLA
        # hoist the whole step out of the loop
        c_next = (c_in ^ _opaque_mask(jnp, nseg[0])).astype(jnp.uint8)
        acc = nseg[0] + decoded[0] + jnp.int32(dec_codes[0, 0])
        return c_next, acc

    dt = _measure(jax, jnp, step, codes, K)

    # correctness gate AFTER timing: decode must invert encode (compare
    # only the first S columns — padding decodes to the escape sentinel)
    f, _ = encode_fn(codes, jnp.int32(S))
    dec, n = decode_fn(f, jnp.int32(S))
    assert (np.asarray(dec)[:, :S] == codes_np[:, :S]).all(), "roundtrip mismatch on device"
    assert (np.asarray(n) == S).all()
    return L * S * 4 / dt / 1e9


def _resolve_loop_gbps(jax, jnp, L, S, codes_np, K=21):
    """Device v4/v6 decode MIDDLE: vertical-match resolve of one v4
    emission's symbol grids back to plain `.vcfc` flags (the inverse of
    the transcode leg's transform); GB of genotype text per second."""
    from vcfc_tpu.format.vcfz_device import _block_classpos
    from vcfc_tpu.ops.rle import rle_encode
    from vcfc_tpu.ops.vcfz_device import (
        compact_symbols,
        resolve_match_grid,
        sympos_v4,
    )

    block_lines = 64
    n_blocks = L // block_lines
    m_base = 257
    flags = rle_encode(jax.device_put(codes_np), jnp.int32(S))[0]
    esc0 = jnp.zeros((L, S), jnp.int32)
    bf_np = np.zeros(L, bool)
    bf_np[::block_lines] = True
    sp0, ns0, _dec = sympos_v4(
        flags, esc0, jnp.int32(S), jnp.asarray(bf_np), m_base, L
    )
    syms, counts = compact_symbols(np.asarray(sp0))
    counts = counts.astype(np.int64)
    grids = []
    pos = 0
    for b in range(n_blocks):
        c = counts[b * block_lines : (b + 1) * block_lines]
        tot = int(c.sum())
        g, _e = _block_classpos(syms[pos : pos + tot], c, S, S, m_base)
        grids.append(g)
        pos += tot
    batch = jax.device_put(np.stack(grids))

    def step(c_in, i):
        flagpos, nseg, bad = resolve_match_grid(c_in, jnp.int32(S))
        c_next = (c_in ^ _opaque_mask(jnp, nseg[0, 0])).astype(jnp.uint8)
        acc = nseg[0, 0] + jnp.int32(flagpos[0, 0, 0]) + bad.astype(jnp.int32)
        return c_next, acc

    dt = _measure(jax, jnp, step, batch, K)

    # correctness gate AFTER timing: resolving the v4 emission of the
    # codes must reproduce their plain greedy flags exactly
    rf, _rn, rbad = resolve_match_grid(batch, jnp.int32(S))
    assert not bool(np.asarray(rbad)), "resolve: MATCH in first line"
    np.testing.assert_array_equal(
        np.asarray(rf).reshape(L, S), np.asarray(flags)
    )
    return L * S * 4 / dt / 1e9


def _text_words(codes_np, S):
    """Render genotype codes to "a|b\\t" i32 words (host mirror of the
    device render; escapes get the "?|?" placeholder)."""
    c = codes_np.astype(np.int32)
    esc = c == 4
    b0 = np.where(esc, 63, 48 + (c >> 1))
    b2 = np.where(esc, 63, 48 + (c & 1))
    sep = np.full_like(c, 9)
    sep[:, S - 1] = 10
    return (b0 | (124 << 8) | (b2 << 16) | (sep << 24)).astype(np.int32)


def _text_loop_gbps(jax, jnp, enc, dec, L, S, codes_np, K=51):
    text_np = _text_words(codes_np, S)
    text = jax.device_put(text_np)

    def step(t_in, i):
        flagpos, nseg, reg = enc(t_in, jnp.int32(S))
        t_out, _codes, decoded = dec(flagpos, jnp.int32(S))
        # t_out is genuinely data-dependent on t_in (and a fixed point of
        # the roundtrip): no opaque-mask threading needed
        return t_out, nseg[0] + decoded[0] + reg[0]

    dt = _measure(jax, jnp, step, text, K)

    f, _, reg = enc(text, jnp.int32(S))
    t2, dec_codes, n = dec(f, jnp.int32(S))
    assert (np.asarray(t2) == text_np).all(), "text roundtrip mismatch on device"
    assert (np.asarray(dec_codes) == codes_np).all()
    assert (np.asarray(n) == S).all() and (np.asarray(reg) == 1).all()
    return L * S * 4 / dt / 1e9


def _vcfz_loop_gbps(jax, jnp, L, S, codes_np, K=21):
    """Device `.vcfz` v4 transcode pipeline (VERDICT r3 #1/#7): RLE
    decode -> vertical-prediction symbol emission -> context-classed
    Huffman bit packing, all on chip; GB of genotype text per second."""
    from vcfc_tpu.ops.huffman import (
        CTX_INIT,
        N_CTX_V4,
        context_codebooks,
        pack_symbols_ctx,
        symbol_classes,
    )
    from vcfc_tpu.ops.rle import rle_encode
    from vcfc_tpu.ops.vcfz_device import (
        _bucket,
        compact_payloads,
        compact_symbols,
        pack_cells_compact,
        pack_entries,
        sort_compact,
        sympos_v4,
    )

    block_lines = 64  # the v4 default (format/vcfz.py)
    n_blocks = L // block_lines
    m_base = 257  # one escape-dictionary entry (the codes' escape tail)
    n_symbols = m_base + S + 1
    classes = symbol_classes(n_symbols, match_base=m_base)

    flags = rle_encode(jax.device_put(codes_np), jnp.int32(S))[0]
    esc0 = jnp.zeros((L, S), jnp.int32)
    bf_np = np.zeros(L, bool)
    bf_np[::block_lines] = True
    bf = jnp.asarray(bf_np)

    # codebooks from one emission pass (host-side, O(symbols))
    sp0, ns0, _dec = sympos_v4(flags, esc0, jnp.int32(S), bf, m_base, L)
    syms, _counts = compact_symbols(np.asarray(sp0))
    ns0 = np.asarray(ns0)
    blk_counts = ns0.reshape(n_blocks, block_lines).sum(axis=1)
    blk_ends = np.cumsum(blk_counts)
    per_block = np.split(syms, blk_ends[:-1])
    books = context_codebooks(per_block, n_symbols, classes, N_CTX_V4)
    entries = jnp.asarray(pack_entries(books))

    # compact-space pipeline (the accelerator default, device_compaction):
    # sort front-compacts each block's symbols, the codeword lookup runs
    # over O(symbols) lanes; KB is static for the timing loop (the loop
    # recycles the same stream, so counts are iteration-invariant)
    KB = _bucket(int(blk_counts.max(initial=0)), block_lines * S)

    def step(f_in, i):
        sp, ns, _d = sympos_v4(f_in, esc0, jnp.int32(S), bf, m_base, L)
        cells = sp.reshape(n_blocks, block_lines * S)
        sc, cnt = sort_compact(cells, cells != 0)
        _wv, _emit, tb, _bad = pack_cells_compact(
            sc[:, :KB], cnt, entries, m_base, CTX_INIT,
            n_ctx=N_CTX_V4, v4=True,
        )
        f_next = (f_in ^ _opaque_mask(jnp, tb[0])).astype(jnp.uint8)
        return f_next, tb[0] + ns[0] + jnp.int32(_wv[0, 0])

    dt = _measure(jax, jnp, step, flags, K)

    # correctness gate AFTER timing: device payload bytes must equal the
    # host context packer on every block
    cells = sp0.reshape(n_blocks, block_lines * S)
    sc, cnt = sort_compact(cells, cells != 0)
    wv, emit, tb, bad = pack_cells_compact(
        sc[:, :KB], cnt, entries, m_base, CTX_INIT, n_ctx=N_CTX_V4, v4=True
    )
    assert not bool(np.asarray(bad).any())
    payloads = compact_payloads(wv, emit, tb)
    for b in (0, n_blocks // 2, n_blocks - 1):
        want, _bits = pack_symbols_ctx(per_block[b], books, classes)
        assert payloads[b] == want, f"device .vcfz payload mismatch, block {b}"
    return L * S * 4 / dt / 1e9


def main() -> None:
    import sys

    import jax
    import jax.numpy as jnp

    from vcfc_tpu.ops.rle import (
        rle_decode,
        rle_encode,
        text_rle_decode,
        text_rle_encode,
    )

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs an NVIDIA GPU; JAX found {dev.platform}")

    # --- headline: codes encode+decode at the 1000G shape
    L, S = 8192, 2560
    K_main, K_wide = 51, 21
    codes_np = _gt_codes(L, S)
    gbps = _codes_loop_gbps(jax, jnp, rle_encode, rle_decode, L, S, codes_np, K=K_main)

    extra: dict = {
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        }
    }

    # --- text roundtrip: ASCII in, ASCII out, all on device
    extra["text_roundtrip_GBps"] = round(
        _text_loop_gbps(
            jax, jnp, text_rle_encode, text_rle_decode, L, S, codes_np, K=K_main
        ),
        3,
    )

    # --- wide cohorts
    wide_xla: dict = {}
    for Lw, Sw in ((2048, 16384), (640, 50000)):
        cw = _gt_codes(Lw, ((Sw + 127) // 128) * 128, seed=Sw)
        cw[:, Sw:] = 0
        wide_xla[f"S={Sw}"] = round(
            _codes_loop_gbps(jax, jnp, rle_encode, rle_decode, Lw, Sw, cw, K=K_wide), 3
        )
    extra["wide_xla_GBps"] = wide_xla

    # --- device .vcfz v4 transcode pipeline
    extra["vcfz_device_GBps"] = round(
        _vcfz_loop_gbps(jax, jnp, L, S, codes_np, K=K_wide), 3
    )

    # --- device v4/v6 decode middle: vertical-match resolve
    extra["vcfz_resolve_GBps"] = round(
        _resolve_loop_gbps(jax, jnp, L, S, codes_np, K=K_wide), 3
    )

    print(
        json.dumps(
            {
                "metric": "genotype_encode_decode_GBps_per_card",
                "value": round(gbps, 3),
                "unit": "GB/s",
                "vs_baseline": round(gbps / BASELINE_COMBINED_GBPS, 1),
                "extra": extra,
            }
        )
    )


if __name__ == "__main__":
    main()
