"""Sharded codec steps over a device mesh.

Variant-line batches are sharded across the ``data`` axis; each device
RLE-encodes its shard locally (lines are independent), then:

  * symbol histograms merge with ``psum`` (global codebook input),
  * per-shard compressed byte counts ``all_gather`` into a deterministic
    exclusive prefix — every shard learns its output byte offset without
    host round-trips, fixed by shard index rather than arrival order
    (SURVEY.md §7 hard part 3).

This replaces the reference's nonexistent distribution story (it ran
single-threaded; SLURM fan-out only, run-all.sh:25).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from ..ops.histogram import ctx_flag_histogram, masked_code_histogram
from ..ops.rle import rle_decode, rle_encode
from .mesh import DATA_AXIS


def make_sharded_encode_step(mesh):
    """Build a pjit-compiled sharded encode step.

    fn(codes, n_samples) -> (flagpos, nseg, global_hist, shard_offset)
    with codes sharded (data, None); shard_offset is the exclusive scan
    of per-shard flag counts (deterministic output placement).
    """

    def _shard_body(codes, n_samples):
        flagpos, nseg = rle_encode(codes, n_samples)
        hist = masked_code_histogram(codes, n_samples)
        hist = jax.lax.psum(hist, DATA_AXIS)
        # deterministic cross-shard exclusive byte-offset scan
        shard_bytes = nseg.sum()[None]
        all_bytes = jax.lax.all_gather(shard_bytes, DATA_AXIS).reshape(-1)
        my_index = jax.lax.axis_index(DATA_AXIS)
        my_offset = jnp.where(
            jnp.arange(all_bytes.shape[0]) < my_index, all_bytes, 0
        ).sum()[None]
        return flagpos, nseg, hist, my_offset

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P(), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_codebook_step(mesh):
    """Encode + global .vcfz v2 codebook statistics in one sharded step:
    every shard RLE-encodes its lines and the (context, flag) histogram
    psum-merges across the mesh — the device-side input for
    ops.huffman.context_codebooks (escape frequencies join host-side)."""

    def _shard_body(codes, n_samples):
        flagpos, nseg = rle_encode(codes, n_samples)
        ctx_hist = jax.lax.psum(ctx_flag_histogram(flagpos, n_samples), DATA_AXIS)
        return flagpos, nseg, ctx_hist

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_decode_step(mesh):
    """Build a pjit-compiled sharded decode step — the decode twin of
    ``make_sharded_encode_step`` (VERDICT r1 #2; the reference's sequential
    spec is decompress2_fd, compress.cpp:1214-1257).

    fn(flagpos, n_samples) -> (codes, decoded) with flagpos sharded
    (data, None); every device run-fills its line shard locally (lines
    are independent), no collectives needed on the decode path itself.
    """

    def _shard_body(flagpos, n_samples):
        return rle_decode(flagpos, n_samples)

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_unpack_decode_step(mesh, out_width: int):
    """Sharded matmul-unpack decode (VERDICT r2 #3): each device expands
    its shard of PACKED file flag bytes to positional flags via the
    batched indicator matmul (ops.rle.unpack_packed_flags) and
    run-fills codes, fused in one jit.  This is the multichip twin of the
    VCFC_UNPACK=device engine route.

    fn(flags (L, M) u8 packed, nflags (L,) i32, n_samples) ->
    (codes (L, out_width) u8, decoded (L,) i32), flags sharded (data, None).
    """
    from ..ops.rle import unpack_rle_decode

    def _shard_body(flags, nflags, n_samples):
        return unpack_rle_decode(flags, nflags, n_samples, out_width=out_width)

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_text_step(mesh):
    """Sharded fused-text roundtrip (r3): each device classifies its
    shard of raw "a|b\\t" ASCII words, RLE-encodes, decodes, and renders
    back to words — the VCFC_PARSE=device kernels under the mesh.

    fn(text (L, S_pad) i32, n_samples) -> (text', flagpos, nseg, seps_ok).
    """
    from ..ops.rle import text_rle_decode, text_rle_encode

    def _shard_body(text, n_samples):
        flagpos, nseg, seps_ok = text_rle_encode(text, n_samples)
        text2, _codes, _decoded = text_rle_decode(flagpos, n_samples)
        return text2, flagpos, nseg, seps_ok

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_roundtrip_step(mesh):
    """Encode + decode on-device roundtrip step (used by multichip dry runs
    and correctness sweeps): returns decoded codes and a per-shard match
    flag reduced with psum."""

    def _shard_body(codes, n_samples):
        flagpos, nseg = rle_encode(codes, n_samples)
        hist = jax.lax.psum(masked_code_histogram(codes, n_samples), DATA_AXIS)
        decoded_codes, decoded = rle_decode(flagpos, n_samples)
        S_pad = codes.shape[1]
        valid = jnp.arange(S_pad, dtype=jnp.int32)[None, :] < n_samples
        ok = jnp.all(
            jnp.where(valid, decoded_codes == codes, True)
        ) & jnp.all(decoded == n_samples)
        n_ok = jax.lax.psum(ok.astype(jnp.int32), DATA_AXIS)
        return decoded_codes, n_ok, hist

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P()),
        out_specs=(P(DATA_AXIS, None), P(), P()),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_vcfz_pack_step(mesh, block_lines: int, n_ctx: int = 1,
                                v4: bool = False):
    """Data-parallel `.vcfz` entropy PACKING under a device mesh (r4):
    each device turns its block-aligned line shard's positional flags
    into positional symbols (escape cells -> dictionary symbols) and
    Huffman-packs every block with the replicated codebook entries —
    blocks are independent, so the multichip transcode is pure data
    parallelism over the block axis (ops/vcfz_device.py kernels inside
    shard_map).

    fn(flagpos (L, S_pad) u8, esc_grid (L, S_pad) i32,
       entries (n_ctx * alphabet,) i32, m_base, ctx_init) ->
    (word_val, emit, total_bits, bad) with the L axis sharded; per-shard
    L must be a multiple of block_lines.
    """
    from ..ops.vcfz_device import pack_cells, sympos_v3

    def _shard_body(flagpos, esc_grid, entries, m_base, ctx_init):
        sympos = sympos_v3(flagpos, esc_grid)
        l, s_pad = sympos.shape
        cells = sympos.reshape(l // block_lines, block_lines * s_pad)
        return pack_cells(
            cells, cells != 0, entries, m_base, ctx_init,
            n_ctx=n_ctx, v4=v4,
        )

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(), P(), P()),
        out_specs=(
            P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS), P(DATA_AXIS),
        ),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_huffman_decode_step(mesh, s1: int, s2: int):
    """Data-parallel order-0 entropy DECODE under a device mesh (r4):
    each device bit-decodes its shard of independent payload streams
    (v1/v5 symbol payloads, v3+/v5 req payloads) with the replicated
    canonical-limit tables — the decode twin of
    ``make_sharded_vcfz_pack_step`` (ops/huffman_device.py kernel
    inside shard_map).

    fn(words (B, W) i32 big-endian, limits (15,), idx_adjust (15,)) ->
    (B, s1*s2) i32 positional `ordinal + 1` plane, B sharded.
    """
    from ..ops.huffman_device import decode_bits

    def _shard_body(words, limits, idx_adjust):
        return decode_bits(words, limits, idx_adjust, s1=s1, s2=s2)

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(), P()),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )
    return jax.jit(sharded)


def make_sharded_resolve_step(mesh):
    """Data-parallel v4/v6 vertical-match RESOLVE under a device mesh
    (r4): blocks are independent Lb-row slabs, so the decode middle
    (ops/vcfz_device.py::resolve_match_grid — fill scan, log-depth row
    resolve, greedy flag re-emission) shards over the block axis with
    no collectives at all.

    fn(classpos (B, Lb, S_pad) u8, n_samples) ->
    (flagpos (B, Lb, S_pad) u8, nseg (B, Lb) i32, bad (n_dev,) bool)
    with the B axis sharded.
    """
    from ..ops.vcfz_device import resolve_match_grid

    def _shard_body(classpos, n_samples):
        flagpos, nseg, bad = resolve_match_grid(classpos, n_samples)
        return flagpos, nseg, bad[None]

    sharded = shard_map(
        _shard_body,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P()),
        out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None), P(DATA_AXIS)),
        check_vma=False,
    )
    return jax.jit(sharded)
