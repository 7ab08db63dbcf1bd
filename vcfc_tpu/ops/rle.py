"""Device RLE codec: vectorized run-length encode/decode of genotype codes.

Device-first design: where the reference walks samples byte-at-a-time
in a scalar loop (compress.cpp:124-186, 832-954), we operate on a dense
(lines x samples) uint8 code matrix with data-parallel vector scans.

Representation: *positional flags*.  A legal .vcfc flag byte is never
0x00 (its count field is >= 1), so a (L, S) matrix holding the flag byte
at each segment's LAST sample position — and 0 elsewhere — is a
lossless, fixed-shape encoding of the ragged flag stream (nonzero lane
order == flag-stream order either way).  End placement is chosen over
start placement because it makes the segment length locally available
to the encoder (length = distance into the run, mod cap, + 1), deleting
the encoder's whole next-boundary suffix scan; the decoder's fill scan
just flips direction at identical cost.  The device does all the dense
O(L*S) work on this form; the native host runtime (or numpy fallback)
performs the tiny O(runs-per-line) positional<->packed transforms
during file I/O.

Why: the positional form needs no scatter or gather — every stage is
a dense elementwise op or a prefix scan over the sample axis, which
XLA fuses (whether a scatter formulation would be faster on the GPU is
an open question, ROADMAP Queue 3):

  encode:  run boundaries  = shifted-compare + per-code run-cap splitting
           run starts      = cummax segmented scan
           run lengths     = local (in-run offset mod cap) + 1 at segment ends
           flag bytes      = arithmetic mask selects (no table gather)

  decode:  segment fill    = next-nonzero associative scan
           codes           = flag-byte bit tests
           ASCII render    = arithmetic byte synthesis ("X|Y\t")

Genotype codes: 0="0|0", 1="0|1", 2="1|0", 3="1|1", 4=escape (any other
ASCII genotype; carried in a host-side side channel).
Flag scheme: utils.hpp:44-56; caps 127/31/1: compress.cpp:126-127,171-185.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..format.constants import (
    CODE_ESCAPE,
    SAMPLE_MASKED_01,
    SAMPLE_MASKED_10,
    SAMPLE_MASKED_11,
    SAMPLE_MASKED_UNCOMPRESSED,
)


def _flag_base(c: jax.Array) -> jax.Array:
    """Flag-byte base value per code, as selects (no table gather)."""
    return jnp.where(
        c == 0,
        0,
        jnp.where(
            c == 1,
            SAMPLE_MASKED_01,
            jnp.where(
                c == 2,
                SAMPLE_MASKED_10,
                jnp.where(c == 3, SAMPLE_MASKED_11, SAMPLE_MASKED_UNCOMPRESSED),
            ),
        ),
    )


@jax.jit
def rle_encode(codes: jax.Array, n_samples: jax.Array):
    """Encode a (L, S_pad) uint8 code matrix into positional flag bytes.

    Columns >= ``n_samples`` are padding and produce no flags.
    ``n_samples`` is a traced scalar: one compile per padded shape.

    Returns:
      flagpos: (L, S_pad) uint8 — flag byte at each segment's LAST
               position, 0 elsewhere (0 is never a legal flag byte)
      nseg:    (L,) int32 — number of flag bytes per row
    """
    L, S_pad = codes.shape
    c = codes.astype(jnp.int32)
    idx = jnp.broadcast_to(jnp.arange(S_pad, dtype=jnp.int32)[None, :], (L, S_pad))

    prev = jnp.pad(c[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    new_run = (c != prev) | (c == CODE_ESCAPE) | (prev == CODE_ESCAPE)

    run_start = jax.lax.cummax(jnp.where(new_run, idx, -1), axis=1)
    # boundary: every run-cap-th position within a run.  Both remainders
    # use CONSTANT divisors (escape runs have cap 1 but always start a new
    # run, so d == 0 and rem31 == 0 there): the compiler strength-reduces
    # a constant divisor, a data-dependent one is a full integer division.
    d = idx - run_start
    rem = jnp.where(c == 0, d % 127, d % 31)
    boundary = (rem == 0) & (idx < n_samples)

    # a segment's last position is the one right before the next boundary
    # (or position n-1); there its length is simply rem + 1 — no
    # next-boundary suffix scan needed
    next_boundary = jnp.pad(boundary[:, 1:], ((0, 0), (0, 1)), constant_values=False)
    last = next_boundary | (idx == n_samples - 1)
    flagpos = jnp.where(last, _flag_base(c) | (rem + 1), 0).astype(jnp.uint8)
    nseg = boundary.sum(axis=1, dtype=jnp.int32)
    return flagpos, nseg


def _next_set_scan(values: jax.Array, present: jax.Array) -> jax.Array:
    """Backward-fill `values` over positions where ``present`` is False
    (each position takes the next present value at-or-after it).

    Implemented as ONE reverse cummin over packed (position << 8) | value
    keys: the earliest set position always wins, so a single min-scan
    replaces the two-array associative scan (half the scan traffic).
    Values are flag BYTES (< 256), so 8 payload bits suffice and the
    int32 key supports sample widths up to 2^23 without overflow."""
    L, S_pad = values.shape
    if S_pad >= (1 << 23):  # pragma: no cover - absurd cohort width
        raise ValueError(f"sample width {S_pad} exceeds the packed-scan range")
    idx = jnp.arange(S_pad, dtype=jnp.int32)[None, :]
    big = jnp.int32(0x7FFFFFFF)
    packed = jnp.where(present, (idx << 8) | values.astype(jnp.int32), big)
    return jax.lax.cummin(packed, axis=1, reverse=True) & 0xFF


@jax.jit
def rle_decode(flagpos: jax.Array, n_samples: jax.Array):
    """Decode positional flag bytes back to codes and rendered ASCII.

    Args:
      flagpos:   (L, S_pad) uint8 — flag byte at each segment-end position
      n_samples: traced scalar — true sample count

    Returns:
      codes:   (L, S_pad) uint8 (columns >= n_samples are padding)
      decoded: (L,) int32 — number of samples covered by the flags
               (== n_samples iff the stream is well-formed)

    ASCII rendering happens host-side (native render or render_text):
    shipping 1 code byte per sample instead of 4 text bytes quarters the
    device->host transfer.
    """
    L, S_pad = flagpos.shape
    present = flagpos > 0
    filled = _next_set_scan(flagpos, present)

    is00 = (filled & 0x80) == 0
    isesc = (filled & 0xE0) == 0xE0
    masked = filled & 0xE0
    code = jnp.where(
        is00,
        0,
        jnp.where(
            isesc,
            CODE_ESCAPE,
            jnp.where(masked == SAMPLE_MASKED_01, 1, jnp.where(masked == SAMPLE_MASKED_10, 2, 3)),
        ),
    ).astype(jnp.uint8)

    fi = flagpos.astype(jnp.int32)
    run_len = jnp.where(
        present,
        jnp.where(
            (fi & 0x80) == 0, fi & 0x7F, jnp.where((fi & 0xE0) == 0xE0, 1, fi & 0x1F)
        ),
        0,
    )
    valid = jnp.arange(S_pad, dtype=jnp.int32)[None, :] < n_samples
    decoded = jnp.sum(run_len * valid, axis=1, dtype=jnp.int32)
    return code, decoded


@jax.jit
def text_rle_encode(text: jax.Array, n_samples):
    """Fused ASCII classify + RLE encode.  ``text`` is (L, S_pad) int32 — one little-endian
    "a|b\\t" word per 4-byte sample field.  Returns (flagpos, nseg,
    seps_ok) with seps_ok == 0 marking rows whose separator bytes are
    not tabs (mis-sliced irregular lines the caller routes to the
    oracle).  Classification predicate matches the reference's four-GT
    match (compress.cpp:126-170; everything else escapes :171-185)."""
    L, S_pad = text.shape
    b0 = text & 0xFF
    b1 = (text >> 8) & 0xFF
    b2 = (text >> 16) & 0xFF
    sep = (text >> 24) & 0xFF
    valid = (((b0 - 48) & ~1) == 0) & (b1 == 124) & (((b2 - 48) & ~1) == 0)
    codes = jnp.where(valid, (b0 - 48) * 2 + (b2 - 48), CODE_ESCAPE).astype(jnp.uint8)
    idx = jnp.arange(S_pad, dtype=jnp.int32)[None, :]
    seps_ok = jnp.min(
        jnp.where(idx < n_samples - 1, (sep == 9).astype(jnp.int32), 1), axis=1
    )
    flagpos, nseg = rle_encode(codes, n_samples)
    return flagpos, nseg, seps_ok


@jax.jit
def text_rle_decode(flagpos: jax.Array, n_samples):
    """Fused RLE decode + ASCII render.  Returns (text int32 "a|b\\t" words — "?|?" escape
    placeholders, '\\n' terminating sample n-1 —, codes, decoded)."""
    L, S_pad = flagpos.shape
    code, decoded = rle_decode(flagpos, n_samples)
    ci = code.astype(jnp.int32)
    esc = ci == CODE_ESCAPE
    b0 = jnp.where(esc, 63, 48 + (ci >> 1))
    b2 = jnp.where(esc, 63, 48 + (ci & 1))
    idx = jnp.arange(S_pad, dtype=jnp.int32)[None, :]
    sep = jnp.where(idx == n_samples - 1, 10, 9)
    text = b0 | (124 << 8) | (b2 << 16) | (sep << 24)
    return text, code, decoded


def render_text(codes) -> "jax.Array":
    """ASCII synthesis "a|b\t" per code (numpy fallback path; the native
    renderer generates text directly from codes)."""
    import numpy as np

    lut = np.zeros((5, 4), np.uint8)
    for c, s in enumerate([b"0|0\t", b"0|1\t", b"1|0\t", b"1|1\t", b"?|?\t"]):
        lut[c] = np.frombuffer(s, np.uint8)
    codes = np.asarray(codes)
    L, S_pad = codes.shape
    return lut[codes].reshape(L, S_pad * 4)


@functools.partial(jax.jit, static_argnames=("out_width",))
def unpack_rle_decode(flags: jax.Array, nflags: jax.Array, n_samples, *, out_width: int):
    """Fused device decode from FILE flag bytes: matmul packed->positional
    unpack + run-fill in one jit (the VCFC_UNPACK=device engine route —
    host work and H2D traffic scale with the compressed size)."""
    return rle_decode(
        unpack_packed_flags(flags, nflags, out_width=out_width), n_samples
    )


@functools.partial(jax.jit, static_argnames=("out_width",))
def unpack_packed_flags(flags: jax.Array, nflags: jax.Array, *, out_width: int):
    """Packed (left-aligned) flag bytes -> positional flags, on device —
    the device-side inverse of flag compaction, so device decode can start
    from file flag bytes (packed per line) instead of detouring through
    the native host unpack.

    The axis transfer (flag slot j -> sample position end_j) is the one
    place a scatter seems forced.  Instead, the placement one-hot
    ``[end_j == p]`` is factored into window and lane indicators,

        [end_j == p]  =  [end_j >> 7 == p >> 7] * [end_j & 127 == p & 127],

    which turns the redistribution into a batched
    (W/128, M) x (M, 128) bf16 matmul (cuBLAS on the GPU) — no 2-D
    scatter, no lane gather.  bf16 operands are exact: flag bytes are
    < 256 (8-bit significand covers them), the indicators are 0/1, at
    most one term per output position is nonzero, and the product
    accumulates in f32 (bf16 operands never take the TF32 path).

    Precondition (same as the rest of the positional representation):
    escape flags carry count 1 — the writer never emits more
    (compress.cpp:171-185 "TODO lookahead"), rle_decode assigns escape
    segments length 1, and the native unpack routes count != 1 lines to
    the oracle (vcfc_host.cpp status 2).

    Args:
      flags:  (L, M) uint8 packed flag bytes, left-aligned, 0-padded
      nflags: (L,) int32 — valid flag count per line
      out_width: static positional width (>= samples covered)

    Returns (L, out_width) uint8 positional flags.
    """
    L, M = flags.shape
    w_pad = (out_width + 127) // 128 * 128
    nwin = w_pad // 128

    fi = flags.astype(jnp.int32)
    valid = jnp.arange(M, dtype=jnp.int32)[None, :] < nflags[:, None]
    run_len = jnp.where(
        valid,
        jnp.where(
            (fi & 0x80) == 0, fi & 0x7F, jnp.where((fi & 0xE0) == 0xE0, 1, fi & 0x1F)
        ),
        0,
    )
    ends = jnp.cumsum(run_len, axis=1) - 1  # segment-end placement
    ok = valid & (run_len > 0) & (ends < out_width)
    win = jnp.where(ok, ends >> 7, nwin)  # sentinel window: matches nothing
    lane = jnp.where(ok, ends & 127, 128)

    # window factor carries the flag value; lane factor is the 0/1 mask
    a = (
        win[:, None, :] == jnp.arange(nwin, dtype=jnp.int32)[None, :, None]
    ).astype(jnp.bfloat16) * fi[:, None, :].astype(jnp.bfloat16)
    b = (
        lane[:, :, None] == jnp.arange(128, dtype=jnp.int32)[None, None, :]
    ).astype(jnp.bfloat16)
    out = jnp.einsum(
        "lwm,lmk->lwk", a, b, preferred_element_type=jnp.float32
    ).reshape(L, w_pad)
    return out[:, :out_width].astype(jnp.uint8)
