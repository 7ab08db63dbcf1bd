"""Genotype symbol histograms.

Per-shard histograms of the 5 genotype codes; merged across the device
mesh with psum to drive global codebook construction (the collective
analog called for by BASELINE.json's north star — the reference has no
distributed layer at all, SURVEY.md §2 'Parallelism inventory').
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

N_SYMBOLS = 5


@jax.jit
def code_histogram(codes: jax.Array) -> jax.Array:
    """Count occurrences of each code in a (L, S) uint8 matrix -> (5,) int64-ish.

    One-hot + sum; XLA lowers this to a single fused reduction.
    """
    one_hot = (codes[..., None] == jnp.arange(N_SYMBOLS, dtype=codes.dtype)).astype(
        jnp.int32
    )
    return one_hot.sum(axis=(0, 1))


@jax.jit
def masked_code_histogram(codes: jax.Array, n_samples: jax.Array) -> jax.Array:
    """Histogram over the first ``n_samples`` columns only (padding ignored)."""
    L, S_pad = codes.shape
    valid = jnp.arange(S_pad, dtype=jnp.int32)[None, :] < n_samples
    one_hot = (codes[..., None] == jnp.arange(N_SYMBOLS, dtype=codes.dtype)).astype(
        jnp.int32
    ) * valid[..., None]
    return one_hot.sum(axis=(0, 1))


@jax.jit
def ctx_flag_histogram(flagpos: jax.Array, n_samples: jax.Array) -> jax.Array:
    """(N_CTX, 256) context-classed flag-byte histogram on device.

    The .vcfz v2 codebooks code each symbol under the CLASS of the
    previous symbol (ops/huffman.py::symbol_classes).  This op counts
    (context, flag-byte) pairs over a positional-flag matrix — per row,
    the context of each flag is the class of the previous flag in that
    row, CTX_INIT at row starts.  psum across a mesh merges shard
    histograms into the global codebook input (escape-dictionary symbol
    frequencies, >= 256, join host-side where the dictionary lives).

    Codebook-grade: .vcfz chains contexts across lines inside a block,
    so up to one symbol per line is attributed to CTX_INIT instead of
    its cross-line context (<0.1% of symbols); build codebooks with a
    +1 floor on present symbols to guarantee codeword coverage.
    """
    from .huffman import CTX_INIT

    L, S_pad = flagpos.shape
    f = flagpos.astype(jnp.int32)
    present = f > 0
    idx = jax.lax.broadcasted_iota(jnp.int32, (L, S_pad), 1)
    # previous present flag per position: packed last-set cummax, shifted
    # (8 payload bits — flags are bytes — so idx supports widths to 2^23)
    packed = jnp.where(present, (idx << 8) | f, -1)
    filled = jax.lax.cummax(packed, axis=1)
    prev_packed = jnp.pad(filled[:, :-1], ((0, 0), (1, 0)), constant_values=-1)
    prev_flag = prev_packed & 0xFF
    ctx = jnp.where(
        prev_packed < 0,
        CTX_INIT,
        jnp.where(
            prev_flag == 0x7F,
            0,
            jnp.where(prev_flag < 0x80, 1, jnp.where(prev_flag < 0xE0, 2, 3)),
        ),
    )
    valid = present & (idx < n_samples)
    bins = jnp.where(valid, ctx * 256 + f, 0)
    hist = jnp.zeros(4 * 256, jnp.int32).at[bins.reshape(-1)].add(
        valid.reshape(-1).astype(jnp.int32)
    )
    return hist.reshape(4, 256)
