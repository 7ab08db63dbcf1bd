"""The device RLE kernels (ops/rle.py) must match a plain reference
encoder/decoder bit-for-bit — narrow, 1000G-width and wide sample axes,
long runs at the caps, escape-heavy rows, and the fused text kernels.

The reference walks each row run by run, as the reference encoder does
(compress.cpp:124-186 encode, 832-954 decode), and shares no code with
the kernels."""

import numpy as np
import pytest

from vcfc_tpu.format.constants import CODE_FLAG_BASE, CODE_RUN_CAP
from vcfc_tpu.ops.rle import (
    rle_decode,
    rle_encode,
    text_rle_decode,
    text_rle_encode,
)

GT_P = [0.81, 0.072, 0.072, 0.0264, 0.0196]  # 1000G-like, escape tail


def ref_encode(codes, S):
    """Positional flags: each segment's flag byte (code base | length)
    at its LAST sample; runs split at the code's cap (127 for 0|0, 31
    for the others, 1 for escapes)."""
    codes = np.asarray(codes)
    L, S_pad = codes.shape
    flagpos = np.zeros((L, S_pad), np.uint8)
    nseg = np.zeros(L, np.int32)
    for i in range(L):
        row = codes[i, :S].astype(np.int64)
        brk = np.flatnonzero((row[1:] != row[:-1]) | (row[1:] == 4)) + 1
        starts = np.concatenate([[0], brk]) if S else np.zeros(0, np.int64)
        ends = np.concatenate([brk, [S]]) if S else np.zeros(0, np.int64)
        for a, b in zip(starts.tolist(), ends.tolist()):
            c = int(row[a])
            cap = CODE_RUN_CAP[c]
            while a < b:
                n = min(cap, b - a)
                flagpos[i, a + n - 1] = CODE_FLAG_BASE[c] | n
                nseg[i] += 1
                a += n
    return flagpos, nseg


def _flag_code(f):
    if f & 0x80 == 0:
        return 0, f & 0x7F
    if f & 0xE0 == 0xE0:
        return 4, 1
    return {0xA0: 1, 0xC0: 2, 0x80: 3}[f & 0xE0], f & 0x1F


def ref_decode(flagpos, S):
    """Fill each segment back from its end-placed flag byte; ``decoded``
    counts the samples the in-range flags cover."""
    flagpos = np.asarray(flagpos)
    L, S_pad = flagpos.shape
    codes = np.zeros((L, S), np.uint8)
    decoded = np.zeros(L, np.int32)
    for i in range(L):
        prev = 0
        for p in np.flatnonzero(flagpos[i, :S]).tolist():
            code, n = _flag_code(int(flagpos[i, p]))
            codes[i, prev : p + 1] = code
            decoded[i] += n
            prev = p + 1
    return codes, decoded


def _check(codes, S):
    """Kernel encode == reference, kernel decode == reference, and the
    decode inverts the encode."""
    f_ref, k_ref = ref_encode(codes, S)
    f, k = map(np.asarray, rle_encode(codes, S))
    np.testing.assert_array_equal(f, f_ref)
    np.testing.assert_array_equal(k, k_ref)
    c_ref, d_ref = ref_decode(f_ref, S)
    c, d = map(np.asarray, rle_decode(f, S))
    np.testing.assert_array_equal(c[:, :S], c_ref)
    np.testing.assert_array_equal(d, d_ref)
    np.testing.assert_array_equal(c[:, :S], np.asarray(codes)[:, :S])
    assert (d == S).all()


def _random_codes(L, S, S_pad, seed, p=GT_P):
    rng = np.random.default_rng(seed)
    codes = np.zeros((L, S_pad), np.uint8)
    codes[:, :S] = rng.choice(5, size=(L, S), p=p)
    return codes


@pytest.mark.parametrize("seed,S", [(0, 300), (1, 384), (2, 127)])
def test_encode_matches_reference(seed, S):
    codes = _random_codes(256, S, 384, seed, p=[0.7, 0.1, 0.1, 0.05, 0.05])
    f_ref, k_ref = ref_encode(codes, S)
    f, k = map(np.asarray, rle_encode(codes, S))
    np.testing.assert_array_equal(f, f_ref)
    np.testing.assert_array_equal(k, k_ref)


def test_decode_matches_reference():
    S = 300
    codes = _random_codes(256, S, 384, 3, p=[0.6, 0.15, 0.1, 0.1, 0.05])
    _check(codes, S)


def test_long_runs_split_at_cap():
    # all-0|0 rows: 127-cap splitting
    codes = np.zeros((256, 384), np.uint8)
    f, k = map(np.asarray, rle_encode(codes, 300))
    assert np.flatnonzero(f[0]).tolist() == [126, 253, 299]
    assert (k == 3).all()
    _check(codes, 300)


def test_cohort_width_uniform_runs():
    """Uniform rows at the 1000G width stress every cap remainder up to
    d = S-1 (a wrong remainder is a malformed flag byte)."""
    S, S_pad = 2504, 2560
    codes = np.zeros((256, S_pad), np.uint8)
    for row, code in enumerate([0, 1, 2, 3]):
        codes[row, :S] = code
    _check(codes, S)


class TestWideWidths:
    @pytest.mark.parametrize("S,S_pad", [(4200, 4224), (16000, 16384)])
    def test_wide_uniform_runs_exact(self, S, S_pad):
        codes = np.zeros((32, S_pad), np.uint8)
        for row in range(4):
            codes[row, :S] = row  # codes 0..3
        _check(codes, S)

    def test_wide_random_roundtrip(self):
        S, S_pad = 8200, 8320
        _check(_random_codes(64, S, S_pad, 7), S)


class TestWideGrids:
    """Many rows at wide widths, the 65,536 padding boundary, and
    escape-heavy wide rows."""

    def test_rows_at_16384(self):
        S, S_pad = 16300, 16384
        codes = _random_codes(96, S, S_pad, 21)
        codes[32, :S] = 0  # maximal runs
        codes[63, :S] = 3
        _check(codes, S)

    def test_rows_at_65536_padding(self):
        S_pad = 1 << 16
        S = S_pad - 60
        codes = _random_codes(24, S, S_pad, 22)
        codes[0, :S] = 1  # uniform het row: remainder stress at max d
        _check(codes, S)

    def test_escape_heavy_wide_rows(self):
        """Mostly-escape rows force a flag byte per cell — the densest
        positional plane the encoder can produce at width."""
        S, S_pad = 16300, 16384
        _check(_random_codes(64, S, S_pad, 23, p=[0.1, 0.05, 0.05, 0.05, 0.75]), S)


def _words(fields, last_newline=True):
    """ASCII 3-byte sample fields -> little-endian i32 "a|b<sep>" words."""
    L = len(fields)
    S = len(fields[0])
    out = np.zeros((L, S), np.int32)
    for i, row in enumerate(fields):
        for j, f in enumerate(row):
            sep = 10 if (last_newline and j == S - 1) else 9
            out[i, j] = f[0] | (f[1] << 8) | (f[2] << 16) | (sep << 24)
    return out


class TestTextKernels:
    """Fused ASCII classify+encode / decode+render."""

    FIELDS = [b"0|0", b"0|1", b"1|0", b"1|1", b"2|0", b"./.", b"0/1", b"9|9"]

    def _random_fields(self, L, S, seed):
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(self.FIELDS), size=(L, S), p=[0.7, 0.08, 0.08, 0.06, 0.03, 0.03, 0.01, 0.01])
        return [[self.FIELDS[pick[i, j]] for j in range(S)] for i in range(L)]

    def _codes(self, fields):
        m = {b"0|0": 0, b"0|1": 1, b"1|0": 2, b"1|1": 3}
        return np.array(
            [[m.get(f, 4) for f in row] for row in fields], np.uint8
        )

    def test_xla_text_encode_matches_classify_then_encode(self):
        S, S_pad = 300, 384
        fields = self._random_fields(64, S, 11)
        text = np.zeros((64, S_pad), np.int32)
        text[:, :S] = _words(fields)
        codes = np.zeros((64, S_pad), np.uint8)
        codes[:, :S] = self._codes(fields)
        f1, k1 = map(np.asarray, rle_encode(codes, S))
        f2, k2, reg = map(np.asarray, text_rle_encode(text, S))
        np.testing.assert_array_equal(f1, f2)
        np.testing.assert_array_equal(k1, k2)
        assert (reg == 1).all()

    def test_bad_separator_flags_row(self):
        S = 8
        fields = [[b"0|0"] * S, [b"0|1"] * S]
        text = _words(fields)
        # corrupt a separator byte on row 1 (sample 2's 4th byte)
        text[1, 2] = (text[1, 2] & 0x00FFFFFF) | (ord("x") << 24)
        _f, _k, reg = map(np.asarray, text_rle_encode(text, S))
        assert reg.tolist() == [1, 0]

    def test_text_encode_matches_reference(self):
        S, S_pad = 290, 384
        fields = self._random_fields(256, S, 12)
        text = np.zeros((256, S_pad), np.int32)
        text[:, :S] = _words(fields)
        codes = np.zeros((256, S_pad), np.uint8)
        codes[:, :S] = self._codes(fields)
        f_ref, k_ref = ref_encode(codes, S)
        f, k, reg = map(np.asarray, text_rle_encode(text, S))
        np.testing.assert_array_equal(f, f_ref)
        np.testing.assert_array_equal(k, k_ref)
        assert (reg == 1).all()

    def test_text_decode_renders_words(self):
        S, S_pad = 300, 384
        fields = self._random_fields(64, S, 13)
        codes = np.zeros((64, S_pad), np.uint8)
        codes[:, :S] = self._codes(fields)
        flags, _ = map(np.asarray, rle_encode(codes, S))
        t1, c1, d1 = map(np.asarray, text_rle_decode(flags, S))
        # every non-escape word matches the source ASCII; escapes render ?|?
        want = _words(
            [
                [f if f in (b"0|0", b"0|1", b"1|0", b"1|1") else b"?|?" for f in row]
                for row in fields
            ]
        )
        np.testing.assert_array_equal(t1[:, :S], want)
        np.testing.assert_array_equal(c1[:, :S], codes[:, :S])
        assert (d1 == S).all()

    def test_text_decode_matches_reference(self):
        S, S_pad = 290, 384
        fields = self._random_fields(256, S, 14)
        codes = np.zeros((256, S_pad), np.uint8)
        codes[:, :S] = self._codes(fields)
        f_ref, _ = ref_encode(codes, S)
        c_ref, d_ref = ref_decode(f_ref, S)
        t, c, d = map(np.asarray, text_rle_decode(f_ref, S))
        np.testing.assert_array_equal(c[:, :S], c_ref)
        np.testing.assert_array_equal(d, d_ref)
        rendered = [
            [
                b"?|?" if x == 4 else b"%d|%d" % (x >> 1, x & 1)
                for x in row.tolist()
            ]
            for row in c_ref
        ]
        np.testing.assert_array_equal(t[:, :S], _words(rendered))

    def test_text_roundtrip_fixed_point(self):
        """decode(encode(text)) == rendered text, and a second pass is
        the identity — the property the bench loop relies on."""
        S, S_pad = 300, 384
        fields = self._random_fields(64, S, 15)
        text = np.zeros((64, S_pad), np.int32)
        text[:, :S] = _words(fields)
        f, _k, _r = text_rle_encode(text, S)
        t1, _c, _d = text_rle_decode(np.asarray(f), S)
        f2, _k2, _r2 = text_rle_encode(np.asarray(t1), S)
        t2, _c2, _d2 = text_rle_decode(np.asarray(f2), S)
        np.testing.assert_array_equal(np.asarray(f), np.asarray(f2))
        np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))
