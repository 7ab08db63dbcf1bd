"""Device-path engine tests: the jnp RLE kernels + host assembly must equal
the oracle (and therefore the reference binary) byte-for-byte."""

import numpy as np
import pytest

from vcfc_tpu import engine
from vcfc_tpu.format import compress_bytes, decompress_bytes
from vcfc_tpu.ops.rle import rle_decode, rle_encode


class TestRleKernels:
    def _np_reference_flags(self, row):
        """Scalar-oracle RLE of a single code row (caps 127/31/1):
        returns (flag, end-position) pairs (segment-end placement)."""
        caps = [127, 31, 31, 31, 1]
        bases = [0x00, 0xA0, 0xC0, 0x80, 0xE0]
        out, ends = [], []
        i, n = 0, len(row)
        while i < n:
            c = row[i]
            j = i + 1
            if c != 4:
                while j < n and row[j] == c and j - i < caps[c]:
                    j += 1
            out.append(bases[c] | (j - i))
            ends.append(j - 1)
            i = j
        return out, ends

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_encode_matches_scalar_oracle(self, seed):
        rng = np.random.default_rng(seed)
        S = 300
        codes = rng.choice(5, size=(7, S), p=[0.7, 0.1, 0.1, 0.05, 0.05]).astype(np.uint8)
        pad = np.zeros((7, 384), np.uint8)
        pad[:, :S] = codes
        flagpos, nseg = map(np.asarray, rle_encode(pad, S))
        for i in range(7):
            want, want_ends = self._np_reference_flags(list(codes[i]))
            got_ends = np.flatnonzero(flagpos[i]).tolist()
            assert got_ends == want_ends
            assert flagpos[i][got_ends].tolist() == want
            assert nseg[i] == len(want)

    def test_long_run_caps(self):
        pad = np.zeros((1, 384), np.uint8)
        flagpos, nseg = map(np.asarray, rle_encode(pad, 300))
        assert flagpos[0][np.flatnonzero(flagpos[0])].tolist() == [127, 127, 46]
        assert np.flatnonzero(flagpos[0]).tolist() == [126, 253, 299]
        assert nseg[0] == 3

    def test_decode_inverts_encode(self):
        rng = np.random.default_rng(3)
        S = 257
        codes = rng.choice(5, size=(5, S), p=[0.6, 0.15, 0.1, 0.1, 0.05]).astype(np.uint8)
        pad = np.zeros((5, 384), np.uint8)
        pad[:, :S] = codes
        flagpos, nseg = map(np.asarray, rle_encode(pad, S))
        codes2, decoded = map(np.asarray, rle_decode(flagpos, S))
        assert (decoded == S).all()
        np.testing.assert_array_equal(codes2[:, :S], codes)
        # rendered text: each sample is 4 bytes "X|Y\t"
        from vcfc_tpu.ops.rle import render_text

        text = render_text(codes2)
        assert text.shape == (5, 384 * 4)
        assert bytes(text[0, :4]) in (b"0|0\t", b"0|1\t", b"1|0\t", b"1|1\t", b"?|?\t")

    def test_unpack_packed_flags(self):
        from vcfc_tpu.ops.rle import unpack_packed_flags

        packed = np.zeros((1, 8), np.uint8)
        packed[0, :3] = [127, 127, 46]
        flagpos = np.asarray(unpack_packed_flags(packed, np.array([3], np.int32), out_width=384))
        assert np.flatnonzero(flagpos[0]).tolist() == [126, 253, 299]
        assert flagpos[0, 126] == 127 and flagpos[0, 299] == 46

    def test_device_unpack_decode_route(self, monkeypatch):
        """VCFC_UNPACK=device: host extracts packed flag bytes, device
        does the matmul unpack fused with the run-fill — lossless and
        byte-identical to the standard route on mixed corpora (escapes,
        run caps, SVs)."""
        from test_fuzz import make_vcf

        from vcfc_tpu.format import compress_bytes
        from vcfc_tpu.host import native

        if not native.available():
            pytest.skip("native runtime unavailable")
        monkeypatch.setenv("VCFC_UNPACK", "device")
        for seed, S, V in [(21, 150, 400), (22, 2504, 120), (23, 31, 900)]:
            vcf = make_vcf(seed, S, V, sv_every=9)
            vcfc = compress_bytes(vcf)
            got = engine.decompress(vcfc, force_device=True)
            assert got == vcf, f"seed {seed} device-unpack decode diverged"

    def test_unpack_inverts_compaction_production_shape(self):
        """Device unpack == inverse of flag compaction at a production
        shape (2,504-sample cohort width), differentially against the
        positional flags the encoder produced and, when the native
        runtime is present, against its packed stream."""
        from vcfc_tpu.host import native
        from vcfc_tpu.ops.rle import rle_encode, unpack_packed_flags

        rng = np.random.default_rng(77)
        L, S = 512, 2504
        S_pad = 2560
        codes = np.zeros((L, S_pad), np.uint8)
        codes[:, :S] = rng.choice(
            5, size=(L, S), p=[0.8, 0.07, 0.07, 0.04, 0.02]
        ).astype(np.uint8)
        # long constant blocks exercise the 127-run-cap splitting
        codes[: L // 4, :S] = 0
        flagpos, nseg = map(np.asarray, rle_encode(codes, S))

        # pack (compact the nonzero flag bytes, preserving order)
        M = int(nseg.max())
        packed = np.zeros((L, M), np.uint8)
        for i in range(L):
            nz = flagpos[i][flagpos[i] > 0]
            packed[i, : len(nz)] = nz
            assert len(nz) == nseg[i]
        if native.available():
            flat = native.compact_flags(flagpos, nseg)
            np.testing.assert_array_equal(
                flat, packed[packed > 0], err_msg="native compaction disagrees"
            )

        got = np.asarray(
            unpack_packed_flags(packed, nseg.astype(np.int32), out_width=S_pad)
        )
        np.testing.assert_array_equal(got, flagpos)


class TestEngineGolden:
    def test_compress_small(self, small_vcf, small_vcfc):
        assert engine.compress(small_vcf) == small_vcfc

    def test_decompress_small(self, small_vcf, small_vcfc):
        assert engine.decompress(small_vcfc) == small_vcf

    def test_compress_sv(self, sv_vcf, sv_vcfc):
        assert engine.compress(sv_vcf) == sv_vcfc

    def test_decompress_sv(self, sv_vcf, sv_vcfc):
        assert engine.decompress(sv_vcfc) == sv_vcf


class TestEngineProperty:
    @pytest.mark.parametrize("seed,samples,variants", [(11, 1, 30), (12, 31, 64), (13, 260, 17)])
    def test_random_roundtrip_vs_oracle(self, seed, samples, variants):
        rng = np.random.default_rng(seed)
        gts = [b"0|0", b"0|1", b"1|0", b"1|1", b"2|0", b"0|2", b"2|2", b"./."]
        p = [0.55, 0.1, 0.1, 0.05, 0.06, 0.06, 0.04, 0.04]
        lines = [b"##fileformat=VCFv4.2\n##x=1\n"]
        hdr = b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
        hdr += b"".join(b"\tS%d" % j for j in range(samples))
        lines.append(hdr + b"\n")
        pos = 100
        for i in range(variants):
            row = [b"1", str(pos).encode(), b"v%d" % i, b"A", b"T", b"9", b"PASS", b".", b"GT"]
            row += list(rng.choice(gts, p=p, size=samples))
            lines.append(b"\t".join(row) + b"\n")
            pos += int(rng.integers(1, 5))
        vcf = b"".join(lines)

        oracle = compress_bytes(vcf)
        fast = engine.compress(vcf)
        assert fast == oracle
        assert engine.decompress(fast) == vcf
        assert decompress_bytes(fast) == vcf

    def test_wide_fields_fall_back(self):
        # "10|2"-style wide fields force the irregular path
        vcf = (
            b"##f=1\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tA\tB\tC\n"
            b"1\t10\tv\tA\tT,G,C,AA,AT,AG,AC,TA,TT\t9\tPASS\t.\tGT\t10|2\t0|0\t0|0\n"
        )
        fast = engine.compress(vcf)
        assert fast == compress_bytes(vcf)
        assert engine.decompress(fast) == vcf


class TestForcedDevicePath:
    """Exercise the device + native-assembly path on small fixtures by
    bypassing the small-input oracle fallback."""

    def test_golden_small_forced(self, small_vcf, small_vcfc):
        assert engine.compress(small_vcf, force_device=True) == small_vcfc
        assert engine.decompress(small_vcfc, force_device=True) == small_vcf

    def test_golden_sv_forced(self, sv_vcf, sv_vcfc):
        # escape + SV lines exercise the oracle splice inside native assembly
        assert engine.compress(sv_vcf, force_device=True) == sv_vcfc
        assert engine.decompress(sv_vcfc, force_device=True) == sv_vcf

    def test_native_library_loads(self):
        from vcfc_tpu.host import native

        # the library ships in-tree and must build/load in CI environments
        assert native.available() or "VCFC_NO_NATIVE" in __import__("os").environ

    def test_numpy_fallback_matches_native(self, small_vcf, small_vcfc, monkeypatch):
        monkeypatch.setenv("VCFC_NO_NATIVE", "1")
        from vcfc_tpu.host import native

        assert not native.available()
        assert engine.compress(small_vcf, force_device=True) == small_vcfc
        assert engine.decompress(small_vcfc, force_device=True) == small_vcf

    def test_host_executor_decode(self, small_vcfc, small_vcf, monkeypatch):
        monkeypatch.setenv("VCFC_EXECUTOR", "host")
        assert engine.decompress(small_vcfc, force_device=True) == small_vcf

    def test_host_executor_encode(self, small_vcf, small_vcfc, monkeypatch):
        monkeypatch.setenv("VCFC_EXECUTOR", "host")
        assert engine.compress(small_vcf, force_device=True) == small_vcfc

    def test_host_executor_multiworker(self, small_vcf, small_vcfc, monkeypatch):
        """VCFC_WORKERS=4 forces libvcfc_host's multi-thread paths even on
        single-core machines (hardware_concurrency()==1 would otherwise
        leave them unexecuted)."""
        monkeypatch.setenv("VCFC_EXECUTOR", "host")
        monkeypatch.setenv("VCFC_WORKERS", "4")
        assert engine.compress(small_vcf, force_device=True) == small_vcfc
        assert engine.decompress(small_vcfc, force_device=True) == small_vcf


class TestMalformedStreams:
    """Fast-path validation parity: a corrupt flag stream must raise (the
    reference throws VcfValidationError on sample-count mismatch,
    compress.cpp:835-840) through BOTH the native unpack (status=1) and
    the numpy fallback walk — never decode garbage silently."""

    def _corrupt(self, vcfc: bytes) -> bytes:
        from vcfc_tpu.format.headers import decode_line_headers
        from vcfc_tpu.format.vcf import parse_metadata_headers

        h = parse_metadata_headers(vcfc)
        _, req_len = decode_line_headers(vcfc, h.data_offset)
        flag_off = h.data_offset + 8 + req_len
        bad = bytearray(vcfc)
        bad[flag_off] = 0x7F  # 127-run of 0|0: overruns the 100-sample row
        return bytes(bad)

    def test_native_unpack_rejects(self, small_vcfc):
        corrupt = self._corrupt(small_vcfc)
        with pytest.raises(ValueError):
            engine.decompress(corrupt, force_device=True)

    def test_numpy_fallback_rejects(self, small_vcfc, monkeypatch):
        monkeypatch.setenv("VCFC_NO_NATIVE", "1")
        corrupt = self._corrupt(small_vcfc)
        with pytest.raises(ValueError):
            engine.decompress(corrupt, force_device=True)

    def test_oracle_rejects(self, small_vcfc):
        from vcfc_tpu.format import decompress_bytes
        from vcfc_tpu.format.lines import VcfValidationError

        with pytest.raises(VcfValidationError):
            decompress_bytes(self._corrupt(small_vcfc))

    def test_native_cli_rejects(self, small_vcfc, tmp_path):
        import subprocess

        from vcfc_tpu.host.native import cli_path

        if cli_path() is None:
            pytest.skip("vcfcq not built")
        p = tmp_path / "bad.vcfc"
        p.write_bytes(self._corrupt(small_vcfc))
        r = subprocess.run(
            [cli_path(), "decompress", str(p), str(tmp_path / "out.vcf")],
            capture_output=True,
        )
        assert r.returncode != 0


class TestZeroSampleCohort:
    """FORMAT column with zero sample columns: the reference handles this
    (compress.cpp:235 yields sample_count 0); 8-column lines without
    FORMAT crash the reference itself and stay out of contract."""

    VCF = (
        b"##fileformat=VCFv4.2\n"
        b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\n"
        b"1\t100\t.\tA\tT\t9\tPASS\t.\tGT\n"
        b"1\t200\t.\tC\tG\t9\tPASS\t.\tGT\n"
    )

    def test_roundtrip(self):
        out = engine.compress(self.VCF)
        assert out == compress_bytes(self.VCF)
        assert engine.decompress(out) == self.VCF

    def test_numpy_fallback(self, monkeypatch):
        monkeypatch.setenv("VCFC_NO_NATIVE", "1")
        out = engine.compress(self.VCF)
        assert engine.decompress(out) == self.VCF
