"""Sparse index layers + CLI: differential tests against the full-scan
query path and golden fixtures, plus filesystem-sparse-file behavior."""

import os
import subprocess
import sys

import pytest

from vcfc_tpu.index.sparse_external import (
    create_sparse_external_index,
    query_sparse_external_index,
)
from vcfc_tpu.index.sparsify import query_sparse_file, sparsify_file
from vcfc_tpu.query.coordinate import CoordinateQuery, parse_coordinate_string
from vcfc_tpu.query.engine import gap_analysis, query_full_scan
from vcfc_tpu.utils.config import SPARSE_EXTERNAL_INDEX_CONFIG, SparseConfig

# a tiny address space keeps test files small while exercising the same code
TEST_SPARSE = SparseConfig(multiplication_factor=1, block_size=256, max_position=100_000)


def _seek_data_supported(tmp_path) -> bool:
    p = tmp_path / "probe"
    with open(p, "wb") as f:
        f.seek(1 << 20)
        f.write(b"x")
    with open(p, "rb") as f:
        try:
            return os.lseek(f.fileno(), 0, os.SEEK_DATA) >= 0
        except OSError:
            return False


class TestFullScanQuery:
    def test_matches_reference_stdout(self, data_dir, small_vcfc):
        golden = (data_dir / "q_small_10100_10150.out").read_bytes()
        q = parse_coordinate_string("1:10100-10150")
        assert b"".join(query_full_scan(small_vcfc, q)) == golden

    def test_ref_only_query(self, data_dir, sv_vcfc):
        golden = (data_dir / "q_sv_chr2.out").read_bytes()
        q = parse_coordinate_string("2")
        assert b"".join(query_full_scan(sv_vcfc, q)) == golden

    def test_full_scan_is_point_match_not_sv_aware(self, sv_vcfc):
        # full-scan uses POS only (main.cpp:3880): the DEL spanning 200-450
        # is NOT returned for 1:400-460
        q = parse_coordinate_string("1:400-460")
        assert b"".join(query_full_scan(sv_vcfc, q)) == b""


class TestBulkHitDecode:
    def test_bulk_batches_match_oracle_with_escapes(self):
        """Batched hit decode (query/bulk.py) must be byte-identical to
        per-line oracle decode across flush boundaries, including escape
        and oracle-fallback lines inside a large batch."""
        from test_fuzz import make_vcf

        from vcfc_tpu.format import compress_bytes
        from vcfc_tpu.format.lines import decode_data_line
        from vcfc_tpu.format.vcf import parse_metadata_headers
        from vcfc_tpu.index.scan import scan_lines
        from vcfc_tpu.query import bulk
        from vcfc_tpu.query.coordinate import CoordinateQuery
        from vcfc_tpu.query.engine import query_full_scan

        # make_vcf puts half the variants on chrom "1": 2,600 -> 1,300
        # hits, crossing the BULK_CHUNK=1024 flush boundary
        vcf = make_vcf(808, 60, 2600, sv_every=7)
        vcfc = compress_bytes(vcf)
        header = parse_metadata_headers(vcfc)
        q = CoordinateQuery.ref_only("1")
        got = b"".join(query_full_scan(vcfc, q))
        want = b"".join(
            decode_data_line(vcfc, rec.offset, header.schema.sample_count)[0]
            for rec in scan_lines(vcfc, header=header)
            if rec.chrom == b"1"
        )
        assert want.count(b"\n") > bulk.BULK_CHUNK  # crosses a flush
        assert got == want

    def test_bulk_rejects_short_runs(self):
        """ADVICE r3: a .vcfc line whose flag runs don't cover the sample
        grid must fail in the bulk (>= BULK_MIN) path too, not render
        garbage silently — the per-line oracle path already raises."""
        from test_fuzz import make_vcf

        from vcfc_tpu.format.lines import VcfValidationError
        from vcfc_tpu.format.vcf import parse_metadata_headers
        from vcfc_tpu.format import compress_bytes
        from vcfc_tpu.index.scan import scan_lines
        from vcfc_tpu.query import bulk

        samples = 60
        vcf = make_vcf(515, samples, bulk.BULK_MIN + 12)
        vcfc = bytearray(compress_bytes(vcf))
        header = parse_metadata_headers(bytes(vcfc))
        recs = list(scan_lines(bytes(vcfc), header=header))
        # find a line whose first sample flag is a 0|0 run of >= 2 and
        # shorten it by one: run sums now land at S-1
        for rec in recs:
            p = rec.offset + 8 + rec.required_length
            if 2 <= vcfc[p] <= 0x7F:
                vcfc[p] -= 1
                break
        else:
            pytest.fail("no multi-sample 0|0 leading run in the fixture")
        blobs = [
            bytes(vcfc[r.offset : r.offset + 4 + r.line_length]) for r in recs
        ]
        assert len(blobs) >= bulk.BULK_MIN
        with pytest.raises(VcfValidationError):
            bulk.decode_hit_blobs(bytes(vcfc[: header.data_offset]), header, blobs)

    def test_small_batches_use_per_line_path(self, small_vcfc):
        from vcfc_tpu.format.vcf import parse_metadata_headers
        from vcfc_tpu.index.scan import scan_lines
        from vcfc_tpu.query.bulk import decode_hit_lines

        header = parse_metadata_headers(small_vcfc)
        recs = list(scan_lines(small_vcfc, header=header))[:3]
        lines = decode_hit_lines(small_vcfc, header, recs)
        assert len(lines) == 3 and all(l.endswith(b"\n") for l in lines)


class TestGapAnalysis:
    def test_sizes_consistent(self, small_vcf, small_vcfc):
        rows = list(gap_analysis(small_vcfc))
        assert len(rows) == 200
        data_lines = [l for l in small_vcf.split(b"\n") if l and not l.startswith(b"#")]
        assert sum(r[1] for r in rows) == sum(len(l) + 1 for l in data_lines)
        header_end = small_vcfc.find(b"\n#CHROM")
        header_end = small_vcfc.find(b"\n", header_end + 1) + 1
        # the reference's per-line byte count skips the trailing newline
        # unless the final sample is an escape column (compress.cpp:869-892,
        # verified byte-equal against the reference binary)
        gts = (b"0|0", b"0|1", b"1|0", b"1|1")
        newline_skips = sum(1 for l in data_lines if l.rsplit(b"\t", 1)[-1] in gts)
        assert sum(r[2] for r in rows) == len(small_vcfc) - header_end - newline_skips


class TestSparsify:
    # offset-as-index files are per-chromosome by design (sparse.hpp:15);
    # small.vcfc is single-chrom with positions within TEST_SPARSE range
    def test_roundtrip_queries(self, tmp_path, small_vcfc):
        if not _seek_data_supported(tmp_path):
            pytest.skip("filesystem lacks SEEK_DATA hole support")
        path = str(tmp_path / "small.sparse")
        sparsify_file(small_vcfc, path, TEST_SPARSE)
        q = CoordinateQuery.range("1", 10100, 10150)
        got = b"".join(query_sparse_file(path, q, TEST_SPARSE))
        want = b"".join(query_full_scan(small_vcfc, q))
        assert got == want

    def test_range_from_hole_start(self, tmp_path, small_vcfc):
        if not _seek_data_supported(tmp_path):
            pytest.skip("filesystem lacks SEEK_DATA hole support")
        path = str(tmp_path / "small.sparse")
        sparsify_file(small_vcfc, path, TEST_SPARSE)
        # query start below the first variant: must realign over the hole
        q = CoordinateQuery.range("1", 1, 10010)
        got = b"".join(query_sparse_file(path, q, TEST_SPARSE))
        want = b"".join(query_full_scan(small_vcfc, q))
        assert got == want

    def test_single_variant_hit_and_miss(self, tmp_path, small_vcfc):
        if not _seek_data_supported(tmp_path):
            pytest.skip("filesystem lacks SEEK_DATA hole support")
        path = str(tmp_path / "small.sparse")
        sparsify_file(small_vcfc, path, TEST_SPARSE)
        hit = b"".join(
            query_sparse_file(path, CoordinateQuery.range("1", 10100, 10100), TEST_SPARSE)
        )
        assert hit.startswith(b"1\t10100\t")
        miss = b"".join(
            query_sparse_file(path, CoordinateQuery.range("1", 10101, 10101), TEST_SPARSE)
        )
        assert miss == b""

    def test_no_criteria_raises(self, tmp_path, small_vcfc):
        """Conscious divergence (PARITY.md C13): the reference's sparse query
        silently does nothing when the query has no criteria (main.cpp:279,335
        — both branches require has_criteria(); the fall-through returns
        nothing).  We raise instead, in both implementations (sparsify.py:147,
        vcfcq.cpp:1933)."""
        path = str(tmp_path / "small.sparse")
        sparsify_file(small_vcfc, path, TEST_SPARSE)
        with pytest.raises(NotImplementedError, match="no filter"):
            list(query_sparse_file(path, CoordinateQuery(), TEST_SPARSE))

    def test_truncated_sparse_ends_cleanly(self, tmp_path, small_vcfc):
        """A sparse file truncated mid-line must end the range iteration
        cleanly (the pre-bulk behavior), not crash on a short read."""
        path = str(tmp_path / "small.sparse")
        sparsify_file(small_vcfc, path, TEST_SPARSE)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(size - 40)  # chop into the final line
        out = b"".join(
            query_sparse_file(path, CoordinateQuery.range("1", 10000, 99999), TEST_SPARSE)
        )
        assert out.endswith(b"\n") or out == b""  # clean, decoded prefix only

    def test_file_is_sparse(self, tmp_path, small_vcfc):
        path = str(tmp_path / "small.sparse")
        sparsify_file(small_vcfc, path, TEST_SPARSE)
        st = os.stat(path)
        assert st.st_size > 25_000_000  # logical size: beyond max_position*block
        assert st.st_blocks * 512 < 5_000_000  # physical: just the data


class TestSparseExternalIndex:
    def test_query_matches_full_scan(self, tmp_path, small_vcfc):
        if not _seek_data_supported(tmp_path):
            pytest.skip("filesystem lacks SEEK_DATA hole support")
        path = str(tmp_path / "small.vcfci-sparse")
        create_sparse_external_index(small_vcfc, path, TEST_SPARSE)
        for region in ["1:10100-10150", "1:10000-10010", "1:10390-10500"]:
            q = parse_coordinate_string(region)
            got = b"".join(query_sparse_external_index(small_vcfc, path, q, TEST_SPARSE))
            want = b"".join(query_full_scan(small_vcfc, q))
            assert got == want, region

    def test_exact_miss_returns_nothing(self, tmp_path, small_vcfc):
        path = str(tmp_path / "small.vcfci-sparse")
        create_sparse_external_index(small_vcfc, path, TEST_SPARSE)
        q = CoordinateQuery.range("1", 10001, 10001)  # positions are even
        assert b"".join(query_sparse_external_index(small_vcfc, path, q, TEST_SPARSE)) == b""


class TestCli:
    def _run(self, *args, cwd=None):
        return subprocess.run(
            [sys.executable, "-m", "vcfc_tpu.cli", *args],
            capture_output=True,
            cwd=cwd,
            env={**os.environ, "JAX_PLATFORMS": "cpu"},
        )

    def test_compress_decompress_roundtrip(self, tmp_path, data_dir):
        vcf_in = data_dir / "sv.vcf"
        out_c = tmp_path / "x.vcfc"
        out_d = tmp_path / "x.vcf"
        r = self._run("compress", str(vcf_in), str(out_c))
        assert r.returncode == 0, r.stderr
        assert out_c.read_bytes() == (data_dir / "sv.vcfc").read_bytes()
        r = self._run("decompress", str(out_c), str(out_d))
        assert r.returncode == 0, r.stderr
        assert out_d.read_bytes() == vcf_in.read_bytes()

    def test_sharded_env_knob_roundtrip(self, tmp_path):
        """VCFC_SHARDED=1 routes CLI compress/decompress through the
        mesh-sharded steps (8 virtual devices here), byte-identical."""
        from test_fuzz import make_vcf

        from vcfc_tpu.format import compress_bytes

        vcf = make_vcf(913, 130, 120, sv_every=9)
        vcf_in = tmp_path / "in.vcf"
        vcf_in.write_bytes(vcf)
        out_c = tmp_path / "x.vcfc"
        out_d = tmp_path / "x.vcf"
        env = {
            **os.environ,
            "JAX_PLATFORMS": "cpu",
            "VCFC_SHARDED": "1",
            "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
        }
        r = subprocess.run(
            [sys.executable, "-m", "vcfc_tpu.cli", "compress", str(vcf_in), str(out_c)],
            capture_output=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        assert out_c.read_bytes() == compress_bytes(vcf)
        r = subprocess.run(
            [sys.executable, "-m", "vcfc_tpu.cli", "decompress", str(out_c), str(out_d)],
            capture_output=True, env=env,
        )
        assert r.returncode == 0, r.stderr
        assert out_d.read_bytes() == vcf

    def test_binned_index_cycle(self, tmp_path, data_dir):
        vcfc = tmp_path / "sv.vcfc"
        vcfc.write_bytes((data_dir / "sv.vcfc").read_bytes())
        r = self._run("create-binned-index", "2", str(vcfc))
        assert r.returncode == 0, r.stderr
        assert (tmp_path / "sv.vcfc.vcfci").read_bytes() == (
            data_dir / "sv.vcfc.vcfci-b2"
        ).read_bytes()
        r = self._run("query-binned-index", str(vcfc), "1:400-460")
        assert r.returncode == 0, r.stderr
        assert r.stdout == (data_dir / "qb_sv_400_460.out").read_bytes()

    def test_query_stdout(self, tmp_path, data_dir):
        r = self._run("query", str(data_dir / "sv.vcfc"), "2")
        assert r.returncode == 0, r.stderr
        assert r.stdout == (data_dir / "q_sv_chr2.out").read_bytes()

    def test_unknown_action(self):
        r = self._run("frobnicate")
        assert r.returncode == 1
        assert b"Unknown action" in r.stdout

    def test_bad_bin_size(self, data_dir):
        r = self._run("create-binned-index", "zero", str(data_dir / "sv.vcfc"))
        assert r.returncode == 1
        assert b"positive integer" in r.stdout
