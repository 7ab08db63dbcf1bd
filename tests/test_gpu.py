"""Card-only tests: the device kernels as compiled for the GPU, checked
against plain references at real widths.  They skip without an NVIDIA
GPU; run them with `python -m pytest -m gpu` (chip_smoke.py does, in
its own process)."""

import numpy as np
import pytest

from test_rle_kernels import GT_P, ref_decode, ref_encode

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")
    return jax.devices()[0]


def _batch(S):
    """(codes, S_pad) at the engine's own batch shape for width S."""
    from vcfc_tpu import engine

    S_pad = (S + 127) // 128 * 128
    L = engine._adaptive_line_batch(engine._LINE_BATCH, S_pad)
    rng = np.random.default_rng(S)
    codes = np.zeros((L, S_pad), np.uint8)
    codes[:, :S] = rng.choice(5, size=(L, S), p=GT_P)
    return codes


@pytest.mark.parametrize("S,row_step", [(2504, 1), (50000, 10)])
def test_rle_kernels_match_reference(gpu, S, row_step):
    """Batch (2048, 2560) and the S=50,000 batch; at S=50,000 every
    10th row is compared with the (slow) reference."""
    from vcfc_tpu.ops.rle import rle_decode, rle_encode

    codes = _batch(S)
    f, k = map(np.asarray, rle_encode(codes, S))
    c, d = map(np.asarray, rle_decode(f, S))
    np.testing.assert_array_equal(c[:, :S], codes[:, :S])
    assert (d == S).all()
    rows = codes[::row_step]
    f_ref, k_ref = ref_encode(rows, S)
    np.testing.assert_array_equal(f[::row_step], f_ref)
    np.testing.assert_array_equal(k[::row_step], k_ref)
    c_ref, d_ref = ref_decode(f_ref, S)
    np.testing.assert_array_equal(c[::row_step, :S], c_ref)
    np.testing.assert_array_equal(d[::row_step], d_ref)


def test_unpack_packed_flags_exact(gpu):
    """The bf16 indicator matmul places every packed flag byte exactly."""
    from vcfc_tpu.ops.rle import unpack_packed_flags

    S = 2504
    codes = _batch(S)
    flagpos, nseg = ref_encode(codes, S)
    M = int(nseg.max())
    packed = np.zeros((len(codes), M), np.uint8)
    for i, row in enumerate(flagpos):
        nz = row[row > 0]
        packed[i, : len(nz)] = nz
    got = np.asarray(unpack_packed_flags(packed, nseg, out_width=codes.shape[1]))
    np.testing.assert_array_equal(got, flagpos)


@pytest.fixture(scope="module")
def cohort_vcfc():
    from vcfc_tpu.eval.random_vcf import generate_correlated_vcf
    from vcfc_tpu.format import compress_bytes

    return compress_bytes(generate_correlated_vcf(2504, 512, mutation_rate=0.03, seed=7))


@pytest.mark.parametrize("version", [1, 2, 3, 4, 5, 6, 7, 8])
def test_vcfz_device_transcode_matches_host(gpu, cohort_vcfc, version):
    """The device `.vcfz` packer writes the host packer's bytes."""
    from vcfc_tpu.format.vcfz import default_block_lines, vcfz_from_vcfc
    from vcfc_tpu.format.vcfz_device import vcfz_from_vcfc_device

    want = vcfz_from_vcfc(cohort_vcfc, version=version, route="host")
    got = vcfz_from_vcfc_device(cohort_vcfc, default_block_lines(version), version)
    assert got == want


@pytest.mark.parametrize("version", [1, 4, 5, 6, 7, 8])
def test_vcfz_device_decode_matches_host(gpu, cohort_vcfc, version):
    from vcfc_tpu.format.vcfz import vcfz_from_vcfc
    from vcfc_tpu.format.vcfz_device import vcfz_to_vcfc_device

    z = vcfz_from_vcfc(cohort_vcfc, version=version, route="host")
    assert vcfz_to_vcfc_device(z) == cohort_vcfc
