"""chip_smoke.py's phases at tiny size on the CPU backend (the script
itself refuses to run without a GPU)."""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture
def work(tmp_path, monkeypatch):
    monkeypatch.setenv("VCFC_FORCE_DEVICE", "1")  # tiny cohorts use the device path
    return str(tmp_path)


def test_main_refuses_cpu_only_host(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "Fake Card, 700.00 W")
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path / "work"))
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out
    assert not (tmp_path / "work").exists()


def test_main_refuses_without_nvidia_smi(monkeypatch, capsys):
    def missing():
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(chip_smoke, "card_line", missing)
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--four-cards"])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_cohort_phase_checks_pass(work):
    vcf, vcfc, detail = chip_smoke.cohort_phase(
        "main", work, samples=60, lines=300, seed=5, oracle_lines=40
    )
    assert vcf.startswith(b"##fileformat") and len(vcfc) < len(vcf)
    assert "cli compress" in detail


def test_oracle_sample_catches_a_corrupt_line(work):
    from vcfc_tpu.format import compress_bytes
    from vcfc_tpu.format.vcf import parse_metadata_headers

    vcf = chip_smoke.generate_realistic_vcf(40, 50, seed=3)
    vcfc = bytearray(compress_bytes(vcf))
    chip_smoke.check_oracle_sample(vcf, bytes(vcfc), n=50)
    spans = chip_smoke.vcfc_line_spans(bytes(vcfc), parse_metadata_headers(vcf).data_offset)
    vcfc[spans[7][1] - 2] ^= 0x01  # a flag byte of line 7
    with pytest.raises(AssertionError, match="oracle"):
        chip_smoke.check_oracle_sample(vcf, bytes(vcfc), n=50)


def test_device_routes_phase(work):
    from vcfc_tpu.format import compress_bytes

    vcf = chip_smoke.generate_realistic_vcf(60, 200, seed=4)
    detail = chip_smoke.device_routes_phase(vcf, compress_bytes(vcf), versions=(7, 8))
    assert "warm device-compact" in detail and "v8 host transcode" in detail


def test_queries_phase(work):
    from vcfc_tpu.format import compress_bytes

    path = os.path.join(work, "q.vcfc")
    with open(path, "wb") as f:
        f.write(compress_bytes(chip_smoke.generate_realistic_vcf(30, 600, seed=8)))
    detail = chip_smoke.queries_phase(work, path)
    assert detail.count("=") == 5


def test_kernel_copy_phase_rows():
    rows = chip_smoke.kernel_copy_phase(widths=((300, 64), (1000, None)), reps=2)
    assert [r["batch"] for r in rows] == [[64, 384], [2048, 1024]]
    for r in rows:
        assert r["encode_s"] > 0 and r["d2h_codes_s"] > 0
        assert isinstance(r["encode_paces"], bool)
        json.dumps(r)


def test_four_cards_phase_on_virtual_devices(work):
    detail = chip_smoke.four_cards_phase(work, samples=40, lines=120)
    assert "dryrun_multichip(4)" in detail
