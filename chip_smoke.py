"""Bring-up proof on an NVIDIA GPU: drive the codec's main path through
the entry points a user calls, at the deployment the reference itself
evaluates (1000 Genomes phase 3: 2,504 samples, GT-only), and check
every result against a plain reference.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded / multi-process path

One line per phase (wall seconds and, for the kernels, the compiled
memory analysis); the card's name and power limit as nvidia-smi reports
them; and, last, one JSON object {"ok": true, "device": {...}}.  Any
failed check raises, so the script exits non-zero and prints no result
line — as it does without a GPU.

Phases (one card):
  device        nvidia-smi + jax.devices(); the platform must be gpu
  native        the C++ host library builds from native/ (make -C native)
  main_path     generate_realistic_vcf(2504, 50_000, seed=5) (~514 MB)
                through `cli compress` / `cli decompress`: the .vcfc must
                equal the C++ host codec's (VCFC_EXECUTOR=host), the
                format/ oracle's on 2,000 sampled lines, and decompress
                must return the input
  wide_cohort   the same checks at S=50,000 x 1,000 lines
  device_routes VCFC_PARSE=device, VCFC_UNPACK=device and the VCFZ_PACK
                device .vcfz v4/v7/v8 transcode + decode, under both
                on-device and host compaction, byte-identical to the host
                routes; the compaction A/B wall times
  queries       create-binned-index 150, then five query-binned-index
                regions equal to the full-scan `query`
  card_tests    `pytest -m gpu` (tests/test_gpu.py), in this process
  kernel_copy   rle_encode / rle_decode vs the batch's host<->device
                copies, at (2048, 2560) and the S=50,000 batch
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

from vcfc_tpu import cli, engine
from vcfc_tpu.eval.random_vcf import generate_realistic_vcf
from vcfc_tpu.host import native

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_work")

MAIN_SAMPLES, MAIN_LINES = 2504, 50_000
WIDE_SAMPLES, WIDE_LINES = 50_000, 1_000
GT_P = [0.81, 0.072, 0.072, 0.0264, 0.0196]  # 1000G-like, escape tail


def report(name: str, seconds: float, detail: str = "") -> None:
    print(f"phase {name}: ok {seconds:.3f} s{' ' + detail if detail else ''}", flush=True)


@contextlib.contextmanager
def env(**kv):
    """Set (value) or unset (None) environment variables for a block."""
    old = {k: os.environ.get(k) for k in kv}
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def card_line() -> str:
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def device_info(min_count: int = 1) -> dict:
    import jax

    devs = jax.devices()
    info = {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }
    if info["platform"] != "gpu" or info["count"] < min_count:
        sys.exit(f"chip_smoke needs {min_count} NVIDIA GPU(s); JAX found {info}")
    return info


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis n/a"
    return (
        f"args {m.argument_size_in_bytes} B, out {m.output_size_in_bytes} B, "
        f"temp {m.temp_size_in_bytes} B"
    )


def run_cli(*argv: str) -> bytes:
    """`vcfc <argv>` in this process; returns what it wrote to stdout."""
    out = io.TextIOWrapper(io.BytesIO())
    with contextlib.redirect_stdout(out):
        rc = cli.main(list(argv))
    out.flush()
    if rc != 0:
        raise RuntimeError(f"cli {argv} exited {rc}")
    return out.buffer.getvalue()


def read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def vcfc_line_spans(vcfc: bytes, data_offset: int) -> list[tuple[int, int]]:
    """Byte span of every compressed line (4-byte length header hops)."""
    from vcfc_tpu.format.headers import decode_line_headers

    spans, pos = [], data_offset
    while pos < len(vcfc):
        line_length, _req = decode_line_headers(vcfc, pos)
        spans.append((pos, pos + 4 + line_length))
        pos += 4 + line_length
    return spans


def check_oracle_sample(vcf: bytes, vcfc: bytes, n: int, seed: int = 0) -> None:
    """The format/ oracle compresses ``n`` sampled lines to the same bytes
    the engine wrote for them (lines are self-contained)."""
    from vcfc_tpu.format.vcf import compress_bytes, parse_metadata_headers

    hb = parse_metadata_headers(vcf).data_offset
    body = np.frombuffer(vcf, np.uint8)[hb:]
    ends = np.flatnonzero(body == 10) + hb + 1
    starts = np.concatenate([[hb], ends[:-1]])
    spans = vcfc_line_spans(vcfc, hb)
    if len(spans) != len(starts):
        raise AssertionError(f"{len(spans)} compressed lines for {len(starts)} VCF lines")
    pick = np.sort(np.random.default_rng(seed).choice(len(starts), min(n, len(starts)), replace=False))
    want = compress_bytes(vcf[:hb] + b"".join(vcf[starts[i] : ends[i]] for i in pick))
    got = vcf[:hb] + b"".join(vcfc[spans[i][0] : spans[i][1]] for i in pick)
    if got != want:
        raise AssertionError(f"engine bytes differ from the oracle on {len(pick)} sampled lines")


def cohort_phase(name: str, work: str, samples: int, lines: int, seed: int,
                 oracle_lines: int) -> tuple[bytes, bytes, str]:
    """Generate a cohort, run it through `cli compress` / `decompress`,
    and check it against the host codec and the oracle."""
    t0 = time.perf_counter()
    vcf = generate_realistic_vcf(samples, lines, seed=seed)
    vcf_path = os.path.join(work, f"{name}.vcf")
    with open(vcf_path, "wb") as f:
        f.write(vcf)
    t_gen = time.perf_counter() - t0

    vcfc_path = vcf_path + "c"
    t0 = time.perf_counter()
    run_cli("compress", vcf_path, vcfc_path)
    t_comp = time.perf_counter() - t0
    vcfc = read(vcfc_path)

    t0 = time.perf_counter()
    with env(VCFC_EXECUTOR="host"):
        host = engine.compress(vcf)
    t_host = time.perf_counter() - t0
    if vcfc != host:
        raise AssertionError(f"{name}: cli compress differs from the C++ host codec")
    check_oracle_sample(vcf, vcfc, oracle_lines)

    back_path = vcf_path + ".back"
    t0 = time.perf_counter()
    run_cli("decompress", vcfc_path, back_path)
    t_dec = time.perf_counter() - t0
    if read(back_path) != vcf:
        raise AssertionError(f"{name}: decompress is not lossless")
    os.remove(back_path)
    detail = (
        f"S={samples} L={lines} vcf={len(vcf)} B vcfc={len(vcfc)} B; "
        f"generate {t_gen:.3f} s, cli compress {t_comp:.3f} s, "
        f"host-codec compress {t_host:.3f} s, cli decompress {t_dec:.3f} s"
    )
    return vcf, vcfc, detail


def device_routes_phase(vcf: bytes, vcfc: bytes, versions=(4, 7, 8)) -> str:
    """Every opt-in device route, byte-identical to its host route."""
    from vcfc_tpu.format.vcfz import decompress_vcfz, default_block_lines, vcfz_from_vcfc
    from vcfc_tpu.format.vcfz_device import vcfz_from_vcfc_device, vcfz_to_vcfc_device

    parts = []
    with env(VCFC_PARSE="device"):
        t0 = time.perf_counter()
        if engine.compress(vcf) != vcfc:
            raise AssertionError("VCFC_PARSE=device compress differs")
        t1 = time.perf_counter()
        if engine.decompress(vcfc) != vcf:
            raise AssertionError("VCFC_PARSE=device decompress differs")
        parts.append(f"parse-device compress {t1 - t0:.3f} s decompress {time.perf_counter() - t1:.3f} s")
    with env(VCFC_UNPACK="device"):
        t0 = time.perf_counter()
        if engine.decompress(vcfc) != vcf:
            raise AssertionError("VCFC_UNPACK=device decompress differs")
        parts.append(f"unpack-device decompress {time.perf_counter() - t0:.3f} s")

    for v in versions:
        t0 = time.perf_counter()
        host_z = vcfz_from_vcfc(vcfc, version=v, route="host")
        walls = [f"v{v} host transcode {time.perf_counter() - t0:.3f} s"]
        # v7 runs twice per setting: the second, warm pass is the A/B
        for rep in range(2 if v == 7 else 1):
            for compact in ("device", "host"):
                with env(VCFZ_COMPACT=compact):
                    t0 = time.perf_counter()
                    z = vcfz_from_vcfc_device(vcfc, default_block_lines(v), v)
                    t1 = time.perf_counter()
                    back = vcfz_to_vcfc_device(host_z)
                    t2 = time.perf_counter()
                if z != host_z:
                    raise AssertionError(f"v{v} device transcode ({compact} compaction) differs")
                if back != vcfc:
                    raise AssertionError(f"v{v} device decode ({compact} compaction) differs")
                tag = "warm " if rep else ""
                walls.append(
                    f"{tag}{compact}-compact transcode {t1 - t0:.3f} s decode {t2 - t1:.3f} s"
                )
        parts.append(", ".join(walls))
    t0 = time.perf_counter()
    if decompress_vcfz(host_z, route="device") != vcf:
        raise AssertionError(f"v{versions[-1]} device decompress-z differs")
    parts.append(f"v{versions[-1]} decompress-z (device route) {time.perf_counter() - t0:.3f} s")
    return "; ".join(parts)


def pick_regions(vcfc: bytes, n: int = 5, span: int = 5000) -> list[str]:
    """``n`` ranged regions on different contigs, each starting at a
    variant that no earlier variant overlaps (there the binned index's
    overlap test and the full scan's point test agree by construction)."""
    from vcfc_tpu.index.scan import scan_lines

    by_chrom: dict[bytes, list] = {}
    for rec in scan_lines(vcfc):
        by_chrom.setdefault(rec.chrom, []).append((rec.pos, rec.end_position()))
    chroms = list(by_chrom)
    regions = []
    for chrom in chroms[:: max(len(chroms) // n, 1)][:n]:
        recs = by_chrom[chrom]
        for k in range(len(recs) // 2, len(recs)):
            if k == 0 or max(e for _p, e in recs[:k]) < recs[k][0]:
                start = recs[k][0]
                regions.append(f"{chrom.decode()}:{start}-{start + span - 1}")
                break
    if len(regions) < min(n, len(chroms)):
        raise AssertionError(f"found only {len(regions)} query regions")
    return regions


def queries_phase(work: str, vcfc_path: str) -> str:
    vcfc = read(vcfc_path)
    t0 = time.perf_counter()
    run_cli("create-binned-index", "150", vcfc_path)
    t_idx = time.perf_counter() - t0
    hits = []
    for region in pick_regions(vcfc):
        binned = run_cli("query-binned-index", vcfc_path, region)
        full = run_cli("query", vcfc_path, region)
        if binned != full or not full:
            raise AssertionError(f"query {region}: binned {len(binned)} B vs full scan {len(full)} B")
        hits.append(f"{region}={full.count(b'\n')}")
    return f"index {t_idx:.3f} s; lines per region {' '.join(hits)}"


class _Outcomes:
    """pytest plugin: counts passed / skipped / failed tests."""

    def __init__(self):
        self.passed = self.skipped = self.failed = 0

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1
        elif report.when == "call":
            self.passed += 1


def card_tests_phase() -> str:
    import pytest

    seen = _Outcomes()
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider",
         os.path.join(REPO, "tests", "test_gpu.py")],
        plugins=[seen],
    )
    if rc != 0 or seen.failed or seen.skipped or not seen.passed:
        raise AssertionError(
            f"pytest -m gpu: rc {rc}, {seen.passed} passed, "
            f"{seen.skipped} skipped, {seen.failed} failed"
        )
    return f"{seen.passed} passed"


def _median_s(fn, reps: int) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def kernel_copy_phase(widths=((MAIN_SAMPLES, 2048), (WIDE_SAMPLES, None)),
                      reps: int = 20) -> list[dict]:
    """Time the XLA RLE kernels against the host<->device copies of their
    own batch.  ``widths``: (S, line batch) pairs; None = the engine's
    adaptive batch for that width."""
    import jax

    from vcfc_tpu.ops.rle import rle_decode, rle_encode

    out = []
    for S, L in widths:
        S_pad = max((S + 127) // 128 * 128, 128)
        L = L or engine._adaptive_line_batch(engine._LINE_BATCH, S_pad)
        rng = np.random.default_rng(S)
        codes = np.zeros((L, S_pad), np.uint8)
        codes[:, :S] = rng.choice(5, size=(L, S), p=GT_P)
        mem_enc = memory_line(rle_encode.lower(codes, S).compile())
        mem_dec = memory_line(rle_decode.lower(codes, S).compile())

        dev_codes = jax.device_put(codes)
        flags_d, _ = rle_encode(dev_codes, S)
        flags = np.asarray(flags_d)
        codes_rt = np.asarray(rle_decode(flags_d, S)[0])
        if not (codes_rt[:, :S] == codes[:, :S]).all():
            raise AssertionError(f"S={S}: device decode does not invert encode")

        def d2h(fn):
            ts = []
            for _ in range(reps):
                arr = jax.block_until_ready(fn())
                t0 = time.perf_counter()
                np.asarray(arr)
                ts.append(time.perf_counter() - t0)
            return float(np.median(ts))

        row = {
            "S": S,
            "batch": [L, S_pad],
            "encode_s": _median_s(lambda: jax.block_until_ready(rle_encode(dev_codes, S)), reps),
            "decode_s": _median_s(lambda: jax.block_until_ready(rle_decode(flags_d, S)), reps),
            "h2d_codes_s": _median_s(lambda: jax.device_put(codes).block_until_ready(), reps),
            "d2h_flags_s": d2h(lambda: rle_encode(dev_codes, S)[0]),
            "h2d_flags_s": _median_s(lambda: jax.device_put(flags).block_until_ready(), reps),
            "d2h_codes_s": d2h(lambda: rle_decode(flags_d, S)[0]),
        }
        row["encode_paces"] = row["encode_s"] > row["h2d_codes_s"] + row["d2h_flags_s"]
        row["decode_paces"] = row["decode_s"] > row["h2d_flags_s"] + row["d2h_codes_s"]
        print(f"  kernel_copy S={S} encode: {mem_enc}; decode: {mem_dec}", flush=True)
        print(f"  kernel_copy {json.dumps(row)}", flush=True)
        if row["encode_paces"] or row["decode_paces"]:
            print(f"  kernel_copy S={S}: the XLA kernel takes longer than its copies", flush=True)
        out.append(row)
    return out


def four_cards_phase(work: str, samples: int = MAIN_SAMPLES, lines: int = MAIN_LINES) -> str:
    """Four `python -m vcfc_tpu.parallel` processes (one card each, run
    before this process touches a card), then the mesh-sharded engine
    over four cards; both byte-equal to the one-card engine.compress."""
    vcf = generate_realistic_vcf(samples, lines, seed=5)
    vcf_path = os.path.join(work, "four.vcf")
    with open(vcf_path, "wb") as f:
        f.write(vcf)
    mp_vcfc = os.path.join(work, "four.mp.vcfc")
    mp_back = os.path.join(work, "four.mp.vcf")

    def launch(src: str, dst: str) -> float:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        child_env = dict(os.environ)
        # one device per process (the host-platform count is a CPU-mesh flag)
        child_env["XLA_FLAGS"] = re.sub(
            r"--xla_force_host_platform_device_count=\d+", "",
            child_env.get("XLA_FLAGS", ""),
        ).strip()
        t0 = time.perf_counter()
        procs, logs = [], []
        for pid in range(4):
            log = open(os.path.join(work, f"proc{pid}.log"), "wb")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "vcfc_tpu.parallel", src, dst,
                 "--coordinator", f"localhost:{port}",
                 "--num-processes", "4", "--process-id", str(pid)],
                cwd=REPO, env=child_env, stdout=log, stderr=subprocess.STDOUT,
            ))
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for log in logs:
                log.close()
        if any(rcs):
            tails = [read(os.path.join(work, f"proc{i}.log"))[-2000:].decode(errors="replace") for i in range(4)]
            raise RuntimeError(f"parallel processes exited {rcs}:\n" + "\n".join(tails))
        return time.perf_counter() - t0

    t_mp_c = launch(vcf_path, mp_vcfc)
    t_mp_d = launch(mp_vcfc, mp_back)
    if read(mp_back) != vcf:
        raise AssertionError("four-process decompress is not lossless")

    from __graft_entry__ import dryrun_multichip
    from vcfc_tpu.parallel.mesh import make_data_mesh

    one = engine.compress(vcf)
    if read(mp_vcfc) != one:
        raise AssertionError("four-process compress differs from one-card engine.compress")
    mesh = make_data_mesh(4)
    t0 = time.perf_counter()
    sharded = engine.compress_sharded(vcf, mesh=mesh)
    t_sc = time.perf_counter() - t0
    if sharded != one:
        raise AssertionError("compress_sharded differs from one-card engine.compress")
    t0 = time.perf_counter()
    if engine.decompress_sharded(sharded, mesh=mesh) != vcf:
        raise AssertionError("decompress_sharded is not lossless")
    t_sd = time.perf_counter() - t0
    t0 = time.perf_counter()
    dryrun_multichip(4)
    t_dry = time.perf_counter() - t0
    return (
        f"S={samples} L={lines}; 4-process compress {t_mp_c:.3f} s decompress "
        f"{t_mp_d:.3f} s; sharded compress {t_sc:.3f} s decompress {t_sd:.3f} s; "
        f"dryrun_multichip(4) {t_dry:.3f} s"
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card path and what it is compared with",
    )
    args = p.parse_args(argv)
    try:
        card = card_line()
    except (OSError, subprocess.SubprocessError) as e:
        sys.exit(f"chip_smoke needs an NVIDIA GPU: nvidia-smi failed ({e})")
    print(f"card: {card}", flush=True)
    if not args.four_cards:
        t0 = time.perf_counter()
        info = device_info()
        report("device", time.perf_counter() - t0, json.dumps(info))

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        if args.four_cards:
            # the four processes run first: this process must not hold a
            # card while they start
            t0 = time.perf_counter()
            detail = four_cards_phase(WORK)
            info = device_info(min_count=4)
            report("four_cards", time.perf_counter() - t0, detail)
        else:
            t0 = time.perf_counter()
            if not native.available():
                raise RuntimeError("the native host library did not build (make -C native)")
            report("native", time.perf_counter() - t0)

            t0 = time.perf_counter()
            vcf, vcfc, detail = cohort_phase(
                "main", WORK, MAIN_SAMPLES, MAIN_LINES, seed=5, oracle_lines=2000
            )
            report("main_path", time.perf_counter() - t0, detail)

            t0 = time.perf_counter()
            _w, _wc, detail = cohort_phase(
                "wide", WORK, WIDE_SAMPLES, WIDE_LINES, seed=6, oracle_lines=100
            )
            del _w, _wc
            report("wide_cohort", time.perf_counter() - t0, detail)

            t0 = time.perf_counter()
            detail = device_routes_phase(vcf, vcfc)
            report("device_routes", time.perf_counter() - t0, detail)

            t0 = time.perf_counter()
            detail = queries_phase(WORK, os.path.join(WORK, "main.vcfc"))
            report("queries", time.perf_counter() - t0, detail)

            t0 = time.perf_counter()
            detail = card_tests_phase()
            report("card_tests", time.perf_counter() - t0, detail)

            t0 = time.perf_counter()
            rows = kernel_copy_phase()
            report("kernel_copy", time.perf_counter() - t0, json.dumps(rows))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
