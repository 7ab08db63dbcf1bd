"""Gene-region query benchmark (reference: evaluation/query.py:144-222).

The reference resolves 13 clinically notable gene symbols to GRCh37
coordinates (Ensembl REST lookup cached in a local sqlite db,
query.py:81-143) and times each scheme over those regions, 3 iterations
per gene.  This is its twin here:

  * same sqlite cache schema (gene_name/reference_name/start/end);
  * Ensembl GRCh37 REST lookup when the network exists, else a vendored
    coordinate table for the reference's 13 genes (GRCh37 symbol spans;
    approximate to the Ensembl lookup — regions drive latency
    benchmarks, not variant interpretation);
  * schemes: tabix over .vcf.gz, bcftools over .bcf, and the native
    vcfcq binned-index / manifest queries — per-process, like the
    reference's subprocess timing (query.py:49-79).

Usage:
  python -m vcfc_tpu.eval.genes --vcf <file.vcf> [--genes NAME:REF:S-E ...]
        [--iterations 3] [--workdir eval-work] [--output out.json]

With --vcf pointing at a 1000G chromosome the vendored genes on that
chromosome run as in the reference; synthetic cohorts can pass --genes
with in-range coordinates.
"""

from __future__ import annotations

import json
import os
import sqlite3
import subprocess
import time

# Vendored GRCh37 symbol spans for the reference's gene list
# (query.py:145-161).  Source: Ensembl GRCh37 symbol lookup.
GRCH37_GENES = {
    "TP53": ("17", 7_565_097, 7_590_856),
    "ALDH2": ("12", 112_204_346, 112_247_782),
    "BRCA1": ("17", 41_196_312, 41_277_500),
    "BRCA2": ("13", 32_889_611, 32_973_805),
    "TNF": ("6", 31_543_344, 31_546_113),
    "EGFR": ("7", 55_086_725, 55_324_313),
    "VEGFA": ("6", 43_737_946, 43_754_224),
    "APOE": ("19", 45_409_039, 45_412_650),
    "IL6": ("7", 22_766_766, 22_771_621),
    "TGFB1": ("19", 41_836_812, 41_859_831),
    "MTHFR": ("1", 11_845_787, 11_866_160),
    "ESR1": ("6", 152_011_631, 152_424_409),
    "AKT1": ("14", 105_235_686, 105_262_088),
}


def _db(path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(path)
    conn.execute(
        "create table if not exists coordinates("
        "gene_name text, reference_name text, start integer, end integer)"
    )
    return conn


def get_gene_coordinates(symbol: str, db_path: str = "gene_coordinates_hg19.db"):
    """sqlite-cached GRCh37 coordinates: cache, then Ensembl REST, then
    the vendored table (this machine has no egress)."""
    conn = _db(db_path)
    row = conn.execute(
        "select reference_name, start, end from coordinates where gene_name = ?",
        (symbol,),
    ).fetchone()
    if row is None:
        coord = _fetch_ensembl(symbol) or GRCH37_GENES.get(symbol)
        if coord is None:
            raise KeyError(f"unknown gene symbol {symbol}")
        conn.execute(
            "insert into coordinates values (?,?,?,?)", (symbol, *coord)
        )
        conn.commit()
        row = coord
    return {
        "gene_name": symbol,
        "reference_name": str(row[0]),
        "start": int(row[1]),
        "end": int(row[2]),
    }


def _fetch_ensembl(symbol: str):
    """Best-effort GRCh37 REST lookup (query.py:114-135); None offline."""
    try:  # pragma: no cover - needs network
        from urllib.request import urlopen

        url = (
            "https://grch37.rest.ensembl.org/lookup/symbol/human/"
            f"{symbol}?content-type=application/json"
        )
        with urlopen(url, timeout=5) as r:
            d = json.load(r)
        return str(d["seq_region_name"]), int(d["start"]), int(d["end"])
    except Exception:
        return None


def measure_gene_queries(
    vcfc: bytes,
    vcfci: bytes,
    genes: dict[str, tuple[str, int, int]] | None = None,
    iterations: int = 3,
) -> dict:
    """In-process variant: time binned-index queries over the gene panel
    without process spawns (the quick engine-level sweep; the
    ``benchmark`` entry below is the reference-faithful per-process
    multi-scheme run)."""
    import statistics

    from ..index.binned import query_binned_index
    from ..query.coordinate import CoordinateQuery

    panel = genes or {k: v for k, v in GRCH37_GENES.items()}
    out: dict = {}
    for name, (chrom, start, end) in panel.items():
        q = CoordinateQuery.range(chrom, start, end)
        times = []
        n_bytes = 0
        for _ in range(iterations):
            t0 = time.perf_counter()
            n_bytes = sum(len(l) for l in query_binned_index(vcfc, vcfci, q))
            times.append(time.perf_counter() - t0)
        out[name] = {
            "region": f"{chrom}:{start}-{end}",
            "p50_s": statistics.median(times),
            "min_s": min(times),
            "result_bytes": n_bytes,
        }
    return out


def _timed_proc(cmd, iterations: int) -> float:
    total = 0.0
    for _ in range(iterations):
        t0 = time.perf_counter()
        subprocess.run(cmd, stdout=subprocess.DEVNULL, check=True)
        total += time.perf_counter() - t0
    return total / iterations


def benchmark(
    vcf_path: str,
    genes: list[dict],
    workdir: str = "eval-work",
    iterations: int = 3,
) -> dict:
    """Time every scheme over every gene region, reference-style
    (per-process subprocess wall clock, averaged over iterations)."""
    from .schemes import SchemeFactory, _tool
    from ..host.native import cli_path
    from .config import Dataset

    ds = Dataset(os.path.basename(vcf_path), vcf_path, "", 0, 0)
    factory = SchemeFactory(ds, workdir)
    cli = cli_path()
    results: dict = {"dataset": ds.name, "iterations": iterations, "genes": {}}

    # prepared artifacts (vcfc + indexes + gz/bcf)
    vcfc = factory.vcfc_path
    if cli:
        subprocess.run([cli, "create-binned-index", "150", vcfc], check=True)
        subprocess.run([cli, "create-manifest", vcfc], check=True)
    gz_scheme = factory.tabix_bgzip()
    bcf_scheme = factory.tabix_bcf()

    for g in genes:
        ref, start, end = g["reference_name"], g["start"], g["end"]
        region = f"{ref}:{start}-{end}"
        row: dict = {"region": region}
        if cli:
            row["vcfc-binned-native"] = _timed_proc(
                [cli, "query-binned-index", vcfc, region], iterations
            )
            row["vcfc-manifest-native"] = _timed_proc(
                [cli, "query-manifest", vcfc, region], iterations
            )
        if gz_scheme:
            tabix = _tool("tabix")[0]
            row[f"tabix-bgzip ({gz_scheme.backend})"] = _timed_proc(
                [tabix, os.path.join(workdir, ds.name + ".vcf.gz"), region],
                iterations,
            )
        if bcf_scheme:
            bcftools = _tool("bcftools")[0]
            row[f"tabix-bcf ({bcf_scheme.backend})"] = _timed_proc(
                [
                    bcftools, "view", "-H",
                    os.path.join(workdir, ds.name + ".bcf"), region,
                ],
                iterations,
            )
        results["genes"][g["gene_name"]] = row
    return results


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="vcfc_tpu.eval.genes", description=__doc__)
    p.add_argument("--vcf", required=True)
    p.add_argument(
        "--genes",
        nargs="*",
        default=None,
        help="NAME:REF:START-END overrides; default = the reference's 13 genes",
    )
    p.add_argument("--iterations", type=int, default=3)
    p.add_argument("--workdir", default="eval-work")
    p.add_argument("--db", default="gene_coordinates_hg19.db")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)

    if args.genes:
        genes = []
        for spec in args.genes:
            name, ref, span = spec.split(":")
            s, e = span.split("-")
            genes.append(
                {"gene_name": name, "reference_name": ref,
                 "start": int(s), "end": int(e)}
            )
    else:
        genes = [get_gene_coordinates(s, args.db) for s in GRCH37_GENES]

    out = benchmark(args.vcf, genes, args.workdir, args.iterations)
    text = json.dumps(out, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
