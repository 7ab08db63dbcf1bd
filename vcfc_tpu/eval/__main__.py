"""Harness CLI: python -m vcfc_tpu.eval <operation> <measure|graph> [opts].

Operations: all-exhaustive-single all-exhaustive-range
binned-timing-profile-single binned-timing-profile-range
binned-index-creation-time all-indexing-times
(matching the reference's evaluation_main.py:759-769).
"""

from __future__ import annotations

import argparse
import os
import sys

from .config import Dataset, HarnessConfig
from .graphs import GRAPHERS
from .harness import OPERATIONS, Harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vcfc_tpu.eval", description=__doc__)
    p.add_argument("operation", choices=sorted(OPERATIONS))
    p.add_argument("mode", choices=["measure", "graph"])
    p.add_argument("--vcf", help="input VCF (default: generate synthetic)")
    p.add_argument("--reference-name", default="1")
    p.add_argument("--min-pos", type=int, default=None)
    p.add_argument("--max-pos", type=int, default=None)
    p.add_argument("--workdir", default="eval-work")
    p.add_argument("--output-dir", default="eval-out")
    p.add_argument("--runs", type=int, default=5)
    p.add_argument("--positions", type=int, default=200)
    p.add_argument("--bin-size", type=int, default=150)
    p.add_argument("--flush-cache", action="store_true")
    p.add_argument(
        "--jax-trace",
        default=None,
        metavar="DIR",
        help="capture a jax.profiler device trace of the measure run",
    )
    p.add_argument("--samples", type=int, default=500, help="synthetic samples")
    p.add_argument("--variants", type=int, default=5000, help="synthetic variants")
    args = p.parse_args(argv)

    config = HarnessConfig(
        workdir=args.workdir,
        output_dir=args.output_dir,
        test_runs=args.runs,
        n_positions=args.positions,
        default_bin_size=args.bin_size,
        flush_page_cache=args.flush_cache,
    )
    os.makedirs(config.workdir, exist_ok=True)

    if args.vcf:
        if args.min_pos is None or args.max_pos is None:
            p.error("--min-pos/--max-pos required with --vcf")
        dataset = Dataset(
            os.path.basename(args.vcf), args.vcf, args.reference_name,
            args.min_pos, args.max_pos,
        )
    else:
        dataset = Dataset.synthetic(config.workdir, args.samples, args.variants)

    if args.mode == "measure":
        from ..utils.timing import device_trace

        harness = Harness(dataset, config)
        with device_trace(args.jax_trace):
            path = OPERATIONS[args.operation](harness)
        print(path)
    else:
        json_path = os.path.join(
            config.output_dir, f"{args.operation}-{dataset.name}.json"
        )
        if not os.path.exists(json_path):
            print(f"measure first: {json_path} not found", file=sys.stderr)
            return 1
        print(GRAPHERS[args.operation](json_path))
    return 0


if __name__ == "__main__":
    sys.exit(main())
