#!/usr/bin/env bash
# Regenerate the full docs/eval artifact sets (reference defaults:
# 200 positions x 5 runs), for BOTH cohorts and BOTH cache modes:
#   docs/eval/       warm page cache (repeat-query regime)
#   docs/eval/cold/  cold page cache — the reference's protocol
#                    (command.py:12-18 flushes before every timed run);
#                    needs root for /proc/sys/vm/drop_caches
# Cohorts: the i.i.d. 2,504x5,000 seed-5 cohort (reference
# other/random_vcf.py workload) and the LD-correlated twin
# (mutation_rate=0.03 — the vertical structure of real 1000G data).
set -euo pipefail
cd "$(dirname "$0")/.."
# query paths are host/native: the sweep needs no accelerator
export JAX_PLATFORMS=cpu

mkdir -p eval-work
python - <<'EOF'
import os
from vcfc_tpu.eval.random_vcf import generate_correlated_vcf, generate_vcf
p = "eval-work/cohort.vcf"
if not os.path.exists(p):
    with open(p, "wb") as f:
        f.write(generate_vcf(2504, 5000, seed=5))
p = "eval-work/corrcohort.vcf"
if not os.path.exists(p):
    with open(p, "wb") as f:
        f.write(generate_correlated_vcf(2504, 5000, mutation_rate=0.03, seed=5))
EOF
# drop stale v4 containers: r3 changed the v4 default block height to 64
rm -f eval-work/*.v4.vcfz

OPS="all-indexing-times binned-index-creation-time all-exhaustive-single \
     all-exhaustive-range binned-timing-profile-single binned-timing-profile-range"
for mode in warm cold; do
  out="docs/eval"; flag=""
  if [ "$mode" = cold ]; then out="docs/eval/cold"; flag="--flush-cache"; fi
  mkdir -p "$out"
  for vcf in cohort corrcohort; do
    for op in $OPS; do
      echo "== $mode $vcf $op ($(date +%H:%M:%S))"
      python -m vcfc_tpu.eval "$op" measure --vcf "eval-work/$vcf.vcf" \
        --min-pos 10000 --max-pos 19998 --runs 5 --positions 200 \
        --output-dir "$out" $flag
      python -m vcfc_tpu.eval "$op" graph --vcf "eval-work/$vcf.vcf" \
        --min-pos 10000 --max-pos 19998 --output-dir "$out"
    done
  done
done
echo "done ($(date +%H:%M:%S))"
