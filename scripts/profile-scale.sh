#!/usr/bin/env bash
# TIMING phase profiles at scale (VERDICT r4 #7): run the
# binned-timing-profile-{single,range} ops at 503 MB and 2.0 GB so the
# index_search / decompress_seeking / decompress_iteration scaling is
# measured, not assumed (reference analog: evaluation_main.py:497-640,
# which profiled only its one chromosome size).
#
# Cohorts match BASELINE.md's scale-validation legs: 2,504 x 50,000
# (503 MB) and 2,504 x 200,000 (2.0 GB), i.i.d. seed 5.  Artifacts land
# in docs/eval/scale/.
set -euo pipefail
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu

mkdir -p eval-work docs/eval/scale
python - <<'EOF'
import os
from vcfc_tpu.eval.random_vcf import generate_vcf
for name, variants in (("scale503", 50_000), ("scale2g", 200_000)):
    p = f"eval-work/{name}.vcf"
    if not os.path.exists(p):
        with open(p, "wb") as f:
            f.write(generate_vcf(2504, variants, seed=5))
    print(p, os.path.getsize(p) / 1e6, "MB", flush=True)
EOF

profile() { # vcf max_pos positions
  local vcf=$1 max_pos=$2 positions=$3
  for op in binned-timing-profile-single binned-timing-profile-range; do
    echo "== $op $vcf ($(date +%H:%M:%S))"
    python -m vcfc_tpu.eval "$op" measure --vcf "eval-work/$vcf" \
      --min-pos 10000 --max-pos "$max_pos" --positions "$positions" \
      --output-dir docs/eval/scale
    python -m vcfc_tpu.eval "$op" graph --vcf "eval-work/$vcf" \
      --min-pos 10000 --max-pos "$max_pos" --output-dir docs/eval/scale
  done
}

profile scale503.vcf 109998 80
profile scale2g.vcf 409998 40
echo "done ($(date +%H:%M:%S))"
