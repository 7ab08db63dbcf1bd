#!/usr/bin/env bash
# Full differential verification against the reference VCFC binary.
#
# Builds the reference from /root/reference (or $VCFC_REFERENCE), generates
# a fresh random corpus (new seed every run), and checks every surface of
# all three implementations:
#   - reference binary  (ground truth)
#   - native CLI        (native/vcfcq)
#   - Python CLI        (python -m vcfc_tpu.cli)
# compress / decompress / binned + sparse indexes / all query engines /
# gap-analysis byte-equal; .vcfz lossless with query-z == full scan.
#
# Usage: scripts/verify-differential.sh [seed]
set -euo pipefail

here="$(cd "$(dirname "$0")/.." && pwd)"
ref_src="${VCFC_REFERENCE:-/root/reference}"
seed="${1:-$RANDOM$RANDOM}"
work="$(mktemp -d /tmp/vcfc-verify.XXXXXX)"
trap 'rm -rf "$work"' EXIT
echo "workdir: $work  seed: $seed"

# --- build the reference oracle once per machine
R=/tmp/refbuild/main_release
if [ ! -x "$R" ]; then
  mkdir -p /tmp/refbuild
  cp -r "$ref_src/src" /tmp/refbuild/ && cp "$ref_src/Makefile" /tmp/refbuild/
  (cd /tmp/refbuild && make release >/dev/null 2>&1)
fi
make -C "$here/native" >/dev/null 2>&1 || true
V="$here/native/vcfcq"
P=(python -m vcfc_tpu.cli)
export PYTHONPATH="$here${PYTHONPATH:+:$PYTHONPATH}"
# byte-level verification runs on the CPU backend (the device routes'
# card leg is chip_smoke.py)
export JAX_PLATFORMS=cpu

# --- fresh corpus: escapes, >127 run caps, SVs, 3 chroms, pos regressions
python - "$seed" "$work/f.vcf" <<'EOF'
import random, sys
random.seed(int(sys.argv[1]))
n = random.randint(120, 600)
lines = ["##fileformat=VCFv4.2", "##source=verify-differential"]
lines.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
             + "\t".join(f"S{i}" for i in range(n)))
gts = ["0|0","0|1","1|0","1|1","2|0","./.","0|2","3|3"]
w = [0.8,0.05,0.05,0.03,0.02,0.02,0.02,0.01]
pos = 1000
for v in range(random.randint(200, 800)):
    pos += random.randint(1, 500)
    chrom = ["17","21","X"][min(v // 200, 2)]
    if v % 200 == 199: pos = random.randint(500, 2000)
    if v % 41 == 3:
        ref, alt, info = "N", "<DEL>", f"END={pos+random.randint(10,9000)}"
    elif v % 41 == 17:
        ref, alt, info = "N", "<DUP>", f"SVLEN={random.randint(40,800)}"
    else:
        ref = random.choice(["A","C","GT","GATTACA"])
        alt = random.choice(["G","T,A","TTA","A,C,G"])
        info = "."
    row = ["0|0"]*n if v % 29 == 7 else random.choices(gts, weights=w, k=n)
    lines.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t99\tPASS\t{info}\tGT\t" + "\t".join(row))
open(sys.argv[2], "w").write("\n".join(lines) + "\n")
EOF

cd "$work"
fail=0
check() { if ! "$@"; then echo "FAIL: $*"; fail=1; fi; }

"$R" compress f.vcf r.vcfc
"$V" compress f.vcf v.vcfc;            check cmp -s r.vcfc v.vcfc
"${P[@]}" compress f.vcf p.vcfc;       check cmp -s r.vcfc p.vcfc
"$V" decompress v.vcfc v.rt;           check cmp -s v.rt f.vcf
"${P[@]}" decompress p.vcfc p.rt;      check cmp -s p.rt f.vcf

"$R" create-binned-index 20 r.vcfc
"$V" create-binned-index 20 v.vcfc;    check cmp -s r.vcfc.vcfci v.vcfc.vcfci
"$R" create-sparse-index r.vcfc
"$V" create-sparse-index v.vcfc
"$R" sparsify r.vcfc r.sparse 2>/dev/null
"$V" sparsify v.vcfc v.sparse

for region in "17" "21:1000-99999" "X:2000-2000" "5" "17:1-999999999"; do
  "$R" query r.vcfc "$region" > a;              "$V" query v.vcfc "$region" > b
  check cmp -s a b
  "${P[@]}" query p.vcfc "$region" > c;          check cmp -s a c
  "$R" query-binned-index r.vcfc "$region" > a; "$V" query-binned-index v.vcfc "$region" > b
  check cmp -s a b
  "$R" query-sparse-index r.vcfc "$region" > a 2>/dev/null
  "$V" query-sparse-index v.vcfc "$region" > b; check cmp -s a b
done
for region in "17:1500-1500" "17:1000-50000"; do
  "$R" sparse-query r.sparse "$region" > a 2>/dev/null
  "$V" sparse-query v.sparse "$region" > b;     check cmp -s a b
done

"$R" gap-analysis r.vcfc; mv start-positions.txt a
"$V" gap-analysis v.vcfc; check cmp -s a start-positions.txt

"$V" compress-z v.vcfc v.vcfz
"${P[@]}" compress-z p.vcfc p.vcfz;    check cmp -s v.vcfz p.vcfz
"$V" decompress-z v.vcfz z.rt;         check cmp -s z.rt f.vcf
"$R" query r.vcfc "21:1000-99999" > a
"$V" query-z v.vcfz "21:1000-99999" > b; check cmp -s a b

# v4 (vertical prediction): both writers byte-equal, both readers invert
"${P[@]}" compress-z p.vcfc p4.vcfz 4
"$V" compress-z v.vcfc v4.vcfz 4;      check cmp -s p4.vcfz v4.vcfz
"$V" decompress-z p4.vcfz z4.rt;       check cmp -s z4.rt f.vcf
"${P[@]}" decompress-z p4.vcfz z4p.rt; check cmp -s z4p.rt f.vcf
"$V" query-z p4.vcfz "21:1000-99999" > b4; check cmp -s a b4

# v5 (order-0, device-decodable): both writers byte-equal, both readers
# invert, and the DEVICE entropy routes (encode pack + bit-parallel
# decode) are byte-identical to the host paths on the fresh corpus
"${P[@]}" compress-z p.vcfc p5.vcfz 5
"$V" compress-z v.vcfc v5.vcfz 5;      check cmp -s p5.vcfz v5.vcfz
"$V" decompress-z p5.vcfz z5.rt;       check cmp -s z5.rt f.vcf
"${P[@]}" decompress-z p5.vcfz z5p.rt; check cmp -s z5p.rt f.vcf
"$V" query-z p5.vcfz "21:1000-99999" > b5; check cmp -s a b5
VCFZ_PACK=device "${P[@]}" compress-z p.vcfc p5d.vcfz 5
check cmp -s p5d.vcfz p5.vcfz
VCFZ_PACK=device "${P[@]}" decompress-z p5.vcfz z5d.rt
check cmp -s z5d.rt f.vcf
VCFZ_PACK=device "${P[@]}" compress-z p.vcfc p4d.vcfz 4
check cmp -s p4d.vcfz p4.vcfz
VCFZ_PACK=device "${P[@]}" decompress-z p4.vcfz z4d.rt
check cmp -s z4d.rt f.vcf

# v6 (vertical prediction + order-0 book): writers byte-equal, readers
# invert, device encode/decode byte-identical
"${P[@]}" compress-z p.vcfc p6.vcfz 6
"$V" compress-z v.vcfc v6.vcfz 6;      check cmp -s p6.vcfz v6.vcfz
"$V" decompress-z p6.vcfz z6.rt;       check cmp -s z6.rt f.vcf
VCFZ_PACK=device "${P[@]}" compress-z p.vcfc p6d.vcfz 6
check cmp -s p6d.vcfz p6.vcfz
VCFZ_PACK=device "${P[@]}" decompress-z p6.vcfz z6d.rt
check cmp -s z6d.rt f.vcf

# v7 (vertical prediction + context-SPLIT sub-payloads — v4's ratio,
# device-decodable): writers byte-equal, readers invert, device
# encode/decode byte-identical, query matches
"${P[@]}" compress-z p.vcfc p7.vcfz 7
"$V" compress-z v.vcfc v7.vcfz 7;      check cmp -s p7.vcfz v7.vcfz
"$V" decompress-z p7.vcfz z7.rt;       check cmp -s z7.rt f.vcf
"${P[@]}" decompress-z p7.vcfz z7p.rt; check cmp -s z7p.rt f.vcf
"$V" query-z p7.vcfz "21:1000-99999" > b7; check cmp -s a b7
VCFZ_PACK=device "${P[@]}" compress-z p.vcfc p7d.vcfz 7
check cmp -s p7d.vcfz p7.vcfz
VCFZ_PACK=device "${P[@]}" decompress-z p7.vcfz z7d.rt
check cmp -s z7d.rt f.vcf

# v8 (literal streams + context-SPLIT sub-payloads — v3's ratio,
# device-decodable): writers byte-equal, readers invert, device
# encode/decode byte-identical, query matches
"${P[@]}" compress-z p.vcfc p8.vcfz 8
"$V" compress-z v.vcfc v8.vcfz 8;      check cmp -s p8.vcfz v8.vcfz
"$V" decompress-z p8.vcfz z8.rt;       check cmp -s z8.rt f.vcf
"${P[@]}" decompress-z p8.vcfz z8p.rt; check cmp -s z8p.rt f.vcf
"$V" query-z p8.vcfz "21:1000-99999" > b8; check cmp -s a b8
VCFZ_PACK=device "${P[@]}" compress-z p.vcfc p8d.vcfz 8
check cmp -s p8d.vcfz p8.vcfz
VCFZ_PACK=device "${P[@]}" decompress-z p8.vcfz z8d.rt
check cmp -s z8d.rt f.vcf

# --- VCFZ_COMPACT=device (r5): on-device sort_compact compaction +
# sparse escape scatter — same bytes through encode AND decode for the
# heaviest containers (v4 resolve, v7 split, v8 literal split)
for zv in 4 7 8; do
  VCFZ_PACK=device VCFZ_COMPACT=device "${P[@]}" compress-z p.vcfc pc$zv.vcfz $zv
  check cmp -s pc$zv.vcfz p$zv.vcfz
  VCFZ_PACK=device VCFZ_COMPACT=device "${P[@]}" decompress-z p$zv.vcfz zc$zv.rt
  check cmp -s zc$zv.rt f.vcf
done

# --- .vcfcm manifest (no reference analog): native and Python writers
# byte-equal; query-manifest output equals the binned-index query (same
# SV-aware overlap semantics) on hit, SV-overlap, and miss regions
"$V" create-manifest v.vcfc
"${P[@]}" create-manifest p.vcfc;      check cmp -s v.vcfc.vcfcm p.vcfc.vcfcm
for region in "17:1000-99999" "21:1-999999999" "X:2000-2000" "5:1-99"; do
  "$R" query-binned-index r.vcfc "$region" > a
  "$V" query-manifest v.vcfc "$region" > b;    check cmp -s a b
  "${P[@]}" query-manifest p.vcfc "$region" > c; check cmp -s a c
done

# --- device-unpack decode route: the matmul packed->positional path must
# reproduce the VCF byte-for-byte on the fresh corpus too
VCFC_FORCE_DEVICE=1 VCFC_UNPACK=device "${P[@]}" decompress p.vcfc pu.rt
check cmp -s pu.rt f.vcf

# --- device-parse routes (VERDICT r2 #1): ASCII classify moves onto the
# device for compress, decode+render for decompress — byte contracts hold
# (FORCE_DEVICE: the corpus can fall below the engine's min-cells gate)
VCFC_FORCE_DEVICE=1 VCFC_PARSE=device "${P[@]}" compress f.vcf pt.vcfc
check cmp -s r.vcfc pt.vcfc
VCFC_FORCE_DEVICE=1 VCFC_PARSE=device "${P[@]}" decompress p.vcfc pt.rt
check cmp -s pt.rt f.vcf

# --- TIMING phase taxonomy differential (VERDICT r1 #8): the reference's
# main_timing build and both our CLIs must emit TIMING labels that the
# eval harness maps into the SAME phase-category sets (the cross-language
# contract: command.py:135-158 regex + evaluation_main.py:649-670 taxonomy).
T=/tmp/refbuild/main_timing
if [ ! -x "$T" ]; then (cd /tmp/refbuild && make timing >/dev/null 2>&1); fi
tcats() {
  python -c '
import re, sys
cat = {"decompress2_metadata_headers": "headers",
       "decompress2_metadata_headers_fd": "headers",
       "decompress_iteration": "iteration",
       "index_search": "index_search",
       "decompress_seeking": "seeking"}
found = set()
text = open(sys.argv[1], "r", errors="replace").read()
for m in re.finditer(r"TIMING (\w+): (\d+)", text):
    if m.group(1) in cat:
        found.add(cat[m.group(1)])
print(",".join(sorted(found)))
' "$1"
}
# hit region: all four categories; EOF-miss region: seeking, no iteration
for region in "17:1000-99999" "X:999999990-999999999"; do
  "$T" query-binned-index r.vcfc "$region" > ta 2>/dev/null
  VCFC_TIMING=1 "$V" query-binned-index v.vcfc "$region" > tb
  # v.vcfc is byte-identical to p.vcfc and has a .vcfci built above
  VCFC_TIMING=1 "${P[@]}" query-binned-index v.vcfc "$region" > tc
  ca=$(tcats ta); cb=$(tcats tb); cc=$(tcats tc)
  check [ -n "$ca" ]
  check [ "$ca" = "$cb" ]
  check [ "$ca" = "$cc" ]
done

if [ "$fail" = 0 ]; then
  echo "PASS: all surfaces byte-equal vs reference (seed $seed)"
else
  echo "FAILURES above (seed $seed, workdir kept: $work)"
  trap - EXIT
  exit 1
fi
