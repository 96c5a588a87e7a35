#!/usr/bin/env bash
# Runs chip_smoke.py on two trees in turns on one card, parent, change,
# change, parent, so that their kernel times compare within one call.
#
#   bash tools/torch_smoke_pair.sh PARENT_DIR OUT_DIR
#
# PARENT_DIR is another checkout's root (for example a `git archive` of the
# parent commit unpacked into a gitignored directory); the change is the
# checkout this script lives in.  Each run's standard output and errors go
# to OUT_DIR as 1-P.log, 2-C.log, 3-C.log and 4-P.log; the script then
# prints each run's exit code and, for every kernel of the result line, its
# ms per launch in the four runs.  Exits 1 if any run failed.
set -u
here="$(cd "$(dirname "$0")/.." && pwd)"
parent="$(cd "$1" && pwd)"
out="$2"
mkdir -p "$out"
status=0
i=0
for tree in P C C P; do
  i=$((i + 1))
  dir="$here"
  [ "$tree" = P ] && dir="$parent"
  (cd "$dir" && python3 chip_smoke.py) > "$out/$i-$tree.log" 2>&1
  rc=$?
  echo "[pair] run $i ($tree): exit $rc, $(grep -c '^\[phase\]' "$out/$i-$tree.log") phases"
  [ $rc = 0 ] || status=1
done
python3 - "$out" <<'PY'
import json, pathlib, sys

runs = []
for log in sorted(pathlib.Path(sys.argv[1]).glob("*.log")):
    kernels = {}
    for line in log.read_text().splitlines():
        if line.startswith('{"kernels"'):
            kernels = {k["name"]: k for k in json.loads(line)["kernels"]}
    runs.append((log.stem, kernels))
names = sorted({n for _, ks in runs for n in ks})
print("[pair] ms a launch:", " ".join(r for r, _ in runs))
for n in names:
    print(f"[pair] {n}:", " ".join(
        f"{ks[n]['ms']:.5g}" if n in ks else "-" for _, ks in runs))
PY
exit $status
