#!/bin/bash
# The dry-run sweep: every (arch × shape × mesh) cell of the port, 8 cells at
# a time, each in its own process (python -m repro_torch.launch.dryrun on the
# host's CPU; no card needed), cheap shapes first.  A cell still running when
# the caller's time limit ends has no record.
#   bash tools/dryrun_sweep.sh [OUT_DIR]      # default experiments/dryrun_torch
# SWEEP_CELL_TIMEOUT (s, default 1500) bounds each cell; SWEEP_SHAPES picks
# shapes (default all four, in the order below).  Then:
#   python tools/dryrun_table.py OUT_DIR
cd "$(dirname "$0")/.."
export OUT=${1:-experiments/dryrun_torch}
mkdir -p "$OUT"
# slowest first, so that the last cells to finish are short ones
archs="qwen1.5-110b hymba-1.5b mamba2-1.3b granite-20b moonshot-v1-16b-a3b phi3-medium-14b deepseek-moe-16b phi-3-vision-4.2b smollm-135m whisper-medium"
# longest cells first; a line ends in no blank (xargs -L would join it to the next)
shapes=${SWEEP_SHAPES:-"train_4k decode_32k long_500k prefill_32k"}
for shape in $shapes; do for pod in " --multi-pod" ""; do for a in $archs; do echo "$a $shape$pod"; done; done; done \
    > "$OUT/cells.txt"
start=$(date +%s)
PYTHONPATH=src xargs -P 8 -L 1 -a "$OUT/cells.txt" bash -c '
t0=$(date +%s.%N); tag="$0_$1${2:+_pod2}"
timeout ${SWEEP_CELL_TIMEOUT:-1500} python -m repro_torch.launch.dryrun --arch "$0" --shape "$1" $2 --out-dir "$OUT" > "$OUT/log_$tag.txt" 2>&1
rc=$?; t1=$(date +%s.%N); echo "$0 $1 ${2:-pod1} rc=$rc wall_s=$(awk "BEGIN {print $t1 - $t0}")" >> "$OUT/walls.txt"'
echo "sweep done in $(( $(date +%s) - start )) s"
