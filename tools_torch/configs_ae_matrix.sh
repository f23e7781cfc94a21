#!/bin/bash
# The paper's configs a-e on one card, end to end, at the size of the JAX
# package's RESULTS.md matrix: a synthetic VOC set of 384 train and 96
# held-out frames of 640x480 (tools_torch/synthetic_data.py, seed 0, PNG
# unless --frames jpg),
# tools_torch/run_configs_ae.py over a-e with the recipe below, then
# tools_torch/summarize_results.py. The card's name and power limit, the
# driver's log, the table (RESULTS_torch.md), the stage seconds and each
# config's kept results, logs and artifact are copied to OUT.
#
#   bash tools_torch/configs_ae_matrix.sh [OUT [--frames jpg] [DRIVER ARGS...]]
#
# OUT defaults to exp/configs_ae_matrix; DRIVER ARGS go after the recipe's
# and override it (e.g. --configs a,b --fp32_epochs 600 --qat_epochs 900
# --lr_step 350,750: the JAX matrix's own epochs). --frames jpg writes the
# same set as JPEG files through cv2, as tests/synthetic.py wrote the JAX
# matrix's (into exp/synthvoc_jpg).
#
# The recipe is the JAX matrix's command line with its epochs cut to 0.4x
# (600 + 300 -> 240 + 120, LR drops at 140 and 300 in place of 350 and
# 750), so that the five configs train in about 40 min on one H100.
set -o pipefail
cd "$(dirname "$0")/.."
out=${1:-exp/configs_ae_matrix}
shift
frames=png
if [ "$1" = "--frames" ]; then frames=$2; shift 2; fi
data=exp/synthvoc
[ "$frames" = png ] || data=exp/synthvoc_$frames
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
t0=$(date +%s)
python -c "import sys; sys.path.insert(0, 'tools_torch'); from synthetic_data import make_voc_dataset; make_voc_dataset('$PWD/$data', num_images=384, img_w=640, img_h=480, test_images=96, seed=0, frames='$frames')" || exit 1
echo "data $(( $(date +%s) - t0 )) s" | tee "$out/data.txt"
CMD="python tools_torch/run_configs_ae.py --data_dir $PWD/$data --device_cache --fp32_epochs 240 --qat_epochs 360 --lr 0.001 --lr_step 140,300 --save_intervals 100 --val_intervals -1 $*"
$CMD > "$out/driver.log" 2>&1; rc=$?
echo "driver rc $rc after $(( $(date +%s) - t0 )) s" | tee -a "$out/data.txt"
python tools_torch/summarize_results.py --data_dir "$PWD/$data" \
  --cmdline "${CMD/$PWD\//}" --note "$(cat "$out/card.txt")" \
  > "$out/summary.log" 2>&1
cp exp/RESULTS_torch.md exp/configs_ae_summary_torch.json "$out/" 2>/dev/null
for d in exp/ctdet/pascal_shufflenetv2_config_*; do
  n=$(basename "$d"); mkdir -p "$out/$n"
  cp "$d"/results_*.json "$d"/log_*.txt "$d"/model_w4a8.npz "$out/$n/" 2>/dev/null
  ls -l "$d" > "$out/$n/ls.txt"
done
grep -h '"stage"' "$out/driver.log"; cat "$out/summary.log"; tail -5 "$out/driver.log"
exit $rc
