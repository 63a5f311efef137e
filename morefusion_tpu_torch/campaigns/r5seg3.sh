#!/bin/bash
# Round-5 segmentation retrain, take 3, on the port (morefusion_tpu_torch):
# stronger foreground weighting.
#
# r5seg2's recipe at --fg-weight 5 (the residual misses were pixel recall,
# so the same lever pushed harder), the same budget otherwise, then the
# same-weights merge A/B, committed as
# docs/results/torch_r5_seg3_per_class[_nomerge].json.
#
# Waits for the port's r5ssl campaign to release the card; r5cont2 waits
# for this one.
#
# Usage: bash morefusion_tpu_torch/campaigns/r5seg3.sh [RUN_DIR] [FG_WEIGHT]
set -u
. "$(dirname "$0")/_common.sh"
RUN="${1:-$RUNS/r5seg3}"
FGW="${2:-5.0}"
cd "$REPO"

wait_log r5seg3 "$LOGS/torch_r5ssl_campaign.log" \
  "\[r5ssl\] done\|\[r5ssl\] pretrain failed"

RETRIES=0
while true; do
  torchrun --standalone --nproc_per_node "$NPROC" \
    -m morefusion_tpu_torch.cli.train_segmentation \
    --out "$RUN" --use-depth --steps 5000 --n-frames 800 \
    --n-val-frames 50 --n-objects 4 10 --seed 0 \
    --fg-weight "$FGW" && break
  RETRIES=$((RETRIES + 1))
  [ "$RETRIES" -gt 10 ] && { echo "[r5seg3] giving up"; exit 1; }
  echo "[r5seg3] train exited nonzero; retry $RETRIES in 120s"
  sleep 120
done

# same-weights ablation: merge heuristic off
python -m morefusion_tpu_torch.cli.train_segmentation \
  --out "$RUN" --use-depth --steps 5000 --n-frames 800 \
  --n-val-frames 50 --n-objects 4 10 --seed 0 \
  --fg-weight "$FGW" --eval-only --no-merge

cp "$RUN/per_class.json" docs/results/torch_r5_seg3_per_class.json
cp "$RUN/per_class_nomerge.json" \
  docs/results/torch_r5_seg3_per_class_nomerge.json
git add docs/results/torch_r5_seg3_per_class.json \
        docs/results/torch_r5_seg3_per_class_nomerge.json
git commit -m "r5seg3 (port): fg-weighted CE retrain per-class tables (fgw=$FGW)"
echo "[r5seg3] done"
