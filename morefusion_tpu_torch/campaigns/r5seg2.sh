#!/bin/bash
# Round-5 segmentation retrain, take 2, on the port (morefusion_tpu_torch):
# foreground-weighted CE.
#
# r5seg's recipe with --fg-weight (the segmentation loss's foreground
# up-weighting; heavily occluded objects give a few hundred foreground
# pixels against a ~10:1 background majority, which the plain-mean CE
# barely sees), then the same-weights merge A/B, committed as
# docs/results/torch_r5_seg2_per_class[_nomerge].json.
#
# Reference role: class-balanced sampling in the reference's instance
# segmentation training (instance_segm/train_multi.py:53-170).
#
# Waits for the port's r5cont campaign to release the card.
#
# Usage: bash morefusion_tpu_torch/campaigns/r5seg2.sh [RUN_DIR] [FG_WEIGHT]
set -u
. "$(dirname "$0")/_common.sh"
RUN="${1:-$RUNS/r5seg2}"
FGW="${2:-3.0}"
cd "$REPO"

wait_log r5seg2 "$LOGS/torch_r5cont_campaign.log" \
  "training complete\|giving up"

RETRIES=0
while true; do
  torchrun --standalone --nproc_per_node "$NPROC" \
    -m morefusion_tpu_torch.cli.train_segmentation \
    --out "$RUN" --use-depth --steps 5000 --n-frames 800 \
    --n-val-frames 50 --n-objects 4 10 --seed 0 \
    --fg-weight "$FGW" && break
  RETRIES=$((RETRIES + 1))
  [ "$RETRIES" -gt 10 ] && { echo "[r5seg2] giving up"; exit 1; }
  echo "[r5seg2] train exited nonzero; retry $RETRIES in 120s"
  sleep 120
done

# same-weights ablation: merge heuristic off
python -m morefusion_tpu_torch.cli.train_segmentation \
  --out "$RUN" --use-depth --steps 5000 --n-frames 800 \
  --n-val-frames 50 --n-objects 4 10 --seed 0 \
  --fg-weight "$FGW" --eval-only --no-merge

cp "$RUN/per_class.json" docs/results/torch_r5_seg2_per_class.json
cp "$RUN/per_class_nomerge.json" \
  docs/results/torch_r5_seg2_per_class_nomerge.json
git add docs/results/torch_r5_seg2_per_class.json \
        docs/results/torch_r5_seg2_per_class_nomerge.json
git commit -m "r5seg2 (port): fg-weighted CE retrain per-class tables (fgw=$FGW)"
echo "[r5seg2] done"
