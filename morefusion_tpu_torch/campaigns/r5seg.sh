#!/bin/bash
# Round-5 segmentation retrain + instancing-merge A/B, on the port
# (morefusion_tpu_torch).
#
# Round 4's recipe (--use-depth --steps 5000 --n-frames 800) with the
# round-5 merge_occlusion_splits active at instancing time, trained over
# NPROC cards under torchrun; after training the SAME weights are
# evaluated again with --eval-only --no-merge, so that the detection and
# precision delta of the merge heuristic is an exact same-weights A/B
# (per_class.json against per_class_nomerge.json), committed as
# docs/results/torch_r5_seg_per_class[_nomerge].json.
#
# Waits for the port's r5tex and r5hires campaigns to release the card.
# Frames come from the MFTPU_SEG_CACHE disk cache where it is set.
#
# Usage: bash morefusion_tpu_torch/campaigns/r5seg.sh [RUN_DIR]
set -u
. "$(dirname "$0")/_common.sh"
RUN="${1:-$RUNS/r5seg}"
cd "$REPO"

wait_log r5seg "$LOGS/torch_r5tex_campaign.log" \
  "training complete\|giving up"
wait_log r5seg "$LOGS/torch_r5hires_campaign.log" \
  "training complete\|giving up"

RETRIES=0
while true; do
  torchrun --standalone --nproc_per_node "$NPROC" \
    -m morefusion_tpu_torch.cli.train_segmentation \
    --out "$RUN" --use-depth --steps 5000 --n-frames 800 \
    --n-val-frames 50 --n-objects 4 10 --seed 0 && break
  RETRIES=$((RETRIES + 1))
  [ "$RETRIES" -gt 10 ] && { echo "[r5seg] giving up"; exit 1; }
  echo "[r5seg] train exited nonzero; retry $RETRIES in 120s"
  sleep 120
done

# same-weights ablation: merge heuristic off
python -m morefusion_tpu_torch.cli.train_segmentation \
  --out "$RUN" --use-depth --steps 5000 --n-frames 800 \
  --n-val-frames 50 --n-objects 4 10 --seed 0 \
  --eval-only --no-merge

cp "$RUN/per_class.json" docs/results/torch_r5_seg_per_class.json
cp "$RUN/per_class_nomerge.json" \
  docs/results/torch_r5_seg_per_class_nomerge.json
git add docs/results/torch_r5_seg_per_class.json \
        docs/results/torch_r5_seg_per_class_nomerge.json
git commit -m "r5seg (port): retrain + instancing-merge A/B per-class tables"
echo "[r5seg] done"
