#!/bin/bash
# Round-5 training-time-resolution A/B, on the port (morefusion_tpu_torch).
#
# The recipe of r5tex.sh (warm start from the committed round-3
# occ_best_bf16.npz, 30 cosine epochs @ 1e-4, batch 16, min-visibility
# 0.8); the ONLY change is the data: the 480x640 re-renders of the same
# textured-settled scenes (train_tex_hires_s44000, same seed 44000),
# validated in-loop on the 480x640 re-render of the frozen val scenes
# (val_tex_hires_packed). Crops pack at 256x256 in both runs; hires
# sources keep the crops' native detail. Compare at matched epochs against
# r5tex's log (the same cosine horizon).
#
# Runs beside r5tex on the same host: eval every 0.5 epoch (the points
# still align with r5tex's 0.25 grid) and a lower RSS exit, so that the
# two trainers fit in host RAM together.
#
# Usage: bash morefusion_tpu_torch/campaigns/r5hires.sh [RUN_DIR] [EPOCHS]
set -u
. "$(dirname "$0")/_common.sh"
RUN="${1:-$RUNS/r5hires}"
EPOCHS="${2:-30}"
cd "$REPO"

while [ ! -f "$DATA/train_tex_hires_s44000_packed/scalars.npz" ]; do
  echo "[campaign] waiting for $DATA/train_tex_hires_s44000_packed ..."
  sleep 60
done

WARM="$(warm_start occ)"
while true; do
  rm -f "$RUN/leak_budget_exit"
  torchrun --standalone --nproc_per_node "$NPROC" \
    -m morefusion_tpu_torch.cli.train \
    --out "$RUN" \
    --data "$DATA/train_tex_hires_s44000_packed" \
    --val-data "$DATA/val_tex_hires_packed" \
    --model singleview_3d --with-occupancy --loss add/add_s \
    --min-visibility 0.8 --batch-size 16 --epochs "$EPOCHS" \
    --lr 1e-4 --lr-schedule cosine --warmup-steps 200 --seed 0 \
    --eval-interval 0.5 --rss-exit-gb 28 \
    --resume --pretrained-model "$WARM"
  code=$(train_code "$RUN" $?)
  if [ "$code" -eq 42 ]; then
    echo "[campaign] RSS exit; relaunching with --resume"
    continue
  fi
  if [ "$code" -eq 0 ]; then
    echo "[campaign] training complete"
    exit 0
  fi
  RETRIES="${RETRIES:-0}"
  RETRIES=$((RETRIES + 1))
  if [ "$RETRIES" -gt 30 ]; then
    echo "[campaign] giving up after $RETRIES failures"
    exit $code
  fi
  echo "[campaign] cli.train exited $code; retry $RETRIES in 120s"
  sleep 120
done
