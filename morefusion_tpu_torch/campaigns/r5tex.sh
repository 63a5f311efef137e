#!/bin/bash
# Round-5 textured accuracy campaign, on the port (morefusion_tpu_torch).
#
# The JAX package's r5tex campaign with the port's train CLI: warm start
# from the committed round-3 occ_best_bf16.npz, 30 cosine epochs @ 1e-4 on
# the textured-settled seed-44000 train set, in-loop eval on the frozen
# textured 862-crop val every 0.25 epoch, B = 16 over NPROC cards under
# torchrun. Exits at 80 GB of host RSS (the train CLI's leak-budget exit,
# code 42) and relaunches with --resume; other failures retry every 120 s,
# 30 times at most (RETRIES counts them and may start above 0).
#
# Usage: bash morefusion_tpu_torch/campaigns/r5tex.sh [RUN_DIR] [EPOCHS]
set -u
. "$(dirname "$0")/_common.sh"
RUN="${1:-$RUNS/r5tex}"
EPOCHS="${2:-30}"
cd "$REPO"

# Wait for the packed train store (cli.regen_datasets may still be running).
while [ ! -f "$DATA/train_tex_s44000_packed/scalars.npz" ]; do
  echo "[campaign] waiting for $DATA/train_tex_s44000_packed ..."
  sleep 60
done

WARM="$(warm_start occ)"
while true; do
  rm -f "$RUN/leak_budget_exit"
  torchrun --standalone --nproc_per_node "$NPROC" \
    -m morefusion_tpu_torch.cli.train \
    --out "$RUN" \
    --data "$DATA/train_tex_s44000_packed" \
    --val-data "$DATA/val_tex_packed" \
    --model singleview_3d --with-occupancy --loss add/add_s \
    --min-visibility 0.8 --batch-size 16 --epochs "$EPOCHS" \
    --lr 1e-4 --lr-schedule cosine --warmup-steps 200 --seed 0 \
    --eval-interval 0.25 --rss-exit-gb 80 \
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
  # Transient failures (another process holding the card) retry with
  # backoff instead of killing the campaign; --resume picks up from the
  # latest trainer snapshot.
  RETRIES="${RETRIES:-0}"
  RETRIES=$((RETRIES + 1))
  if [ "$RETRIES" -gt 30 ]; then
    echo "[campaign] giving up after $RETRIES failures"
    exit $code
  fi
  echo "[campaign] cli.train exited $code; retry $RETRIES in 120s"
  sleep 120
done
