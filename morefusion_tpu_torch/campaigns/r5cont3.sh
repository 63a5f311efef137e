#!/bin/bash
# Round-5 continuation, take 3, on the port (morefusion_tpu_torch):
# quadruple fresh-data fine-tune.
#
# The next rung of the fresh-data ladder: warm start from the banked
# r5cont2 best, falling back to the r5cont best (the port's torch_ banks
# first, then the JAX package's committed checkpoints), and fine-tune on
# QUADRUPLE hires data, seeds 44000-47000. The guardian banks every
# improvement as docs/results/torch_r5cont3_best_bf16.npz.
#
# Waits for (a) the port's r5cont2 campaign to release the card, (b) the
# seed-47000 generation chained after seed-46000.
#
# Usage: bash morefusion_tpu_torch/campaigns/r5cont3.sh [RUN_DIR] [EPOCHS]
set -u
. "$(dirname "$0")/_common.sh"
RUN="${1:-$RUNS/r5cont3}"
EPOCHS="${2:-10}"
cd "$REPO"

wait_log r5cont3 "$LOGS/torch_r5cont2_campaign.log" \
  "training complete\|giving up"

while [ ! -f "$DATA/train_tex_hires_s47000_reindexed/meta.json" ]; do
  echo "[r5cont3] waiting for seed-47000 generation ..."
  sleep 120
done

if [ ! -f "$DATA/train_tex_hires_s47000_packed/scalars.npz" ]; then
  python -c "
from morefusion_tpu_torch import datasets
datasets.packed.pack_reindexed(
    '$DATA/train_tex_hires_s47000_reindexed',
    '$DATA/train_tex_hires_s47000_packed')
"
fi

WARM="$(warm_start r5cont2 r5cont)"
python -m morefusion_tpu_torch.cli.campaign_guardian \
  --run-dir "$RUN" --tag torch_r5cont3 \
  > "$LOGS/torch_r5cont3_guardian.log" 2>&1 &

RETRIES=0
while true; do
  rm -f "$RUN/leak_budget_exit"
  torchrun --standalone --nproc_per_node "$NPROC" \
    -m morefusion_tpu_torch.cli.train \
    --out "$RUN" \
    --data "$DATA/train_tex_hires_s44000_packed" \
           "$DATA/train_tex_hires_s45000_packed" \
           "$DATA/train_tex_hires_s46000_packed" \
           "$DATA/train_tex_hires_s47000_packed" \
    --val-data "$DATA/val_tex_hires_packed" \
    --model singleview_3d --with-occupancy --loss add/add_s \
    --min-visibility 0.8 --batch-size 16 --epochs "$EPOCHS" \
    --lr 3e-5 --lr-schedule cosine --warmup-steps 200 --seed 0 \
    --eval-interval 0.25 --rss-exit-gb 80 \
    --resume --pretrained-model "$WARM"
  code=$(train_code "$RUN" $?)
  if [ "$code" -eq 42 ]; then
    echo "[r5cont3] RSS exit; relaunching with --resume"
    continue
  fi
  if [ "$code" -eq 0 ]; then
    echo "[r5cont3] training complete"
    exit 0
  fi
  RETRIES=$((RETRIES + 1))
  if [ "$RETRIES" -gt 30 ]; then
    echo "[r5cont3] giving up after $RETRIES failures"
    exit $code
  fi
  echo "[r5cont3] cli.train exited $code; retry $RETRIES in 120s"
  sleep 120
done
