#!/bin/bash
# Round-5 continuation, take 2, on the port (morefusion_tpu_torch):
# triple fresh-data fine-tune.
#
# The design of r5cont.sh one rung up the ladder: warm start from the
# banked r5cont best (the port's torch_r5cont_best_bf16.npz, else the JAX
# package's r5cont_best_bf16.npz) and train on TRIPLE hires data, seeds
# 44000 + 45000 + the freshly generated 46000. The guardian banks every
# improvement as docs/results/torch_r5cont2_best_bf16.npz.
#
# Waits for (a) the port's r5seg3 campaign to release the card, (b) the
# seed-46000 generation, then packs it and trains.
#
# Usage: bash morefusion_tpu_torch/campaigns/r5cont2.sh [RUN_DIR] [EPOCHS]
set -u
. "$(dirname "$0")/_common.sh"
RUN="${1:-$RUNS/r5cont2}"
EPOCHS="${2:-12}"
cd "$REPO"

wait_log r5cont2 "$LOGS/torch_r5seg3_campaign.log" \
  "\[r5seg3\] done\|\[r5seg3\] giving up"

while [ ! -f "$DATA/train_tex_hires_s46000_reindexed/meta.json" ]; do
  echo "[r5cont2] waiting for seed-46000 generation ..."
  sleep 120
done

if [ ! -f "$DATA/train_tex_hires_s46000_packed/scalars.npz" ]; then
  python -c "
from morefusion_tpu_torch import datasets
datasets.packed.pack_reindexed(
    '$DATA/train_tex_hires_s46000_reindexed',
    '$DATA/train_tex_hires_s46000_packed')
"
fi

WARM="$(warm_start r5cont)"
python -m morefusion_tpu_torch.cli.campaign_guardian \
  --run-dir "$RUN" --tag torch_r5cont2 \
  > "$LOGS/torch_r5cont2_guardian.log" 2>&1 &

RETRIES=0
while true; do
  rm -f "$RUN/leak_budget_exit"
  torchrun --standalone --nproc_per_node "$NPROC" \
    -m morefusion_tpu_torch.cli.train \
    --out "$RUN" \
    --data "$DATA/train_tex_hires_s44000_packed" \
           "$DATA/train_tex_hires_s45000_packed" \
           "$DATA/train_tex_hires_s46000_packed" \
    --val-data "$DATA/val_tex_hires_packed" \
    --model singleview_3d --with-occupancy --loss add/add_s \
    --min-visibility 0.8 --batch-size 16 --epochs "$EPOCHS" \
    --lr 3e-5 --lr-schedule cosine --warmup-steps 200 --seed 0 \
    --eval-interval 0.25 --rss-exit-gb 80 \
    --resume --pretrained-model "$WARM"
  code=$(train_code "$RUN" $?)
  if [ "$code" -eq 42 ]; then
    echo "[r5cont2] RSS exit; relaunching with --resume"
    continue
  fi
  if [ "$code" -eq 0 ]; then
    echo "[r5cont2] training complete"
    exit 0
  fi
  RETRIES=$((RETRIES + 1))
  if [ "$RETRIES" -gt 30 ]; then
    echo "[r5cont2] giving up after $RETRIES failures"
    exit $code
  fi
  echo "[r5cont2] cli.train exited $code; retry $RETRIES in 120s"
  sleep 120
done
