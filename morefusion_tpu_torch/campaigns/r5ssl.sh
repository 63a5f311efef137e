#!/bin/bash
# Round-5 backbone-init A/B, on the port (morefusion_tpu_torch): a
# self-supervised warm start against random init, same recipe and budget,
# frozen hires val.
#
# ImageNet init needs a download; the substitute is RotNet pretraining on
# the procedural textured renders (cli.pretrain_backbone). Two
# from-scratch arms isolate the init: identical data, recipe, seed and
# budget; one grafts the pretrained resnet_extractor subtree
# (--pretrained-backbone). The summary, each arm's best in-loop
# main/add_or_add_s/auc (the key the train CLI logs), is committed as
# docs/results/torch_r5_ssl_ab.json.
#
# Reference role: morefusion/models/resnet.py:7-52 (a pretrained,
# frozen-BN ResNet18 under the reference recipe).
#
# Waits for the port's r5seg2 campaign to release the card.
#
# Usage: bash morefusion_tpu_torch/campaigns/r5ssl.sh [EPOCHS]
set -u
. "$(dirname "$0")/_common.sh"
EPOCHS="${1:-6}"
cd "$REPO"

wait_log r5ssl "$LOGS/torch_r5seg2_campaign.log" \
  "\[r5seg2\] done\|\[r5seg2\] giving up"

if [ ! -f "$RUNS/r5ssl_pre/backbone_bf16.npz" ]; then
  python -m morefusion_tpu_torch.cli.pretrain_backbone \
    --out "$RUNS/r5ssl_pre" \
    --data "$DATA/train_tex_hires_s44000_packed" \
           "$DATA/train_tex_hires_s45000_packed" \
    --steps 3000 --batch-size 64 --lr 3e-4 --seed 0 \
    || { echo "[r5ssl] pretrain failed"; exit 1; }
fi

run_arm() {  # run_arm NAME [extra cli.train args...]
  local name="$1"; shift
  rm -f "$RUNS/$name/leak_budget_exit"
  torchrun --standalone --nproc_per_node "$NPROC" \
    -m morefusion_tpu_torch.cli.train \
    --out "$RUNS/$name" \
    --data "$DATA/train_tex_hires_s44000_packed" \
    --val-data "$DATA/val_tex_hires_packed" \
    --model singleview_3d --with-occupancy --loss add/add_s \
    --min-visibility 0.8 --batch-size 16 --epochs "$EPOCHS" \
    --lr 1e-4 --lr-schedule cosine --warmup-steps 200 --seed 0 \
    --eval-interval 0.25 --rss-exit-gb 80 --resume "$@"
  local code
  code=$(train_code "$RUNS/$name" $?)
  if [ "$code" -eq 42 ]; then
    echo "[r5ssl] $name RSS exit; relaunching with --resume"
    run_arm "$name" "$@"
  fi
}

run_arm r5ssl_rand
run_arm r5ssl_init --pretrained-backbone "$RUNS/r5ssl_pre/backbone_bf16.npz"

python - "$RUNS" <<'PY'
import json, os, sys

runs = sys.argv[1]


def best(run):
    log = json.load(open(os.path.join(runs, run, "log.json")))
    pts = [
        (e["main/add_or_add_s/auc"], e["epoch"])
        for e in log
        if "main/add_or_add_s/auc" in e
    ]
    return {
        "best_auc": max(pts)[0] if pts else None,
        "best_epoch": max(pts)[1] if pts else None,
        "curve": pts,
    }


pre = [json.loads(l) for l in open(os.path.join(runs, "r5ssl_pre",
                                                 "log.jsonl"))]
out = {
    "protocol": "from-scratch A/B, train_tex_hires_s44000, frozen hires "
                "val, identical recipe/seed; arms differ only in "
                "--pretrained-backbone; the port (morefusion_tpu_torch)",
    "pretext_val_acc": pre[-1]["val_acc"] if pre else None,
    "random_init": best("r5ssl_rand"),
    "ssl_init": best("r5ssl_init"),
}
path = "docs/results/torch_r5_ssl_ab.json"
json.dump(out, open(path, "w"), indent=1)
print("[r5ssl] wrote", path, {k: out[k] for k in ("pretext_val_acc",)},
      out["random_init"]["best_auc"], out["ssl_init"]["best_auc"])
PY
git add docs/results/torch_r5_ssl_ab.json
git commit -m "r5ssl (port): backbone-init A/B artifact (RotNet SSL vs random init)"
echo "[r5ssl] done"
