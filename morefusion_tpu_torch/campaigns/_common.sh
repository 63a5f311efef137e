# Shared set-up of the port's training campaigns: sourced by each
# campaign script, never run on its own.
#
# Environment (each has a default):
#   MFTPU_DATA         the packed / reindexed data sets ($HOME/data)
#   MFT_RUNS           run directories ($HOME/runs_torch, apart from the
#                      JAX campaigns' $HOME/runs)
#   MFT_CAMPAIGN_LOGS  where the campaign and guardian logs live (/tmp);
#                      a campaign waits on torch_<campaign>_campaign.log
#   NPROC              training processes, one a card (the cards this
#                      process can see: torch.cuda.device_count(), which
#                      honours CUDA_VISIBLE_DEVICES)
REPO="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"
DATA="${MFTPU_DATA:-$HOME/data}"
RUNS="${MFT_RUNS:-$HOME/runs_torch}"
LOGS="${MFT_CAMPAIGN_LOGS:-/tmp}"
# as the JAX package's fit shards each batch over every local device
NPROC="${NPROC:-$(python -c \
  'import torch; print(torch.cuda.device_count())' 2>/dev/null)}"
[ "${NPROC:-0}" -ge 1 ] 2>/dev/null || NPROC=1
# PyTorch's launcher, where no torchrun script is on the PATH
command -v torchrun >/dev/null \
  || torchrun() { python -m torch.distributed.run "$@"; }

# warm_start NAME...: the checkpoint a warm start reads. The port's own
# banked docs/results/torch_NAME_best_bf16.npz of the first NAME that has
# one, else the JAX package's committed docs/results/NAME_best_bf16.npz of
# the first NAME that has one (loaded by --pretrained-model).
warm_start() {
  local n
  for n in "$@"; do
    if [ -f "$REPO/docs/results/torch_${n}_best_bf16.npz" ]; then
      echo "docs/results/torch_${n}_best_bf16.npz"; return
    fi
  done
  for n in "$@"; do
    if [ -f "$REPO/docs/results/${n}_best_bf16.npz" ]; then
      echo "docs/results/${n}_best_bf16.npz"; return
    fi
  done
  echo "docs/results/${1}_best_bf16.npz"  # missing: the train CLI says so
}

# train_code OUT CODE: the exit code a train run meant. torchrun reports a
# worker's exit code 42 (the leak-budget exit, its checkpoint saved) as 1;
# the train CLI leaves OUT/leak_budget_exit behind for it, which each
# campaign removes before it launches a run.
train_code() {
  if [ -f "$1/leak_budget_exit" ]; then echo 42; else echo "$2"; fi
}

# wait_log TAG LOG PATTERN: block until LOG exists and matches PATTERN
# (grep's basic syntax), saying so every two minutes.
wait_log() {
  while true; do
    [ -f "$2" ] && grep -q "$3" "$2" && return
    echo "[$1] waiting for $2 ..."
    sleep 120
  done
}
