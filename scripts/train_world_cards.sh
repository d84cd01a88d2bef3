#!/usr/bin/env bash
# The multi-process trainer on the four cards of one host (NCCL over
# NVLink): the cuda-marked world tests (worlds of 3 and 4 ranks against the
# stacked-rows trainer on card 0), then the train CLI under
# torch.distributed.run, one process a card: llama3.2-1b at full width under
# compressed and mrd_zero1 at dp 4 and 3, and minicpm-2b whole under
# compressed at dp 4; 4 steps of 2 x 1024 tokens a rank (a warm-up, 2 timed,
# the last profiled on rank 0 by --profile).  Every run's log and every
# rank's record go to chiprun_out/.  From the root of the repo:
#
#   bash scripts/train_world_cards.sh
set -euo pipefail
cd "$(dirname "$0")/.."
out=chiprun_out
mkdir -p "$out"
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -m pytest -q -m cuda tests/test_torch_train_world_nccl.py

run() {  # tag arch grad-sync ranks
    local tag=$1 arch=$2 mode=$3 n=$4
    python -m torch.distributed.run --standalone --nproc-per-node "$n" \
        -m repro_torch.launch.train --arch "$arch" --steps 4 --batch $((2 * n)) --seq 1024 \
        --dp "$n" --grad-sync "$mode" --remat full --profile \
        --summary-json "$out/world_${tag}_rank{rank}.json" > "$out/world_$tag.log" 2>&1 \
        || { tail -c 4000 "$out/world_$tag.log"; return 1; }
    echo "== $tag"
    grep -E "^(train|step|profiled|peak)" "$out/world_$tag.log"
}

run llama_compressed_dp4 llama3.2-1b compressed 4
run llama_zero1_dp4 llama3.2-1b mrd_zero1 4
run llama_compressed_dp3 llama3.2-1b compressed 3
run llama_zero1_dp3 llama3.2-1b mrd_zero1 3
run minicpm_compressed_dp4 minicpm-2b compressed 4
