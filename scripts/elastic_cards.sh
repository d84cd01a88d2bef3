#!/usr/bin/env bash
# The elastic trainer on the four cards of one host (NCCL over NVLink), one
# process a card, against the stacked-rows elastic trainer on card 0:
# llama3.2-1b at full width cut to 8 layers (the stacked run holds every
# rank's rows on one card), ranks 0-3 under grow_on_join with
# the script --kill 2:1 --join 4:1 (4 -> 3 at step 2, back to 4 at step 4, the
# killed rank joining again), 6 steps of 12 x 1024 tokens, under compressed
# (device_fused: mrd_combine combines in the step) and mrd_zero1.  Each live
# rank's losses and final state digest must equal the stacked trainer's row
# (scripts/elastic_cards.py --compare).  Logs and each rank's record go to
# chiprun_out/elastic_cards/; the exit code is 1 if a run fails or differs.
# From the root of the repo:
#
#   bash scripts/elastic_cards.sh
set -uo pipefail
cd "$(dirname "$0")/.."
out=chiprun_out/elastic_cards
mkdir -p "$out"
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/gpu.txt"
ARGS=(--layers 8 --steps 6 --batch 12 --seq 1024 --out "$out")
fail=0
start=$SECONDS
for mode in compressed mrd_zero1; do
    timeout -k 10 600 python -m torch.distributed.run --standalone --nproc-per-node 4 \
        scripts/elastic_cards.py --mode "$mode" "${ARGS[@]}" > "$out/world_$mode.log" 2>&1 \
        || { echo "== world $mode FAILED"; tail -c 3000 "$out/world_$mode.log"; fail=1; continue; }
    grep -E "^world" "$out/world_$mode.log"
    CUDA_VISIBLE_DEVICES=0 timeout -k 10 600 python scripts/elastic_cards.py --stacked \
        --mode "$mode" "${ARGS[@]}" > "$out/stacked_$mode.log" 2>&1 \
        || { echo "== stacked $mode FAILED"; tail -c 3000 "$out/stacked_$mode.log"; fail=1;
             continue; }
    grep -E "^stacked" "$out/stacked_$mode.log"
    python scripts/elastic_cards.py --compare --mode "$mode" --out "$out" || fail=1
    echo "# $((SECONDS - start)) s"
done
exit $fail
