#!/usr/bin/env bash
# The elastic trainer on the four cards of one host (NCCL over NVLink), one
# process a card, llama3.2-1b at full width under grow_on_join, batches of
# 12 x 1024 tokens.  Logs and each rank's record go to
# chiprun_out/elastic_cards/; the exit code is 1 if a run fails or differs.
# From the root of the repo:
#
#   bash scripts/elastic_cards.sh          # every part
#   bash scripts/elastic_cards.sh stacked  # the ("data",) worlds against the stacked rows
#   bash scripts/elastic_cards.sh tp       # gspmd and the (data, model) worlds
#   bash scripts/elastic_cards.sh ckpt     # a (2, 2) gspmd world checkpointed and resumed
#
# stacked: cut to 8 layers (the stacked run holds every rank's rows on one
# card), ranks 0-3 under the script --kill 2:1 --join 4:1 (4 -> 3 at step 2,
# back to 4 at step 4, the killed rank joining again), 6 steps, under
# compressed (device_fused: mrd_combine combines in the step) and mrd_zero1;
# each live rank's losses and final state digest must equal the stacked
# trainer's row (scripts/elastic_cards.py --compare).
#
# tp: gspmd at (4, 1) under the same script (4 -> 3 -> 4, the FSDP blocks
# re-sharded at each resize), 6 steps; gspmd, mrd_zero1 and compressed
# (device_fused: mrd_combine in the step) at (2, 2) under
# --kill 2:1 --join 4:0,1 (rank 1's failure drops its slice, (2, 2) ->
# (1, 2), and the two rejoin, back to (2, 2)), 6 steps.
#
# ckpt: a gspmd (2, 2) world cut to 2 layers under that script, run 8 steps
# in one go, and 6 steps checkpointed every 3 (a save at (1, 2) and one at
# (2, 2)) followed by a world that recovers the last checkpoint on the
# mesh it was saved at and runs 2 more steps: its losses and final digests
# must equal the uninterrupted run's (--compare --tp 2); records in
# chiprun_out/elastic_cards/ckpt/.  A world that runs past 200 s is
# stopped and counts as failed.
set -uo pipefail
cd "$(dirname "$0")/.."
out=chiprun_out/elastic_cards
mkdir -p "$out"
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/gpu.txt"
part=${1:-all}
fail=0
start=$SECONDS
WORLD=(python -m torch.distributed.run --standalone --nproc-per-node 4 scripts/elastic_cards.py)

world() {  # world <log name> <args...>: one world run, its summary line printed
    local name=$1
    shift
    timeout -k 10 200 "${WORLD[@]}" --out "$out" "$@" > "$out/world_$name.log" 2>&1 \
        || { echo "== world $name FAILED"; tail -c 3000 "$out/world_$name.log"; fail=1;
             return 1; }
    grep -E "^world" "$out/world_$name.log"
    echo "# $((SECONDS - start)) s"
}

if [ "$part" = all ] || [ "$part" = stacked ]; then
    ARGS=(--layers 8 --steps 6 --batch 12 --seq 1024 --out "$out")
    for mode in compressed mrd_zero1; do
        world "$mode" --grad-sync "$mode" "${ARGS[@]}" || continue
        CUDA_VISIBLE_DEVICES=0 timeout -k 10 600 python scripts/elastic_cards.py --stacked \
            --grad-sync "$mode" "${ARGS[@]}" > "$out/stacked_$mode.log" 2>&1 \
            || { echo "== stacked $mode FAILED"; tail -c 3000 "$out/stacked_$mode.log"; fail=1;
                 continue; }
        grep -E "^stacked" "$out/stacked_$mode.log"
        python scripts/elastic_cards.py --compare --grad-sync "$mode" --out "$out" || fail=1
        echo "# $((SECONDS - start)) s"
    done
fi

if [ "$part" = all ] || [ "$part" = tp ]; then
    TP=(--steps 6 --batch 12 --seq 1024)
    world gspmd_tp1 --grad-sync gspmd "${TP[@]}"
    for mode in gspmd mrd_zero1 compressed; do
        world "${mode}_tp2" --grad-sync "$mode" --tp 2 --kill 2:1 --join 4:0,1 "${TP[@]}"
    done
fi

if [ "$part" = all ] || [ "$part" = ckpt ]; then
    CK=(--grad-sync gspmd --tp 2 --layers 2 --batch 12 --seq 1024)
    ck=build/elastic_cards_ck
    rm -rf "$ck"
    world gspmd_tp2_full "${CK[@]}" --kill 2:1 --join 4:0,1 --steps 8 --out "$out/ckpt" \
        && world gspmd_tp2_ckpt "${CK[@]}" --kill 2:1 --join 4:0,1 --steps 6 --ckpt-dir "$ck" \
            --out "$out/ckpt" \
        && world gspmd_tp2_resume "${CK[@]}" --steps 2 --ckpt-dir "$ck" --resume \
            --out "$out/ckpt" \
        && { python scripts/elastic_cards.py --compare --grad-sync gspmd --tp 2 \
                 --out "$out/ckpt" || fail=1; }
    rm -rf "$ck"
fi
exit $fail
