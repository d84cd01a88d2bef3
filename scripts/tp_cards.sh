#!/usr/bin/env bash
# Sharding, the gspmd trainer and --tp on the four cards of one host (NCCL
# over NVLink), one process a card:
#
# 1. the cuda-marked NCCL tests of the sharded paths
#    (tests/test_torch_tp_nccl.py: the gspmd worlds and the TP serving CLI
#    against the same port in one process on card 0);
# 2. the train CLI under gspmd, 4 steps of 2 x 1024 tokens a data rank
#    (a warm-up, 2 timed, the last profiled on rank 0 by --profile: the
#    share of device time in the step's NCCL collectives), remat full:
#    llama3.2-1b at (dp, tp) = (4, 1), (2, 2) and (1, 4); falcon-mamba-7b
#    whole (64 layers) at (4, 1); gemma3-12b whole (48 layers) at (2, 2);
#    then a gspmd checkpoint: llama3.2-1b at (2, 2), 3 steps uninterrupted
#    against 1 step saved (rank 0 writing the global leaves as the ranks
#    gather them) and 2 more resumed from it (each rank reading its blocks),
#    under --schedule const: the resumed steps' losses, grad norms and every
#    rank's final state digest equal the uninterrupted run's bit for bit;
# 3. the serving CLI: qwen2.5-32b paged at --tp 4 against the same command
#    at --tp 1 on one card (tokens compared; at the first differing token
#    of a request the top-2 logit gap of the --tp 1 model, teacher-forced
#    on the common prefix, is reported beside the bf16 spacing of the top
#    logit); mixtral-8x7b whole (32 layers, contiguous llm_decode) and
#    llama4-scout whole (48 layers, paged) at --tp 4.
#
# Every run's log and every rank's record (--summary-json: losses, ms a
# step, tokens/s, the peak memory; TTFT, TPOT, tokens/s and every kernel's
# launches) go to chiprun_out/tp_cards/; a run that fails is reported and
# the others still run (the exit code is then 1).  From the root of the repo:
#
#   bash scripts/tp_cards.sh
set -uo pipefail
cd "$(dirname "$0")/.."
out=chiprun_out/tp_cards
mkdir -p "$out"
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/gpu.txt"
fail=0
start=$SECONDS

timeout -k 10 900 python -m pytest -q -m cuda tests/test_torch_tp_nccl.py \
    > "$out/nccl_tests.log" 2>&1 \
    || { echo "== nccl tests FAILED"; fail=1; }
tail -n 3 "$out/nccl_tests.log"
echo "# $((SECONDS - start)) s"

train() {  # tag arch dp tp seconds
    local tag=$1 arch=$2 dp=$3 tp=$4 limit=$5
    timeout -k 10 "$limit" python -m torch.distributed.run --standalone --nproc-per-node $((dp * tp)) \
        -m repro_torch.launch.train --arch "$arch" --steps 4 --batch $((2 * dp)) --seq 1024 \
        --dp "$dp" --tp "$tp" --remat full --profile \
        --summary-json "$out/train_${tag}_rank{rank}.json" > "$out/train_$tag.log" 2>&1 \
        || { echo "== $tag FAILED"; tail -c 3000 "$out/train_$tag.log"; fail=1; return 0; }
    echo "== $tag"
    grep -E "^(train|step|profiled|peak)" "$out/train_$tag.log"
    echo "# $((SECONDS - start)) s"
}

serve() {  # tag ranks seconds args...
    local tag=$1 n=$2 limit=$3
    shift 3
    timeout -k 10 "$limit" python -m torch.distributed.run --standalone --nproc-per-node "$n" \
        -m repro_torch.launch.serve "$@" \
        --summary-json "$out/serve_${tag}_rank{rank}.json" > "$out/serve_$tag.log" 2>&1 \
        || { echo "== $tag FAILED"; tail -c 3000 "$out/serve_$tag.log"; fail=1; return 0; }
    echo "== $tag"
    grep -vE "Warning|warn|^\s*$|^\*+$|OMP_NUM|Setting OMP" "$out/serve_$tag.log" | tail -n 8
    echo "# $((SECONDS - start)) s"
}

train llama_dp4 llama3.2-1b 4 1 240
train llama_dp2_tp2 llama3.2-1b 2 2 240
train llama_tp4 llama3.2-1b 1 4 240
train falcon_dp4 falcon-mamba-7b 4 1 420
train gemma3_dp2_tp2 gemma3-12b 2 2 420

ckpt_gspmd() {  # the (2, 2) gspmd world saved after step 1 and resumed
    local run=(python -m torch.distributed.run --standalone --nproc-per-node 4
               -m repro_torch.launch.train --arch llama3.2-1b --batch 4 --seq 1024 --dp 2
               --tp 2 --remat full --schedule const)
    rm -rf "$out/ckpt_gspmd"
    timeout -k 10 240 "${run[@]}" --steps 3 --summary-json "$out/ckpt_full_rank{rank}.json" \
        > "$out/ckpt_full.log" 2>&1 \
        && timeout -k 10 240 "${run[@]}" --steps 1 --ckpt-dir "$out/ckpt_gspmd" \
            > "$out/ckpt_first.log" 2>&1 \
        && timeout -k 10 240 "${run[@]}" --steps 2 --ckpt-dir "$out/ckpt_gspmd" \
            --summary-json "$out/ckpt_resumed_rank{rank}.json" > "$out/ckpt_resumed.log" 2>&1 \
        && python - "$out" <<'EOF'
import json, sys
out = sys.argv[1]
same = True
for r in range(4):
    full = json.load(open(f"{out}/ckpt_full_rank{r}.json"))
    res = json.load(open(f"{out}/ckpt_resumed_rank{r}.json"))
    ok = (res["resumed_from"] == 1 and res["losses"] == full["losses"][1:]
          and res["grad_norms"] == full["grad_norms"][1:]
          and res["state_digest"] == full["state_digest"])
    print(f"rank {r}: resumed from {res['resumed_from']}, losses {res['losses']} against "
          f"{full['losses'][1:]}, digest equal {res['state_digest'] == full['state_digest']}")
    same = same and ok
print("gspmd checkpoint resumed bit for bit:", same)
sys.exit(0 if same else 1)
EOF
}
ckpt_gspmd > "$out/ckpt_gspmd.log" 2>&1 || { echo "== ckpt_gspmd FAILED"; fail=1; }
echo "== ckpt_gspmd"; tail -n 6 "$out/ckpt_gspmd.log"
rm -rf "$out/ckpt_gspmd"  # its archive: not brought back
echo "# $((SECONDS - start)) s"

QWEN=(--arch qwen2.5-32b --continuous --workload llm_decode_paged --attn kernel --dp 5
      --slots 8 --requests 16 --min-prompt-len 128 --prompt-len 1024 --gen 32
      --max-len 1056 --block-size 16)
serve qwen_tp4 4 420 "${QWEN[@]}" --tp 4
# the same command on one card, then the tokens compared
qwen_tp1() {
CUDA_VISIBLE_DEVICES=0 python - "$out" "$@" <<'EOF'
import json, sys
import numpy as np
import torch
from repro_torch.launch import serve as cli
from repro_torch.models import transformer

out, argv = sys.argv[1], sys.argv[2:]
eng = cli.main(argv + ["--summary-json", f"{out}/serve_qwen_tp1_rank{{rank}}.json"])
tp4 = json.load(open(f"{out}/serve_qwen_tp4_rank0.json"))["results"]
args = cli.build_parser().parse_args(argv)
cfg = eng.workload.cfg
reqs = {r.id: r for r in cli.make_requests(cfg, args.requests, args.prompt_len, args.gen,
                                           args.seed, args.min_prompt_len)}
report = {"requests": len(eng.results), "equal": 0, "differ": []}
for i, r in sorted(eng.results.items()):
    a, b = [int(t) for t in np.asarray(r.output)], tp4[str(i)][0]
    if a == b:
        report["equal"] += 1
        continue
    pos = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), min(len(a), len(b)))
    seq = np.concatenate([reqs[i].prompt, np.asarray(a[:pos], np.int32)])
    with torch.no_grad():
        logits = transformer.forward_last_logits(
            eng.workload.params, torch.as_tensor(seq, device="cuda")[None].long(), cfg)[0]
    top = torch.topk(logits.float(), 2)
    gap = float(top.values[0] - top.values[1])
    spacing = float(abs(top.values[0])) * 2.0 ** -7  # bf16's spacing at the top logit
    report["differ"].append({"request": i, "position": pos, "tp1": a[pos] if pos < len(a)
                             else None, "tp4": b[pos] if pos < len(b) else None,
                             "top2": top.indices.tolist(), "gap": gap, "bf16_spacing": spacing,
                             "within_bf16": gap <= 2 * spacing})
json.dump(report, open(f"{out}/qwen_tp4_vs_tp1.json", "w"), indent=1)
print("qwen tp4 vs tp1:", json.dumps(report))
ok = all(d["within_bf16"] for d in report["differ"])
sys.exit(0 if ok else 1)
EOF
}
export -f qwen_tp1
export out
timeout -k 10 420 bash -c 'qwen_tp1 "$@"' _ "${QWEN[@]}" > "$out/serve_qwen_tp1.log" 2>&1 \
    || { echo "== qwen_tp1 FAILED"; tail -c 3000 "$out/serve_qwen_tp1.log"; fail=1; }
echo "== qwen_tp1"; tail -n 4 "$out/serve_qwen_tp1.log"
echo "# $((SECONDS - start)) s"

serve mixtral_tp4 4 420 --arch mixtral-8x7b --continuous --workload llm_decode --dp 3 --slots 4 \
    --requests 8 --min-prompt-len 4096 --prompt-len 6144 --gen 32 --tp 4
serve llama4_tp4 4 540 --arch llama4-scout-17b-a16e --continuous --workload llm_decode_paged \
    --attn kernel --dp 5 --slots 8 --requests 8 --min-prompt-len 128 --prompt-len 1024 \
    --gen 32 --max-len 1056 --block-size 16 --tp 4

python - "$out" <<'EOF'
import glob, json, os, sys
out = sys.argv[1]
rows = {}
for path in sorted(glob.glob(f"{out}/*_rank*.json")):
    tag, rank = os.path.basename(path)[:-5].rsplit("_rank", 1)
    rec = json.load(open(path))
    row = rows.setdefault(tag, {"peak_gib": {}})
    if rec.get("peak_bytes") is not None:
        row["peak_gib"][rank] = round(rec["peak_bytes"] / 2**30, 3)
    if rank != "0":
        continue
    if "losses" in rec:
        row.update(losses=rec["losses"], ms_per_step=rec["ms_per_step"],
                   tokens_per_s=rec["tokens_per_s"], profile=rec.get("profile"),
                   mrd_combine_launches=rec["mrd_combine_launches"])
    else:
        s = rec["summary"]
        row.update({k: s.get(k) for k in ("completed", "ticks", "throughput_tok_s",
                                          "ttft_p50_ms", "tpot_p50_ms", "wall_s")},
                   launches=rec["launches"])
json.dump(rows, open(f"{out}/summary.json", "w"), indent=1)
print(json.dumps(rows))
EOF
echo "# total $((SECONDS - start)) s"
exit $fail
