#!/usr/bin/env bash
# The MRD grad-sync modes at tp > 1 and the ready-bucket overlap on the four
# cards of one host (NCCL over NVLink), one process a card:
#
# 1. the cuda-marked NCCL tests of the new paths
#    (tests/test_torch_mrd_tp_nccl.py: every MRD mode's (2, 2) world held to
#    the stacked-rows step on card 0, the replicated leaves across model
#    ranks, a checkpoint resumed, --overlap against --no-overlap in worlds
#    of (4,) and (2, 2));
# 2. the train CLI (train.train(), the runs of one world in one
#    torch.distributed.run that joins the world once), 4 steps of 2 x 1024
#    tokens a data rank (a warm-up, 2 timed, the last profiled on rank 0 by
#    --profile: device busy, NCCL's share, the NCCL time that ran beside
#    other kernels), remat full:
#    llama3.2-1b whole at (2, 2) under mrd_zero1, compressed, mrd_paper,
#    mrd_leaf and local_sgd; llama3.2-1b at (4, 1) and (2, 2) under
#    mrd_zero1 and compressed with --overlap and --no-overlap (each pair's
#    losses and every rank's state digest compared: bit for bit);
#    falcon-mamba-7b whole (64 layers) at (2, 2) under mrd_zero1, and under
#    compressed cut to FALCON_CUT_LAYERS (48) layers.
#
# Memory by arithmetic, falcon-mamba-7b at (2, 2) (7.27e9 parameters, a
# rank holds half of every TP-sharded leaf and a quarter of the ZeRO-1
# rows): bf16 params 7.3 GB, fp32 master/mu/nu rows 21.8 GB, fp32 gradient
# buckets 14.6 GB (while the bf16 gradients, 7.3 GB, are packed), the
# all-gathered bf16 params beside the old ones 7.3 GB: ~58 GB before
# activations under mrd_zero1; compressed adds the EF residual, a whole
# local fp32 vector, 14.6 GB: ~73 GB at 64 layers, too close to 80 GB with
# the activations, so it runs at 48 layers (5.71e9 parameters: ~57 GB).
#
# Every run's log and every rank's record (--summary-json: losses, ms a
# step, tokens/s, peak memory, the profile, mrd_combine's launches, the
# state digest) go to chiprun_out/mrd_tp_cards/; a run that fails is
# reported and the others still run (the exit code is then 1).  From the
# root of the repo:
#
#   bash scripts/mrd_tp_cards.sh
set -uo pipefail
cd "$(dirname "$0")/.."
out=chiprun_out/mrd_tp_cards
mkdir -p "$out"
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}
export PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True
FALCON_CUT_LAYERS=48
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/gpu.txt"
fail=0
start=$SECONDS

timeout -k 10 900 python -m pytest -q -m cuda tests/test_torch_mrd_tp_nccl.py \
    > "$out/nccl_tests.log" 2>&1 \
    || { echo "== nccl tests FAILED"; fail=1; }
tail -n 3 "$out/nccl_tests.log"
echo "# $((SECONDS - start)) s"

# the train CLI's runs of one world in one torch.distributed.run: the world
# joined once, then train.train() a run, each with its own --summary-json;
# a run's "layers" cuts the registry's config of its --arch to that depth
cat > "$out/train_runs.py" <<'EOF'
import json, sys
from unittest import mock

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch import train

runs = json.loads(sys.argv[1])
device, mesh = train.init_world(train.build_parser().parse_args(runs[0]["argv"]),
                                train.world_env())
try:
    for run in runs:
        args = train.build_parser().parse_args(run["argv"])
        cut = {}
        if run.get("layers"):
            cut = {args.arch: registry.override(registry.get_config(args.arch),
                                                n_layers=run["layers"])}
        torch.cuda.reset_peak_memory_stats(device)
        with mock.patch.dict(registry._FULL, cut):
            train.train(args, device, mesh)
        torch.cuda.empty_cache()
finally:
    dist.destroy_process_group()
EOF

world() {  # name dp tp seconds run... (a run: tag:arch:mode:layers-or-0:extra CLI flag)
    local name=$1 dp=$2 tp=$3 limit=$4
    shift 4
    local runs
    runs=$(python - "$out" "$dp" "$tp" "$@" <<'EOF'
import json, sys
out, dp, tp, specs = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4:]
runs = []
for spec in specs:
    tag, arch, mode, layers, flag = spec.split(":")
    runs.append({"layers": int(layers), "argv": [
        "--arch", arch, "--steps", "4", "--batch", str(2 * dp), "--seq", "1024",
        "--dp", str(dp), "--tp", str(tp), "--grad-sync", mode, "--remat", "full", "--profile",
        flag, "--summary-json", f"{out}/train_{tag}_rank{{rank}}.json"]})
print(json.dumps(runs))
EOF
)
    timeout -k 10 "$limit" python -m torch.distributed.run --standalone \
        --nproc-per-node $((dp * tp)) "$out/train_runs.py" "$runs" > "$out/world_$name.log" 2>&1 \
        || { echo "== $name FAILED"; tail -c 3000 "$out/world_$name.log"; fail=1; }
    echo "== $name"
    grep -E "^(train|step|profiled|peak)" "$out/world_$name.log"
    echo "# $((SECONDS - start)) s"
}

world llama_dp2_tp2 2 2 600 \
    llama_dp2_tp2_mrd_zero1:llama3.2-1b:mrd_zero1:0:--no-overlap \
    llama_dp2_tp2_compressed:llama3.2-1b:compressed:0:--no-overlap \
    llama_dp2_tp2_mrd_paper:llama3.2-1b:mrd_paper:0:--no-overlap \
    llama_dp2_tp2_mrd_leaf:llama3.2-1b:mrd_leaf:0:--no-overlap \
    llama_dp2_tp2_local_sgd:llama3.2-1b:local_sgd:0:--no-overlap \
    llama_dp2_tp2_mrd_zero1_overlap:llama3.2-1b:mrd_zero1:0:--overlap \
    llama_dp2_tp2_compressed_overlap:llama3.2-1b:compressed:0:--overlap
world llama_dp4 4 1 420 \
    llama_dp4_mrd_zero1:llama3.2-1b:mrd_zero1:0:--no-overlap \
    llama_dp4_mrd_zero1_overlap:llama3.2-1b:mrd_zero1:0:--overlap \
    llama_dp4_compressed:llama3.2-1b:compressed:0:--no-overlap \
    llama_dp4_compressed_overlap:llama3.2-1b:compressed:0:--overlap
world falcon_dp2_tp2_mrd_zero1 2 2 600 \
    falcon_dp2_tp2_mrd_zero1:falcon-mamba-7b:mrd_zero1:0:--no-overlap
world falcon_dp2_tp2_compressed 2 2 600 \
    "falcon_dp2_tp2_compressed:falcon-mamba-7b:compressed:$FALCON_CUT_LAYERS:--no-overlap"

python - "$out" <<'EOF'
import glob, json, os, sys
out = sys.argv[1]
rows, digests = {}, {}
for path in sorted(glob.glob(f"{out}/train_*_rank*.json")):
    tag, rank = os.path.basename(path)[len("train_"):-5].rsplit("_rank", 1)
    rec = json.load(open(path))
    row = rows.setdefault(tag, {"peak_gib": {}})
    if rec.get("peak_bytes") is not None:
        row["peak_gib"][rank] = round(rec["peak_bytes"] / 2**30, 3)
    digests.setdefault(tag, {})[rank] = rec["state_digest"]
    if rank == "0":
        row.update(losses=rec["losses"], grad_norms=rec["grad_norms"],
                   ms_per_step=rec["ms_per_step"], tokens_per_s=rec["tokens_per_s"],
                   profile=rec.get("profile"), mrd_combine_launches=rec["mrd_combine_launches"])
pairs, ok = {}, True
for tag in rows:
    if not tag.endswith("_overlap"):
        continue
    base = tag[:-len("_overlap")]
    if base not in rows:
        pairs[tag] = "no --no-overlap run"
        ok = False
        continue
    same = (rows[tag]["losses"] == rows[base]["losses"]
            and rows[tag]["grad_norms"] == rows[base]["grad_norms"]
            and digests[tag] == digests[base])
    pairs[tag] = same
    ok = ok and same
json.dump({"runs": rows, "overlap_bit_for_bit": pairs}, open(f"{out}/summary.json", "w"),
          indent=1)
print(json.dumps({"runs": rows, "overlap_bit_for_bit": pairs}))
sys.exit(0 if ok else 1)
EOF
[[ $? -eq 0 ]] || { echo "== overlap pairs differ"; fail=1; }
echo "# total $((SECONDS - start)) s"
exit $fail
