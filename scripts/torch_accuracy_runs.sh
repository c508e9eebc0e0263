#!/usr/bin/env bash
# The port's train-to-accuracy runs on one card, each through its entry with the recipe's
# defaults but the knobs below (the JAX package's records: docs/digits_accuracy.json,
# docs/records_accuracy.json, docs/lm_ppl.json); the log, logfile and summary.json of each
# under OUT (the first argument, default runs/accuracy), the wall of each run on stdout; the
# corpora and the checkpoints under build/acc. Run from the repository's root:
#   bash scripts/torch_accuracy_runs.sh [OUT]
# The LM leg alone is `python3 scripts/torch_lm_accuracy.py OUT`.
set -u
OUT="${1:-runs/accuracy}"
mkdir -p "$OUT" build/acc
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
t0=$(date +%s.%N)
DIGITS_DIR=build/acc/digits EPOCHS=150 BATCH=128 SAVE_DIR=build/acc/digits_run \
  python3 -m distributed_training_pytorch_tpu_torch.examples.train_digits > "$OUT/digits.log" 2>&1
rc1=$?
t1=$(date +%s.%N)
echo "train_digits rc=$rc1 wall $(python3 -c "print(round($t1 - $t0, 1))") s"
cp build/acc/digits_run/summary.json "$OUT/digits_summary.json"
cp build/acc/digits_run/logfile.log "$OUT/digits_logfile.log"
DIGITS_DIR=build/acc/digits EPOCHS=100 BATCH=128 RECORDS_LR=0.08 SAVE_DIR=build/acc/records_run \
  python3 -m distributed_training_pytorch_tpu_torch.examples.train_records > "$OUT/records.log" 2>&1
rc2=$?
t2=$(date +%s.%N)
echo "train_records rc=$rc2 wall $(python3 -c "print(round($t2 - $t1, 1))") s"
cp build/acc/records_run/summary.json "$OUT/records_summary.json"
cp build/acc/records_run/logfile.log "$OUT/records_logfile.log"
OUT="$OUT" python3 - <<'PY'
import json, os
out = os.environ["OUT"]
for name in ("digits", "records"):
    s = json.load(open(f"{out}/{name}_summary.json"))
    curve = {c["epoch"]: c for c in s["curve"]}
    print(name, s["results"], {e: curve.get(e) for e in (1, 10, 25, 50, 100, 150)})
PY
# make_lm_corpus (24 MB), train_lm at docs/lm_ppl.json's knobs, eval_lm on best: OUT/torch_lm_ppl.json
python3 scripts/torch_lm_accuracy.py "$OUT" > "$OUT/lm.log" 2>&1
rc3=$?
t3=$(date +%s.%N)
echo "lm rc=$rc3 wall $(python3 -c "print(round($t3 - $t2, 1))") s"
cp build/acc/lm_run/logfile.log "$OUT/lm_logfile.log"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
exit $(( rc1 || rc2 || rc3 ))
