#!/bin/bash
# The three strength gates of the PyTorch port on the trained archive, on
# one card. The anchor against the baseline (2000 ms a move, a wall-clock
# budget) runs first and alone on the host. Then each asym_match batch
# measures its own int8/bf16 sims/s ratio alone on the card: seed 2026
# runs alone, and both quant_match batches start beside seed 2027's match
# once its ratio is printed; then a captured profile of each evaluator at
# the matches' 32 games (scripts/gate_profiles.py), alone on the card.
# The logs go to the directory given as the
# first argument (default build/gates; this directory keeps a run's logs).
# A second argument `no-anchor` leaves the anchor out (its score does not
# depend on the evaluators' speed). From the root of the repo:
#     bash docs/logs/torch/run_gates.sh [log directory] [no-anchor]
set -u
OUT=${1:-build/gates}
ANCHOR=${2:-anchor}
mkdir -p $OUT
W=artifacts/model_r5_latest.npz
{ nvidia-smi --query-gpu=name,power.limit --format=csv,noheader; date -u
  python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)'
  nproc; } > $OUT/card.txt 2>&1
run() {
  local log=$1; shift
  local t0=$(date +%s.%N)
  { echo "\$ $*"; echo "started $(date -u +%T)"; } > $OUT/$log
  "$@" >> $OUT/$log 2>&1
  local rc=$?
  echo "exit $rc at $(date -u +%T), wall $(python3 -c "print(round($(date +%s.%N) - $t0, 1))") s" >> $OUT/$log
}
[ "$ANCHOR" = no-anchor ] || run vs_baseline.log python3 -m alphazero_torch.strength.vs_baseline $W 20 2000 4
run asym_2026.log env AZTPU_MATCH_SEED=2026 python3 -m alphazero_torch.strength.asym_match $W 16 300 200 --ratio-from-card
run asym_2027.log env AZTPU_MATCH_SEED=2027 python3 -m alphazero_torch.strength.asym_match $W 16 300 200 --ratio-from-card &
A=$!
for i in $(seq 1 900); do grep -q '^ratio ' $OUT/asym_2027.log && break; ! kill -0 $A 2>/dev/null && break; sleep 1; done
run quant_2026.log env AZTPU_MATCH_SEED=2026 python3 -m alphazero_torch.strength.quant_match $W 16 200 &
B=$!
run quant_2027.log env AZTPU_MATCH_SEED=2027 python3 -m alphazero_torch.strength.quant_match $W 16 200 &
C=$!
wait $A $B $C
# a captured 16-simulation profile of each evaluator at the gates' 32 games
run gate_profiles.log python3 scripts/gate_profiles.py $W
for f in $OUT/*.log; do echo "== $f"; grep -v '^game ' $f | tail -n 6; done
cat $OUT/card.txt
