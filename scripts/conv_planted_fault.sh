#!/usr/bin/env bash
# Shows that chip_smoke.py's phase 17 rejects a conv3x3 kernel whose
# rounding point moved. It copies this checkout into a temporary
# directory, takes the bf16 rounding of the conv's sum out of the copy's
# epilogue (alphazero_torch/csrc/conv_kernels.cu: conv_value returns the
# f32 sum, so the BatchNorm's affine runs on the unrounded sum), runs
# `python3 chip_smoke.py conv` there and prints the phase's verdict.
# Exits 0 only if that run failed on the conv3x3 check.
#
# Needs a CUDA card, as chip_smoke.py does:
#   bash scripts/conv_planted_fault.sh
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
copy=$(mktemp -d)
trap 'rm -rf "$copy"' EXIT
tar -C "$root" --exclude=./build --exclude=./.git \
    -cf - . | tar -C "$copy" -xf -
src="$copy/alphazero_torch/csrc/conv_kernels.cu"
# the conv's output no longer rounded to bf16 before the affine
sed -i -e '/^__device__ __forceinline__ float conv_value(float sum) {$/{n;s/^  return round_bf16(sum);$/  return sum;/}' "$src"
if grep -q '^  return round_bf16(sum);$' "$src" \
        || ! grep -q '^  return sum;$' "$src"; then
    echo "planted fault: the rounding of the conv's sum was not found" >&2
    exit 2
fi
diff "$root/alphazero_torch/csrc/conv_kernels.cu" "$src"
(cd "$copy" && python3 chip_smoke.py conv) > "$copy/run.txt" 2>&1
rc=$?
grep -h "conv3x3 against its plain version" "$copy/run.txt"
if [ "$rc" -ne 0 ] && grep -q "SmokeFailure: conv3x3 against" "$copy/run.txt"; then
    echo "planted fault rejected (chip_smoke.py exit $rc)"
    exit 0
fi
echo "planted fault NOT rejected (chip_smoke.py exit $rc)" >&2
tail -20 "$copy/run.txt" >&2
exit 1
