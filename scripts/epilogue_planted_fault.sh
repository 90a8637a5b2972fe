#!/usr/bin/env bash
# Shows that chip_smoke.py's phase 16 rejects a se_residual kernel whose
# rounding points moved. It copies this checkout into a temporary
# directory, takes the bf16 rounding of y * gate out of the copy's
# se_residual_kernel (alphazero_torch/csrc/epilogue_kernels.cu: y * gate +
# shift becomes one fused operation, rounded once), runs
# `python3 chip_smoke.py epilogue` there and prints the phase's verdict.
# Exits 0 only if that run failed on the se_residual check.
#
# Needs a CUDA card, as chip_smoke.py does:
#   bash scripts/epilogue_planted_fault.sh
set -u
root=$(cd "$(dirname "$0")/.." && pwd)
copy=$(mktemp -d)
trap 'rm -rf "$copy"' EXIT
tar -C "$root" --exclude=./build --exclude=./chiprun_out --exclude=./.git \
    -cf - . | tar -C "$copy" -xf -
src="$copy/alphazero_torch/csrc/epilogue_kernels.cu"
# y * gate + shift as one fused bf16x2 operation, rounded once: the
# product is no longer rounded on its own
sed -i -e 's/bf2_add(bf2_mul(yw\[q\], gw\[q\]), sw\[q\])/bf2_fma(yw[q], gw[q], sw[q])/' \
    -e 's/^\/\/ torch.relu.s, lane by lane: NaN stays NaN$/__device__ __forceinline__ uint32_t bf2_fma(uint32_t a, uint32_t b, uint32_t c) {\n  uint32_t d;\n  asm("fma.rn.bf16x2 %0, %1, %2, %3;\\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));\n  return d;\n}\n\n&/' "$src"
if ! grep -q 'bf2_fma(yw\[q\], gw\[q\], sw\[q\])' "$src" \
        || ! grep -q 'fma.rn.bf16x2' "$src"; then
    echo "planted fault: the rounding of y * gate was not found" >&2
    exit 2
fi
diff "$root/alphazero_torch/csrc/epilogue_kernels.cu" "$src"
(cd "$copy" && python3 chip_smoke.py epilogue) > "$copy/run.txt" 2>&1
rc=$?
grep -h "se_residual against its plain version" "$copy/run.txt"
if [ "$rc" -ne 0 ] && grep -q "SmokeFailure: se_residual against" "$copy/run.txt"; then
    echo "planted fault rejected (chip_smoke.py exit $rc)"
    exit 0
fi
echo "planted fault NOT rejected (chip_smoke.py exit $rc)" >&2
tail -20 "$copy/run.txt" >&2
exit 1
