#!/bin/bash
# Time variants of the window-field kernel (csrc/window_field.cu) on one GPU,
# without PyTorch. From the repository root, on a machine with nvcc:
#
#   scripts/tune_window_field.sh NAME[@FILE]:SED ...
#
# Each argument is one variant: FILE (default: the repository's
# slam2d_tpu_torch/csrc/window_field.cu) with the sed -z -E expression SED
# applied ("s/XXXX//" changes nothing), built with scripts/tune_window_field.cu
# and timed twice, in the order given and then again. Examples:
#
#   "base:s/XXXX//"
#   "stages2:s/constexpr int STAGES = 3;/constexpr int STAGES = 2;/"
#   "old@/tmp/parent_window_field.cu:s/XXXX//"
#
# Variants that drop work to see what it costs (no stores, FMAs for the
# rounded products and sums) print another checksum: they are timings, not
# candidates. At the end the first variant runs for a few seconds while
# nvidia-smi samples the SM clock and the power beside it.
set -u
SRC=slam2d_tpu_torch/csrc
NVCC=${CUDA_HOME:-/usr/local/cuda}/bin/nvcc
TMP=$(mktemp -d)
names=()
n=0
for spec in "$@"; do
  head="${spec%%:*}"; expr="${spec#*:}"
  name="${head%%@*}"; file="$SRC/window_field.cu"
  [[ "$head" == *@* ]] && file="${head#*@}"
  names+=("$name")
  sed -z -E "$expr" "$file" > "$TMP/$name.cu"
  ( "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -I$SRC \
      -DVARIANT_FILE="\"$TMP/$name.cu\"" -o "$TMP/$name" \
      scripts/tune_window_field.cu 2>&1 | grep -iE "error" | head -5 ) &
  n=$((n + 1)); (( n % 8 == 0 )) && wait
done
wait
for round in 1 2; do
  for name in "${names[@]}"; do [ -x "$TMP/$name" ] && "$TMP/$name" "$name"; done
done
nvidia-smi --query-gpu=clocks.sm,power.draw --format=csv,noheader -lms 100 \
  > "$TMP/clocks.txt" &
smi=$!
sleep 0.5; "$TMP/${names[0]}" "${names[0]}" 12000 | grep launches; kill $smi
echo "SM clock and power while it ran (count, values):"
sort "$TMP/clocks.txt" | uniq -c | sort -rn | head -4
rm -rf "$TMP"
