#!/bin/bash
# Time variants of one of the port's kernels on one GPU, without PyTorch.
# From the repository root, on a machine with nvcc:
#
#   scripts/tune_kernel.sh KERNEL NAME[@FILE]:SED ...
#
# KERNEL is window_field, shared_apply, update_ray, update_ism, score, corr,
# update_hybrid, search_space or refine_product: the harness scripts/tune_KERNEL.cu includes the kernel
# source and times it at its main path's shapes. Each further argument is one variant: FILE (default:
# the repository's slam2d_tpu_torch/csrc/KERNEL.cu) with the sed -z -E
# expression SED applied ("s/XXXX//" changes nothing), built and timed
# twice, in the order given and then again. Examples:
#
#   scripts/tune_kernel.sh shared_apply "base:s/XXXX//" \
#       "band64:s/BAND = 32;/BAND = 64;/" "old@/tmp/old_shared_apply.cu:s/XXXX//"
#
# The build prints each kernel's registers and stack frame (ptxas -v). The
# harness prints a checksum of what the kernel wrote: two variants that
# compute the same thing print the same checksum; a variant that drops work
# to see what it costs prints another (a timing, not a candidate). At the
# end the first variant runs for a few seconds while nvidia-smi samples the
# SM clock and the power beside it.
set -u
KERNEL=$1
shift
SRC=slam2d_tpu_torch/csrc
NVCC=${CUDA_HOME:-/usr/local/cuda}/bin/nvcc
TMP=$(mktemp -d)
names=()
n=0
for spec in "$@"; do
  head="${spec%%:*}"; expr="${spec#*:}"
  name="${head%%@*}"; file="$SRC/$KERNEL.cu"
  [[ "$head" == *@* ]] && file="${head#*@}"
  names+=("$name")
  sed -z -E "$expr" "$file" > "$TMP/$name.cu"
  ( "$NVCC" -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -I$SRC \
      -Xptxas -v -DVARIANT_FILE="\"$TMP/$name.cu\"" -o "$TMP/$name" \
      "scripts/tune_$KERNEL.cu" 2>&1 | grep -iE "error|entry|registers|stack" \
      | grep -vE "checksum|fill" | cut -c1-160 | sed "s/^/$name: /" | head -24 ) &
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
