#!/usr/bin/env bash
# Build and run the reference library with the reconstructed driver
# (BASELINE.json config 1: 2^27 uniform keys, msb_64 on CPU).
#
# Requirements: a many-core x86 NUMA host with libnuma-dev (numa.h).
# The reference hard-codes 64 threads (msb_64.c:2266), so this script is
# the *harness* for the anchor measurement, to be run on a suitable CPU
# host; on a small VM without numa.h its number means nothing.
set -euo pipefail

REF=${REF:-/root/reference}
OUT=${OUT:-/tmp/refbench}
LOGN=${1:-27}

mkdir -p "$OUT"
if [ -f /usr/include/numa.h ]; then
    EXTRA_INC=""
    EXTRA_LIB="-lnuma"
else
    # no libnuma on this host: build against the single-node shim
    # (benchmarks/numa_shim/numa.h) — correctness/checksum anchor only
    echo "numa.h not found — using single-node shim (correctness anchor)" >&2
    EXTRA_INC="-I$(dirname "$0")/numa_shim"
    EXTRA_LIB=""
fi
# --wrap=malloc/calloc: sentinel-tail allocator shim working around the
# reference's numa_dest overread (msb_64.c:2168) — see ref_driver.c
gcc -O3 -march=native $EXTRA_INC -I"$REF/include" -I"$REF/src" \
    "$(dirname "$0")/ref_driver.c" "$REF/src/msb_64.c" "$REF/src/rand.c" \
    -o "$OUT/msb_64_bench" -Wl,--wrap=malloc,--wrap=calloc \
    -lpthread $EXTRA_LIB -lm
"$OUT/msb_64_bench" "$LOGN" "${NUMA_NODES:-1}"
