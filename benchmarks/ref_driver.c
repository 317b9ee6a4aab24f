/* Reconstructed benchmark driver for the reference library.
 *
 * The reference repo's Makefile names driver sources (benchmark_msb_64.c,
 * init.c, zipf.c, shuffle.c — /root/reference/Makefile:20-21) that are
 * absent; this re-creates the minimum: generate uniform uint64 keys with
 * the library's own MT19937-64, call sort() with the mandatory 64 threads
 * (msb_64.c:2266), verify with check(), print keys/sec and the 10-row
 * phase report.
 *
 * Build via benchmarks/baseline_reference.sh (links against the reference
 * sources in-place; nothing is copied into this repository).
 *
 * NOTE: needs a many-core NUMA host; on a small VM the 64-thread
 * requirement makes the number meaningless — run on a real CPU host for
 * the BASELINE.json config-1 anchor.
 */
#include <stdio.h>
#include <stdlib.h>
#include <stdint.h>
#include <string.h>
#include <time.h>
#include <signal.h>
#include <execinfo.h>
#include <unistd.h>
#include "msb_64.h"
#include "rand.h"

/* check() is implemented but not declared in the public header
 * (msb_64.c:2470-2505); an implicit declaration would truncate the
 * returned 64-bit checksum. */
uint64_t check(uint64_t **keys, uint64_t **rids, uint64_t *size,
               int numa, int same);

/* Upstream bug mitigation (found via ASAN on this harness): the
 * per-node partition scan `for (; d->numa_dest[p] == numa_node ; ++p);`
 * (msb_64.c:2168) runs one past the 128-entry numa_dest array for the
 * LAST numa node; whether it stops depends on the heap bytes after the
 * malloc'd block (glibc chunk header usually != 0, so upstream survives
 * by luck; on this box it intermittently reads 0 and runs wild, crashing
 * in inject()).  Linked with -Wl,--wrap=malloc,--wrap=calloc, every
 * allocation gets a 64-byte 0xFF sentinel tail, making the overread
 * deterministic and harmless without touching the reference sources. */
void *__real_malloc(size_t n);
void *__real_calloc(size_t n, size_t m);
void *__wrap_malloc(size_t n) {
    char *p = __real_malloc(n + 64);
    if (p) memset(p + n, 0xFF, 64);
    return p;
}
void *__wrap_calloc(size_t n, size_t m) {
    size_t bytes = n * m;
    char *p = __real_malloc(bytes + 64);
    if (!p) return NULL;
    memset(p, 0, bytes);
    memset(p + bytes, 0xFF, 64);
    return p;
}

static double now_sec(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + ts.tv_nsec * 1e-9;
}

/* On SIGSEGV, print a raw backtrace (addresses resolvable via
 * addr2line) — this box has no debugger. */
static void segv_handler(int sig) {
    static const char msg[] = "=== SIGSEGV backtrace ===\n";
    ssize_t r = write(2, msg, sizeof(msg) - 1);
    void *bt[32];
    int n = backtrace(bt, 32);
    backtrace_symbols_fd(bt, n, 2);
    _exit(139);
    (void)sig; (void)r;
}

int main(int argc, char **argv) {
    {   /* pre-load libgcc so backtrace() is async-safe later */
        void *bt[2];
        backtrace(bt, 2);
    }
    signal(SIGSEGV, segv_handler);
    signal(SIGBUS, segv_handler);
    uint64_t log_n = argc > 1 ? strtoull(argv[1], 0, 10) : 27;
    int numa_nodes = argc > 2 ? atoi(argv[2]) : 1;
    uint64_t total_pre = 1ull << (argc > 1 ? strtoull(argv[1], 0, 10) : 27);
    /* fudge must cover 1 + numa_blocks + threads_per_numa*range_partitions
     * exchange blocks plus combine-phase fresh-block appends
     * (msb_64.c:1574-1578, 1722-1745): scale the slack with 1/n. */
    double fudge = 1.1 + (64.0 * 128 * 4096 * 1.3) / total_pre;
    if (fudge < 1.3) fudge = 1.3;
    uint64_t total = 1ull << log_n;

    uint64_t **keys = malloc(numa_nodes * sizeof(uint64_t *));
    uint64_t **rids = malloc(numa_nodes * sizeof(uint64_t *));
    uint64_t *size = malloc(numa_nodes * sizeof(uint64_t));
    rand64_t *gen = rand64_init(42);
    uint64_t checksum_in = 0;
    /* REF_INPUT=<path>: read the key multiset from a binary u64 file
     * (e.g. a Zipfian stream dumped by the device-side generator) instead
     * of the built-in MT19937-64 stream — the skewed-input parity row
     * of BASELINE config 1. */
    const char *inpath = getenv("REF_INPUT");
    FILE *inf = NULL;
    if (inpath) {
        inf = fopen(inpath, "rb");
        if (!inf) { perror(inpath); return 2; }
    }
    for (int nnode = 0; nnode < numa_nodes; ++nnode) {
        size[nnode] = total / numa_nodes;
        size_t cap = (size_t)(size[nnode] * fudge) + 4096;
        keys[nnode] = mamalloc(cap * sizeof(uint64_t));
        rids[nnode] = mamalloc(cap * sizeof(uint64_t));
        if (inf) {
            size_t got = fread(keys[nnode], sizeof(uint64_t),
                               size[nnode], inf);
            if (got != size[nnode]) {
                fprintf(stderr, "short read from %s\n", inpath);
                return 2;
            }
            for (uint64_t i = 0; i < size[nnode]; ++i) {
                rids[nnode][i] = keys[nnode][i];
                checksum_in += keys[nnode][i];
            }
        } else for (uint64_t i = 0; i < size[nnode]; ++i) {
            uint64_t k = rand64_next(gen);
            keys[nnode][i] = k;
            rids[nnode][i] = k; /* check(same=1) mode, msb_64.c:2461 */
            checksum_in += k;
        }
    }
    if (inf) fclose(inf);

    char *desc[16];
    uint64_t times[16];
    double t0 = now_sec();
    sort(keys, rids, size, 64, numa_nodes, fudge, desc, times);
    double dt = now_sec() - t0;

    uint64_t checksum_out = check(keys, rids, size, numa_nodes, 1);
    printf("sorted %llu keys in %.3f s = %.3f Mkeys/s  checksum %s\n",
           (unsigned long long)total, dt, total / dt / 1e6,
           checksum_in == checksum_out ? "OK" : "MISMATCH");
    printf("checksum_in %llu checksum_out %llu\n",
           (unsigned long long)checksum_in,
           (unsigned long long)checksum_out);
    for (int i = 0; i < 10; ++i)
        printf("  %-28s %llu us\n", desc[i], (unsigned long long)times[i]);

    /* REF_DUMP=<path>: write the sorted key sequence for the bitwise
     * parity comparison against rs.sort (BASELINE config 1). */
    const char *dump = getenv("REF_DUMP");
    if (dump) {
        FILE *f = fopen(dump, "wb");
        for (int nnode = 0; nnode < numa_nodes; ++nnode)
            fwrite(keys[nnode], sizeof(uint64_t), size[nnode], f);
        fclose(f);
        printf("dumped sorted keys to %s\n", dump);
    }
    return checksum_in == checksum_out ? 0 : 1;
}
