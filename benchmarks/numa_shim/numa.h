/* Single-node libnuma shim for running the reference binary on hosts
 * without libnuma-dev (a small VM).  Provides exactly the
 * seven libnuma entry points the reference uses
 * (/root/reference/src/msb_64.c:49,100-109,206-237,2323-2327) with
 * single-NUMA-node semantics: node 0 everywhere, interleaved alloc =
 * plain aligned malloc, membind = no-op.  Correctness-only — the
 * anchor's *performance* is meaningless on this 1-vCPU box, but the
 * checksum/bitwise output comparison (BASELINE.json config 1) is not.
 */
#ifndef NUMA_SHIM_H
#define NUMA_SHIM_H

#include <stdlib.h>
#include <sys/mman.h>

struct bitmask { unsigned long dummy; };

static inline int numa_max_node(void) { return 0; }
static inline int numa_node_of_cpu(int cpu) { (void)cpu; return 0; }

/* mmap-backed like real libnuma: the reference double-frees its sample
 * buffers (msb_64.c:2374-2375 then :2424-2425), which libnuma's munmap
 * tolerates silently — a malloc-backed shim would crash in free(). */
static inline void *numa_alloc_interleaved(size_t size) {
    void *p = mmap(NULL, size, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
    return p == MAP_FAILED ? NULL : p;
}

static inline void numa_free(void *mem, size_t size) {
    munmap(mem, size);
}

static inline struct bitmask *numa_parse_nodestring(const char *s) {
    (void)s;
    static struct bitmask bm;
    return &bm;
}

static inline void numa_set_membind(struct bitmask *bm) { (void)bm; }
static inline void numa_free_nodemask(struct bitmask *bm) { (void)bm; }

#endif /* NUMA_SHIM_H */
