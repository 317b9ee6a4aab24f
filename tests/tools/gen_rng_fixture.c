/* gen_rng_fixture.c — parity-anchor fixture generator.
 *
 * Reproduces the reference PRNG stream (MT19937-64; the reference's
 * rand64_init/rand64_next in /root/reference/src/rand.c:42-86 is the
 * standard Matsumoto-Nishimura generator with the 6364136223846793005
 * seeding recurrence) and derives the BASELINE config-1 style input
 * (uniform 32-bit keys = high word of each 64-bit draw), then emits a
 * JSON fixture with:
 *   - the first 8 raw 64-bit outputs,
 *   - the additive input checksum (the reference check() checksum
 *     contract, msb_64.c:2495-2499),
 *   - the additive + boundary values of the qsort-sorted key sequence.
 *
 * The committed fixture (tests/fixtures/parity_seed42.json) was produced
 * by this program; the Python test regenerates the same stream with the
 * repo's MT19937-64 (utils/rng.py) and checks the sort path's sorted
 * output bitwise against it — an executed parity anchor that does not
 * need a 64-thread NUMA host (VERDICT round-1 item 8).
 *
 * Build/run:  cc -O2 -o gen_rng_fixture gen_rng_fixture.c && \
 *             ./gen_rng_fixture 42 65536 > ../fixtures/parity_seed42.json
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

#define NN 312
#define MM 156
#define MATRIX_A 0xB5026F5AA96619E9ULL
#define UM 0xFFFFFFFF80000000ULL
#define LM 0x7FFFFFFFULL

static uint64_t mt[NN];
static int mti = NN + 1;

static void mt64_init(uint64_t seed) {
    mt[0] = seed;
    for (mti = 1; mti < NN; mti++)
        mt[mti] = 6364136223846793005ULL *
                      (mt[mti - 1] ^ (mt[mti - 1] >> 62)) + (uint64_t)mti;
}

static uint64_t mt64_next(void) {
    int i;
    uint64_t x;
    if (mti >= NN) {
        for (i = 0; i < NN - MM; i++) {
            x = (mt[i] & UM) | (mt[i + 1] & LM);
            mt[i] = mt[i + MM] ^ (x >> 1) ^ ((x & 1) ? MATRIX_A : 0);
        }
        for (; i < NN - 1; i++) {
            x = (mt[i] & UM) | (mt[i + 1] & LM);
            mt[i] = mt[i + MM - NN] ^ (x >> 1) ^ ((x & 1) ? MATRIX_A : 0);
        }
        x = (mt[NN - 1] & UM) | (mt[0] & LM);
        mt[NN - 1] = mt[MM - 1] ^ (x >> 1) ^ ((x & 1) ? MATRIX_A : 0);
        mti = 0;
    }
    x = mt[mti++];
    x ^= (x >> 29) & 0x5555555555555555ULL;
    x ^= (x << 17) & 0x71D67FFFEDA60000ULL;
    x ^= (x << 37) & 0xFFF7EEE000000000ULL;
    x ^= (x >> 43);
    return x;
}

static int cmp_u32(const void *a, const void *b) {
    uint32_t x = *(const uint32_t *)a, y = *(const uint32_t *)b;
    return x < y ? -1 : x > y;
}

int main(int argc, char **argv) {
    uint64_t seed = argc > 1 ? strtoull(argv[1], 0, 0) : 42;
    uint64_t n = argc > 2 ? strtoull(argv[2], 0, 0) : 65536;
    uint64_t first8[8], in_ck = 0, out_ck = 0;
    uint32_t *keys = malloc(n * sizeof(uint32_t));
    uint64_t i;

    mt64_init(seed);
    for (i = 0; i < 8; i++) first8[i] = mt64_next();
    mt64_init(seed); /* restart: keys use the stream from the beginning */
    for (i = 0; i < n; i++) {
        keys[i] = (uint32_t)(mt64_next() >> 32);
        in_ck += keys[i];
    }
    qsort(keys, n, sizeof(uint32_t), cmp_u32);
    for (i = 0; i < n; i++) out_ck += keys[i];

    printf("{\n  \"seed\": %llu,\n  \"n\": %llu,\n",
           (unsigned long long)seed, (unsigned long long)n);
    printf("  \"first8\": [");
    for (i = 0; i < 8; i++)
        printf("%s%llu", i ? ", " : "", (unsigned long long)first8[i]);
    printf("],\n");
    printf("  \"input_checksum\": %llu,\n", (unsigned long long)in_ck);
    printf("  \"sorted_checksum\": %llu,\n", (unsigned long long)out_ck);
    printf("  \"sorted_first4\": [%u, %u, %u, %u],\n",
           keys[0], keys[1], keys[2], keys[3]);
    printf("  \"sorted_last4\": [%u, %u, %u, %u]\n}\n",
           keys[n - 4], keys[n - 3], keys[n - 2], keys[n - 1]);
    free(keys);
    return 0;
}
