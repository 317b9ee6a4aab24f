"""MT19937-64 parity with the reference PRNG (reference rand.c:42-86).

The fixture vectors in FIXTURE_SEED_42 are produced by the reference
``rand64_init(42)`` / ``rand64_next`` stream (standard MT19937-64 with the
same init recurrence); regenerated by tests/tools/gen_rng_fixture.c if the
reference library is available.
"""

import numpy as np
import pytest

from inplacemsdradixsort.utils import rng as mtrng

# Standard MT19937-64 with seed 5489: canonical first outputs
# (Matsumoto & Nishimura reference implementation).
MT64_5489_FIRST = [
    14514284786278117030,
    4620546740167642908,
    13109570281517897720,
    17462938647148434322,
    355488278567739596,
]


def test_mt64_canonical_stream():
    out = mtrng.mt64_stream(5489, 5)
    assert [int(x) for x in out] == MT64_5489_FIRST


def test_mt64_block_boundaries():
    # values around the 312-output twist boundary must be continuous
    full = mtrng.mt64_stream(7, 700)
    a = mtrng.MT19937_64(7)
    got = np.concatenate([a.next_block(), a.next_block(), a.next_block()])
    assert np.array_equal(full, got[:700])


def _mt32_scalar(seed, cnt):
    """Direct scalar transcription of the reference rand32 semantics
    (rand.c:88-131): the oracle for the vectorized class."""
    n = [0] * 625
    n[0] = seed & 0xFFFFFFFF
    for i in range(623):
        n[i + 1] = (0x6C078965 * (n[i] ^ (n[i] >> 30))) & 0xFFFFFFFF
    out, idx = [], 624
    for _ in range(cnt):
        if idx == 624:
            for i in range(227):
                y = (n[i] & 0x80000000) + (n[i + 1] & 0x7FFFFFFF)
                n[i] = n[i + 397] ^ (y >> 1) ^ (0x9908B0DF if y & 1 else 0)
            n[624] = n[0]
            for i in range(227, 624):
                y = (n[i] & 0x80000000) + (n[i + 1] & 0x7FFFFFFF)
                n[i] = n[i - 227] ^ (y >> 1) ^ (0x9908B0DF if y & 1 else 0)
            idx = 0
        y = n[idx]
        idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        out.append(y)
    return out


@pytest.mark.parametrize("seed", [42, 0, 0xDEADBEEF])
def test_mt32_matches_reference_semantics(seed):
    """The 32-bit variant (rand.c:88-131), including its nonstandard
    seeding (no ``+ i``) and the 625th mirror word."""
    got = mtrng.mt32_stream(seed, 1400)       # > 2 twists
    assert [int(x) for x in got] == _mt32_scalar(seed, 1400)


def test_mulhi_index_range():
    r = mtrng.mt64_stream(1, 1000)
    idx = mtrng.mulhi_index(r, 12345)
    assert idx.min() >= 0 and idx.max() < 12345
    # roughly uniform: mean near size/2
    assert abs(idx.astype(np.float64).mean() - 12345 / 2) < 12345 * 0.05


def test_uniform_u32_from_stream():
    u32 = mtrng.uniform_u32(9, 64)
    u64 = mtrng.uniform_u64(9, 64)
    assert np.array_equal(u32, (u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))
