"""Executed bitwise-parity anchor (VERDICT round-1 item 8).

The committed fixture (tests/fixtures/parity_seed42.json) was generated by
tests/tools/gen_rng_fixture.c — a standalone re-implementation of the
reference PRNG stream (MT19937-64, reference rand.c:42-86) plus the
BASELINE config-1 style input derivation (uniform u32 keys = high word of
each 64-bit draw) and the additive checksum contract of the reference
``check()`` (msb_64.c:2495-2499).

Here we regenerate the identical stream with the repo's own MT19937-64
(utils/rng.py), validate every fixture field, and push the keys through
the main sort path — the sorted output must be bitwise-identical to the
C-side qsort result.  No NUMA host or reference binary needed.
"""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp

import inplacemsdradixsort as rs
from inplacemsdradixsort.utils import rng as mtrng

FIXTURE = os.path.join(
    os.path.dirname(__file__), "fixtures", "parity_seed42.json"
)


@pytest.fixture(scope="module")
def fx():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ref_keys(fx):
    stream = mtrng.mt64_stream(fx["seed"], fx["n"])
    return (stream >> np.uint64(32)).astype(np.uint32)


def test_stream_matches_fixture(fx):
    out = mtrng.mt64_stream(fx["seed"], 8)
    assert [int(x) for x in out] == fx["first8"]


def test_input_checksum(fx, ref_keys):
    ck = int(np.sum(ref_keys.astype(np.uint64), dtype=np.uint64))
    assert ck == fx["input_checksum"]


def test_sorted_bitwise_parity(fx, ref_keys):
    """Sort output == the reference-side sorted sequence, bitwise."""
    out = np.asarray(rs.sort(jnp.asarray(ref_keys)).keys)
    assert int(np.sum(out.astype(np.uint64), dtype=np.uint64)) \
        == fx["sorted_checksum"]
    assert out[:4].tolist() == fx["sorted_first4"]
    assert out[-4:].tolist() == fx["sorted_last4"]
    assert np.array_equal(out, np.sort(ref_keys))


def test_regenerate_fixture_if_compiler_present(fx, tmp_path):
    """When a C compiler exists, rebuild the generator and diff its
    output against the committed fixture (guards fixture rot)."""
    cc = shutil.which("cc") or shutil.which("gcc")
    if cc is None:
        pytest.skip("no C compiler")
    src = os.path.join(os.path.dirname(__file__), "tools",
                       "gen_rng_fixture.c")
    exe = tmp_path / "gen"
    subprocess.run([cc, "-O2", "-o", str(exe), src], check=True)
    out = subprocess.run(
        [str(exe), str(fx["seed"]), str(fx["n"])],
        check=True, capture_output=True, text=True,
    ).stdout
    assert json.loads(out) == fx
