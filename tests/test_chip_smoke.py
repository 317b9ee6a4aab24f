"""chip_smoke.py at tiny sizes on the CPU: every phase runs and passes
its gates, each gate catches a corrupted output, and the script refuses
to run without a GPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs
from inplacemsdradixsort.parallel import dsort
from inplacemsdradixsort.parallel.mesh import make_sort_mesh
from inplacemsdradixsort.utils import checking, compile_cache
from inplacemsdradixsort.utils.hlo import sort_lowering


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.require_gpu(jax.devices())


def test_main_prints_no_result_without_gpu(capsys):
    with pytest.raises(SystemExit):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("ph", cs.ONE_CARD, ids=lambda p: p.name)
def test_phase_tiny(ph):
    row = cs.run_phase(ph, seed=3, log_n=10, bitwise=True)
    assert row["log_n"] == 10 and row["compile_s"] >= 0
    assert row["sorts"]["cub_radix_sort"] == 0      # XLA:CPU has no CUB


def test_parity_fixture_phase():
    cs.run_parity_fixture()


def test_dsort_phase_one_card():
    row = cs.run_dsort(make_sort_mesh(1), "uniform", seed=1, log_n=12,
                       bitwise=True)
    assert set(row["sorts"]) == {"exchange", "local"}


def test_four_phase_on_virtual_devices():
    """--four's path on 4 virtual CPU devices, generation sharded."""
    cs.run_four(make_sort_mesh(4), seed=2, log_n=14, bitwise_log_n=12)


def test_generate_sharded_shards_per_device():
    mesh = make_sort_mesh(4)
    keys = cs.generate_sharded(mesh, "zipf100", 1 << 12, seed=5)
    assert keys.shape == (1 << 12,) and keys.dtype == jnp.uint32
    assert len(keys.addressable_shards) == 4
    assert {s.data.shape for s in keys.addressable_shards} == {(1 << 10,)}
    shards = [np.asarray(s.data) for s in keys.addressable_shards]
    assert not np.array_equal(shards[0], shards[1])     # own key per shard


# --------------------------------------------------- gates catch errors

def _sorted_u32(n=4096, seed=0):
    x = np.random.default_rng(seed).integers(0, 1000, n, dtype=np.uint32)
    return x, np.sort(x)


def test_fingerprint_catches_dropped_key():
    x, s = _sorted_u32()
    dropped = np.concatenate([s[:100], s[101:], s[-1:]])   # same length
    assert checking.fingerprint(jnp.asarray(s)) == \
        checking.fingerprint(jnp.asarray(x))
    assert checking.fingerprint(jnp.asarray(dropped)) != \
        checking.fingerprint(jnp.asarray(x))


def test_fingerprint_catches_compensated_change():
    # +1 on one key and -1 on another keeps the plain sum: the hash differs
    x, s = _sorted_u32()
    bad = s.copy()
    bad[10] += 1
    bad[3000] -= 1
    fa, fb = (checking.fingerprint(jnp.asarray(a)) for a in (s, bad))
    assert fa[:2] == fb[:2] and fa[2] != fb[2]


def test_ascending_catches_swap():
    _, s = _sorted_u32()
    bad = s.copy()
    bad[[5, 4000]] = bad[[4000, 5]]
    assert checking.device_is_sorted(jnp.asarray(s))
    assert not checking.device_is_sorted(jnp.asarray(bad))


def _pairs(n=4096):
    keys = np.random.default_rng(1).integers(0, 50, n, dtype=np.uint32)
    order = np.argsort(keys, kind="stable").astype(np.uint32)
    return keys, keys[order], order


def test_pair_gates_pass_on_stable_sort():
    keys, k, r = _pairs()
    got = checking.pair_gates(jnp.asarray(keys), jnp.asarray(k),
                              jnp.asarray(r))
    assert all(got.values()), got


def test_pair_gates_catch_swapped_rid():
    keys, k, r = _pairs()
    bad = r.copy()
    i = int(np.argmax(k != k[0]))           # first index of the 2nd run
    bad[[0, i]] = bad[[i, 0]]
    got = checking.pair_gates(jnp.asarray(keys), jnp.asarray(k),
                              jnp.asarray(bad))
    assert got["rids_permutation"] and not got["payload"]


def test_pair_gates_catch_unstable_tie():
    keys, k, r = _pairs()
    bad = r.copy()
    bad[[0, 1]] = bad[[1, 0]]               # equal keys, rids reversed
    assert k[0] == k[1]
    got = checking.pair_gates(jnp.asarray(keys), jnp.asarray(k),
                              jnp.asarray(bad))
    assert got["payload"] and got["rids_permutation"]
    assert not got["stable"]


def test_pair_gates_catch_duplicated_rid():
    keys, k, r = _pairs()
    bad = r.copy()
    bad[1] = bad[0]
    got = checking.pair_gates(jnp.asarray(keys), jnp.asarray(k),
                              jnp.asarray(bad))
    assert not got["rids_permutation"]


def test_dsort_gates_catch_boundary_and_dropped_key():
    mesh = make_sort_mesh(4)
    keys = cs.generate_sharded(mesh, "uniform", 1 << 12, seed=4)
    fp = checking.fingerprint(keys)
    res = dsort.distributed_sort(keys, mesh=mesh)
    assert all(cs.dsort_gates(res, 1 << 12, fp).values())
    k = np.asarray(jax.device_get(res.keys))
    c = np.asarray(jax.device_get(res.counts))
    swapped = k.copy()
    swapped[[0, 1], 0] = swapped[[1, 0], 0]    # shard 1 starts too low
    got = cs.dsort_gates(res._replace(keys=jnp.asarray(swapped)),
                         1 << 12, fp)
    assert not got["ascending_per_shard"] or \
        not got["ascending_across_shards"]
    fewer = c.copy()
    fewer[2] -= 1                              # a dropped key
    got = cs.dsort_gates(res._replace(counts=jnp.asarray(fewer)),
                         1 << 12, fp)
    assert not got["count"] and not got["fingerprint"]


# ---------------------------------------------------------- reporting

def test_sort_lowering_counts_cub_and_xla_sorts():
    hlo = (
        '%a = (u32[1048576]{0}, u8[9]{0}) custom-call(u32[1048576]{0} %p),'
        ' custom_call_target="__cub$DeviceRadixSort"\n'
        '%s = (u32[64]{0}, u32[64]{0}) sort(u32[64]{0} %x, u32[64]{0} %y),'
        ' dimensions={0}, is_stable=true, to_apply=%cmp\n'
        '%sort.3 = u32[8]{0} sort(u32[8]{0} %z), dimensions={0}\n')
    got = sort_lowering(hlo)
    assert got["cub_radix_sort"] == 1 and got["xla_sort"] == 2
    assert got["custom_calls"] == ["__cub$DeviceRadixSort"]


def test_cache_dir_follows_env():
    assert compile_cache.cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) == "/x/cache"


def test_cache_dir_defaults_to_checkout():
    import os
    got = compile_cache.cache_dir({})
    assert got == os.path.join(os.path.dirname(os.path.abspath(
        cs.__file__)), ".jax_cache")


def test_result_line_is_the_contract(monkeypatch, capsys):
    """With the device check and the phases stubbed, main's last line
    is exactly the contract object."""
    monkeypatch.setattr(cs, "require_gpu", lambda devices, count=1: None)
    monkeypatch.setattr(cs, "card_name_and_power_limit", lambda: "X, 1 W")
    monkeypatch.setattr(cs, "run_one_card", lambda seed: None)
    assert cs.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    d = jax.devices()[0]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}
