"""The port's solver cache (``repro_torch.core.solver_cache``) against the
JAX package's: hit/miss accounting, key sensitivity to chain edits, solve
flags and the fill, on-disk round-trips across cache instances, the
corrupted-entry fallback to a fresh solve, the chain fingerprint byte for
byte, memoized schedules equal to the JAX package's, a code fingerprint
that covers the fill kernels' CUDA sources, and Solutions that hold no
tensor (they load where torch does not)."""

import math
import pickle
import pickletools
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import solver_cache as jsolver_cache  # noqa: E402
from repro.core.chain import HostTransferModel as JHost  # noqa: E402
from repro.core.solver import solve_optimal as jsolve_optimal  # noqa: E402
from repro.offload.solver import \
    solve_optimal_offload as jsolve_offload  # noqa: E402
from repro_torch.core import dp_kernels, solver_cache  # noqa: E402
from repro_torch.core.chain import Chain, HostTransferModel  # noqa: E402
from repro_torch.core.schedule import Schedule, simulate  # noqa: E402
from repro_torch.core.solver import (solve_min_memory,  # noqa: E402
                                     solve_optimal)
from repro_torch.offload.solver import solve_optimal_offload  # noqa: E402
from repro_torch.plan import chain_fingerprint  # noqa: E402

from helpers import random_chain  # noqa: E402


def _port(ch) -> Chain:
    host = None if ch.host is None else HostTransferModel(
        bandwidth_d2h=ch.host.bandwidth_d2h,
        bandwidth_h2d=ch.host.bandwidth_h2d, latency=ch.host.latency)
    return Chain.make(uf=ch.uf, ub=ch.ub, wa=ch.wa, wabar=ch.wabar,
                      wdelta=ch.wdelta, of=ch.of, ob=ch.ob, host=host)


@pytest.fixture
def cache_dir(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_STORE", raising=False)
    monkeypatch.delenv("REPRO_SOLVER_CACHE", raising=False)
    monkeypatch.setenv("REPRO_SOLVER_CACHE_DIR", str(tmp_path))
    solver_cache.configure()
    yield tmp_path
    # drop the singleton; the next user lazily rebuilds it from the
    # (restored) environment
    solver_cache.reset()


def _chain_and_budget(seed=0, frac=0.6):
    rng = np.random.default_rng(seed)
    ch = _port(random_chain(rng, max_len=5))
    peak = simulate(ch, Schedule.store_all(ch.length)).peak_mem
    return ch, float(math.ceil(peak * frac))


def test_second_solve_is_served_from_cache(cache_dir, monkeypatch):
    ch, m = _chain_and_budget()
    sol1 = solve_optimal(ch, m, num_slots=int(m))
    stats0 = solver_cache.stats()
    assert stats0["puts"] == 1 and stats0["misses"] == 1

    # a cached call must not touch the fill at all
    def boom(*a, **k):
        raise AssertionError("table fill ran on a cache hit")
    monkeypatch.setattr(dp_kernels, "fill_two_tier", boom)

    sol2 = solve_optimal(ch, m, num_slots=int(m))
    stats1 = solver_cache.stats()
    assert stats1["hits"] == 1
    assert sol2.expected_time == sol1.expected_time
    assert sol2.schedule.ops == sol1.schedule.ops
    assert sol2.mem_limit == sol1.mem_limit


def test_offload_solve_cached(cache_dir, monkeypatch):
    rng = np.random.default_rng(4)
    ch = _port(random_chain(rng, max_len=4)).with_host(
        HostTransferModel(bandwidth_d2h=1.0))
    peak = simulate(ch, Schedule.store_all(ch.length)).peak_mem
    m = float(math.ceil(peak))
    sol1 = solve_optimal_offload(ch, m, num_slots=int(m))
    assert sol1.feasible

    def boom(*a, **k):
        raise AssertionError("offload fill ran on a cache hit")
    monkeypatch.setattr(dp_kernels, "fill_offload", boom)

    sol2 = solve_optimal_offload(ch, m, num_slots=int(m))
    assert sol2.expected_time == sol1.expected_time
    assert sol2.schedule.ops == sol1.schedule.ops


def test_key_sensitivity(cache_dir):
    ch, m = _chain_and_budget(seed=1)
    S = int(m)
    solve_optimal(ch, m, num_slots=S)
    base = solver_cache.stats()["misses"]

    # a chain edit must miss
    edited = Chain.make(uf=np.asarray(ch.uf) + 0.5, ub=ch.ub, wa=ch.wa,
                        wabar=ch.wabar, of=ch.of, ob=ch.ob)
    solve_optimal(edited, m, num_slots=S)
    # allow_fall flips must miss
    solve_optimal(ch, m, num_slots=S, allow_fall=False)
    # slot-count changes must miss
    solve_optimal(ch, m, num_slots=S + 7)
    # budget changes must miss
    solve_optimal(ch, m + 1.0, num_slots=S)
    # attaching a host model must miss (offload delegates two-tier when the
    # host link is absent, so key on the host params too)
    solve_optimal(ch.with_host(HostTransferModel(bandwidth_d2h=2.0)), m,
                  num_slots=S)
    # the fill is part of the key: the plain PyTorch fill must miss
    solve_optimal(ch, m, num_slots=S, impl="plain")
    assert solver_cache.stats()["misses"] == base + 6
    # and the original still hits
    solve_optimal(ch, m, num_slots=S)
    assert solver_cache.stats()["hits"] == 1


def test_disk_roundtrip(cache_dir):
    ch, m = _chain_and_budget(seed=2)
    sol1 = solve_optimal(ch, m, num_slots=int(m))
    assert len(list(cache_dir.glob("*.pkl"))) == 1

    # a fresh cache instance (same directory): memory LRU is empty, the
    # entry must come back from disk
    solver_cache.configure()
    sol2 = solve_optimal(ch, m, num_slots=int(m))
    st = solver_cache.stats()
    assert st["disk_hits"] == 1 and st["hits"] == 1
    assert sol2.feasible == sol1.feasible
    assert sol2.expected_time == sol1.expected_time
    assert sol2.schedule.ops == sol1.schedule.ops
    assert type(sol2.tree) is type(sol1.tree)


def test_corrupted_entry_falls_back_to_fresh_solve(cache_dir):
    ch, m = _chain_and_budget(seed=3)
    sol1 = solve_optimal(ch, m, num_slots=int(m))
    [entry] = list(cache_dir.glob("*.pkl"))

    entry.write_bytes(b"not a pickle at all")
    solver_cache.configure()
    sol2 = solve_optimal(ch, m, num_slots=int(m))
    st = solver_cache.stats()
    assert st["disk_errors"] >= 1 and st["misses"] == 1
    assert sol2.expected_time == sol1.expected_time

    # header/key mismatch (a valid pickle of the wrong thing) also misses
    entry2 = list(cache_dir.glob("*.pkl"))[0]
    entry2.write_bytes(pickle.dumps(("wrong-magic", 0, "key", None)))
    solver_cache.configure()
    sol3 = solve_optimal(ch, m, num_slots=int(m))
    assert sol3.expected_time == sol1.expected_time


def test_cache_disabled_by_env(tmp_path, monkeypatch):
    monkeypatch.delenv("REPRO_STORE", raising=False)
    monkeypatch.setenv("REPRO_SOLVER_CACHE", "0")
    monkeypatch.setenv("REPRO_SOLVER_CACHE_DIR", str(tmp_path))
    solver_cache.configure()
    try:
        ch, m = _chain_and_budget(seed=5)
        solve_optimal(ch, m, num_slots=int(m))
        solve_optimal(ch, m, num_slots=int(m))
        st = solver_cache.stats()
        assert st["hits"] == 0 and st["puts"] == 0
        assert list(tmp_path.glob("*.pkl")) == []
    finally:
        solver_cache.reset()


def test_cache_param_bypass(cache_dir):
    """cache=False neither reads nor writes the cache (timings of real
    fills use it)."""
    ch, m = _chain_and_budget(seed=6)
    solve_optimal(ch, m, num_slots=int(m), cache=False)
    solve_min_memory(ch, num_slots=int(m), cache=False)
    st = solver_cache.stats()
    assert st["puts"] == 0 and st["misses"] == 0
    assert list(cache_dir.glob("*.pkl")) == []


def test_obs_counters_mirror_cache_stats(cache_dir):
    """Every stats bump lands in the port's metrics registry too
    (``solver_cache.*`` counters)."""
    from repro_torch.obs import metrics as obs_metrics

    obs_metrics.reset()
    ch, m = _chain_and_budget(seed=7)
    solve_optimal(ch, m, num_slots=int(m))
    assert obs_metrics.value("solver_cache.misses") == 1
    assert obs_metrics.value("solver_cache.puts") == 1
    assert obs_metrics.value("solver_cache.hits") == 0
    solve_optimal(ch, m, num_slots=int(m))
    assert obs_metrics.value("solver_cache.hits") == 1
    assert obs_metrics.value("solver_cache.misses") == 1
    # and they agree with the instance stats
    st = solver_cache.stats()
    assert obs_metrics.value("solver_cache.hits") == st["hits"]
    assert obs_metrics.value("solver_cache.misses") == st["misses"]


def test_lru_evictions_are_counted(monkeypatch):
    """Overflowing a capacity-2 memory LRU evicts oldest entries and counts
    each one, in both the instance stats and the metrics registry."""
    from repro_torch.obs import metrics as obs_metrics

    monkeypatch.delenv("REPRO_SOLVER_CACHE", raising=False)
    obs_metrics.reset()
    solver_cache.configure(capacity=2, directory=None)
    try:
        for seed in range(4):
            ch, m = _chain_and_budget(seed=20 + seed)
            solve_optimal(ch, m, num_slots=int(m))
        st = solver_cache.stats()
        assert st["puts"] == 4
        assert st["evictions"] == 2
        assert obs_metrics.value("solver_cache.evictions") == 2
        # the two most-recent entries survived and still hit
        for seed in (2, 3):
            ch, m = _chain_and_budget(seed=20 + seed)
            solve_optimal(ch, m, num_slots=int(m))
        st = solver_cache.stats()
        assert st["hits"] == 2
        assert st["misses"] == 4
        assert st["evictions"] == 2
    finally:
        solver_cache.reset()


# -- against the JAX package ---------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_chain_fingerprint_equals_jax(seed):
    rng = np.random.default_rng(seed)
    ch = random_chain(rng, max_len=6)
    if seed % 2:
        ch = ch.with_host(JHost(bandwidth_d2h=0.5, bandwidth_h2d=0.25,
                                latency=1e-3))
    assert chain_fingerprint(_port(ch)) == jsolver_cache.chain_fingerprint(ch)
    assert solver_cache.chain_fingerprint(_port(ch)) == \
        jsolver_cache.chain_fingerprint(ch)


@pytest.mark.parametrize("impl", ["banded", "plain"])
@pytest.mark.parametrize("seed", range(4))
def test_memoized_schedules_equal_jax(cache_dir, seed, impl):
    """The solve that misses and the hit that follows give the JAX
    package's schedule and makespan (its own solve uncached), two tiers
    and three."""
    rng = np.random.default_rng(seed)
    ch = random_chain(rng, max_len=6)
    peak = simulate(_port(ch), Schedule.store_all(ch.length)).peak_mem
    S = 48
    for frac in (0.5, 0.8):
        m = float(math.ceil(peak * frac))
        want = jsolve_optimal(ch, m, num_slots=S, cache=False)
        got = [solve_optimal(_port(ch), m, num_slots=S, impl=impl)
               for _ in range(2)]
        for sol in got:
            assert sol.feasible == want.feasible
            if want.feasible:
                assert sol.schedule.ops == want.schedule.ops
                assert sol.expected_time == want.expected_time
        hch = ch.with_host(JHost(bandwidth_d2h=0.5))
        want = jsolve_offload(hch, m, num_slots=S, cache=False)
        got = [solve_optimal_offload(_port(hch), m, num_slots=S, impl=impl)
               for _ in range(2)]
        for sol in got:
            assert sol.feasible == want.feasible
            if want.feasible:
                assert sol.schedule.ops == want.schedule.ops
    st = solver_cache.stats()
    assert st["misses"] == 4 and st["hits"] == 4


def test_code_fingerprint_covers_the_fill_kernels(tmp_path):
    """The code fingerprint hashes the solver sources and both fill
    kernels' CUDA sources, read by path: editing ``dp_fused_fill.cu``
    changes it, so Solutions the old kernel made are never served."""
    from pathlib import Path

    root = Path(solver_cache.__file__).resolve().parents[1]
    for rel in solver_cache._FINGERPRINT_FILES:
        assert (root / rel).is_file(), rel
    assert {"kernels/csrc/dp_band_min.cu", "kernels/csrc/dp_fused_fill.cu",
            "kernels/dp_fill/ops.py"} <= set(solver_cache._FINGERPRINT_FILES)
    assert solver_cache._hash_sources(root) == solver_cache.code_fingerprint()
    copy = tmp_path / "repro_torch"
    for rel in solver_cache._FINGERPRINT_FILES:
        (copy / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(root / rel, copy / rel)
    assert solver_cache._hash_sources(copy) == solver_cache.code_fingerprint()
    with open(copy / "kernels/csrc/dp_fused_fill.cu", "a") as f:
        f.write("\n// edited\n")
    assert solver_cache._hash_sources(copy) != solver_cache.code_fingerprint()


@pytest.mark.parametrize("impl", ["banded", "plain"])
def test_cached_solution_holds_no_tensor(cache_dir, impl):
    """A Solution of any fill pickles without a torch object (the plain
    fill computes on torch tensors), so a cache entry written beside the
    card loads on a host without one."""
    rng = np.random.default_rng(0)
    ch = _port(random_chain(rng, max_len=6)).with_host(
        HostTransferModel(bandwidth_d2h=0.5))
    peak = ch.store_all_peak()
    for sol in (solve_optimal(ch, peak * 0.9, num_slots=40, impl=impl),
                solve_optimal_offload(ch, peak * 0.8, num_slots=40,
                                      impl=impl)):
        assert sol.feasible
        modules = {arg.split()[0] for op, arg, _ in
                   pickletools.genops(pickle.dumps(sol))
                   if op.name in ("GLOBAL", "STACK_GLOBAL") and arg}
        modules |= {arg for op, arg, _ in
                    pickletools.genops(pickle.dumps(sol))
                    if op.name in ("SHORT_BINUNICODE", "BINUNICODE")
                    and isinstance(arg, str) and arg.startswith("torch")}
        assert not any(m.startswith("torch") for m in modules), modules
