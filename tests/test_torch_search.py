"""The port's schedule searches against the reference.

``dp`` and ``parallel`` are deterministic: chunks and waste must match
the reference. ``hillclimb``, ``anneal`` and ``multi_restart`` draw from
a ``torch.Generator`` where the reference draws from ``jax.random``, so
the walks differ; their recovered fractions must land within 0.05 of the
reference's on the same histogram (both converge to near the optimum of
a tight unimodal histogram), and never above the exact DP optimum.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.memcached import paper_histogram  # noqa: E402
from repro_torch.core import hillclimb as th  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

RECOVERED_TOL = 0.05
CPU = "cpu"


@pytest.fixture(scope="module")
def unimodal():
    rng = np.random.default_rng(0)
    sizes = np.clip(rng.normal(500, 15, size=100_000), 1, None).astype(int)
    return R.size_histogram(sizes)


@pytest.fixture(scope="module")
def search_workload():
    """The workload of the reference's kernel-in-search test."""
    rng = np.random.default_rng(0)
    sizes = R.sample_lognormal_sizes(rng, 20_000, 700.0, 25.0)
    support, freqs = R.size_histogram(sizes)
    init = np.asarray([600, 752, 944], dtype=np.int64)
    init[-1] = max(init[-1], int(support.max()))
    return init, support, freqs


@pytest.mark.parametrize("k", [1, 3, 6, 12])
@pytest.mark.parametrize("seed", [0, 1])
def test_dp_optimal_bit_identical(k, seed):
    rng = np.random.default_rng(seed)
    sizes = R.sample_multimodal_sizes(
        rng, 5_000, ((0.5, 300.0, 30.0), (0.5, 900.0, 40.0)))
    support, freqs = R.size_histogram(sizes)
    want = R.dp_optimal(support, freqs, k)
    got = T.dp_optimal(support, freqs, k)
    np.testing.assert_array_equal(got.chunks, want.chunks)
    assert got.waste == want.waste and got.k == want.k
    brute = T.dp_optimal_bruteforce(support[:60], freqs[:60], k)
    assert brute.waste == R.dp_optimal_bruteforce(support[:60], freqs[:60],
                                                  k).waste


@pytest.mark.parametrize("table", [0, 2, 4])
def test_slab_policy_fit_dp_bit_identical(table):
    wl = R.PAPER_WORKLOADS[table]
    support, freqs = paper_histogram(wl, n_items=50_000)
    old = np.asarray(wl.old_chunks)
    want = R.SlabPolicy().fit(support, freqs, len(old), baseline=old)
    got = T.SlabPolicy(torch_device=CPU).fit(support, freqs, len(old),
                                              baseline=old)
    np.testing.assert_array_equal(got.chunk_sizes, want.chunk_sizes)
    assert (got.waste, got.baseline_waste, got.method) == \
        (want.waste, want.baseline_waste, want.method)
    assert got.utilization == want.utilization
    assert got.waste_fraction == want.waste_fraction
    np.testing.assert_array_equal(
        T.covering_default_classes(support, k=8),
        R.covering_default_classes(support, k=8))
    np.testing.assert_array_equal(
        T.schedule_with_default_tail(got.chunk_sizes),
        R.schedule_with_default_tail(want.chunk_sizes))


@pytest.mark.parametrize("engine", ["plain", "kernel"])
def test_parallel_hillclimb_matches_reference(search_workload, engine):
    """Same final chunks and waste as the reference, through the default
    plain evaluator and through the waste_eval kernel's wrapper."""
    init, support, freqs = search_workload
    want = R.parallel_hillclimb(init, support, freqs, max_iters=40)
    batch_eval = ops.waste_eval if engine == "kernel" else None
    got = T.parallel_hillclimb(init, support, freqs, max_iters=40,
                               batch_eval=batch_eval, torch_device=CPU)
    assert got.waste == want.waste
    np.testing.assert_array_equal(got.chunks, want.chunks)
    assert got.steps == want.steps
    assert got.init_waste == want.init_waste


def test_parallel_hillclimb_paper_tables_match_reference():
    for wl in R.PAPER_WORKLOADS[:3]:
        support, freqs = paper_histogram(wl, n_items=30_000)
        init = np.asarray(wl.old_chunks)
        want = R.parallel_hillclimb(init, support, freqs)
        got = T.parallel_hillclimb(init, support, freqs, torch_device=CPU)
        assert got.waste == want.waste
        np.testing.assert_array_equal(got.chunks, want.chunks)


def test_paper_hillclimb_recovers_like_reference(unimodal):
    support, freqs = unimodal
    init = np.array([304, 384, 480, 600, 752, 944])
    want = R.paper_hillclimb(jax.random.PRNGKey(0), init, support, freqs,
                             patience=200, max_steps=6_000)
    gen = torch.Generator().manual_seed(0)
    got = T.paper_hillclimb(gen, init, support, freqs, patience=200,
                            max_steps=6_000, torch_device=CPU)
    assert got.waste <= got.init_waste == want.init_waste
    assert got.recovered_frac == pytest.approx(want.recovered_frac,
                                               abs=RECOVERED_TOL)
    assert got.chunks.max() >= support.max()
    assert got.waste >= R.dp_optimal(support, freqs, len(init)).waste


def test_paper_hillclimb_stops_on_patience(unimodal, monkeypatch):
    """Steps after the patience trips are masked and the host reads the
    stop flag once per block: whatever the block, the walk stops inside
    the step cap, after at least ``patience + 1`` rejections."""
    support, freqs = unimodal
    init = np.array([480, 600, 1000])
    for block in (7, 1024):
        monkeypatch.setattr(th, "PATIENCE_BLOCK", block)
        gen = torch.Generator().manual_seed(3)
        res = T.paper_hillclimb(gen, init, support, freqs, patience=25,
                                max_steps=5_000, torch_device=CPU)
        assert 26 <= res.steps < 5_000
        assert res.waste <= res.init_waste
        assert res.chunks.min() >= T.MIN_CHUNK


def test_multi_restart_recovers_like_reference(unimodal):
    support, freqs = unimodal
    init = np.array([304, 384, 480, 600, 752, 944])
    want = R.multi_restart(jax.random.PRNGKey(0), init, support, freqs,
                           n_restarts=4, max_iters=100)
    gen = torch.Generator().manual_seed(0)
    got = T.multi_restart(gen, init, support, freqs, n_restarts=4,
                          max_iters=100, torch_device=CPU)
    assert got.recovered_frac == pytest.approx(want.recovered_frac,
                                               abs=RECOVERED_TOL)
    # restart 0 is the unjittered schedule: never worse than parallel
    assert got.waste <= T.parallel_hillclimb(
        init, support, freqs, max_iters=100, torch_device=CPU).waste


def test_anneal_recovers_like_reference(unimodal):
    support, freqs = unimodal
    init = np.array([304, 384, 480, 600, 752, 944])
    want = R.anneal(jax.random.PRNGKey(0), init, support, freqs,
                    n_steps=3_000)
    gen = torch.Generator().manual_seed(0)
    got = T.anneal(gen, init, support, freqs, n_steps=3_000,
                   torch_device=CPU)
    assert got.init_waste == want.init_waste
    assert got.recovered_frac == pytest.approx(want.recovered_frac,
                                               abs=RECOVERED_TOL)
    assert got.waste >= R.dp_optimal(support, freqs, len(init)).waste


@pytest.mark.parametrize("method", ["hillclimb", "parallel", "multi_restart",
                                    "anneal"])
def test_slab_policy_methods_run_on_generator(unimodal, method):
    support, freqs = unimodal
    kwargs = {"hillclimb": dict(patience=100, max_steps=2_000),
              "parallel": dict(max_iters=50),
              "multi_restart": dict(n_restarts=2, max_iters=50),
              "anneal": dict(n_steps=500)}[method]
    a = T.SlabPolicy(seed=1, torch_device=CPU).fit(support, freqs, 6,
                                                   method=method, **kwargs)
    b = T.SlabPolicy(seed=1, torch_device=CPU).fit(support, freqs, 6,
                                                   method=method, **kwargs)
    np.testing.assert_array_equal(a.chunk_sizes, b.chunk_sizes)  # seeded
    assert a.waste <= a.baseline_waste
    with pytest.raises(ValueError):
        T.SlabPolicy(torch_device=CPU).fit(support, freqs, 6, method="nope")
