"""The slice as a whole: the port's online loop (observe → drift gate →
refit → reconfigure) against the reference's on the same traffic.

Decisions, final schedules and integer state must be identical; drifts
agree within 1e-6 (the sketches are float32 on both sides, summed in
different orders); waste scores within rtol 1e-6.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.memcached import SlabAllocator as RAlloc  # noqa: E402
from repro.memcached import phase_shift_traffic  # noqa: E402
from repro.core.distribution import PAPER_WORKLOADS  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.memcached import SlabAllocator as TAlloc  # noqa: E402

SRC = Path(__file__).resolve().parent.parent / "src"
N = 12_000
COMMON = dict(k=6, check_every=500, half_life=1000.0, drift_threshold=0.12,
              min_items_between_refits=2000, amortization_windows=8.0,
              cost_weight=0.1)
PATHS = {
    "host": {},
    "per_batch": dict(device=True, device_buckets=1 << 12,
                      fused_observe=False),
    "fused": dict(device=True, device_buckets=1 << 12),
}


@pytest.fixture(scope="module")
def phase_shift():
    a, b = PAPER_WORKLOADS[0], PAPER_WORKLOADS[2]
    sizes = phase_shift_traffic(a, b, n_items=N, shift_at=0.5, seed=11)
    support, freqs = R.size_histogram(sizes[:N // 10])
    fit = R.SlabPolicy().fit(support, freqs, 6, method="dp")
    return sizes, R.schedule_with_default_tail(fit.chunk_sizes)


def _pair(path, deployed):
    extra = PATHS[path]
    ref = R.SlabController(deployed, config=R.ControllerConfig(**COMMON,
                                                               **extra))
    port = T.SlabController(deployed, config=T.ControllerConfig(
        **COMMON, **extra, torch_device="cpu"))
    return ref, port


def _drive(ctls, sizes, start, stop, batch=125):
    for i in range(start, stop, batch):
        for c in ctls:
            c.observe_many(sizes[i:i + batch])
            c.maybe_refit()


def _assert_same(ref, port):
    assert ([(d.approved, d.reason, d.at_observation, d.predictive)
             for d in port.decisions]
            == [(d.approved, d.reason, d.at_observation, d.predictive)
                for d in ref.decisions])
    for dp, dr in zip(port.decisions, ref.decisions):
        assert dp.drift == pytest.approx(dr.drift, abs=1e-6)
        assert dp.forecast_drift == pytest.approx(dr.forecast_drift,
                                                  abs=1e-6)
        assert dp.current_waste == pytest.approx(dr.current_waste,
                                                 rel=1e-6)
        assert dp.candidate_waste == pytest.approx(dr.candidate_waste,
                                                   rel=1e-6)
        if dr.chunks is None:
            assert dp.chunks is None
        else:
            np.testing.assert_array_equal(dp.chunks, dr.chunks)
    np.testing.assert_array_equal(port.chunks, ref.chunks)
    assert (port.n_checks, port.n_refits, port.n_observed) == \
        (ref.n_checks, ref.n_refits, ref.n_observed)
    assert port.last_drift == pytest.approx(ref.last_drift, abs=1e-6)
    for name in ("n_dispatches", "n_host_syncs", "n_scalar_syncs"):
        assert getattr(port.sketch, name, None) == \
            getattr(ref.sketch, name, None), name


@pytest.mark.parametrize("path", list(PATHS))
def test_phase_shift_decisions_match_reference(phase_shift, path):
    sizes, deployed = phase_shift
    ref, port = _pair(path, deployed)
    _drive((ref, port), sizes, 0, N)
    assert ref.n_refits >= 1
    _assert_same(ref, port)
    if path == "fused":
        # one launch and at most one scalar sync per cadence window
        assert port.sketch.n_dispatches <= port.n_checks
        assert port.sketch.n_scalar_syncs <= port.n_checks


def _replay(mods, sizes, deployed, config):
    """adaptive_slab.py's replay: every item goes through the allocator
    and the controller; approved schedules are applied live."""
    alloc = mods["alloc"](deployed)
    ctl = mods["ctl"](deployed, config=config)
    cum = 0
    for i, s in enumerate(sizes.tolist()):
        idx = alloc.class_for(s)
        cum += (int(alloc.chunk_sizes[idx]) - s if idx is not None
                else int(mods["charge"](s)))
        alloc.set(str(i), s)
        ctl.observe(s)
        d = ctl.maybe_refit(cost_bytes_fn=lambda c: alloc.migration_cost_bytes(
            mods["tail"](c)))
        if d is not None and d.approved:
            new = mods["tail"](d.chunks)
            alloc.reconfigure(new)
            ctl.set_chunks(new)
    return cum, dataclasses.asdict(alloc.stats()), ctl


def test_reconfigure_loop_matches_reference(phase_shift):
    sizes, deployed = phase_shift
    sizes = sizes[::2]
    cfg = dict(k=6, check_every=1000, half_life=2000.0,
               drift_threshold=0.12, min_items_between_refits=2000,
               amortization_windows=8.0, cost_weight=0.1)
    want = _replay(dict(alloc=RAlloc, ctl=R.SlabController,
                        charge=R.uncovered_charge,
                        tail=R.schedule_with_default_tail),
                   sizes, deployed, R.ControllerConfig(**cfg))
    got = _replay(dict(alloc=TAlloc, ctl=T.SlabController,
                       charge=T.uncovered_charge,
                       tail=T.schedule_with_default_tail),
                  sizes, deployed,
                  T.ControllerConfig(**cfg, torch_device="cpu"))
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[1]["n_reassigned_pages"] > 0
    _assert_same(want[2], got[2])


def _export_sketch(sk):
    if isinstance(sk, R.DeviceSizeSketch):
        weights = np.asarray(sk.weights_device)       # flushes the window
        return dict(weights=weights, n_observed=sk.n_observed,
                    n_dispatches=sk.n_dispatches,
                    n_host_syncs=sk.n_host_syncs,
                    n_scalar_syncs=sk.n_scalar_syncs,
                    half_life=sk.half_life, num_buckets=sk.num_buckets,
                    bucket_width=sk.bucket_width, window=sk._window)
    sizes = np.asarray(sorted(sk._w), dtype=np.int64)
    return dict(sizes=sizes,
                weights=np.asarray([sk._w[s] for s in sizes.tolist()]),
                last=np.asarray([sk._last[s] for s in sizes.tolist()]),
                t=sk._t, total=sk._total, n_observed=sk.n_observed,
                n_host_syncs=sk.n_host_syncs, n_dispatches=sk.n_dispatches,
                half_life=sk.half_life, max_bins=sk.max_bins)


def _export_controller(ctl):
    ref = ctl.reference
    if ref is not None:
        ref = (np.asarray(ref) if ctl.config.device
               else (np.asarray(ref[0]), np.asarray(ref[1])))
    config = {f.name: getattr(ctl.config, f.name)
              for f in dataclasses.fields(ctl.config)}
    return dict(config=config, chunks=np.asarray(ctl.chunks), reference=ref,
                since_check=ctl._since_check,
                last_refit_at=ctl._last_refit_at, n_checks=ctl.n_checks,
                n_refits=ctl.n_refits, sketch=_export_sketch(ctl.sketch))


@pytest.mark.parametrize("path", list(PATHS))
def test_state_carry_over_continues_like_reference(phase_shift, path):
    """Run the reference halfway, carry its state into the port, then
    continue both: every later decision is identical."""
    sizes, deployed = phase_shift
    ref, _ = _pair(path, deployed)
    _drive((ref,), sizes, 0, N // 2 + 125 * 3)     # mid-window
    port = convert.load_controller_state(_export_controller(ref),
                                         torch_device="cpu")
    assert port._since_check == ref._since_check > 0
    n_before = len(ref.decisions)
    _drive((ref, port), sizes, N // 2 + 125 * 3, N)
    assert len(ref.decisions) > n_before
    assert ([(d.approved, d.reason, d.at_observation)
             for d in port.decisions]
            == [(d.approved, d.reason, d.at_observation)
                for d in ref.decisions[n_before:]])
    for dp, dr in zip(port.decisions, ref.decisions[n_before:]):
        assert dp.drift == pytest.approx(dr.drift, abs=1e-6)
    np.testing.assert_array_equal(port.chunks, ref.chunks)
    assert (port.n_checks, port.n_refits) == (ref.n_checks, ref.n_refits)


def test_load_sketch_state_round_trip():
    rng = np.random.default_rng(4)
    ref = R.DeviceSizeSketch(half_life=100.0, num_buckets=128,
                             bucket_width=2, window_kernel=False)
    ref.observe_many(rng.integers(1, 300, 200))
    port = convert.load_sketch_state(_export_sketch(ref), torch_device="cpu")
    batch = rng.integers(1, 300, 50)
    ref.observe_many(batch)
    port.observe_many(batch)
    np.testing.assert_allclose(port.snapshot_weights()[1],
                               ref.snapshot_weights()[1], rtol=1e-6)
    assert (port.n_dispatches, port.n_host_syncs) == \
        (ref.n_dispatches, ref.n_host_syncs)
    bad = dict(_export_sketch(ref), weights=np.zeros(3, np.float32))
    with pytest.raises(ValueError):
        convert.load_sketch_state(bad, torch_device="cpu")


PAGE = 1 << 16


def _periodic(seed, n_blocks=24, block=200):
    rng = np.random.default_rng(seed)
    return [rng.integers(90, 130, block) if i % 6 < 3
            else rng.integers(850, 950, block) for i in range(n_blocks)]


@pytest.mark.parametrize("device", [False, True])
def test_predictive_refits_match_reference(device):
    """The forecast seam: periodic traffic, predictive refits fire before
    the phase arrives, on both the host and the device sketch."""
    def run(mod):
        cfg = mod.ControllerConfig(
            k=3, check_every=200, half_life=200.0, drift_threshold=0.3,
            min_items_between_refits=400, page_size=PAGE, min_chunk=48,
            device=device, device_buckets=1 << 10,
            forecast=mod.DemandForecaster(), forecast_min_confidence=0.3,
            **({} if mod is R else dict(torch_device="cpu")))
        ctl = mod.SlabController([128, 1024, 2048], config=cfg)
        for sizes in _periodic(0):
            ctl.observe_many(sizes)
            ctl.maybe_refit()
        return ctl

    ref, port = run(R), run(T)
    assert port.n_predictive_refits == ref.n_predictive_refits >= 1
    assert port.forecaster.n_windows == ref.forecaster.n_windows
    _assert_same(ref, port)


def test_port_imports_neither_jax_nor_reference():
    """Importing every module of the port pulls in no jax and no repro."""
    pkg = SRC / "repro_torch"
    mods = sorted(".".join(p.relative_to(SRC).with_suffix("").parts)
                  for p in pkg.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or "
            "k.startswith('repro.'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro_torch.core.controller" in mods
    assert "repro_torch.convert" in mods
