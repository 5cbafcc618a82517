"""The port's cross-tenant arbiter against the reference's, and its
fleet mode against its legacy loop.

The arbiter's decisions are host code (Python ints and float64), so
every ``TransferDecision`` field must be identical between the two
packages and between the port's legacy and fleet modes. Refit verdicts
carry the waste scores of the kernels: the reference sums them in
float32 and the port in float64 rounded once, so verdicts (approved,
reason, schedule) and host drifts must match exactly while the waste
figures are not compared. On device sketches the drift gate is held to
decision level, with drifts within 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.distribution import PAPER_WORKLOADS  # noqa: E402
from repro.core.forecast import DemandForecaster as RForecaster  # noqa: E402
from repro.memcached import SlabAllocator as RAlloc  # noqa: E402
from repro.memcached import multitenant_phased_ops  # noqa: E402
from repro.memcached.eviction import make_policy as r_policy  # noqa: E402
from repro_torch.core.distribution import sample_lognormal_sizes  # noqa: E402
from repro_torch.core.forecast import DemandForecaster as TForecaster  # noqa: E402
from repro_torch.memcached import SlabAllocator as TAlloc  # noqa: E402
from repro_torch.memcached import fleet_stream  # noqa: E402
from repro_torch.memcached.eviction import make_policy as t_policy  # noqa: E402

SIDES = {
    "ref": dict(mod=R, alloc=RAlloc, forecaster=RForecaster,
                policy=r_policy, cfg={}),
    "port": dict(mod=T, alloc=TAlloc, forecaster=TForecaster,
                 policy=t_policy, cfg=dict(torch_device="cpu")),
}


def _transfer_sig(arb):
    return [(d.approved, d.reason, d.donor, d.recipient, d.benefit,
             d.cost, d.forecast_penalty, d.evicted_items,
             d.evicted_bytes, d.at_op) for d in arb.decisions]


def _verdicts(arb, *, drift_digits=None):
    return [(n, d.approved, d.reason,
             d.drift if drift_digits is None
             else round(float(d.drift), drift_digits),
             None if d.chunks is None else tuple(np.asarray(d.chunks).tolist()))
            for n in sorted(arb.tenants)
            for d in arb.tenants[n].controller.decisions]


# -- the examples/multitenant.py --fast stream --------------------------------

MT_PAGE = 1 << 16


def _multitenant_arbiter(side, total_pages, *, fleet=False):
    """multitenant_bench's arbitrated setup, with a cadence short enough
    that each tenant's controller refits within the fast stream."""
    s = SIDES[side]
    mod = s["mod"]
    pool = mod.PagePool(total_pages, page_size=MT_PAGE)
    cfg = mod.ControllerConfig(
        k=6, page_size=MT_PAGE, check_every=500, half_life=1000.0,
        drift_threshold=0.12, min_items_between_refits=1000,
        amortization_windows=8.0, cost_weight=0.1, **s["cfg"])
    arb = mod.TenantArbiter(pool, controller_config=cfg,
                            arbitrate_every=1000, amortization_windows=8.0,
                            cost_weight=0.1, fleet=fleet)
    classes = mod.default_memcached_schedule(page_size=MT_PAGE)
    for t in range(3):
        name = f"tenant{t}"
        arb.register(name, s["alloc"](classes, page_size=MT_PAGE,
                                      page_pool=pool, tenant=name,
                                      eviction_policy=s["policy"]("coldest")),
                     floor_pages=total_pages // 12)
    pool.equal_partition()
    return arb


def test_multitenant_fast_stream_matches_reference():
    n_sets = 10_000
    total_pages = max(12, 88 * n_sets // 30_000)
    ops = multitenant_phased_ops(PAPER_WORKLOADS[:3], n_sets=n_sets,
                                 trough_mix=0.5, seed=7)
    arbs = {}
    for side, fleet in (("ref", False), ("port", False), ("port", True)):
        arb = _multitenant_arbiter(side, total_pages, fleet=fleet)
        for op in ops:
            name = f"tenant{op.tenant}"
            if op.op == "set":
                arb.set(name, op.key, op.size)
            else:
                arb.delete(name, op.key)
        arbs[(side, fleet)] = arb
    ref = arbs[("ref", False)]
    assert ref.n_transfers > 0 and sum(
        t.controller.n_refits for t in ref.tenants.values()) > 0
    for key, arb in arbs.items():
        assert _transfer_sig(arb) == _transfer_sig(ref), key
        assert _verdicts(arb) == _verdicts(ref), key
        assert (arb.n_ops, arb.n_transfers, arb.n_bounced) == \
            (ref.n_ops, ref.n_transfers, ref.n_bounced), key
        for name in ref.tenants:
            assert arb.pool.quota(name) == ref.pool.quota(name)
            assert arb.pool.owned(name) == ref.pool.owned(name)
        assert arb.pool.conserved


# -- fleet_stream: the reference's fleet bench traffic ------------------------

FLEET_PAGE = 1 << 14


def _fleet_arbiter(side, n, *, fleet, device=False, check_every=10**9,
                   forecast=True):
    s = SIDES[side]
    mod = s["mod"]
    pool = mod.PagePool(2 * n, page_size=FLEET_PAGE)
    cfg = mod.ControllerConfig(page_size=FLEET_PAGE, check_every=check_every,
                               min_items_between_refits=2 * check_every,
                               device=device, **s["cfg"])
    fc = (s["forecaster"](ring=12, min_confidence=0.05) if forecast
          else None)
    arb = mod.TenantArbiter(pool, controller_config=cfg,
                            arbitrate_every=10**9, forecast=fc, fleet=fleet,
                            fleet_capacity=max(8, n))
    classes = mod.default_memcached_schedule(page_size=FLEET_PAGE)
    for i in range(n):
        name = f"t{i:05d}"
        arb.register(name, s["alloc"](classes, page_size=FLEET_PAGE,
                                      page_pool=pool, tenant=name))
    pool.equal_partition(floor=1)
    return arb


def _drive_fleet_stream(arb, n, rounds=8, seed=7):
    stream = fleet_stream(n, rounds * n * 6, seed)
    per = len(stream) // rounds
    for r in range(rounds):
        for phys, op in stream[r * per:(r + 1) * per]:
            name = f"t{phys:05d}"
            if op.op == "set":
                arb.set(name, op.key, op.size)
            elif op.op == "delete":
                arb.delete(name, op.key)
            elif not arb.get(name, op.key):
                arb.set(name, op.key, op.size)
        arb.tick(0)
        arb.arbitrate()
    return arb


@pytest.mark.parametrize("n", [10, 50])
@pytest.mark.parametrize("forecast", [True, False])
def test_fleet_stream_decisions_identical(n, forecast):
    """Reference legacy, port legacy and port fleet make the same
    transfer decisions, every field exact."""
    arbs = [_drive_fleet_stream(_fleet_arbiter(side, n, fleet=fleet,
                                               forecast=forecast), n)
            for side, fleet in (("ref", False), ("port", False),
                                ("port", True))]
    sigs = [_transfer_sig(a) for a in arbs]
    assert sigs[0] and sigs[0] == sigs[1] == sigs[2]
    assert arbs[1].stats() == arbs[2].stats()
    assert arbs[2].n_transfers == arbs[0].n_transfers > 0


def test_port_fleet_twin_parity_under_churn():
    """Join/leave mid-stream: the fleet reuses freed rows and still
    decides exactly as the legacy loop."""
    n = 12
    stream = fleet_stream(n, 8 * n * 6, 3)
    twins = []
    for fleet in (False, True):
        arb = _fleet_arbiter("port", n, fleet=fleet)
        for i, (phys, op) in enumerate(stream):
            if i == len(stream) // 3:
                arb.remove("t00004")
            if i == len(stream) // 2:
                pool = arb.pool
                arb.register("late", TAlloc(
                    T.default_memcached_schedule(page_size=FLEET_PAGE),
                    page_size=FLEET_PAGE, page_pool=pool, tenant="late"),
                    quota=2)
            name = f"t{phys:05d}"
            if name not in arb.tenants:
                name = "late"               # the leaver's traffic
            if name not in arb.tenants:
                continue
            if op.op == "set":
                arb.set(name, op.key, op.size)
            elif op.op == "delete":
                arb.delete(name, op.key)
            elif not arb.get(name, op.key):
                arb.set(name, op.key, op.size)
            if i % 500 == 499:
                arb.arbitrate()
        twins.append(arb)
    legacy, fleet = twins
    assert _transfer_sig(legacy) == _transfer_sig(fleet)
    assert legacy.stats() == fleet.stats()
    assert fleet.fleet.row_of["late"] == 4          # the freed row, reused
    assert fleet.n_transfers > 0
    assert legacy.pool.conserved and fleet.pool.conserved


# -- device sketches: the batched drift gate ----------------------------------

def _gate_run(side, n, *, fleet, rounds=6, seed=7):
    arb = _fleet_arbiter(side, n, fleet=fleet, device=True, check_every=128)
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        for i in range(n):
            wl = PAPER_WORKLOADS[i % len(PAPER_WORKLOADS)]
            mu = wl.mu * (1.6 if (r // 2) % 2 else 1.0)
            arb.observe(f"t{i:05d}", sample_lognormal_sizes(
                rng, 64, mu, wl.sigma, max_size=FLEET_PAGE))
        arb.tick(1)
    return arb


def test_device_gate_decisions_and_dispatch_bound():
    n, rounds = 16, 6
    ref = _gate_run("ref", n, fleet=False, rounds=rounds)
    legacy = _gate_run("port", n, fleet=False, rounds=rounds)
    fleet = _gate_run("port", n, fleet=True, rounds=rounds)
    # port legacy vs fleet: the fleet_bench contract (drift to 1e-6)
    assert _verdicts(legacy, drift_digits=6) == \
        _verdicts(fleet, drift_digits=6)
    # port vs reference: same verdicts, drifts within 1e-6
    vr, vp = _verdicts(ref), _verdicts(fleet)
    assert [(v[0], v[1], v[2], v[4]) for v in vr] == \
        [(v[0], v[1], v[2], v[4]) for v in vp]
    np.testing.assert_allclose([v[3] for v in vp], [v[3] for v in vr],
                               atol=1e-6)
    assert sum(v[1] for v in vp) > 0
    assert legacy.n_gate_launches == 0
    assert 1 <= fleet.n_gate_launches
    assert fleet.n_gate_launches + fleet.n_score_launches <= 2 * rounds
    assert fleet.n_frontiers_scored == legacy.n_frontiers_scored \
        == ref.n_frontiers_scored > 1


def test_arbiter_defaults_to_the_card():
    pool = T.PagePool(4)
    if torch.cuda.is_available():
        assert T.TenantArbiter(pool) is not None
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            T.TenantArbiter(pool)


def test_fleet_gate_gathers_live_rows_at_once(monkeypatch):
    """The fleet gate reads the due tenants' live rows with one gather of
    the stacked sketch, not with a copy per tenant through
    ``weights_device``."""
    from repro_torch.core.fleet import FleetSketchView
    seen = {"copies": 0, "in_gate": False}
    prop = FleetSketchView.weights_device

    def counting(self):
        if seen["in_gate"]:
            seen["copies"] += 1
        return prop.fget(self)

    gate = T.TenantArbiter._batched_gate

    def watched(self, due):
        seen["in_gate"] = True
        try:
            return gate(self, due)
        finally:
            seen["in_gate"] = False

    monkeypatch.setattr(FleetSketchView, "weights_device",
                        property(counting))
    monkeypatch.setattr(T.TenantArbiter, "_batched_gate", watched)
    fleet = _gate_run("port", 8, fleet=True, rounds=6)
    assert fleet.n_gate_launches >= 1
    assert seen["copies"] == 0
