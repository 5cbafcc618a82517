"""The arbitration slice's kernels and stacked state against the
reference: ``waste_eval_fleet``, ``score_requests``, the batched drift
gate, ``FleetState`` row plumbing and the fleet sketch view's aliasing.

Tolerances: the fleet waste kernel's plain version sums integer terms
exactly in float64, so it equals ``waste_eval`` bit for bit on a
replicated histogram, and the reference's float32 sums within rtol 1e-6
(the reference kernel test's own tolerance); drift distances within
1e-6 (float32 sketches on both sides, summed in different orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.core.controller import score_requests as r_score  # noqa: E402
from repro.core.fleet import FleetState as RFleet  # noqa: E402
from repro.kernels.fleet_gate import drift_gate_fleet as r_gate  # noqa: E402
from repro.kernels.waste_eval import (waste_eval_fleet_pallas,  # noqa: E402
                                      waste_eval_fleet_ref)
from repro_torch import convert  # noqa: E402
from repro_torch.core.controller import score_requests  # noqa: E402
from repro_torch.core.fleet import FleetSketchView, FleetState  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.fleet_gate import drift_gate_fleet  # noqa: E402
from repro_torch.kernels.ref import (waste_eval_fleet_ref as t_fleet_ref,  # noqa: E402
                                     waste_eval_ref)

CPU = torch.device("cpu")


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def _fleet_inputs(seed, b, k, s, page_size):
    rng = np.random.default_rng(seed)
    chunks = rng.integers(1, 2 * page_size, (b, k))
    supports = np.sort(rng.integers(0, 3 * page_size, (b, s)), axis=1)
    freqs = rng.integers(0, 800, (b, s))
    if s:
        supports[:, -1] = 0          # a padded size-0 / freq-0 entry
        freqs[:, -1] = 0
    return chunks, supports, freqs


@pytest.mark.parametrize("b,k,s", [(1, 1, 1), (5, 3, 40), (12, 7, 130),
                                   (3, 16, 300)])
@pytest.mark.parametrize("page_size", [1000, 1 << 14])
def test_waste_eval_fleet_matches_reference(b, k, s, page_size):
    chunks, supports, freqs = _fleet_inputs(b * k + s, b, k, s, page_size)
    args = (jnp.asarray(chunks, jnp.int32), jnp.asarray(supports, jnp.int32),
            jnp.asarray(freqs, jnp.float32))
    pallas = np.asarray(waste_eval_fleet_pallas(*args, page_size=page_size,
                                                interpret=True))
    oracle = np.asarray(waste_eval_fleet_ref(*args, page_size=page_size))
    got = ops.waste_eval_fleet(_t(chunks, torch.int32),
                               _t(supports, torch.int32),
                               _t(freqs, torch.float32),
                               page_size=page_size)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-6)
    exact = [R.waste_exact(c, sp, f, page_size=page_size)
             for c, sp, f in zip(chunks, supports, freqs)]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(exact, dtype=np.float32))


def test_waste_eval_fleet_replicated_rows_bit_equal_waste_eval():
    chunks, supports, freqs = _fleet_inputs(5, 9, 6, 200, 4096)
    sup, frq = supports[3], freqs[3]
    one = waste_eval_ref(_t(chunks, torch.int32), _t(sup, torch.int32),
                         _t(frq, torch.float32), page_size=4096)
    fleet = t_fleet_ref(_t(chunks, torch.int32),
                        _t(np.tile(sup, (9, 1)), torch.int32),
                        _t(np.tile(frq, (9, 1)), torch.float32),
                        page_size=4096)
    assert torch.equal(one, fleet)
    # fractional freqs too: same arithmetic row by row
    frac = np.random.default_rng(1).uniform(0.1, 9.0, frq.shape)
    one = waste_eval_ref(_t(chunks, torch.int32), _t(sup, torch.int32),
                         _t(frac, torch.float32), page_size=4096)
    fleet = t_fleet_ref(_t(chunks, torch.int32),
                        _t(np.tile(sup, (9, 1)), torch.int32),
                        _t(np.tile(frac, (9, 1)), torch.float32),
                        page_size=4096)
    assert torch.equal(one, fleet)


def test_waste_eval_fleet_checks_arguments():
    c = torch.ones((2, 3), dtype=torch.int32)
    s = torch.ones((2, 4), dtype=torch.int32)
    f = torch.ones((2, 4), dtype=torch.float32)
    with pytest.raises(ValueError):
        ops.waste_eval_fleet(c, s[:1], f[:1])
    with pytest.raises(TypeError):
        ops.waste_eval_fleet(c, s.float(), f)
    with pytest.raises(ValueError):
        ops.waste_eval_fleet(c, s.t().contiguous().t(), f)


def _requests(request_cls, seed, n):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        support = np.unique(rng.integers(48, 9000, 30 + 17 * i))
        freqs = rng.integers(1, 300, support.size)
        rows = [np.sort(rng.integers(64, 9000, 3 + (i % 3)))
                for _ in range(3)]
        reqs.append(request_cls(
            rows=rows, support=support, freqs=freqs, page_size=1 << 14,
            drift=0.5, cost_bytes_fn=None))
    return reqs


def test_score_requests_matches_reference_and_solo_scoring():
    import repro.core.controller as rc
    import repro_torch.core.controller as tc

    want = r_score(_requests(rc.ScoreRequest, 3, 5))
    got = score_requests(_requests(tc.ScoreRequest, 3, 5),
                         torch_device="cpu")
    assert len(got) == len(want) == 5
    for g, w, req in zip(got, want, _requests(tc.ScoreRequest, 3, 5)):
        np.testing.assert_allclose(g, w, rtol=1e-6)
        solo = tc._score_frontier(req.rows, req.support, req.freqs,
                                  page_size=req.page_size,
                                  torch_device="cpu")
        np.testing.assert_array_equal(g, solo)
    with pytest.raises(ValueError):
        bad = _requests(tc.ScoreRequest, 1, 2)
        bad[1].page_size = 4096
        score_requests(bad, torch_device="cpu")


@pytest.mark.parametrize("metric", ["l1", "emd"])
def test_drift_gate_fleet_matches_reference(metric):
    rng = np.random.default_rng(9)
    refs = rng.random((6, 256)).astype(np.float32) * (rng.random((6, 256))
                                                      < 0.3)
    live = rng.random((6, 256)).astype(np.float32) * (rng.random((6, 256))
                                                      < 0.3)
    refs[4] = 0.0                     # empty vs mass -> 1
    live[5] = 0.0
    refs[5] = 0.0                     # empty vs empty -> 0
    want = np.asarray(r_gate(jnp.asarray(refs), jnp.asarray(live),
                             metric=metric))
    got = drift_gate_fleet(_t(refs, torch.float32), _t(live, torch.float32),
                           metric=metric)
    assert got.shape == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    solo = [float(T.histogram_distance_device(
        _t(a, torch.float32), _t(b, torch.float32), metric=metric))
        for a, b in zip(refs, live)]
    np.testing.assert_array_equal(got.numpy(), np.float32(solo))
    with pytest.raises(ValueError):
        drift_gate_fleet(_t(refs, torch.float32), _t(live[:2], torch.float32))


def test_fleet_rows_grow_free_and_reuse_like_reference():
    ref, port = RFleet(capacity=2), FleetState(capacity=2)
    cfg = T.ControllerConfig(device=True, device_buckets=64,
                             torch_device="cpu")
    for f in (ref, port):
        for name in ("a", "b", "c"):
            f.alloc_row(name)
        f.owned[f.row_of["b"]] = 7
        f.pressure[f.row_of["c"]] = 2.5
    view = port.sketch_view(port.row_of["c"], cfg)
    view.observe_many([3, 5, 5, 60])
    for f in (ref, port):
        assert f.capacity == 4 and f.n_active == 3
        f.free_row("b")
        assert f.alloc_row("d") == f.row_of["d"] == 1  # LIFO reuse
        assert f.owned[1] == 0 and f.n_active == 3
    np.testing.assert_array_equal(port.active, ref.active)
    np.testing.assert_array_equal(port.pressure, ref.pressure)
    assert port.name_of == ref.name_of
    # growth keeps every row's sketch; the view re-resolves its row
    for name in ("e", "f", "g"):
        port.alloc_row(name)
    assert port.capacity == 8 and port.sketch.shape == (8, 64)
    assert float(view.weights_device.sum()) == pytest.approx(4.0, rel=1e-3)
    port.free_row("c")
    assert float(port.sketch[2].abs().sum()) == 0.0
    with pytest.raises(ValueError):
        port.alloc_row("a")
    with pytest.raises(ValueError):
        port.ensure_sketch(128, "cpu")


def test_fleet_view_reference_does_not_alias_the_live_row():
    """A controller adopts ``sketch.weights_device`` as its drift
    reference. On a fleet row that must be a value, not a view of the
    row the sketch kernel keeps updating in place: otherwise every
    update moves the reference with the live sketch and drift reads 0
    forever (JAX never sees this: its arrays are immutable)."""
    fleet = FleetState(capacity=2)
    cfg = T.ControllerConfig(device=True, device_buckets=128,
                             check_every=50, half_life=100.0,
                             drift_threshold=0.2,
                             min_items_between_refits=50, k=3,
                             torch_device="cpu")
    fleet.alloc_row("a")
    view = fleet.sketch_view(0, cfg)
    held = view.weights_device
    view.observe_many(np.full(40, 7))
    view.flush_window()
    assert float(held.sum()) == 0.0            # the held copy stayed put
    assert float(view.weights_device.sum()) > 0.0
    ctl = T.SlabController([16, 64, 128], config=cfg, sketch=view)
    ctl.observe_many(np.full(50, 10))
    assert ctl.maybe_refit() is None           # adopts the reference
    ctl.observe_many(np.full(200, 100))        # traffic moves away
    d = ctl.maybe_refit()
    assert d is not None and d.drift > 0.5
    # a reallocation by _grow leaves the view on the live row
    fleet.alloc_row("b")
    fleet.alloc_row("c")
    assert fleet.capacity == 4
    ctl.observe_many(np.full(60, 100))
    view.flush_window()
    assert view._weights.data_ptr() == fleet.sketch[0].data_ptr()
    assert float(fleet.sketch[0].sum()) == pytest.approx(
        float(view.weights_device.sum()))


def test_load_fleet_sketch_from_reference():
    ref = RFleet(capacity=3)
    rcfg = R.ControllerConfig(device=True, device_buckets=32)
    for name in ("a", "b"):
        ref.alloc_row(name)
    rview = ref.sketch_view(1, rcfg)
    rview.observe_many([1, 2, 2, 30])
    rview.flush_window()
    port = FleetState(capacity=3)
    for name in ("a", "b"):
        port.alloc_row(name)
    tcfg = T.ControllerConfig(device=True, device_buckets=32,
                              torch_device="cpu")
    pview = port.sketch_view(1, tcfg)      # a new view starts its row at 0
    convert.load_fleet_sketch(port, np.asarray(ref.sketch),
                              torch_device="cpu")
    np.testing.assert_array_equal(port.sketch.numpy(), np.asarray(ref.sketch))
    for v in (rview, pview):
        v.observe_many([4, 4, 31])
    np.testing.assert_allclose(pview.snapshot_weights()[1],
                               rview.snapshot_weights()[1], rtol=1e-6)
    with pytest.raises(ValueError):
        convert.load_fleet_sketch(port, np.zeros((2, 32), np.float32),
                                  torch_device="cpu")


def test_fleet_view_is_a_device_size_sketch():
    fleet = FleetState(capacity=1)
    cfg = T.ControllerConfig(device=True, device_buckets=16,
                             fused_observe=False, torch_device="cpu")
    fleet.alloc_row("a")
    view = fleet.sketch_view(0, cfg)
    assert isinstance(view, FleetSketchView)
    assert isinstance(view, T.DeviceSizeSketch)
    view.observe_many([1, 1, 9])
    assert view.n_dispatches == 1
    support, freqs = view.snapshot()
    np.testing.assert_array_equal(support, [1, 9])
    np.testing.assert_array_equal(freqs, [2, 1])
