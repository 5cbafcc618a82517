"""The port's device sketch and sketch kernel contract against the
reference: plain kernel versions within rtol/atol 1e-6, sketch snapshots
and sync/dispatch counters equal, drift distances within 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.observe as ro  # noqa: E402
import repro_torch.core.observe as to  # noqa: E402
from repro.kernels import sketch_update as rk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import sketch_update as tk  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


def test_sketch_update_ref_matches_reference():
    rng = np.random.default_rng(3)
    state = rng.random(2000).astype(np.float32)
    idx = rng.integers(-3, 2010, 700).astype(np.int32)   # some out of range
    w = rng.random(700).astype(np.float32)
    want = np.asarray(rk.sketch_update_ref(state, idx, w, 0.875))
    got = tk.sketch_update_ref(_t(state, torch.float32),
                               _t(idx, torch.int32),
                               _t(w, torch.float32), 0.875).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    out = _t(state, torch.float32)
    ops.sketch_update(out, _t(idx, torch.int32), _t(w, torch.float32),
                      0.875, out=out)                   # in place on CPU
    np.testing.assert_array_equal(out.numpy(), got)


def _window_inputs(seed, *, lens, n, num_buckets, width, weighted):
    rng = np.random.default_rng(seed)
    rows = len(lens)
    sizes = rng.integers(-20, num_buckets * width + 200, (rows, n))
    weights = (rng.uniform(0.25, 3.0, (rows, n)) if weighted
               else np.ones((rows, n)))
    state = rng.random(num_buckets) * 5
    return (state.astype(np.float32), sizes.astype(np.int32),
            weights.astype(np.float32), np.asarray(lens, dtype=np.int32))


@pytest.mark.parametrize("half_life", [None, 7.0, 300.0])
@pytest.mark.parametrize("width", [1, 4])
@pytest.mark.parametrize("weighted", [False, True])
def test_sketch_window_ref_matches_reference(half_life, width, weighted):
    """Ragged rows, a zero-length row, weights, decay, negative sizes and
    sizes past the grid (clamped into the top bucket)."""
    lens = [64, 0, 33, 100, 1, 128]
    num_buckets = 256
    state, sizes, weights, lengths = _window_inputs(
        len(lens) + width, lens=lens, n=128, num_buckets=num_buckets,
        width=width, weighted=weighted)
    decay = 0.5 ** (1.0 / half_life) if half_life else 1.0
    totals = np.asarray([decay ** int(n) for n in lengths], dtype=np.float32)
    want = np.asarray(rk.sketch_window_ref(
        state, sizes, weights, lengths, np.float32(decay), totals,
        bucket_width=width))
    got = tk.sketch_window_ref(
        _t(state, torch.float32), _t(sizes, torch.int32),
        _t(weights, torch.float32), _t(lengths, torch.int32), decay,
        _t(totals, torch.float32), bucket_width=width).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    via_ops = ops.sketch_window(
        _t(state, torch.float32), _t(sizes, torch.int32),
        _t(weights, torch.float32), _t(lengths, torch.int32), decay,
        _t(totals, torch.float32), bucket_width=width)
    np.testing.assert_array_equal(via_ops.numpy(), got)


def test_bucketize_matches_reference_rule():
    sizes = np.array([-7, -1, 0, 1, 3, 4, 5, 128, 129, 10_000], np.int32)
    for width, nb in ((1, 16), (4, 8), (128, 32)):
        want = np.asarray(rk._bucketize(jnp.asarray(sizes), width, nb))
        got = tk.bucketize(_t(sizes, torch.int32), width, nb).numpy()
        np.testing.assert_array_equal(got, want)


def test_sketch_window_rejects_bad_arguments():
    state = torch.zeros(16)
    sizes = torch.zeros((2, 4), dtype=torch.int32)
    w = torch.ones((2, 4))
    lens = torch.tensor([4, 4], dtype=torch.int32)
    totals = torch.ones(2)
    with pytest.raises(TypeError):
        ops.sketch_window(state, sizes.to(torch.int64), w, lens, 1.0, totals)
    with pytest.raises(ValueError):
        ops.sketch_window(state, sizes, w[:, :3].contiguous(), lens, 1.0,
                          totals)
    with pytest.raises(ValueError):
        ops.sketch_window(state, sizes, w, lens, 1.0, totals, bucket_width=0)
    with pytest.raises(ValueError):
        ops.sketch_window(state, sizes, w, lens, 1.0, totals,
                          out=torch.zeros(8))


def _drive(sketch_cls, batches, weights, **kw):
    sk = sketch_cls(**kw)
    for b, w in zip(batches, weights):
        sk.observe_many(b, w)
    return sk


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("half_life", [None, 50.0])
def test_device_sketch_matches_reference(window, half_life):
    rng = np.random.default_rng(7)
    batches = [rng.integers(-3, 300, n) for n in (40, 7, 1, 90, 40)]
    weights = [None, rng.uniform(0.5, 2.0, 7).astype(np.float32), 2.0,
               None, None]
    kw = dict(half_life=half_life, num_buckets=256, bucket_width=1,
              window=window)
    ref = _drive(ro.DeviceSizeSketch, batches, weights,
                 window_kernel=False, **kw)
    got = _drive(to.DeviceSizeSketch, batches, weights,
                 torch_device="cpu", **kw)
    assert got.n_dispatches == ref.n_dispatches
    for view in ("snapshot", "snapshot_weights"):
        (rs, rw_), (gs, gw) = getattr(ref, view)(), getattr(got, view)()
        np.testing.assert_array_equal(gs, rs)
        np.testing.assert_allclose(gw, rw_, **TOL)
    assert got.effective_count == pytest.approx(ref.effective_count,
                                                rel=1e-6)
    assert (got.n_observed, got.n_dispatches, got.n_host_syncs,
            got.n_scalar_syncs) == (ref.n_observed, ref.n_dispatches,
                                    ref.n_host_syncs, ref.n_scalar_syncs)
    np.testing.assert_array_equal(
        got.bucket_of(np.array([-1, 0, 5, 999])).numpy(),
        np.asarray(ref.bucket_of(np.array([-1, 0, 5, 999]))))
    np.testing.assert_array_equal(got.support_device.numpy(),
                                  np.asarray(ref.support_device))
    got.reset()
    assert (got.n_observed, got.n_dispatches, got.n_host_syncs,
            got.n_scalar_syncs) == (0, 0, 0, 0)
    assert got.snapshot()[0].size == 0


def test_observe_window_matches_reference_with_drift():
    rng = np.random.default_rng(5)
    batches = [rng.integers(1, 900, n) for n in (64, 1, 33, 200, 513)]
    weights = [rng.uniform(0.25, 3.0, len(b)).astype(np.float32)
               for b in batches]
    ref_sizes = rng.integers(1, 900, 300)
    kw = dict(half_life=300.0, num_buckets=256, bucket_width=4)
    r_ref = ro.DeviceSizeSketch(window_kernel=False, **kw)
    r_ref.observe_many(ref_sizes)
    t_ref = to.DeviceSizeSketch(torch_device="cpu", **kw)
    t_ref.observe_many(ref_sizes)
    r = ro.DeviceSizeSketch(window=True, window_kernel=False, **kw)
    t = to.DeviceSizeSketch(window=True, torch_device="cpu", **kw)
    r_drift = r.observe_window(batches, weights,
                               reference=r_ref.weights_device)
    t_drift = t.observe_window(batches, weights,
                               reference=t_ref.weights_device)
    assert t.n_dispatches == r.n_dispatches == 1
    assert float(t_drift) == pytest.approx(float(r_drift), abs=1e-6)
    np.testing.assert_allclose(t.weights_device.numpy(),
                               np.asarray(r.weights_device), **TOL)


def test_window_and_per_batch_paths_agree_bitwise():
    """One window launch gives the same bits as one launch per batch."""
    rng = np.random.default_rng(8)
    batches = [rng.integers(1, 900, n) for n in (64, 1, 33, 200, 300, 513)]
    kw = dict(half_life=300.0, num_buckets=256, bucket_width=4,
              torch_device="cpu")
    seq = to.DeviceSizeSketch(**kw)
    for b in batches:
        seq.observe_many(b)
    win = to.DeviceSizeSketch(window=True, **kw)
    win.observe_window(batches)
    assert seq.n_dispatches == len(batches) and win.n_dispatches == 1
    np.testing.assert_array_equal(win.weights_device.numpy(),
                                  seq.weights_device.numpy())


@pytest.mark.parametrize("window", [False, True])
def test_tensor_batches_match_host_batches(window):
    """Sizes and weights may arrive as tensors (straight out of a serve
    step), mixed with host arrays in one window."""
    rng = np.random.default_rng(6)
    batches = [rng.integers(1, 200, n) for n in (30, 5, 60)]
    weights = [rng.uniform(0.5, 2.0, len(b)).astype(np.float32)
               for b in batches]
    kw = dict(half_life=40.0, num_buckets=256, window=window,
              torch_device="cpu")
    host = to.DeviceSizeSketch(**kw)
    mixed = to.DeviceSizeSketch(**kw)
    for i, (b, w) in enumerate(zip(batches, weights)):
        host.observe_many(b, w)
        mixed.observe_many(torch.as_tensor(b) if i % 2 else b,
                           w if i % 2 else torch.as_tensor(w))
    assert torch.equal(mixed.weights_device, host.weights_device)
    assert mixed.n_dispatches == host.n_dispatches


def test_updates_in_place_unless_a_reference_escaped():
    sk = to.DeviceSizeSketch(num_buckets=64, torch_device="cpu")
    sk.observe_many([10, 10, 20])
    held = sk.weights_device                 # escapes: copy on next launch
    before = held.clone()
    sk.observe_many([30, 40, 50])
    assert torch.equal(held, before)
    current = sk._weights
    sk.observe_many([30])                     # nothing escaped: in place
    assert sk._weights is current and current[29] == 2.0


@pytest.mark.parametrize("metric", ["l1", "emd"])
def test_histogram_distance_device_matches_reference(metric):
    rng = np.random.default_rng(5)
    a = np.zeros(512, np.float32)
    b = np.zeros(512, np.float32)
    np.add.at(a, rng.integers(0, 500, 2000), 1.0)
    np.add.at(b, rng.integers(200, 480, 1500), 0.75)
    want = float(ro.histogram_distance_device(jnp.asarray(a), jnp.asarray(b),
                                              metric=metric))
    got = to.histogram_distance_device(_t(a, torch.float32),
                                       _t(b, torch.float32), metric=metric)
    assert got.dim() == 0
    assert float(got) == pytest.approx(want, abs=1e-6)
    z = torch.zeros(64)
    m = torch.zeros(64)
    m[3] = 5.0
    assert float(to.histogram_distance_device(z, z, metric=metric)) == 0.0
    assert float(to.histogram_distance_device(z, m, metric=metric)) == 1.0
    with pytest.raises(ValueError):
        to.histogram_distance_device(z, m, metric="chi2")


def test_default_torch_device_is_cuda():
    """Without ``torch_device`` the port runs on the card, and without a
    card it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        assert to.DeviceSizeSketch().torch_device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            to.DeviceSizeSketch()
