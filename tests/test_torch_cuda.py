"""The port's CUDA kernels on the card, at edge shapes chip_smoke.py does
not reach, against their plain PyTorch versions. Needs a card and nvcc:
each test skips without a card (the decision is made in the ``cuda``
fixture). Run on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Imports neither jax nor the reference package, so it runs where only
torch is installed.

Tolerances: waste_eval sums integer terms exactly in double, so it must
equal its plain version bit for bit; sketch_window's ``powf`` and the
plain version's ``torch.pow`` may differ in the last float32 bit, so its
weights are held to rtol/atol 1e-5 (exact when decay is 1).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ControllerConfig, DeviceSizeSketch,  # noqa: E402
                              SlabController, SlabPolicy,
                              schedule_with_default_tail, size_histogram)
from repro_torch.core.distribution import PAPER_WORKLOADS  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.ref import waste_eval_ref  # noqa: E402
from repro_torch.kernels.sketch_update import (sketch_update_ref,  # noqa: E402
                                               sketch_window_ref)
from repro_torch.memcached import phase_shift_traffic  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with `PYTHONPATH=src "
                    "python -m pytest -q -m cuda tests/test_torch_cuda.py`")
    build.build()
    return torch.device("cuda")


def _waste_inputs(seed, b, k, s, page_size, *, integer=True):
    rng = np.random.default_rng(seed)
    support = np.sort(rng.integers(-5, 3 * page_size, s))
    freqs = (rng.integers(1, 1000, s) if integer
             else rng.uniform(0.1, 50.0, s))
    batch = rng.integers(1, 2 * page_size, (b, k))
    if b and k > 2:
        batch[0, 1] = batch[0, 2]               # duplicate chunk in a row
    return batch, support, freqs


@pytest.mark.parametrize("b,k,s", [(1, 1, 1), (7, 3, 100), (33, 8, 700),
                                   (5, 1024, 1000), (2, 5, 0), (0, 3, 10),
                                   (120, 6, 257)])
@pytest.mark.parametrize("page_size", [1000, 4096, 1 << 20])
def test_waste_eval_kernel_equals_plain(cuda, b, k, s, page_size):
    batch, support, freqs = _waste_inputs(b + k + s, b, k, s, page_size)
    args = [torch.as_tensor(batch, dtype=torch.int32),
            torch.as_tensor(support, dtype=torch.int32),
            torch.as_tensor(freqs, dtype=torch.float32)]
    want = waste_eval_ref(*args, page_size=page_size)
    got = ops.waste_eval(*[a.to(cuda) for a in args], page_size=page_size)
    torch.cuda.synchronize()
    assert got.shape == (b,)
    assert torch.equal(got.cpu(), want)


def test_waste_eval_kernel_fractional_freqs(cuda):
    batch, support, freqs = _waste_inputs(3, 9, 6, 400, 4096, integer=False)
    args = [torch.as_tensor(batch, dtype=torch.int32),
            torch.as_tensor(support, dtype=torch.int32),
            torch.as_tensor(freqs, dtype=torch.float32)]
    want = waste_eval_ref(*args, page_size=4096)
    got = ops.waste_eval(*[a.to(cuda) for a in args], page_size=4096)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=0)


def _window_inputs(seed, bins, rows, n, width, weighted):
    rng = np.random.default_rng(seed)
    state = rng.random(bins).astype(np.float32) * 3
    sizes = rng.integers(-10, bins * width + 100, (rows, n))
    weights = (rng.uniform(0.25, 3.0, (rows, n)) if weighted
               else np.ones((rows, n)))
    lengths = rng.integers(-2, n + 5, rows)      # below 0 and past N clamp
    return (torch.as_tensor(state), torch.as_tensor(sizes, dtype=torch.int32),
            torch.as_tensor(weights, dtype=torch.float32),
            torch.as_tensor(lengths, dtype=torch.int32))


@pytest.mark.parametrize("bins", [2, 255, 256, 257, 8192])
@pytest.mark.parametrize("rows,n", [(0, 4), (1, 512), (5, 300)])
@pytest.mark.parametrize("decay,weighted", [(1.0, False), (0.99, True)])
def test_sketch_window_kernel_matches_plain(cuda, bins, rows, n, decay,
                                            weighted):
    for width in (1, 4, 1000):
        state, sizes, weights, lengths = _window_inputs(
            bins + rows + width, bins, rows, n, width, weighted)
        clamped = lengths.clamp(0, n)
        totals = torch.tensor([decay ** int(x) for x in clamped.tolist()],
                              dtype=torch.float32)
        want = sketch_window_ref(state, sizes, weights, clamped, decay,
                                 totals, bucket_width=width)
        got = ops.sketch_window(state.to(cuda), sizes.to(cuda),
                                weights.to(cuda), lengths.to(cuda), decay,
                                totals.to(cuda), bucket_width=width).cpu()
        if decay == 1.0:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_sketch_window_in_place_and_rows_bitwise(cuda):
    """``out=state`` updates in place with the same bits as a fresh
    output, and one R-row launch gives the same bits as R launches."""
    state, sizes, weights, lengths = _window_inputs(9, 8192, 6, 512, 1, True)
    lengths = lengths.clamp(0, 512)
    decay = 0.5 ** (1 / 10_000)
    totals = torch.tensor([decay ** int(x) for x in lengths.tolist()],
                          dtype=torch.float32)
    state, sizes, weights, lengths, totals = (
        t.to(cuda) for t in (state, sizes, weights, lengths, totals))
    fresh = ops.sketch_window(state, sizes, weights, lengths, decay, totals)
    inplace = state.clone()
    assert ops.sketch_window(inplace, sizes, weights, lengths, decay, totals,
                             out=inplace) is inplace
    rowwise = state.clone()
    for r in range(sizes.shape[0]):
        ops.sketch_window(rowwise, sizes[r:r + 1], weights[r:r + 1],
                          lengths[r:r + 1], decay, totals[r:r + 1],
                          out=rowwise)
    assert torch.equal(inplace, fresh)
    assert torch.equal(rowwise, fresh)


def test_sketch_update_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    state = torch.as_tensor(rng.random(2000), dtype=torch.float32)
    idx = torch.as_tensor(rng.integers(-3, 2010, 700), dtype=torch.int32)
    w = torch.as_tensor(rng.random(700), dtype=torch.float32)
    want = sketch_update_ref(state, idx, w, 0.875)
    before = ops.sketch_update.n_launches
    got = ops.sketch_update(state.to(cuda), idx.to(cuda), w.to(cuda), 0.875)
    assert ops.sketch_update.n_launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_launch_counters_count_launches(cuda):
    sup = torch.tensor([10, 20], dtype=torch.int32, device=cuda)
    frq = torch.tensor([1.0, 2.0], device=cuda)
    before = ops.waste_eval.n_launches
    ops.waste_eval(torch.tensor([[16, 32]], dtype=torch.int32, device=cuda),
                   sup, frq)
    ops.waste_eval(torch.tensor([[16, 32]], dtype=torch.int32), sup.cpu(),
                   frq.cpu())                    # CPU: plain version
    assert ops.waste_eval.n_launches == before + 1
    with pytest.raises(ValueError):              # mixed devices
        ops.waste_eval(torch.tensor([[16, 32]], dtype=torch.int32), sup, frq)


@pytest.mark.parametrize("extra", [
    {}, dict(device=True, device_buckets=1 << 12, fused_observe=False),
    dict(device=True, device_buckets=1 << 12)],
    ids=["host", "per_batch", "fused"])
def test_controller_on_card_matches_cpu(cuda, extra):
    n = 12_000
    a, b = PAPER_WORKLOADS[0], PAPER_WORKLOADS[2]
    sizes = phase_shift_traffic(a, b, n_items=n, shift_at=0.5, seed=11)
    support, freqs = size_histogram(sizes[:n // 10])
    deployed = schedule_with_default_tail(SlabPolicy(torch_device="cpu").fit(
        support, freqs, 6, method="dp").chunk_sizes)
    common = dict(k=6, check_every=500, half_life=1000.0,
                  drift_threshold=0.12, min_items_between_refits=2000,
                  amortization_windows=8.0, cost_weight=0.1, **extra)
    ctls = [SlabController(deployed, config=ControllerConfig(
        **common, torch_device=dev)) for dev in ("cpu", "cuda")]
    before = (ops.waste_eval.n_launches, ops.sketch_window.n_launches)
    for i in range(0, n, 125):
        for c in ctls:
            c.observe_many(sizes[i:i + 125])
            c.maybe_refit()
    host, card = ctls
    assert card.n_refits == host.n_refits >= 1
    assert ([(d.approved, d.reason) for d in card.decisions]
            == [(d.approved, d.reason) for d in host.decisions])
    for dc, dh in zip(card.decisions, host.decisions):
        assert dc.drift == pytest.approx(dh.drift, abs=1e-6)
    np.testing.assert_array_equal(card.chunks, host.chunks)
    assert ops.waste_eval.n_launches > before[0]
    if extra:
        assert ops.sketch_window.n_launches > before[1]
        assert card.sketch.n_dispatches == host.sketch.n_dispatches


@pytest.mark.parametrize("window", [False, True])
def test_device_sketch_takes_card_tensors(cuda, window):
    """Batches straight out of a serve step (tensors on the card) fold in
    like host arrays, with no readback."""
    rng = np.random.default_rng(11)
    batches = [rng.integers(-2, 9000, n) for n in (512, 7, 300)]
    weights = [rng.uniform(0.5, 2.0, len(b)).astype(np.float32)
               for b in batches]
    kw = dict(half_life=1000.0, num_buckets=1 << 13, window=window)
    host = DeviceSizeSketch(torch_device="cpu", **kw)
    card = DeviceSizeSketch(torch_device="cuda", **kw)
    for b, w in zip(batches, weights):
        host.observe_many(b, w)
        card.observe_many(torch.as_tensor(b, device=cuda),
                          torch.as_tensor(w, device=cuda))
    torch.testing.assert_close(card.weights_device.cpu(),
                               host.weights_device, rtol=1e-5, atol=1e-5)
    assert card.n_dispatches == host.n_dispatches
    assert card.n_host_syncs == 0


def test_entry_points_default_to_the_card(cuda):
    assert DeviceSizeSketch().torch_device.type == "cuda"
    assert SlabPolicy().torch_device.type == "cuda"
    assert ControllerConfig().torch_device == "cuda"
