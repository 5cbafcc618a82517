"""The port's CUDA kernels on the card, at edge shapes chip_smoke.py does
not reach, against their plain PyTorch versions. Needs a card and nvcc:
each test skips without a card (the decision is made in the ``cuda``
fixture). Run on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Imports neither jax nor the reference package, so it runs where only
torch is installed.

Tolerances: waste_eval and waste_eval_fleet sum integer terms exactly
in double, so they must equal their plain versions bit for bit;
sketch_window's ``powf`` and the plain version's ``torch.pow`` may differ
in the last float32 bit, so its weights are held to rtol/atol 1e-5
(exact when decay is 1). The KV scatters move bits (bit for bit); decode
attention sums in another order than its plain version (rtol/atol 1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ControllerConfig, DeviceSizeSketch,  # noqa: E402
                              SlabController, SlabPolicy,
                              schedule_with_default_tail, size_histogram)
from repro_torch.core.distribution import PAPER_WORKLOADS  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.kv_scatter import (BLOCK_T,  # noqa: E402
                                            kv_append_ref,
                                            kv_chunk_copy_ref)
from repro_torch.kernels.ref import (  # noqa: E402
    slab_decode_attention_window_ref, waste_eval_fleet_ref, waste_eval_ref)
from repro_torch.kernels.sketch_update import (sketch_update_ref,  # noqa: E402
                                               sketch_window_ref)
from repro_torch.memcached import phase_shift_traffic  # noqa: E402
from repro_torch.serving import (KVSlabPool, OfflineHarness,  # noqa: E402
                                 lognormal_request_workload)

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


# -- the arbitration and serving slice's kernels ------------------------------

@pytest.mark.parametrize("b,k,s", [(1, 1, 1), (9, 6, 200), (40, 12, 700),
                                   (3, 1024, 50), (2, 4, 0)])
def test_waste_eval_fleet_kernel_equals_plain(cuda, b, k, s):
    rng = np.random.default_rng(b + k + s)
    chunks = torch.as_tensor(rng.integers(1, 40_000, (b, k)),
                             dtype=torch.int32)
    sup = torch.as_tensor(np.sort(rng.integers(0, 60_000, (b, s)), axis=1),
                          dtype=torch.int32)
    frq = torch.as_tensor(rng.integers(0, 900, (b, s)), dtype=torch.float32)
    want = waste_eval_fleet_ref(chunks, sup, frq, page_size=1 << 14)
    before = ops.waste_eval_fleet.n_launches
    got = ops.waste_eval_fleet(chunks.to(cuda), sup.to(cuda), frq.to(cuda),
                               page_size=1 << 14)
    torch.cuda.synchronize()
    assert ops.waste_eval_fleet.n_launches == before + 1
    assert torch.equal(got.cpu(), want)


def test_waste_eval_fleet_replicated_rows_equal_waste_eval(cuda):
    rng = np.random.default_rng(2)
    chunks = torch.as_tensor(rng.integers(48, 20_000, (33, 7)),
                             dtype=torch.int32, device=cuda)
    sup = torch.as_tensor(np.sort(rng.integers(1, 30_000, 400)),
                          dtype=torch.int32, device=cuda)
    for frq in (torch.as_tensor(rng.integers(1, 500, 400)),
                torch.as_tensor(rng.uniform(0.1, 7.0, 400))):
        frq = frq.to(device=cuda, dtype=torch.float32)
        one = ops.waste_eval(chunks, sup, frq, page_size=4096)
        fleet = ops.waste_eval_fleet(chunks, sup.expand(33, -1).contiguous(),
                                     frq.expand(33, -1).contiguous(),
                                     page_size=4096)
        assert torch.equal(one, fleet)


@pytest.mark.parametrize("h,d", [(8, 128), (1, 16), (1, 3)])
def test_kv_append_kernel_equals_plain(cuda, h, d):
    rng = np.random.default_rng(h * d)
    t = 4 * BLOCK_T
    pool = torch.as_tensor(rng.normal(size=(t, h, d)), dtype=torch.float32)
    rows = rng.permutation(t - 1)[:64].astype(np.int32)
    rows[::5] = -1                                   # skipped slots
    rows = torch.as_tensor(rows)
    vals = torch.as_tensor(rng.normal(size=(64, h, d)), dtype=torch.float32)
    want = kv_append_ref(pool.clone(), rows, vals)
    card = pool.to(cuda)
    before = ops.kv_append.n_launches
    assert ops.kv_append(card, rows.to(cuda), vals.to(cuda)) is card
    torch.cuda.synchronize()
    assert ops.kv_append.n_launches == before + 1
    assert torch.equal(card.cpu(), want)


CHUNK_CASES = [
    # (pool tiles, src, dst, n_tokens, max_copy_tokens)
    (8, [0, 2], [4, 6], [2 * BLOCK_T, BLOCK_T], 2 * BLOCK_T),
    (4, [0], [2], [0], 2 * BLOCK_T),                  # zero length
    (4, [0], [2], [5], 2 * BLOCK_T),                  # tile rounding
    (6, [0, 3], [2, 0], [BLOCK_T, BLOCK_T], BLOCK_T),  # WAR
    (6, [0, 1], [2, 3], [BLOCK_T, 0], 4 * BLOCK_T),   # junk tile
    (8, [0, 2, 5], [2, 4, 4], [BLOCK_T, 2 * BLOCK_T, BLOCK_T],
     2 * BLOCK_T),                                    # RAW and WAW
    (6, [0], [1], [3 * BLOCK_T], 3 * BLOCK_T),        # self-overlap
    (4, [0, 1], [2, 9], [-200, 3], BLOCK_T),          # negative, clamped
]


@pytest.mark.parametrize("case", range(len(CHUNK_CASES)))
def test_kv_chunk_copy_kernel_equals_plain(cuda, case):
    tiles, src, dst, n, w = CHUNK_CASES[case]
    rng = np.random.default_rng(case)
    pool = torch.as_tensor(rng.normal(size=(tiles * BLOCK_T, 2, 8)),
                           dtype=torch.float32)
    args = [torch.as_tensor(np.asarray(a) * (BLOCK_T if i < 2 else 1),
                            dtype=torch.int32)
            for i, a in enumerate((src, dst, n))]
    want = kv_chunk_copy_ref(pool.clone(), *args, max_copy_tokens=w)
    card = pool.to(cuda)
    before = ops.kv_chunk_copy.n_launches
    ops.kv_chunk_copy(card, *[a.to(cuda) for a in args], max_copy_tokens=w)
    torch.cuda.synchronize()
    assert ops.kv_chunk_copy.n_launches == before + 1
    assert torch.equal(card.cpu(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_chunk_copy_kernel_many_moves(cuda, seed):
    """64 random tile-aligned moves at the harness's widths, overlapping
    freely: the one-cluster kernel equals the sequential plain version."""
    rng = np.random.default_rng(seed)
    tiles, w = 40, 8 * BLOCK_T
    pool = torch.as_tensor(rng.normal(size=(tiles * BLOCK_T, 8, 128)),
                           dtype=torch.float32)
    src = torch.as_tensor(rng.integers(0, tiles - 8, 64) * BLOCK_T,
                          dtype=torch.int32)
    dst = torch.as_tensor(rng.integers(0, tiles - 8, 64) * BLOCK_T,
                          dtype=torch.int32)
    n = torch.as_tensor(rng.integers(-BLOCK_T, w + 1, 64), dtype=torch.int32)
    want = kv_chunk_copy_ref(pool.clone(), src, dst, n, max_copy_tokens=w)
    card = pool.to(cuda)
    ops.kv_chunk_copy(card, src.to(cuda), dst.to(cuda), n.to(cuda),
                      max_copy_tokens=w)
    assert torch.equal(card.cpu(), want)


@pytest.mark.parametrize("case", [3, 5, 6])
def test_kv_chunk_copy_kernel_odd_row_width(cuda, case):
    """Rows of 15 floats take the kernel's scalar (non-float4) copy."""
    tiles, src, dst, n, w = CHUNK_CASES[case]
    rng = np.random.default_rng(case)
    pool = torch.as_tensor(rng.normal(size=(tiles * BLOCK_T, 3, 5)),
                           dtype=torch.float32)
    args = [torch.as_tensor(np.asarray(a) * (BLOCK_T if i < 2 else 1),
                            dtype=torch.int32)
            for i, a in enumerate((src, dst, n))]
    want = kv_chunk_copy_ref(pool.clone(), *args, max_copy_tokens=w)
    card = pool.to(cuda)
    ops.kv_chunk_copy(card, *[a.to(cuda) for a in args], max_copy_tokens=w)
    assert torch.equal(card.cpu(), want)


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_attention_kernel_matches_plain(cuda, d, g):
    rng = np.random.default_rng(d + g)
    lens = np.asarray([0, 1, 127, 128, 1024, 700], np.int32)
    chunk, hkv = 1024, 2
    b = lens.size
    t = b * chunk + BLOCK_T
    q = torch.as_tensor(rng.normal(size=(b, hkv * g, d)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(t, hkv, d)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(t, hkv, d)), dtype=torch.float32)
    starts = torch.as_tensor(np.arange(b) * chunk, dtype=torch.int32)
    lens_t = torch.as_tensor(lens)
    want = slab_decode_attention_window_ref(q, k, v, starts, lens_t,
                                            max_chunk_tokens=chunk)
    args = [x.to(cuda) for x in (q, k, v, starts, lens_t)]
    before = ops.slab_decode_attention.n_launches
    got = ops.slab_decode_attention(*args, max_chunk_tokens=chunk)
    torch.cuda.synchronize()
    assert ops.slab_decode_attention.n_launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got[0].cpu(), torch.zeros_like(got[0].cpu()))
    # a sequence's bits do not depend on the batch it is in
    for i in (2, 4):
        alone = ops.slab_decode_attention(
            args[0][i:i + 1].contiguous(), args[1], args[2],
            args[3][i:i + 1].contiguous(), args[4][i:i + 1].contiguous(),
            max_chunk_tokens=chunk)
        assert torch.equal(alone[0], got[i])


def test_decode_graph_replay_equals_eager(cuda):
    """The batched harness (one CUDA-graph replay per tick) against the
    legacy one (eager, a request at a time) at the serving phase's
    widths: identical tokens, decisions and pools, one replay a tick,
    and the kernels' counters counting their wrappers' calls only (the
    warm-up and the capture), never a replay."""
    def run(mode):
        pool = KVSlabPool(32768, (128, 256, 512, 1024))
        h = OfflineHarness(pool, max_batch=16, mode=mode, hkv=8, d=128)
        wl = lognormal_request_workload(
            np.random.default_rng(7), 24, prompt_mean=96.0, prompt_std=64.0,
            output_mean=40.0, output_std=5.0, arrival_rate=4.0)
        return h, h.run(wl)

    before = ops.slab_decode_attention.n_launches
    gh, graph = run("batched")
    launches = ops.slab_decode_attention.n_launches - before
    eh, eager = run("legacy")
    assert graph.decisions() == eager.decisions()
    assert graph.tokens == eager.tokens and graph.generated_tokens > 0
    assert graph.realloc_copies > 0
    assert torch.equal(gh._k, eh._k) and torch.equal(gh._v, eh._v)
    assert graph.n_decode_dispatches <= graph.ticks
    assert graph.n_decode_dispatches > 2
    assert launches == 2                 # the warm-up and the capture


# -- the Hopper redesigns: sketch segmented sum, split-KV attention ------------

def _sketch_both(state, sizes, weights, lengths, decay, totals, width=1):
    """(kernel on the card, plain version on the CPU) of one window."""
    want = sketch_window_ref(state, sizes, weights, lengths.clamp(
        0, sizes.shape[1]), decay, totals, bucket_width=width)
    got = ops.sketch_window(*(t.to("cuda") for t in (state, sizes, weights,
                                                     lengths)),
                            decay, totals.to("cuda"), bucket_width=width)
    return got.cpu(), want


@pytest.mark.parametrize("size", [7, -1, 10**9], ids=["one_bin", "negative",
                                                      "past_bins"])
@pytest.mark.parametrize("rows,n", [(1, 5000), (3, 9000), (40, 7)])
def test_sketch_window_skewed_items(cuda, size, rows, n):
    """Every item in one bin (more hits than a block's threads, a row
    longer than a chunk, more rows than a chunk), every item negative
    (skipped) or past the grid (clipped into the last bin): unit weights
    and decay 1 bit for bit, decayed weights within 1e-5."""
    rng = np.random.default_rng(rows + n)
    state = torch.as_tensor(rng.random(8192), dtype=torch.float32)
    sizes = torch.full((rows, n), size, dtype=torch.int32)
    lengths = torch.full((rows,), n, dtype=torch.int32)
    ones = torch.ones((rows, n))
    got, want = _sketch_both(state, sizes, ones, lengths, 1.0,
                             torch.ones(rows))
    assert torch.equal(got, want)
    weights = torch.as_tensor(rng.uniform(0.5, 2.0, (rows, n)),
                              dtype=torch.float32)
    decay = 0.5 ** (1 / 1000)
    totals = torch.full((rows,), decay ** n, dtype=torch.float32)
    got, want = _sketch_both(state, sizes, weights, lengths, decay, totals)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bins", [1, 63, 64, 65, 100, 8191, (1 << 20) + 3])
def test_sketch_window_ragged_bins(cuda, bins):
    """BINS not a multiple of a block's 64 bins, with R = 0 (the state
    comes back unchanged) and a window whose sizes cover the grid; past
    2^20 bins the kernel finds a bin's block by integer division."""
    state, sizes, weights, lengths = _window_inputs(bins, bins, 4, 300, 1,
                                                    False)
    got = ops.sketch_window(state.to(cuda), sizes[:0].to(cuda),
                            weights[:0].to(cuda), lengths[:0].to(cuda), 0.9,
                            torch.ones(0, device=cuda))
    assert torch.equal(got.cpu(), state)
    got, want = _sketch_both(state, sizes, weights, lengths, 1.0,
                             torch.ones(4))
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", [(10, 512), (2, 64), (1, 512), (33, 16)],
                         ids=["fused", "gate", "per_batch", "many_rows"])
def test_sketch_window_equals_row_launches_on_paper_sizes(cuda, shape):
    """The main path's shapes on the paper's skewed sizes: one R-row
    launch gives the bits of R one-row launches, and the plain version's
    within 1e-5 (bit for bit at unit weights and decay 1)."""
    rows, n = shape
    sizes = torch.as_tensor(phase_shift_traffic(
        PAPER_WORKLOADS[0], PAPER_WORKLOADS[2], n_items=rows * n,
        seed=7).reshape(rows, n), dtype=torch.int32)
    lengths = torch.full((rows,), n, dtype=torch.int32)
    lengths[-1] = n - 3                          # a short last batch
    decay = 0.5 ** (1 / 10_000)
    totals = torch.as_tensor([decay ** int(x) for x in lengths],
                             dtype=torch.float32)
    state = torch.as_tensor(np.random.default_rng(1).random(8192) * 5,
                            dtype=torch.float32)
    weights = torch.ones((rows, n))
    got, want = _sketch_both(state, sizes, weights, lengths, decay, totals)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    card = [t.to(cuda) for t in (state, sizes, weights, lengths, totals)]
    rowwise = card[0].clone()
    for r in range(rows):
        ops.sketch_window(rowwise, card[1][r:r + 1], card[2][r:r + 1],
                          card[3][r:r + 1], decay, card[4][r:r + 1],
                          out=rowwise)
    assert torch.equal(rowwise.cpu(), got)
    unit, plain = _sketch_both(state, sizes, weights, lengths, 1.0,
                               torch.ones(rows))
    assert torch.equal(unit, plain)


def test_sketch_update_out_of_grid_ids_skipped(cuda):
    """The prebucketed entry: ids past BINS and negative ids add nothing,
    one hot id takes every other hit, bit for bit at unit weights."""
    ids = np.full(3000, 70, np.int32)
    ids[::3] = 8192
    ids[1::7] = -5
    state = torch.zeros(8192)
    idx = torch.as_tensor(ids)
    w = torch.ones(3000)
    want = sketch_update_ref(state, idx, w, 1.0)
    got = ops.sketch_update(state.to(cuda), idx.to(cuda), w.to(cuda), 1.0)
    assert torch.equal(got.cpu(), want)
    assert float(got.sum()) == float((ids == 70).sum())


def _attention_inputs(seed, lens, hkv, g, d, chunk):
    rng = np.random.default_rng(seed)
    b = len(lens)
    t = b * chunk + BLOCK_T
    mk = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=torch.float32)
    return (mk(b, hkv * g, d), mk(t, hkv, d), mk(t, hkv, d),
            torch.as_tensor(np.arange(b) * chunk, dtype=torch.int32),
            torch.as_tensor(np.asarray(lens, np.int32)))


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_attention_split_edges(cuda, d, g):
    """Lengths at the split edges (split - 1, split, split + 1, two
    splits +- 1, a tile's edges, the window) against the plain
    version."""
    chunk = 1024
    lens = [127, 128, 129, 255, 256, 257, 31, 32, 33, 1, chunk]
    args = _attention_inputs(d * g, lens, 2, g, d, chunk)
    want = slab_decode_attention_window_ref(*args, max_chunk_tokens=chunk)
    got = ops.slab_decode_attention(*(a.to(cuda) for a in args),
                                    max_chunk_tokens=chunk)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch", [64, 128])
def test_attention_bits_do_not_depend_on_the_batch(cuda, batch):
    """Each sequence alone gives the bits it gets in a batch of 64 or
    128, sequences spanning up to 16 splits included."""
    chunk = 1024
    rng = np.random.default_rng(batch)
    lens = np.clip(rng.lognormal(5.0, 0.9, batch), 0, chunk).astype(np.int32)
    lens[:4] = (chunk, 0, 64, 65)
    args = [a.to(cuda) for a in _attention_inputs(3, lens, 8, 4, 128, chunk)]
    full = ops.slab_decode_attention(*args, max_chunk_tokens=chunk)
    q, k, v, starts, ln = args
    for i in list(range(6)) + [batch - 1]:
        alone = ops.slab_decode_attention(
            q[i:i + 1].contiguous(), k, v, starts[i:i + 1].contiguous(),
            ln[i:i + 1].contiguous(), max_chunk_tokens=chunk)
        assert torch.equal(alone[0], full[i]), (i, int(lens[i]))
    # the same sequences in another order and beside other neighbours
    perm = torch.as_tensor(rng.permutation(batch), device=cuda)
    shuffled = ops.slab_decode_attention(
        q[perm].contiguous(), k, v, starts[perm].contiguous(),
        ln[perm].contiguous(), max_chunk_tokens=chunk)
    assert torch.equal(shuffled, full[perm])


@pytest.mark.parametrize("d,offset", [(3, 0), (17, 0), (100, 0), (128, 1)],
                         ids=["d3", "d17", "d100", "misaligned"])
def test_attention_scalar_copy_path(cuda, d, offset):
    """Rows that are not whole float4s (or pools that do not start on 16
    bytes) take the 4-byte copies: still the plain version's result."""
    chunk = 256
    q, k, v, starts, ln = _attention_inputs(d, [0, 1, 64, 65, 200, 256],
                                            2, 4, d, chunk)
    want = slab_decode_attention_window_ref(q, k, v, starts, ln,
                                            max_chunk_tokens=chunk)
    if offset:   # pools that start one float past an aligned address
        big = torch.zeros(k.numel() + offset, device=cuda)
        kc = big[offset:].view(k.shape)
        kc.copy_(k)
        big_v = torch.zeros(v.numel() + offset, device=cuda)
        vc = big_v[offset:].view(v.shape)
        vc.copy_(v)
        assert kc.data_ptr() % 16 and vc.data_ptr() % 16
    else:
        kc, vc = k.to(cuda), v.to(cuda)
    got = ops.slab_decode_attention(q.to(cuda), kc, vc, starts.to(cuda),
                                    ln.to(cuda), max_chunk_tokens=chunk)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_attention_long_window_wider_splits(cuda):
    """A window past 64 splits of 128 tokens takes 256-token splits:
    still the plain version's result, lengths at the new edges."""
    chunk = 9000
    lens = [8193, 255, 256, 257, chunk]
    args = _attention_inputs(9, lens, 1, 2, 64, chunk)
    want = slab_decode_attention_window_ref(*args, max_chunk_tokens=chunk)
    got = ops.slab_decode_attention(*(a.to(cuda) for a in args),
                                    max_chunk_tokens=chunk)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_attention_in_a_cuda_graph(cuda):
    """Captured once (its split scratch comes from the graph's pool),
    replayed on new inputs: the eager call's bits, every replay."""
    chunk = 1024
    lens = [1000, 0, 65, 300]
    q, k, v, starts, ln = (a.to(cuda) for a in _attention_inputs(
        11, lens, 8, 4, 128, chunk))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ops.slab_decode_attention(q, k, v, starts, ln,
                                  max_chunk_tokens=chunk)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.slab_decode_attention(q, k, v, starts, ln,
                                        max_chunk_tokens=chunk)
    rng = np.random.default_rng(12)
    for _ in range(3):
        q.copy_(torch.as_tensor(rng.normal(size=q.shape),
                                dtype=torch.float32))
        ln.copy_(torch.as_tensor(rng.integers(0, chunk + 1, len(lens)),
                                 dtype=torch.int32))
        graph.replay()
        eager = ops.slab_decode_attention(q, k, v, starts, ln,
                                          max_chunk_tokens=chunk)
        assert torch.equal(out, eager)
