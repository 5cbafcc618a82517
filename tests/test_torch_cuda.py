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
