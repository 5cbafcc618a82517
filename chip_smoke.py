"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); no network, no JAX.
Phases, each printing a line of its numbers; any failed check exits
non-zero before the last line is printed:

1. environment: the card (``nvidia-smi`` name and power limit), versions,
   TF32 off;
2. build: the four CUDA sources compiled from ``src/repro_torch/csrc``
   (one ``nvcc`` each, in parallel);
3. kernels against plain: each of the six kernels at the main path's
   shapes against its plain PyTorch version, with kernel, plain, bound
   and library times (CUDA events, median of 20 runs after warm-up; see
   time_ms) and each shape's bound share (bound / kernel time) and ratio
   to the library call; the sketch window also against its rows'
   launches and, at decay 1, its plain version, bit for bit, and decode
   attention alone and reordered against its batched bits;
4. paper tables: Tables 1-5 at 1,000,000 items — the exact DP, the
   parallel hill climb driven by the waste_eval kernel and by the plain
   evaluator (both on the card), and the paper's Algorithm 1;
5. online loop: 200,000 phase-shifted items through the host, per-batch
   device and fused device controllers and a live ``SlabAllocator``;
6. arbitration: the legacy and fleet ``TenantArbiter`` on the fleet
   stream at 1,000 tenants (decisions equal across modes and to the
   reference's), and the device-sketch gate cell at 1,000 tenants (a
   [1000, 8192] sketch stack on the card; refit verdicts equal across
   modes and to the reference's, gate + score launches <= 2 per tick);
7. serving: the offline harness at Hkv = 8, D = 128 on the serving
   bench's full sweep (160 requests at batch 16, 64 and 128), its quick
   workload (72 requests at batch 16 and 64) and its two-tenant
   admission cell, batched (one CUDA-graph replay per tick) against
   legacy (eager), tokens and decisions equal to the reference's.

The launch counters are zeroed right before each of phases 4-7 and read
right after it, so each phase prints its own path's launches and fails
if a kernel of its path never ran. Counters count wrapper calls only: a
CUDA-graph replay does not advance them, and phase 7 reports the
replays beside them (``graph_replays``). The ``kernels`` line gives each
kernel's launches over phases 4-7 and per phase. The last line is the
device JSON.
"""
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "src"

# What the JAX package (``repro``) computes on the same inputs: the exact
# DP and the parallel hill climb on each table's 1,000,000-item seed-0
# traffic (``repro.core.SlabPolicy().fit(..., method="dp")`` and
# ``repro.core.parallel_hillclimb(old_chunks, ...)``), and the decisions
# of its host controller on phase 5's stream. Both are deterministic, so
# the port must reproduce them exactly.
REFERENCE_TABLES = {
    1: dict(dp=4234879, parallel=4237594, old=81987374),
    2: dict(dp=10868164, parallel=10884049, old=254586537),
    3: dict(dp=15757685, parallel=15771648, old=210990547),
    4: dict(dp=24440218, parallel=24440218, old=410999202),
    5: dict(dp=72978162, parallel=70058916, old=748978162),
}
REFERENCE_ONLINE = dict(
    refit_at_check=19, n_checks=39, cum_waste=3405647,
    reasons={"drift-below-threshold": 18, "cost-exceeds-savings": 18,
             "refit": 1, "cooldown": 1})

# Phase 6, what the reference computes on the same streams, with
# benchmarks/fleet_bench.py's own helpers (PAGE_SIZE 1 << 14, seed 7,
# 8 rounds; its legacy and fleet modes agree). ``decisions``: sha256 of
# ``repr`` of ``decisions_sig`` (every TransferDecision field, exact) on
# the fleet stream at 1,000 tenants:
#   PYTHONPATH=src:benchmarks JAX_PLATFORMS=cpu python -c "import hashlib,
#   fleet_bench as fb; s = fb.fleet_stream(1000, 8 * 1000 * 6, 7);
#   per = len(s) // 8; a = fb.build_arbiter(1000, fleet=True);
#   fb._drive(a, [s[i * per:(i + 1) * per] for i in range(8)]);
#   d = fb.decisions_sig(a); print(len(d),
#   hashlib.sha256(repr(d).encode()).hexdigest())"
# ``verdicts``: sha256 of ``repr`` of the gate cell's refit verdicts
# ``[(tenant, approved, reason), ...]`` (tenants sorted, drift left out:
# it is compared within 1e-6 across the port's modes) at 1,000 tenants:
#   ... a = fb.build_arbiter(1000, fleet=True, check_every=128,
#   device=True); rng = np.random.default_rng(7); then for r in range(8):
#   each tenant i observes sample_lognormal_sizes(rng, 64, w.mu * (1.6 if
#   (r // 2) % 2 else 1.0), w.sigma, max_size=fb.PAGE_SIZE) with
#   w = PAPER_WORKLOADS[i % 5], then a.tick(1) (fleet_bench.gate_cell).
REFERENCE_FLEET = dict(
    n_tenants=1000, rounds=8, n_decisions=32,
    decisions="07be5de72ccdadec9ba25a2c0a6dfcc98bfffad98026b7ff0ec086c901bad975",
    n_verdicts=3000, n_refits=1801,
    verdicts="6be1d596fb8ecc5a4e47dae5e9a17c312c7b86848ce277776b21a25be3103060")
# Phase 7, what the reference harness computes
# (``repro.serving.OfflineHarness(..., hkv=8, d=128, vocab=16)``,
# impl="ref", batched and legacy agreeing; JAX_PLATFORMS=cpu) on
# benchmarks/serving_bench.py's quick workload (``make_workload(72, 7)``
# over ``KVSlabPool(32768, CLASSES)``) and on its admission cell
# (``admission_workload(7)`` over ``KVSlabPool(8192, CLASSES)`` with
# quotas 4096/4096, ``token_quota_arbiter(pool, unit_tokens=512,
# arbitrate_every=2)``, batch 64): ``HarnessResult.decisions()``,
# ``generated_tokens`` and ``tokens_digest(result.tokens)``. The full
# sweep's cells are the same harness on ``make_workload(160, 7)`` over
# ``KVSlabPool(32768, CLASSES)`` at batch 16, 64 and 128.
REFERENCE_SERVING = {
    "full16": dict(decisions=(101, 160, 0, 5, 640, 0, 0), generated=1439,
                   tokens="7f47db94a69fe2a329f09bc23c6815e2d26e0ad37c7477b8"
                          "e1bd2a86ace51dde"),
    "full64": dict(decisions=(58, 160, 0, 5, 640, 0, 0), generated=1439,
                   tokens="7f47db94a69fe2a329f09bc23c6815e2d26e0ad37c7477b8"
                          "e1bd2a86ace51dde"),
    "full128": dict(decisions=(58, 160, 0, 5, 640, 0, 0), generated=1439,
                    tokens="7f47db94a69fe2a329f09bc23c6815e2d26e0ad37c7477b8"
                           "e1bd2a86ace51dde"),
    "quick16": dict(decisions=(49, 72, 0, 3, 384, 0, 0), generated=630,
                    tokens="39f1dd5274a45de73589882b4515e37273cc0ece80dd7d0d"
                           "16f03c3c5068190a"),
    "quick64": dict(decisions=(33, 72, 0, 3, 384, 0, 0), generated=630,
                    tokens="39f1dd5274a45de73589882b4515e37273cc0ece80dd7d0d"
                           "16f03c3c5068190a"),
    "admission64": dict(decisions=(60, 66, 14, 3, 384, 0, 10),
                        generated=637,
                        tokens="1d73965da8d58175e43d277db165554bcfc3a0b43651"
                               "bcc998617660f1319ce6"),
}
SERVING_CLASSES = (128, 256, 512, 1024)
FLEET_PAGE = 1 << 14

HILLCLIMB_TABLES = (1, 2, 3, 4, 5)  # tables run through Algorithm 1
HILLCLIMB_MAX_STEPS = 150_000  # the cap of examples/memcached_repro.py
F32_OPS_PER_S = 67e12         # H100 SXM float32 non-tensor peak
BYTES_PER_S = 3.35e12         # H100 SXM HBM3 bandwidth


# The six kernels, and the three of the serving decode tick.
KERNELS = ("waste_eval", "sketch_window", "waste_eval_fleet",
           "slab_decode_attention", "kv_append", "kv_chunk_copy")
DECODE_KERNELS = ("slab_decode_attention", "kv_append", "kv_chunk_copy")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def zero_launches(ops) -> None:
    for name in KERNELS + ("sketch_update",):
        getattr(ops, name).n_launches = 0


def read_launches(ops) -> dict:
    """Launches per kernel since the last ``zero_launches`` (the
    single-row ``sketch_update`` entry runs the sketch_window kernel)."""
    out = {name: getattr(ops, name).n_launches for name in KERNELS}
    out["sketch_window"] += ops.sketch_update.n_launches
    return out


def phase_counts(ops, phase: int, path) -> dict:
    """Read and print a phase's launches; fail if a kernel of its path
    (``path``) never ran."""
    counts = read_launches(ops)
    print(f"[launches phase {phase}] "
          + " ".join(f"{k}={v}" for k, v in counts.items()), flush=True)
    for name in path:
        check(counts[name] > 0,
              f"{name} was not launched on phase {phase}'s path")
    return counts


def spin_cycles_per_ms(torch) -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    torch.cuda._sleep(1_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(20_000_000)
    end.record()
    end.synchronize()
    return 20_000_000 / start.elapsed_time(end)


def time_ms(torch, fn, cycles_per_ms: float, *, runs: int = 20,
            calls: int = 10):
    """``(device_ms, call_ms)`` of one call of ``fn``, CUDA events.

    ``device_ms`` is the median over ``runs`` runs of the time of
    ``calls`` back-to-back calls divided by ``calls``; each run is queued
    behind a spin kernel that outlasts the host's enqueueing, so the card
    runs the calls without gaps and the host's launch overhead is not
    counted. This holds while a run's launches fit in the card's launch
    queue and ``fn`` never waits for the card. ``call_ms`` is the median time of one call issued with the
    card idle, host overhead included (what a caller waiting on it sees).
    """
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int(cycles_per_ms * max(4 * host_ms, 1.0))
    device, call = [], []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end) / calls)
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        call.append(start.elapsed_time(end))
    return statistics.median(device), statistics.median(call)


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def shape_entry(label: str, shape, ms: float, bound_ms: float,
                library_ms=None) -> dict:
    """One timed shape of a kernel: its time, its share of the bound
    (bound_ms / ms) and its ratio to the library call (ms / library_ms,
    null without one)."""
    return {"label": label, "shape": list(shape), "ms": ms,
            "bound_ms": bound_ms, "library_ms": library_ms,
            "bound_share": bound_ms / ms,
            "library_ratio": None if library_ms is None
            else ms / library_ms}


def shares(entry: dict) -> str:
    """The printed form of a shape's bound share and library ratio."""
    lib = entry["library_ratio"]
    return (f"bound_share={entry['bound_share']:.3f} vs_library="
            + ("null" if lib is None else f"{lib:.2f}x"))


def tokens_digest(tokens) -> str:
    """sha256 of a harness's generated tokens, ``{rid: [token, ...]}``."""
    rows = sorted((int(k), [int(t) for t in v]) for k, v in tokens.items())
    return hashlib.sha256(json.dumps(rows).encode()).hexdigest()


def serving_workload(Request, lognormal_request_workload, cell: str):
    """benchmarks/serving_bench.py's full workload (160 requests, seed 7),
    its quick one (72 requests) or its two-tenant admission workload (40
    requests a tenant, peaks 30 ticks apart, seed 7), rebuilt fresh: the
    harness mutates requests."""
    rng = np.random.default_rng(7)
    if not cell.startswith("admission"):
        n = 160 if cell.startswith("full") else 72
        return lognormal_request_workload(
            rng, n, prompt_mean=96.0, prompt_std=64.0, output_mean=10.0,
            output_std=5.0, arrival_rate=4.0)
    reqs = []
    for k, (tenant, phase) in enumerate((("a", 0.0), ("b", 30.0))):
        prompts = np.clip(rng.lognormal(5.2, 0.5, 40), 16, 1024).astype(int)
        outputs = np.clip(rng.lognormal(2.2, 0.5, 40), 1, 64).astype(int)
        arrivals = phase + np.cumsum(rng.exponential(1.0 / 4.0, 40))
        for i in range(40):
            reqs.append(Request(rid=1000 * k + i, prompt_len=int(prompts[i]),
                                output_len=int(outputs[i]),
                                arrival=float(arrivals[i]), tenant=tenant))
    return reqs


def compare_kernel(torch, name, got, want, *, exact: bool) -> float:
    """Fail unless ``got`` (kernel) matches ``want`` (plain version):
    bit for bit, or within rtol/atol 1e-5. Returns the max abs error."""
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    if exact:
        check(torch.equal(got, want), f"{name} differs from its plain "
              "version (must be bit for bit)")
    else:
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"{name} disagrees with its plain version beyond "
              "rtol/atol 1e-5")
    return float((got - want).abs().max()) if got.numel() else 0.0


def serving_kernels(torch, dev, cyc, results) -> None:
    """Phase 3 for the arbitration and serving slice: waste_eval_fleet at
    the gate cell's shape (1,000 tenants x 3 frontier rows), the KV
    scatters at the serving harness's pool (Hkv = 8, D = 128, batch 64)
    and decode attention at Mixtral-8x7B's per-layer KV width (Hq = 32,
    Hkv = 8, D = 128) and at the harness's G = 1, each against its plain
    version, with kernel, plain, bound and library times."""
    import torch.nn.functional as F

    from repro_torch.core import (PAPER_WORKLOADS, default_memcached_schedule,
                                  size_histogram)
    from repro_torch.core.distribution import sample_lognormal_sizes
    from repro_torch.kernels import ops
    from repro_torch.kernels.kv_scatter import (kv_append_ref,
                                                kv_chunk_copy_ref)
    from repro_torch.kernels.ref import (slab_decode_attention_window_ref,
                                         waste_eval_fleet_ref)
    rng = np.random.default_rng(7)

    # waste_eval_fleet: three frontier rows per tenant, each tenant's
    # histogram of 128 sizes (two check windows of the gate cell).
    n_t = 1000
    sched = default_memcached_schedule(page_size=FLEET_PAGE)
    hists = [size_histogram(sample_lognormal_sizes(
        rng, 128, PAPER_WORKLOADS[i % 5].mu, PAPER_WORKLOADS[i % 5].sigma,
        max_size=FLEET_PAGE)) for i in range(n_t)]
    s_max = max(len(h[0]) for h in hists)
    k_ = len(sched)
    chunks = np.empty((3 * n_t, k_), np.int64)
    sup = np.zeros((3 * n_t, s_max), np.int64)
    frq = np.zeros((3 * n_t, s_max), np.int64)
    for i, (hs, hf) in enumerate(hists):
        for j in range(3):
            row = sched if j == 0 else np.clip(
                sched + rng.integers(-64, 64, k_), 48, FLEET_PAGE)
            chunks[3 * i + j] = row
            sup[3 * i + j, :len(hs)] = hs
            frq[3 * i + j, :len(hf)] = hf
    args = (torch.as_tensor(chunks, dtype=torch.int32, device=dev),
            torch.as_tensor(sup, dtype=torch.int32, device=dev),
            torch.as_tensor(frq, dtype=torch.float32, device=dev))
    got = ops.waste_eval_fleet(*args, page_size=FLEET_PAGE)
    err = compare_kernel(torch, "waste_eval_fleet", got,
                         waste_eval_fleet_ref(*args, page_size=FLEET_PAGE),
                         exact=True)
    one = ops.waste_eval(args[0][:3].contiguous(), args[1][0].contiguous(),
                         args[2][0].contiguous(), page_size=FLEET_PAGE)
    check(torch.equal(one, got[:3]), "waste_eval_fleet on a tenant's rows "
          "differs from waste_eval on its histogram")
    b_ = 3 * n_t
    bms, by = bound(4 * (b_ * k_ + 2 * b_ * s_max + b_),
                    b_ * s_max * (int(np.ceil(np.log2(k_ + 1))) + 2))
    ms, call = time_ms(torch, lambda: ops.waste_eval_fleet(
        *args, page_size=FLEET_PAGE), cyc)
    plain_ms, plain_call = time_ms(torch, lambda: waste_eval_fleet_ref(
        *args, page_size=FLEET_PAGE), cyc)
    sh = shape_entry("gate", (b_, k_, s_max), ms, bms)
    results["waste_eval_fleet"] = dict(
        route="cuda", source="src/repro_torch/csrc/waste_eval.cu",
        replaces="src/repro/kernels/waste_eval.py:135", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=None, shapes=[sh])
    print(f"[kernel] waste_eval_fleet (B,K,S)=({b_},{k_},{s_max}) "
          f"max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bms:.2e} ({by}) library_ms=null {shares(sh)}; per "
          f"call with host overhead: {call:.4f} / plain {plain_call:.4f}",
          flush=True)

    # The serving harness's pools: 32,768 tokens + a 1,024-token tail.
    hkv, d, w_max, batch = 8, 128, 1024, 64
    t_pool = 32768 + w_max
    row_bytes = hkv * d * 4
    pool = torch.randn((t_pool, hkv, d), device=dev)

    # kv_append: a 64-slot tick, a quarter of the slots inactive.
    rows = rng.permutation(32768)[:batch].astype(np.int32)
    rows[::4] = -1
    live = rows >= 0
    rows_t = torch.as_tensor(rows, device=dev)
    vals = torch.randn((batch, hkv, d), device=dev)
    live_rows = torch.as_tensor(rows[live].astype(np.int64), device=dev)
    live_vals = vals[torch.as_tensor(live, device=dev)].contiguous()
    got = ops.kv_append(pool.clone(), rows_t, vals)
    err = compare_kernel(torch, "kv_append", got,
                         kv_append_ref(pool.clone(), rows_t, vals),
                         exact=True)
    scratch = pool.clone()
    n_live = int(live.sum())
    bms, by = bound(2 * n_live * row_bytes + 4 * batch, 0)
    ms, call = time_ms(torch, lambda: ops.kv_append(scratch, rows_t, vals),
                       cyc)
    plain_ms, plain_call = time_ms(torch, lambda: kv_append_ref(
        scratch, rows_t, vals), cyc)
    lib_ms, lib_call = time_ms(torch, lambda: scratch.index_copy_(
        0, live_rows, live_vals), cyc)
    sh = shape_entry("tick", (t_pool, hkv, d, batch), ms, bms, lib_ms)
    results["kv_append"] = dict(
        route="cuda", source="src/repro_torch/csrc/kv_scatter.cu",
        replaces="src/repro/kernels/kv_scatter.py:47", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms, shapes=[sh])
    print(f"[kernel] kv_append (T,H,D,B)=({t_pool},{hkv},{d},{batch}) "
          f"live={n_live} max_abs_err={err} ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} bound_ms={bms:.2e} ({by}) library_ms={lib_ms:.4f}"
          f" (index_copy_) {shares(sh)}; per call with host overhead: {call:.4f} / "
          f"plain {plain_call:.4f} / library {lib_call:.4f}", flush=True)

    # kv_chunk_copy: a 64-slot tick with three class-overflow moves into
    # free chunks (disjoint ranges, so repeated calls are idempotent).
    src = np.zeros(batch, np.int32)
    dst = np.zeros(batch, np.int32)
    ntok = np.zeros(batch, np.int32)
    for j, (a_, b2, n) in enumerate(((0, 8192, 300), (2048, 12288, 700),
                                     (4096, 16384, 129))):
        src[5 * j], dst[5 * j], ntok[5 * j] = a_, b2, n
    mv = [torch.as_tensor(x, device=dev) for x in (src, dst, ntok)]
    tiled = [-(-int(n) // 128) * 128 for n in ntok if n > 0]
    src_idx = torch.as_tensor(np.concatenate(
        [np.arange(a_, a_ + t) for a_, t in zip(src[ntok > 0], tiled)]),
        device=dev)
    dst_idx = torch.as_tensor(np.concatenate(
        [np.arange(b2, b2 + t) for b2, t in zip(dst[ntok > 0], tiled)]),
        device=dev)
    got = ops.kv_chunk_copy(pool.clone(), *mv, max_copy_tokens=w_max)
    err = compare_kernel(torch, "kv_chunk_copy", got, kv_chunk_copy_ref(
        pool.clone(), *mv, max_copy_tokens=w_max), exact=True)
    check(torch.equal(got[dst_idx], pool[src_idx]),
          "kv_chunk_copy did not move the chunks")
    moved = sum(tiled)
    bms, by = bound(2 * moved * row_bytes + 3 * 4 * batch, 0)
    ms, call = time_ms(torch, lambda: ops.kv_chunk_copy(
        scratch, *mv, max_copy_tokens=w_max), cyc)
    # ~5 launches per move: queue 2 calls a run (see sketch_window)
    plain_ms, plain_call = time_ms(torch, lambda: kv_chunk_copy_ref(
        scratch, *mv, max_copy_tokens=w_max), cyc, calls=2)
    lib_ms, lib_call = time_ms(torch, lambda: scratch.index_copy_(
        0, dst_idx, scratch.index_select(0, src_idx)), cyc)
    sh = shape_entry("tick", (t_pool, hkv, d, batch, w_max), ms, bms, lib_ms)
    results["kv_chunk_copy"] = dict(
        route="cuda", source="src/repro_torch/csrc/kv_scatter.cu",
        replaces="src/repro/kernels/kv_scatter.py:111", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms, shapes=[sh])
    print(f"[kernel] kv_chunk_copy (T,H,D,M,W)=({t_pool},{hkv},{d},{batch},"
          f"{w_max}) moved={moved} rows max_abs_err={err} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={bms:.2e} ({by}) library_ms="
          f"{lib_ms:.4f} (index_select + index_copy_) {shares(sh)}; per "
          f"call with host "
          f"overhead: {call:.4f} / plain {plain_call:.4f} / library "
          f"{lib_call:.4f}", flush=True)
    del pool, scratch

    # decode attention: 64 sequences of the harness's chunk window, with
    # KV lengths spread like a serving batch's (1 .. 1,024).
    lens = np.clip(rng.lognormal(5.0, 0.9, batch), 1, w_max).astype(np.int32)
    lens[:2] = (w_max, 1)
    att = {}
    for label, g in (("mixtral", 4), ("harness", 1)):
        t_att = batch * w_max + 128
        q = torch.randn((batch, hkv * g, d), device=dev)
        kp = torch.randn((t_att, hkv, d), device=dev)
        vp = torch.randn((t_att, hkv, d), device=dev)
        starts = torch.arange(batch, dtype=torch.int32, device=dev) * w_max
        lens_t = torch.as_tensor(lens, device=dev)
        a_args = (q, kp, vp, starts, lens_t)
        got = ops.slab_decode_attention(*a_args, max_chunk_tokens=w_max)
        err = compare_kernel(torch, f"slab_decode_attention[{label}]", got,
                             slab_decode_attention_window_ref(
                                 *a_args, max_chunk_tokens=w_max),
                             exact=False)
        # a sequence's bits do not depend on the batch it is in: alone,
        # and in the batch reversed, it gets the batched bits
        for i in (0, 1, 2, batch - 1):
            alone = ops.slab_decode_attention(
                q[i:i + 1].contiguous(), kp, vp, starts[i:i + 1].contiguous(),
                lens_t[i:i + 1].contiguous(), max_chunk_tokens=w_max)
            check(torch.equal(alone[0], got[i]),
                  f"slab_decode_attention[{label}]: sequence {i} alone "
                  "differs from its bits in the batch")
        rev = torch.arange(batch - 1, -1, -1, device=dev)
        flipped = ops.slab_decode_attention(
            q[rev].contiguous(), kp, vp, starts[rev].contiguous(),
            lens_t[rev].contiguous(), max_chunk_tokens=w_max)
        check(torch.equal(flipped, got[rev]),
              f"slab_decode_attention[{label}]: a reordered batch changes "
              "the bits")
        n_tok = int(lens.sum())
        bms, by = bound(2 * q.numel() * 4 + 2 * n_tok * hkv * d * 4
                        + 8 * batch, 4 * n_tok * hkv * g * d)
        ms, call = time_ms(torch, lambda: ops.slab_decode_attention(
            *a_args, max_chunk_tokens=w_max), cyc)
        plain_ms, plain_call = time_ms(
            torch, lambda: slab_decode_attention_window_ref(
                *a_args, max_chunk_tokens=w_max), cyc, calls=2)
        # yardstick: SDPA over the gathered windows, GQA heads expanded
        idx = (starts[:, None].long()
               + torch.arange(w_max, device=dev)[None, :])
        kg = kp[idx].permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        vg = vp[idx].permute(0, 2, 1, 3).repeat_interleave(g, 1).contiguous()
        mask = (torch.arange(w_max, device=dev)[None, :]
                < lens_t[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask)
        sdpa_err = float((sdpa[:, :, 0] - got).abs().max())
        check(sdpa_err <= 1e-3, f"SDPA yardstick[{label}] computes "
              f"something else (max abs diff {sdpa_err})")
        lib_ms, lib_call = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask), cyc)
        del kg, vg
        sh = shape_entry(label, (batch, hkv * g, hkv, d, w_max), ms, bms,
                         lib_ms)
        att[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, library_ms=lib_ms,
                          shape=sh)
        print(f"[kernel] slab_decode_attention {label} (B,Hq,Hkv,D,W)="
              f"({batch},{hkv * g},{hkv},{d},{w_max}) tokens={n_tok} "
              f"max_abs_err={err} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={bms:.2e} ({by}) library_ms={lib_ms:.4f} (SDPA "
              f"over gathered windows, max abs diff {sdpa_err:.1e}) "
              f"{shares(sh)}; alone and reordered == batched bits; per "
              f"call with host overhead: "
              f"{call:.4f} / plain {plain_call:.4f} / library "
              f"{lib_call:.4f}", flush=True)
    results["slab_decode_attention"] = dict(
        att["mixtral"], route="cuda",
        source="src/repro_torch/csrc/slab_attention.cu",
        replaces="src/repro/kernels/slab_attention.py:84",
        max_abs_err=max(v["max_abs_err"] for v in att.values()),
        shapes=[v["shape"] for v in att.values()])


def build_fleet_arbiter(n: int, *, fleet: bool, device: bool = False,
                        check_every: int = 10**9, torch_device="cuda"):
    """benchmarks/fleet_bench.py's arbiter, built from the port: a pool
    of 2 pages (16 KiB) per tenant shared equally, a demand forecaster,
    one ``SlabAllocator`` per tenant, controllers on the card."""
    from repro_torch.core import (ControllerConfig, PagePool, TenantArbiter,
                                  default_memcached_schedule)
    from repro_torch.core.forecast import DemandForecaster
    from repro_torch.memcached import SlabAllocator
    pool = PagePool(2 * n, page_size=FLEET_PAGE)
    cfg = ControllerConfig(page_size=FLEET_PAGE, check_every=check_every,
                           min_items_between_refits=2 * check_every,
                           device=device, torch_device=torch_device)
    arb = TenantArbiter(pool, controller_config=cfg, arbitrate_every=10**9,
                        forecast=DemandForecaster(ring=12,
                                                  min_confidence=0.05),
                        fleet=fleet, fleet_capacity=max(8, n))
    classes = default_memcached_schedule(page_size=FLEET_PAGE)
    for i in range(n):
        name = f"t{i:05d}"
        arb.register(name, SlabAllocator(classes, page_size=FLEET_PAGE,
                                         page_pool=pool, tenant=name))
    pool.equal_partition(floor=1)
    return arb


def arbitration_phase(torch, torch_device="cuda") -> None:
    """Phase 6: the legacy and fleet arbiters on the fleet stream (host
    path) and the device-sketch gate cell, both at 1,000 tenants."""
    from repro_torch.core.distribution import (PAPER_WORKLOADS,
                                               sample_lognormal_sizes)
    from repro_torch.memcached import fleet_stream
    ref = REFERENCE_FLEET
    n, rounds = ref["n_tenants"], ref["rounds"]
    stream = fleet_stream(n, rounds * n * 6, 7)
    per = len(stream) // rounds
    sigs = {}
    for mode, fleet in (("legacy", False), ("fleet", True)):
        t0 = time.perf_counter()
        arb = build_fleet_arbiter(n, fleet=fleet, torch_device=torch_device)
        tick_s = 0.0
        for r in range(rounds):
            for phys, op in stream[r * per:(r + 1) * per]:
                name = f"t{phys:05d}"
                if op.op == "set":
                    arb.set(name, op.key, op.size)
                elif op.op == "delete":
                    arb.delete(name, op.key)
                elif not arb.get(name, op.key):
                    arb.set(name, op.key, op.size)
            t1 = time.perf_counter()
            arb.tick(0)
            arb.arbitrate()
            tick_s += time.perf_counter() - t1
        sig = [(d.approved, d.reason, d.donor, d.recipient, d.benefit,
                d.cost, d.forecast_penalty, d.evicted_items,
                d.evicted_bytes, d.at_op) for d in arb.decisions]
        sigs[mode] = sig
        digest = hashlib.sha256(repr(sig).encode()).hexdigest()
        check(len(sig) == ref["n_decisions"] and digest == ref["decisions"],
              f"arbiter[{mode}] decisions ({len(sig)}, {digest[:16]}) differ "
              "from the reference's")
        print(f"[arbiter {mode}] {n} tenants, {len(stream):,} ops, "
              f"{rounds} rounds: {len(sig)} decisions, {arb.n_transfers} "
              f"transfers, digest == reference; decision path "
              f"{1e3 * tick_s / rounds:.2f} ms/tick, run "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    check(sigs["legacy"] == sigs["fleet"], "legacy and fleet decisions differ")

    # device gate cell: every tenant observes 64 sizes a round through the
    # serving-mode observe/tick route, checks every 128 observations
    w = len(PAPER_WORKLOADS)
    side = {}
    for mode, fleet in (("legacy", False), ("fleet", True)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        arb = build_fleet_arbiter(n, fleet=fleet, device=True,
                                  check_every=128, torch_device=torch_device)
        rng = np.random.default_rng(7)
        for r in range(rounds):
            for i in range(n):
                wl = PAPER_WORKLOADS[i % w]
                mu = wl.mu * (1.6 if (r // 2) % 2 else 1.0)
                arb.observe(f"t{i:05d}", sample_lognormal_sizes(
                    rng, 64, mu, wl.sigma, max_size=FLEET_PAGE))
            arb.tick(1)
        torch.cuda.synchronize()
        decisions = [(name, d) for name in sorted(arb.tenants)
                     for d in arb.tenants[name].controller.decisions]
        verdicts = [(name, d.approved, d.reason) for name, d in decisions]
        side[mode] = dict(
            sig=[v + (round(float(d.drift), 6),)
                 for v, (_, d) in zip(verdicts, decisions)],
            gate=arb.n_gate_launches, score=arb.n_score_launches,
            frontiers=arb.n_frontiers_scored)
        digest = hashlib.sha256(repr(verdicts).encode()).hexdigest()
        n_refits = sum(v[1] for v in verdicts)
        check(len(verdicts) == ref["n_verdicts"]
              and n_refits == ref["n_refits"]
              and digest == ref["verdicts"],
              f"gate cell[{mode}] verdicts ({len(verdicts)}, {n_refits} "
              f"refits, {digest[:16]}) differ from the reference's")
        stack = ""
        if fleet:
            sk = arb.fleet.sketch
            check(sk.device.type == torch_device
                  and tuple(sk.shape) == (n, 8192),
                  f"fleet sketch stack {tuple(sk.shape)} not on "
                  f"{torch_device}")
            stack = (f" sketch stack {tuple(sk.shape)} "
                     f"{sk.numel() * 4 / 2**20:.0f} MiB on {sk.device};")
        print(f"[gate {mode}] {n} tenants x {rounds} ticks: "
              f"{len(verdicts)} checks, {n_refits} refits (== reference), "
              f"gate launches={arb.n_gate_launches} score launches="
              f"{arb.n_score_launches} frontiers={arb.n_frontiers_scored};"
              f"{stack} peak {torch.cuda.max_memory_allocated() / 2**20:.0f}"
              f" MiB; {time.perf_counter() - t0:.1f} s", flush=True)
    fl = side["fleet"]
    check(side["legacy"]["sig"] == fl["sig"],
          "gate cell: legacy and fleet refit verdicts differ")
    check(1 <= fl["gate"] and fl["gate"] + fl["score"] <= 2 * rounds,
          f"gate cell: {fl['gate']} gate + {fl['score']} score launches "
          f"break the bound of 2 per tick ({rounds} ticks)")


def top_two_gap(OfflineHarness, make_pool, workload, batch):
    """Smallest gap between the two largest scores any decode step's
    argmax saw, in a run of the plain versions on the CPU (a diagnostic
    for a token that differs from the reference's)."""
    from repro_torch.kernels import ops
    gaps = []
    attend = ops.slab_decode_attention

    def recording(*args, **kw):
        out = attend(*args, **kw)
        top = out[:, 0, :16].topk(2, dim=-1).values
        gaps.append(float((top[:, 0] - top[:, 1]).min()))
        return out

    ops.slab_decode_attention = recording
    try:
        pool, arb = make_pool("cpu")
        OfflineHarness(pool, max_batch=batch, hkv=8, d=128, vocab=16,
                       arbiter=arb, torch_device="cpu").run(workload)
    finally:
        ops.slab_decode_attention = attend
    return min(gaps)


def serving_phase(torch, torch_device="cuda") -> int:
    """Phase 7: the offline harness on the card, batched (one CUDA-graph
    replay per tick) against legacy (eager, a request at a time), on the
    serving bench's full sweep, quick workload and admission cell.
    Returns the batched runs' decode dispatches (graph replays)."""
    from repro_torch.serving import (KVSlabPool, OfflineHarness, Request,
                                     lognormal_request_workload,
                                     token_quota_arbiter)

    def make_pool(device, cell):
        if not cell.startswith("admission"):
            return KVSlabPool(32768, SERVING_CLASSES,
                              torch_device=device), None
        pool = KVSlabPool(8192, SERVING_CLASSES, torch_device=device)
        for name in ("a", "b"):
            pool.register_tenant(name, quota_tokens=4096)
        return pool, token_quota_arbiter(pool, unit_tokens=512,
                                         arbitrate_every=2)

    replays = 0
    for cell, batch in (("full16", 16), ("full64", 64), ("full128", 128),
                        ("quick16", 16), ("quick64", 64),
                        ("admission64", 64)):
        ref = REFERENCE_SERVING[cell]
        runs = {}
        for mode in ("batched", "legacy"):
            pool, arb = make_pool(torch_device, cell)
            h = OfflineHarness(pool, max_batch=batch, mode=mode, hkv=8,
                               d=128, vocab=16, arbiter=arb,
                               torch_device=torch_device)
            wl = serving_workload(Request, lognormal_request_workload, cell)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = h.run(wl)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[mode] = (h, res)
            run_s = wall - h.capture_s
            print(f"[serve {cell} {mode}] {res.generated_tokens} tokens in "
                  f"{res.ticks} ticks, {wall:.4f} s with the graph capture "
                  f"({h.capture_s:.4f} s); without it "
                  f"{res.generated_tokens / run_s:.1f} tokens/s, "
                  f"{1e3 * run_s / res.ticks:.3f} ms/tick; decode dispatches={res.n_decode_dispatches} "
                  f"prefill dispatches={res.n_prefill_dispatches}; "
                  f"decisions={res.decisions()}"
                  + (f" admission checks={arb.n_admission_checks} denials="
                     f"{arb.n_admission_denials} transfers={arb.n_transfers}"
                     if arb is not None else ""), flush=True)
        (hb, rb), (hl, rl) = runs["batched"], runs["legacy"]
        replays += rb.n_decode_dispatches
        check(rb.decisions() == rl.decisions() and rb.tokens == rl.tokens,
              f"serve {cell}: batched and legacy differ")
        check(torch.equal(hb._k, hl._k) and torch.equal(hb._v, hl._v),
              f"serve {cell}: batched and legacy KV pools differ")
        check(rb.n_decode_dispatches <= rb.ticks,
              f"serve {cell}: {rb.n_decode_dispatches} decode dispatches > "
              f"{rb.ticks} ticks")
        check(rb.decisions() == ref["decisions"]
              and rb.generated_tokens == ref["generated"],
              f"serve {cell}: decisions {rb.decisions()} differ from the "
              f"reference's {ref['decisions']}")
        digest = tokens_digest(rb.tokens)
        if digest != ref["tokens"]:
            gap = top_two_gap(OfflineHarness,
                              lambda dev: make_pool(dev, cell),
                              serving_workload(Request,
                                               lognormal_request_workload,
                                               cell), batch)
            fail(f"serve {cell}: tokens differ from the reference's; the "
                 f"smallest top-two gap of the plain run is {gap:.3e}")
        print(f"[serve {cell}] batched == legacy (tokens, decisions, KV "
              f"pools); decisions and tokens == reference", flush=True)
    return replays


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a card")
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a repo checkout")
    sys.path.insert(0, str(SRC))

    # -- 1. environment ------------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # -- 2. build ------------------------------------------------------------
    from repro_torch.kernels import build
    for name in build.SOURCES:          # always build from this checkout
        build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    logs = build.build()
    build_s = time.perf_counter() - t0
    used = {name: [ln.split(":", 1)[1].strip() for ln in log.splitlines()
                   if "Used" in ln] for name, log in logs.items()}
    print(f"[build] {sorted(logs)} in {build_s:.2f} s (parallel nvcc); "
          f"ptxas {used}", flush=True)

    from repro_torch.core import (PAPER_WORKLOADS, ControllerConfig,
                                  SlabController, SlabPolicy,
                                  default_memcached_schedule,
                                  parallel_hillclimb,
                                  schedule_with_default_tail,
                                  size_histogram, uncovered_charge,
                                  waste_exact)
    from repro_torch.core.hillclimb import DEFAULT_DELTAS
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import waste_eval_ref
    from repro_torch.kernels.sketch_update import (bucketize,
                                                   sketch_window_ref)
    from repro_torch.memcached import (SlabAllocator, paper_traffic,
                                       phase_shift_traffic)
    dev = torch.device("cuda")

    # Data (set-up): the paper tables' traffic and the online stream.
    t0 = time.perf_counter()
    tables = {}
    for wl in PAPER_WORKLOADS:
        tables[wl.table] = size_histogram(paper_traffic(wl))
    n_online = 200_000
    a, b = PAPER_WORKLOADS[0], PAPER_WORKLOADS[2]
    stream = phase_shift_traffic(a, b, n_items=n_online, seed=7)
    print(f"[data] 5 x 1,000,000 paper items + {n_online:,} online items "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 3. kernels against their plain versions -----------------------------
    results = {}
    cyc = spin_cycles_per_ms(torch)

    # waste_eval at the parallel hill climb's shape (Table 1: B = K * 20
    # candidates of K = 6 classes) and at the controller frontier's.
    wl1 = PAPER_WORKLOADS[0]
    sup1, frq1 = tables[1]
    old1 = np.asarray(wl1.old_chunks)
    k1 = len(old1)
    moves = (np.eye(k1, dtype=np.int64)[:, None, :]
             * np.asarray(DEFAULT_DELTAS)[None, :, None])
    cands = np.clip(old1[None, None, :] + moves, 48, 1 << 20)
    cands = cands.reshape(-1, k1)
    warm_sup, warm_frq = size_histogram(stream[:n_online // 10])
    learned = schedule_with_default_tail(SlabPolicy(torch_device=dev).fit(
        warm_sup, warm_frq, 6, method="dp").chunk_sizes)
    win_sup, win_frq = size_histogram(stream[:5000])
    rows = [learned, np.unique(learned[:6]), default_memcached_schedule()]
    kmax = max(len(r) for r in rows)
    frontier = np.stack([np.concatenate([r, np.full(kmax - len(r), r[-1])])
                         for r in rows])
    shapes = {"hillclimb": (cands, sup1, frq1),
              "frontier": (frontier, win_sup, win_frq)}
    we = {}
    for label, (batch, sup, frq) in shapes.items():
        args = (torch.as_tensor(batch, dtype=torch.int32, device=dev),
                torch.as_tensor(sup, dtype=torch.int32, device=dev),
                torch.as_tensor(frq, dtype=torch.float32, device=dev))
        got = ops.waste_eval(*args)
        want = waste_eval_ref(*args)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        rel = float(((got - want).abs() / want.abs().clamp(min=1)).max())
        check(rel <= 1e-6, f"waste_eval[{label}] rel err {rel} > 1e-6")
        exact = [waste_exact(r, sup, frq) for r in batch]
        check(np.allclose(got.cpu().numpy(), exact, rtol=1e-6, atol=0),
              f"waste_eval[{label}] disagrees with waste_exact")
        b_, k_ = batch.shape
        s_ = len(sup)
        bms, by = bound(4 * (b_ * k_ + 2 * s_ + b_),
                        b_ * s_ * (int(np.ceil(np.log2(k_ + 1))) + 2))
        ms, call_ms = time_ms(torch, lambda: ops.waste_eval(*args), cyc)
        plain_ms, plain_call = time_ms(torch, lambda: waste_eval_ref(*args),
                                       cyc)
        sh = shape_entry(label, (b_, k_, s_), ms, bms)
        we[label] = dict(shape=(b_, k_, s_), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         entry=sh)
        print(f"[kernel] waste_eval {label} (B,K,S)={we[label]['shape']} "
              f"max_abs_err={err} rel={rel:.2e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bms:.2e} ({by}) "
              f"library_ms=null {shares(sh)}; per call with host overhead: "
              f"{call_ms:.4f} / plain {plain_call:.4f}", flush=True)
    results["waste_eval"] = dict(
        we["hillclimb"], route="cuda",
        source="src/repro_torch/csrc/waste_eval.cu",
        replaces="src/repro/kernels/waste_eval.py:64", library_ms=None,
        max_abs_err=max(v["max_abs_err"] for v in we.values()),
        shapes=[v["entry"] for v in we.values()])

    # sketch_window at the fused window's shape (BINS = 8192, N = 512,
    # R = 10 batches per 5,000-item cadence), the per-batch one (R = 1)
    # and the arbitration gate cell's (a tenant's window: two 64-item
    # batches per 128-item check, half-life 256 items).
    bins, n_row, cadence = 1 << 13, 512, 5000
    sw = {}
    for label, r_, n_, half_life in (
            ("fused", -(-cadence // n_row), n_row, 2.0 * cadence),
            ("per_batch", 1, n_row, 2.0 * cadence),
            ("gate", 2, 64, 256.0)):
        decay = 0.5 ** (1.0 / half_life)
        items = stream[:r_ * n_]
        sizes = torch.as_tensor(items.reshape(r_, n_), dtype=torch.int32,
                                device=dev)
        weights = torch.ones((r_, n_), dtype=torch.float32, device=dev)
        lengths = torch.full((r_,), n_, dtype=torch.int32, device=dev)
        totals = torch.full((r_,), decay ** n_, dtype=torch.float32,
                            device=dev)
        state = torch.zeros(bins, dtype=torch.float32, device=dev)
        state = ops.sketch_window(state, sizes, weights, lengths, decay,
                                  totals)       # a populated sketch
        out = torch.empty_like(state)
        got = ops.sketch_window(state, sizes, weights, lengths, decay,
                                totals, out=out).clone()
        want = sketch_window_ref(state, sizes, weights, lengths, decay,
                                 totals)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), "sketch_window not finite")
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"sketch_window[{label}] disagrees with its plain version")
        err = float((got - want).abs().max())
        # one R-row launch == R one-row launches, bit for bit; at unit
        # weights and decay 1 the kernel == its plain version, bit for bit
        rowwise = state.clone()
        for r in range(r_):
            ops.sketch_window(rowwise, sizes[r:r + 1], weights[r:r + 1],
                              lengths[r:r + 1], decay, totals[r:r + 1],
                              out=rowwise)
        check(torch.equal(rowwise, got), f"sketch_window[{label}]: the "
              "window launch differs from its rows' launches")
        ones, whole = torch.ones_like(totals), torch.round(state)
        check(torch.equal(
            ops.sketch_window(whole, sizes, weights, lengths, 1.0, ones),
            sketch_window_ref(whole, sizes, weights, lengths, 1.0, ones)),
            f"sketch_window[{label}] at decay 1 differs from its plain "
            "version (must be bit for bit)")
        idx = bucketize(sizes.reshape(-1), 1, bins).to(torch.int64)
        n_items = r_ * n_
        w_flat = torch.pow(torch.tensor(decay, dtype=torch.float32,
                                        device=dev),
                           torch.arange(n_items - 1, -1, -1, device=dev,
                                        dtype=torch.float32))
        d_all = float(decay ** n_items)
        scratch = state.clone()
        bms, by = bound(4 * (2 * bins + 2 * n_items + 2 * r_),
                        8 * n_items + bins * r_)
        ms, call_ms = time_ms(torch, lambda: ops.sketch_window(
            state, sizes, weights, lengths, decay, totals, out=out), cyc)
        # ~15 launches per row: queue 2 calls a run, or the host would
        # fill the card's launch queue (about a thousand entries) and
        # wait behind the spin, timing itself instead of the card.
        plain_ms, plain_call = time_ms(torch, lambda: sketch_window_ref(
            state, sizes, weights, lengths, decay, totals), cyc, calls=2)
        lib_ms, lib_call = time_ms(
            torch, lambda: scratch.mul_(d_all).index_add_(0, idx, w_flat),
            cyc)
        sh = shape_entry(label, (bins, r_, n_), ms, bms, lib_ms)
        sw[label] = dict(shape=(bins, r_, n_), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by, entry=sh)
        print(f"[kernel] sketch_window {label} (BINS,R,N)="
              f"{sw[label]['shape']} max_abs_err={err} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={bms:.2e} ({by}) {shares(sh)}; == its rows' "
              f"launches and, at decay 1, its plain version, bit for bit; "
              f"per call with host overhead: {call_ms:.4f} / plain "
              f"{plain_call:.4f} / library {lib_call:.4f}", flush=True)
    results["sketch_window"] = dict(
        sw["fused"], route="cuda",
        source="src/repro_torch/csrc/sketch_update.cu",
        replaces="src/repro/kernels/sketch_update.py:57",
        max_abs_err=max(v["max_abs_err"] for v in sw.values()),
        shapes=[v["entry"] for v in sw.values()])
    serving_kernels(torch, dev, cyc, results)
    print("[kernels] comparison launches (not counted below): "
          + " ".join(f"{k}={v}" for k, v in read_launches(ops).items()),
          flush=True)

    # -- 4. paper tables -----------------------------------------------------
    phase_launches = {}
    zero_launches(ops)
    for wl in PAPER_WORKLOADS:
        t0 = time.perf_counter()
        support, freqs = tables[wl.table]
        old = np.asarray(wl.old_chunks)
        ref = REFERENCE_TABLES[wl.table]
        dp = SlabPolicy(torch_device=dev).fit(support, freqs, k=len(old),
                                               baseline=old, method="dp")
        check(dp.waste == ref["dp"] and dp.baseline_waste == ref["old"],
              f"table {wl.table}: dp waste {dp.waste} != reference "
              f"{ref['dp']}")
        kern = parallel_hillclimb(old, support, freqs,
                                  batch_eval=ops.waste_eval,
                                  torch_device=dev)
        plain = parallel_hillclimb(old, support, freqs, torch_device=dev)
        check(kern.waste == plain.waste
              and np.array_equal(kern.chunks, plain.chunks),
              f"table {wl.table}: kernel-driven search {kern.waste} != "
              f"plain-driven {plain.waste}")
        check(kern.waste == ref["parallel"],
              f"table {wl.table}: parallel waste {kern.waste} != reference "
              f"{ref['parallel']}")
        line = (f"[table {wl.table}] old={dp.baseline_waste:,} "
                f"dp={dp.waste:,} ({dp.recovered_frac:.1%}) parallel="
                f"{kern.waste:,} ({kern.recovered_frac:.1%}, "
                f"{kern.steps} iters, kernel == plain)")
        if wl.table in HILLCLIMB_TABLES:
            th = time.perf_counter()
            hc = SlabPolicy(seed=wl.table, torch_device=dev).fit(
                support, freqs, k=len(old), baseline=old, method="hillclimb",
                patience=1000, max_steps=HILLCLIMB_MAX_STEPS)
            check(dp.waste <= hc.waste <= hc.baseline_waste,
                  f"table {wl.table}: hillclimb waste {hc.waste} outside "
                  f"[dp, old]")
            line += (f" hillclimb={hc.waste:,} ({hc.recovered_frac:.1%}, "
                     f"cap {HILLCLIMB_MAX_STEPS:,} steps, "
                     f"{time.perf_counter() - th:.1f} s)")
        print(f"{line} paper={wl.recovered_frac:.1%} "
              f"[{time.perf_counter() - t0:.1f} s]", flush=True)

    phase_launches[4] = phase_counts(ops, 4, ("waste_eval",))

    # -- 5. online loop ------------------------------------------------------
    zero_launches(ops)
    common = dict(k=6, check_every=cadence, half_life=2.0 * cadence,
                  drift_threshold=0.12, min_items_between_refits=2 * cadence,
                  amortization_windows=8.0, cost_weight=0.1,
                  torch_device="cuda")

    def replay(schedule, config=None):
        alloc = SlabAllocator(schedule)
        ctl = (SlabController(schedule, config=config)
               if config is not None else None)
        cum = cum_bytes = 0
        for i in range(0, n_online, n_row):
            batch = stream[i:i + n_row]
            for j, s in enumerate(batch.tolist()):
                idx = alloc.class_for(s)
                cum += (int(alloc.chunk_sizes[idx]) - s if idx is not None
                        else int(uncovered_charge(s)))
                cum_bytes += s
                alloc.set(str(i + j), s)
            if ctl is None:
                continue
            ctl.observe_many(batch)
            d = ctl.maybe_refit(cost_bytes_fn=lambda c: (
                alloc.migration_cost_bytes(schedule_with_default_tail(c))))
            if d is not None and d.approved:
                deployed = schedule_with_default_tail(d.chunks)
                alloc.reconfigure(deployed)
                ctl.set_chunks(deployed)
        return ctl, alloc, cum, cum_bytes

    runs = {}
    for name, extra in (("host", {}),
                        ("per_batch", dict(device=True,
                                           fused_observe=False)),
                        ("fused", dict(device=True))):
        t0 = time.perf_counter()
        ctl, alloc, cum, cum_bytes = replay(
            learned, ControllerConfig(**common, **extra))
        torch.cuda.synchronize()
        runs[name] = (ctl, alloc, cum, cum_bytes)
        sk = ctl.sketch
        print(f"[online {name}] checks={ctl.n_checks} refits={ctl.n_refits} "
              f"dispatches={sk.n_dispatches} host_syncs={sk.n_host_syncs} "
              f"scalar_syncs={getattr(sk, 'n_scalar_syncs', 0)} "
              f"wall={time.perf_counter() - t0:.2f} s", flush=True)
    keys = {name: [(d.approved, d.reason) for d in r[0].decisions]
            for name, r in runs.items()}
    check(keys["host"] == keys["per_batch"] == keys["fused"],
          "host / per-batch / fused decisions differ")
    check(all(np.array_equal(runs["host"][0].chunks, r[0].chunks)
              for r in runs.values()), "final chunks differ across paths")
    fused = runs["fused"][0]
    check(fused.sketch.n_dispatches <= fused.n_checks,
          f"fused dispatches {fused.sketch.n_dispatches} > checks "
          f"{fused.n_checks}")
    reasons = {}
    for _, reason in keys["host"]:
        reasons[reason] = reasons.get(reason, 0) + 1
    approved = [i for i, (ok, _) in enumerate(keys["host"]) if ok]
    check(reasons == REFERENCE_ONLINE["reasons"]
          and approved == [REFERENCE_ONLINE["refit_at_check"]]
          and runs["host"][0].n_checks == REFERENCE_ONLINE["n_checks"],
          f"online decisions differ from the reference: {reasons}, "
          f"refits at {approved}")
    check(runs["fused"][2] == REFERENCE_ONLINE["cum_waste"],
          f"adaptive cumulative waste {runs['fused'][2]} != reference")
    default = replay(default_memcached_schedule())
    static = replay(learned)
    ast = runs["fused"][1].stats()
    print(f"[online] decisions identical on 3 paths ({reasons}); "
          f"cumulative waste fraction default={default[2] / default[3]:.4%} "
          f"static={static[2] / static[3]:.4%} adaptive="
          f"{runs['fused'][2] / runs['fused'][3]:.4%} "
          f"({ast.n_reassigned_pages} pages re-carved, "
          f"{ast.migration_evictions:,} migration evictions)", flush=True)

    phase_launches[5] = phase_counts(ops, 5, ("waste_eval",
                                              "sketch_window"))

    # -- 6. arbitration -------------------------------------------------------
    t0 = time.perf_counter()
    zero_launches(ops)
    arbitration_phase(torch)
    phase_launches[6] = phase_counts(ops, 6, ("waste_eval_fleet",
                                              "sketch_window"))
    print(f"[arbitration] {time.perf_counter() - t0:.1f} s", flush=True)

    # -- 7. serving ------------------------------------------------------------
    t0 = time.perf_counter()
    zero_launches(ops)
    replays = serving_phase(torch)
    phase_launches[7] = phase_counts(ops, 7, DECODE_KERNELS)
    print(f"[serving] graph_replays={replays} (each runs every kernel of "
          f"the decode tick; not in the counts above); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # -- launches on the main path -------------------------------------------
    kernels = []
    for name in KERNELS:
        r = results[name]
        by_phase = {str(p): c[name] for p, c in phase_launches.items()
                    if c[name]}
        entry = {"name": name, "route": r["route"],
                 "source": r["source"], "replaces": r["replaces"],
                 "launches": sum(by_phase.values()),
                 "launches_by_phase": by_phase,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "shapes": r["shapes"]}
        if name in DECODE_KERNELS:
            entry["graph_replays"] = replays
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
