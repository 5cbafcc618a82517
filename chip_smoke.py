"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); no network, no JAX.
Phases, each printing a line of its numbers; any failed check exits
non-zero before the last line is printed:

1. environment: the card (``nvidia-smi`` name and power limit), versions,
   TF32 off;
2. build: both CUDA kernels compiled from ``src/repro_torch/csrc``;
3. kernels against plain: each kernel at the main path's shapes against
   its plain PyTorch version, with kernel, plain, bound and library
   times (CUDA events, median of 20 runs after warm-up; see time_ms);
4. paper tables: Tables 1-5 at 1,000,000 items — the exact DP, the
   parallel hill climb driven by the waste_eval kernel and by the plain
   evaluator (both on the card), and the paper's Algorithm 1;
5. online loop: 200,000 phase-shifted items through the host, per-batch
   device and fused device controllers and a live ``SlabAllocator``.

The launch counters are zeroed right before phase 4 and read right after
phase 5, so the ``kernels`` line counts the main path's launches only.
The last line is the device JSON.
"""
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

HILLCLIMB_TABLES = (1, 2, 3, 4, 5)  # tables run through Algorithm 1
HILLCLIMB_MAX_STEPS = 150_000  # the cap of examples/memcached_repro.py
F32_OPS_PER_S = 67e12         # H100 SXM float32 non-tensor peak
BYTES_PER_S = 3.35e12         # H100 SXM HBM3 bandwidth


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
        we[label] = dict(shape=(b_, k_, s_), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        print(f"[kernel] waste_eval {label} (B,K,S)={we[label]['shape']} "
              f"max_abs_err={err} rel={rel:.2e} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={bms:.2e} ({by}) "
              f"library_ms=null; per call with host overhead: "
              f"{call_ms:.4f} / plain {plain_call:.4f}", flush=True)
    results["waste_eval"] = dict(
        we["hillclimb"], route="cuda",
        source="src/repro_torch/csrc/waste_eval.cu",
        replaces="src/repro/kernels/waste_eval.py:64", library_ms=None,
        max_abs_err=max(v["max_abs_err"] for v in we.values()))

    # sketch_window at the fused window's shape (BINS = 8192, N = 512,
    # R = 10 batches per 5,000-item cadence) and the per-batch one (R = 1).
    bins, n_row, cadence = 1 << 13, 512, 5000
    decay = 0.5 ** (1.0 / (2.0 * cadence))
    sw = {}
    for label, r_ in (("fused", -(-cadence // n_row)), ("per_batch", 1)):
        items = stream[:r_ * n_row]
        sizes = torch.as_tensor(items.reshape(r_, n_row), dtype=torch.int32,
                                device=dev)
        weights = torch.ones((r_, n_row), dtype=torch.float32, device=dev)
        lengths = torch.full((r_,), n_row, dtype=torch.int32, device=dev)
        totals = torch.full((r_,), decay ** n_row, dtype=torch.float32,
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
        idx = bucketize(sizes.reshape(-1), 1, bins).to(torch.int64)
        n_items = r_ * n_row
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
        sw[label] = dict(shape=(bins, r_, n_row), max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms,
                         bound_by=by)
        print(f"[kernel] sketch_window {label} (BINS,R,N)="
              f"{sw[label]['shape']} max_abs_err={err} ms={ms:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={bms:.2e} ({by}); per call with host overhead: "
              f"{call_ms:.4f} / plain {plain_call:.4f} / library "
              f"{lib_call:.4f}", flush=True)
    results["sketch_window"] = dict(
        sw["fused"], route="cuda",
        source="src/repro_torch/csrc/sketch_update.cu",
        replaces="src/repro/kernels/sketch_update.py:57",
        max_abs_err=max(v["max_abs_err"] for v in sw.values()))
    print(f"[kernels] waste_eval launches={ops.waste_eval.n_launches} "
          f"sketch_window launches={ops.sketch_window.n_launches} "
          "(comparison runs; zeroed before the main path)", flush=True)

    # -- main path: counters from zero ---------------------------------------
    ops.waste_eval.n_launches = 0
    ops.sketch_window.n_launches = 0
    ops.sketch_update.n_launches = 0

    # -- 4. paper tables -----------------------------------------------------
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

    # -- 5. online loop ------------------------------------------------------
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

    # -- launches on the main path -------------------------------------------
    launches = {"waste_eval": ops.waste_eval.n_launches,
                "sketch_window": (ops.sketch_window.n_launches
                                  + ops.sketch_update.n_launches)}
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    kernels = []
    for name in ("waste_eval", "sketch_window"):
        r = results[name]
        kernels.append({"name": name, "route": r["route"],
                        "source": r["source"], "replaces": r["replaces"],
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
