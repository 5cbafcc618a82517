"""The port's memcached simulator and traffic generators (numpy copies)
against the reference: identical stats over identical op streams for
every eviction policy, identical traffic for every seed."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.memcached as R  # noqa: E402
import repro_torch.memcached as T  # noqa: E402
from repro.core.distribution import PAPER_WORKLOADS  # noqa: E402

PAGE = 1 << 16


def _replay(mod, policy, ops, schedules):
    """Drive one allocator through gets/sets/deletes, a live reconfigure,
    page reassigns and releases; return every observable result."""
    alloc = mod.SlabAllocator(schedules[0], mem_limit=24 * PAGE,
                              page_size=PAGE,
                              eviction_policy=mod.make_policy(policy))
    results = []
    for i, op in enumerate(ops):
        if op.op == "set":
            results.append(alloc.set(op.key, op.size))
        elif op.op == "get":
            hit = alloc.get(op.key)
            if not hit:
                alloc.set(op.key, op.size)       # read-through refill
            results.append(hit)
        else:
            results.append(alloc.delete(op.key))
        if i == len(ops) // 3:
            results.append(alloc.migration_cost_bytes(schedules[1]))
            results.append(dataclasses.astuple(
                alloc.reconfigure(schedules[1])))
        if i == len(ops) // 2:
            src = max(range(len(alloc.classes)),
                      key=lambda c: alloc.classes[c].pages)
            dst = (src + 1) % len(alloc.classes)
            results.append(alloc.reassign(src, dst))
            results.append(alloc.page_release_cost_bytes())
            results.append(alloc.release_page())
    results.append(alloc.referenced_bytes(500))
    return results, dataclasses.asdict(alloc.stats())


@pytest.mark.parametrize("policy", ["coldest", "segmented", "ranked"])
def test_allocator_stats_identical_per_policy(policy):
    ops = R.zipfian_rereference_ops(PAPER_WORKLOADS[:2], n_ops=6_000,
                                    seed=3)
    ops += [R.TenantOp(0, "delete", op.key, 0) for op in ops[:300:3]]
    schedules = ([96, 120, 152, 192, 240, 304, 384, 480, 600, 752, 944,
                  1184, 1480, 1856, 2320, PAGE],
                 [300, 500, 700, 944, 1300, 1856, PAGE])
    want = _replay(R, policy, ops, schedules)
    got = _replay(T, policy, ops, schedules)
    assert got[1] == want[1]
    assert got[0] == want[0]


def test_run_workload_and_compare_schedules_identical():
    sizes = R.paper_traffic(PAPER_WORKLOADS[0], n_items=20_000)
    wl = PAPER_WORKLOADS[0]
    assert (dataclasses.asdict(T.run_workload(wl.new_chunks, sizes))
            == dataclasses.asdict(R.run_workload(wl.new_chunks, sizes)))
    assert (T.compare_schedules(wl.old_chunks, wl.new_chunks,
                                sizes).recovered_frac
            == R.compare_schedules(wl.old_chunks, wl.new_chunks,
                                   sizes).recovered_frac)


@pytest.mark.parametrize("seed", [0, 7])
def test_traffic_identical_per_seed(seed):
    a, b = PAPER_WORKLOADS[0], PAPER_WORKLOADS[2]
    for name, kw in (
            ("paper_traffic", dict(workload=a, n_items=5_000)),
            ("paper_histogram", dict(workload=b, n_items=5_000)),
            ("phase_shift_traffic", dict(a=a, b=b, n_items=5_000)),
            ("drift_traffic", dict(a=a, b=b, n_items=5_000)),
            ("diurnal_traffic", dict(a=a, b=b, n_items=5_000,
                                     period=1_000)),
            ("diurnal_multimodal_traffic",
             dict(day_modes=((0.5, 300.0, 20.0), (0.5, 900.0, 30.0)),
                  night_modes=((1.0, 600.0, 25.0),), n_items=5_000,
                  period=1_000))):
        np.testing.assert_array_equal(
            np.asarray(getattr(T, name)(seed=seed, **kw)),
            np.asarray(getattr(R, name)(seed=seed, **kw)))
    assert (T.multitenant_phased_ops(PAPER_WORKLOADS[:3], n_sets=2_000,
                                     trough_mix=0.3, seed=seed)
            == [T.TenantOp(*dataclasses.astuple(op)) for op in
                R.multitenant_phased_ops(PAPER_WORKLOADS[:3], n_sets=2_000,
                                         trough_mix=0.3, seed=seed)])
    assert (T.zipfian_rereference_ops(PAPER_WORKLOADS[:2], n_ops=2_000,
                                      seed=seed)
            == [T.TenantOp(*dataclasses.astuple(op)) for op in
                R.zipfian_rereference_ops(PAPER_WORKLOADS[:2], n_ops=2_000,
                                          seed=seed)])
    assert ([dataclasses.astuple(w) for w in T.all_paper_workloads()]
            == [dataclasses.astuple(w) for w in R.all_paper_workloads()])
