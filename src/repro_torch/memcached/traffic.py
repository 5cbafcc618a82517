"""Workload generation for the paper's experiments (Tables 1-5), plus
non-stationary variants the online controller adapts to.

The paper's runs are stationary — one (mu, sigma) operating point per
table — which can never exercise the *loop* half of its contribution.
The non-stationary generators below provide the scenarios where online
adaptation wins or loses:

* ``phase_shift_traffic`` — an abrupt jump between two paper operating
  points mid-stream (a deploy / tenant change),
* ``drift_traffic``       — gradual linear drift of the byte-space
  moments from one operating point to another (organic growth),
* ``diurnal_traffic``     — a periodic mixture of two operating points
  (day/night traffic mix).

Multi-tenant (what the arbiter serves): ``multitenant_phased_ops``
interleaves N tenants' op streams over one shared pool, each tenant's
arrival intensity a raised cosine shifted out of phase with the others
(tenants peak at different times — the setting where cross-tenant page
arbitration has something to win), with TTL-style deletes so an
off-peak tenant's pages accumulate free chunks (the holes arbitration
reclaims). ``fleet_stream`` fans that stream out to a fleet of
hundreds or thousands of tenants.

Re-reference skew (what the eviction policies serve):
``zipfian_rereference_ops`` draws get/set traffic over a fixed key
universe with Zipf-distributed popularity — a small hot set is
re-referenced constantly while a long tail of one-hit wonders streams
through. Under this skew the *choice* of eviction victim is
measurable: evicting a hot resident forces a read-through refill
(``reused_after_evict``), while evicting tail keys is free — exactly
the asymmetry the cost-aware policies in ``repro_torch.memcached.eviction``
exploit.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.distribution import (PAGE_SIZE, PAPER_N_ITEMS,
                                     PAPER_WORKLOADS, PaperWorkload,
                                     lognormal_params_from_moments,
                                     sample_lognormal_sizes,
                                     sample_multimodal_sizes, size_histogram)


def paper_traffic(workload: PaperWorkload, *, n_items: int = PAPER_N_ITEMS,
                  seed: int = 0, log_space_sigma: bool = False
                  ) -> np.ndarray:
    """Item sizes for one of the paper's operating points."""
    rng = np.random.default_rng(seed + workload.table)
    return sample_lognormal_sizes(
        rng, n_items, workload.mu, workload.sigma,
        max_size=PAGE_SIZE, log_space_sigma=log_space_sigma)


def paper_histogram(workload: PaperWorkload, *,
                    n_items: int = PAPER_N_ITEMS, seed: int = 0,
                    log_space_sigma: bool = False
                    ) -> Tuple[np.ndarray, np.ndarray]:
    return size_histogram(paper_traffic(workload, n_items=n_items, seed=seed,
                                        log_space_sigma=log_space_sigma))


def all_paper_workloads() -> Tuple[PaperWorkload, ...]:
    return PAPER_WORKLOADS


# -- non-stationary workloads (what the adaptive controller serves) ---------

def phase_shift_traffic(a: PaperWorkload, b: PaperWorkload, *,
                        n_items: int = PAPER_N_ITEMS,
                        shift_at: float = 0.5,
                        seed: int = 0) -> np.ndarray:
    """Abrupt operating-point change: sizes ~ ``a`` until ``shift_at`` of
    the stream, then ~ ``b``."""
    if not 0.0 < shift_at < 1.0:
        raise ValueError(f"shift_at must be in (0, 1), got {shift_at}")
    n_a = int(n_items * shift_at)
    rng = np.random.default_rng(seed)
    part_a = sample_lognormal_sizes(rng, n_a, a.mu, a.sigma,
                                    max_size=PAGE_SIZE)
    part_b = sample_lognormal_sizes(rng, n_items - n_a, b.mu, b.sigma,
                                    max_size=PAGE_SIZE)
    return np.concatenate([part_a, part_b])


def drift_traffic(a: PaperWorkload, b: PaperWorkload, *,
                  n_items: int = PAPER_N_ITEMS,
                  seed: int = 0) -> np.ndarray:
    """Gradual drift: the byte-space (mean, std) interpolate linearly from
    ``a`` to ``b`` across the stream; item ``i`` is drawn at the
    interpolated operating point."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 1.0, n_items)
    mean = (1.0 - t) * a.mu + t * b.mu
    std = (1.0 - t) * a.sigma + t * b.sigma
    mu_log, sigma_log = lognormal_params_from_moments(mean, std)
    raw = np.exp(mu_log + sigma_log * rng.standard_normal(n_items))
    return np.clip(np.rint(raw), 1, PAGE_SIZE).astype(np.int64)


def diurnal_traffic(a: PaperWorkload, b: PaperWorkload, *,
                    n_items: int = PAPER_N_ITEMS,
                    period: int = 200_000,
                    seed: int = 0) -> np.ndarray:
    """Periodic mixture: item ``i`` is drawn from ``b`` with probability
    ``0.5 * (1 - cos(2*pi*i/period))`` (pure-``a`` troughs, pure-``b``
    peaks) — the day/night shape of production cache traffic."""
    rng = np.random.default_rng(seed)
    i = np.arange(n_items)
    p_b = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / period))
    from_b = rng.random(n_items) < p_b
    sizes_a = sample_lognormal_sizes(rng, n_items, a.mu, a.sigma,
                                     max_size=PAGE_SIZE)
    sizes_b = sample_lognormal_sizes(rng, n_items, b.mu, b.sigma,
                                     max_size=PAGE_SIZE)
    return np.where(from_b, sizes_b, sizes_a)


def diurnal_multimodal_traffic(day_modes: Sequence[Tuple[float, float, float]],
                               night_modes: Sequence[
                                   Tuple[float, float, float]], *,
                               n_items: int = PAPER_N_ITEMS,
                               period: int = 200_000,
                               seed: int = 0) -> np.ndarray:
    """Periodic swap between two MULTI-MODAL size mixtures.

    ``day_modes`` / ``night_modes`` are ``(weight, mean, std)``
    log-normal mode tuples (``sample_multimodal_sizes``); item ``i`` is
    drawn from the day mixture with probability
    ``0.5 * (1 - cos(2*pi*i/period))`` — pure-night troughs, pure-day
    peaks. Unlike :func:`diurnal_traffic` (two unimodal operating
    points, where a few classes cover the union for good), the union
    of two multi-modal phases needs roughly twice the classes of
    either phase alone — under a scarce class budget the optimal
    schedule genuinely *tracks* the phase, which is the regime the
    forecast-driven controller is for
    (``benchmarks/forecast_bench.py``).
    """
    rng = np.random.default_rng(seed)
    i = np.arange(n_items)
    p_day = 0.5 * (1.0 - np.cos(2.0 * np.pi * i / period))
    from_day = rng.random(n_items) < p_day
    day = sample_multimodal_sizes(rng, n_items, tuple(day_modes),
                                  max_size=PAGE_SIZE)
    night = sample_multimodal_sizes(rng, n_items, tuple(night_modes),
                                    max_size=PAGE_SIZE)
    return np.where(from_day, day, night)


# -- multi-tenant workloads (what the arbiter serves) ------------------------

@dataclasses.dataclass(frozen=True)
class TenantOp:
    """One operation of an interleaved multi-tenant stream."""

    tenant: int          # index into the workload list
    op: str              # "set" | "delete" | "get"
    key: str
    size: int            # item payload bytes (0 for deletes; for gets,
    #                      the key's payload — the read-through refill
    #                      size a driver stores on a miss)


def multitenant_phased_ops(workloads: Sequence[PaperWorkload], *,
                           n_sets: int = PAPER_N_ITEMS,
                           period: int = 0,
                           lifetime: int = 0,
                           base_rate: float = 0.1,
                           trough_mix: float = 0.0,
                           seed: int = 0) -> List[TenantOp]:
    """Interleaved op streams for N tenants peaking out of phase.

    Tenant ``t``'s arrival intensity at set ``i`` is
    ``base_rate + (1 - base_rate) * 0.5 * (1 - cos(2*pi*(i/period -
    t/N)))`` — raised cosines offset by ``1/N`` of a period, so exactly
    one tenant is near peak at any time. Each stored item is deleted
    ``~lifetime`` sets later (uniform 0.5x-1.5x jitter) — cache-TTL
    churn, so a tenant past its peak holds pages full of free chunks.

    ``trough_mix > 0`` additionally makes each tenant's *size
    distribution* non-stationary: at its deepest trough a fraction
    ``trough_mix`` of its items is drawn from the NEXT tenant's
    operating point (fading to zero at its peak) — per-tenant drift the
    intra-tenant controllers must chase while the arbiter moves pages.

    Returns ``n_sets`` set ops with their deletes interleaved in arrival
    order (total length < 2 * n_sets; items whose TTL survives the
    stream are never deleted). ``period`` defaults to half the stream,
    ``lifetime`` to a third of the period.
    """
    n_t = len(workloads)
    if n_t < 2:
        raise ValueError("need at least two tenants")
    period = period or max(2, n_sets // 2)
    lifetime = lifetime or max(1, period // 3)
    rng = np.random.default_rng(seed)
    sizes = [sample_lognormal_sizes(rng, n_sets, w.mu, w.sigma,
                                    max_size=PAGE_SIZE) for w in workloads]
    alt_sizes = [sample_lognormal_sizes(
        rng, n_sets, workloads[(t + 1) % n_t].mu,
        workloads[(t + 1) % n_t].sigma, max_size=PAGE_SIZE)
        for t in range(n_t)]
    step = np.arange(n_sets)[:, None]
    phase = np.arange(n_t)[None, :] / n_t
    cosarg = 2.0 * np.pi * (step / period - phase)
    intensity = base_rate + (1.0 - base_rate) * 0.5 * (1.0 - np.cos(cosarg))
    intensity /= intensity.sum(axis=1, keepdims=True)
    picks = (rng.random(n_sets)[:, None]
             > np.cumsum(intensity, axis=1)).sum(axis=1)
    troughness = 0.5 * (1.0 + np.cos(cosarg))   # 1 at trough, 0 at peak
    use_alt = rng.random(n_sets)
    ttls = rng.uniform(0.5, 1.5, n_sets) * lifetime
    ops: List[TenantOp] = []
    due: List[Tuple[int, int, int, str]] = []   # (expiry, seq, tenant, key)
    counters = [0] * n_t
    for i in range(n_sets):
        while due and due[0][0] <= i:
            _, _, dt, dkey = heapq.heappop(due)
            ops.append(TenantOp(dt, "delete", dkey, 0))
        tn = int(picks[i])
        key = f"t{tn}:{counters[tn]}"
        pool = (alt_sizes
                if use_alt[i] < trough_mix * troughness[i, tn] else sizes)
        ops.append(TenantOp(tn, "set", key, int(pool[tn][counters[tn]])))
        counters[tn] += 1
        heapq.heappush(due, (i + int(ttls[i]), i, tn, key))
    return ops


# -- re-reference-skewed workloads (what the eviction policies serve) --------

def zipfian_rereference_ops(workloads: Sequence[PaperWorkload], *,
                            n_ops: int = PAPER_N_ITEMS,
                            universe: int = 0,
                            get_frac: float = 0.7,
                            zipf_s: float = 1.1,
                            shift_at: float = 0.5,
                            head_frac: float = 0.05,
                            alt_workloads: Optional[
                                Sequence[PaperWorkload]] = None,
                            period: int = 0,
                            base_rate: float = 0.1,
                            seed: int = 0) -> List[TenantOp]:
    """Zipf-skewed get/set traffic over a fixed key universe, with a
    mid-stream tail shift.

    Each tenant owns ``universe`` keys; key ``j`` is drawn with
    probability proportional to ``1 / (j+1)**zipf_s`` (rank-1 keys are
    re-referenced constantly, the tail is one-hit wonders). Every op is
    a ``get`` with probability ``get_frac``, else a ``set``; both
    sample the same Zipf popularity, and a key's payload size is fixed
    at its first draw from the tenant's operating point. Gets carry
    that size so a driver can model a read-through cache (miss =>
    refill ``set``) — the loop that makes a wrongly-chosen eviction
    victim cost real bytes.

    At ``shift_at`` of the stream the *tail* changes identity: keys
    below the Zipf head (the top ``head_frac`` of ranks) are replaced
    by fresh keys whose sizes come from ``alt_workloads`` (defaults to
    the workload list rotated by one; pass explicitly for a single
    tenant). The hot head keeps its keys and sizes throughout. This is
    the scenario cost-aware eviction is about: after the shift the
    cache is full of stale phase-one tail items that will never be
    re-referenced — a wholesale cost model prices them at full payload
    and vetoes the refit toward the new tail sizes, while a rank-based
    model knows they are dead. ``shift_at=0`` disables the shift.

    With more than one workload, tenants' arrival intensities are the
    same out-of-phase raised cosines as ``multitenant_phased_ops``
    (``period`` defaults to half the stream), so the arbiter has pages
    to move while the policies pick victims. ``universe`` defaults to
    ``n_ops // (4 * n_tenants)`` — several times a constrained pool's
    capacity, so eviction is continuous.
    """
    n_t = len(workloads)
    if n_t < 1:
        raise ValueError("need at least one workload")
    if not 0.0 <= get_frac <= 1.0:
        raise ValueError(f"get_frac must be in [0, 1], got {get_frac}")
    universe = universe or max(64, n_ops // max(1, 4 * n_t))
    rng = np.random.default_rng(seed)
    probs = np.arange(1, universe + 1, dtype=np.float64) ** -zipf_s
    probs /= probs.sum()
    sizes = [sample_lognormal_sizes(rng, universe, w.mu, w.sigma,
                                    max_size=PAGE_SIZE) for w in workloads]
    if alt_workloads is None and n_t > 1:
        alt_workloads = [workloads[(t + 1) % n_t] for t in range(n_t)]
    alt_sizes = (None if alt_workloads is None else
                 [sample_lognormal_sizes(rng, universe, w.mu, w.sigma,
                                         max_size=PAGE_SIZE)
                  for w in alt_workloads])
    if n_t > 1:
        period = period or max(2, n_ops // 2)
        step = np.arange(n_ops)[:, None]
        phase = np.arange(n_t)[None, :] / n_t
        cosarg = 2.0 * np.pi * (step / period - phase)
        intensity = (base_rate
                     + (1.0 - base_rate) * 0.5 * (1.0 - np.cos(cosarg)))
        intensity /= intensity.sum(axis=1, keepdims=True)
        picks = (rng.random(n_ops)[:, None]
                 > np.cumsum(intensity, axis=1)).sum(axis=1)
    else:
        picks = np.zeros(n_ops, dtype=np.int64)
    key_idx = rng.choice(universe, size=n_ops, p=probs)
    is_get = rng.random(n_ops) < get_frac
    head_cut = max(1, int(head_frac * universe))
    shift_op = int(shift_at * n_ops) if (shift_at and alt_sizes is not None
                                         ) else n_ops
    ops: List[TenantOp] = []
    for i, (t, j, g) in enumerate(zip(picks, key_idx, is_get)):
        t, j = int(t), int(j)
        if i >= shift_op and j >= head_cut:     # post-shift tail key
            key, size = f"t{t}:b{j}", int(alt_sizes[t][j])
        else:
            key, size = f"t{t}:z{j}", int(sizes[t][j])
        ops.append(TenantOp(t, "get" if g else "set", key, size))
    return ops


def fleet_stream(n_tenants: int, n_sets: int, seed: int
                 ) -> List[Tuple[int, TenantOp]]:
    """The paper's phased multi-tenant stream fanned out to a fleet of
    ``n_tenants`` (the stream of the reference's fleet arbitration
    bench, ``benchmarks/fleet_bench.py``).

    ``multitenant_phased_ops`` over all five operating points
    (``trough_mix=0.5``) interleaves one stream per operating point;
    each set op is routed round-robin to one of the physical tenants
    backing that operating point (``logical + W*k mod n``), so every
    fleet tenant sees one workload's sizes and phase. Deletes follow
    their key to whichever tenant stored it. Returns
    ``(physical tenant, op)`` pairs.
    """
    w = len(PAPER_WORKLOADS)
    base = multitenant_phased_ops(PAPER_WORKLOADS, n_sets=n_sets,
                                  trough_mix=0.5, seed=seed)
    cycles = max(1, -(-n_tenants // w))
    cnt = [0] * w
    home: Dict[Tuple[int, str], int] = {}
    out: List[Tuple[int, TenantOp]] = []
    for op in base:
        k = (op.tenant, op.key)
        if op.op == "set" and k not in home:
            home[k] = (op.tenant + w * cnt[op.tenant]) % n_tenants
            cnt[op.tenant] = (cnt[op.tenant] + 1) % cycles
        out.append((home[k], op))
    return out

