"""Continuous-batching scheduler over the slab KV pool.

A discrete-event simulator faithful to serving dynamics (admission,
decode, completion, chunk reallocation on class overflow) that measures
what the paper's technique buys at the serving layer: HBM internal
fragmentation of the KV pool under default vs learned chunk classes,
plus admission failures (a fragmented pool admits fewer requests).

The tick is phase-structured the way the device harness executes it
(admit → decode bookkeeping → batched within-chunk growth → completion
→ observe/arbitrate/refit): :meth:`ContinuousBatcher.step` batches all
within-chunk decode growth into ONE ``KVSlabPool.extend_bulk`` call per
tick, mirroring the one-dispatch-per-tick decode step of
``offline_harness``. The pre-refactor per-request loop is kept verbatim
as :meth:`step_legacy`, the bit-parity oracle — every counter,
observation, admission and rejection must match it exactly
(tests/test_serving_harness.py runs the differential).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.kv_slab_pool import ALIGN, KVSlabPool, quantize_lengths


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    output_len: int
    decoded: int = 0
    arrival: float = 0.0      # open-loop arrival time, in ticks
    tenant: str = "default"   # serving stream tag (trace client id)

    @property
    def kv_len(self) -> int:
        return self.prompt_len + self.decoded


def queue_delay_stats(delays) -> Tuple[float, float, float]:
    """(mean, p50, p99) of per-request queue delays (admit − arrival),
    in ticks; zeros when nothing was admitted."""
    if len(delays) == 0:
        return 0.0, 0.0, 0.0
    d = np.asarray(delays, dtype=np.float64)
    return (float(d.mean()), float(np.percentile(d, 50)),
            float(np.percentile(d, 99)))


@dataclasses.dataclass
class SimResult:
    steps: int
    completed: int
    rejected: int
    realloc_copies: int          # class-overflow chunk moves
    realloc_tokens: int          # tokens copied in those moves
    mean_waste_fraction: float   # time-averaged pool fragmentation
    peak_active: int
    mean_active: float
    n_refits: int = 0            # schedule changes applied during the run
    # per-request queue delay (admit tick − arrival), the latency the
    # aggregate step counts used to hide: an admission-starved stream
    # shows up here long before it shows up in `rejected`
    queue_delay_mean: float = 0.0
    queue_delay_p50: float = 0.0
    queue_delay_p99: float = 0.0


class ContinuousBatcher:
    """Admit-from-queue / decode-all / free-on-finish loop.

    Refit modes:
      * ``refit_every=N`` — legacy cadence: unconditionally re-learn the
        classes every N steps (through the pool's shared controller);
      * ``adaptive=True`` — drive the controller's full drift-detection /
        hysteresis / cost-model pipeline each step; refits happen only
        when the controller approves one. Decisions land in
        ``self.refit_decisions``.

    Open-loop arrivals: a request with ``arrival > 0`` is not
    admissible before tick ``ceil(arrival)``; admission stays FIFO (a
    not-yet-arrived head blocks the queue — order is part of the
    decision contract the harness must reproduce). Each admission
    records ``t - arrival`` into ``queue_delays``; :meth:`run` folds
    them into the ``SimResult`` p50/p99.

    ``legacy_loop=True`` routes :meth:`step` through
    :meth:`step_legacy`, the pre-refactor per-request loop kept as the
    bit-parity oracle for the phase-structured tick.

    Multi-tenant serving: several batchers (one per serving stream) may
    share ONE ``KVSlabPool``; each registers under its ``tenant`` name
    so the pool keeps per-stream token accounting (and optionally a
    quota). Request ids must be unique across all batchers of a shared
    pool. The pool's learned classes come from the merged traffic of
    all streams — the arbitration analogue of the memcached side.
    """

    def __init__(self, pool: KVSlabPool, *, max_batch: int = 64,
                 refit_every: Optional[int] = None,
                 adaptive: bool = False,
                 tenant: str = "default",
                 quota_tokens: Optional[int] = None,
                 arbiter=None,
                 legacy_loop: bool = False):
        self.pool = pool
        self.tenant = tenant
        pool.register_tenant(tenant, quota_tokens=quota_tokens)
        self.max_batch = max_batch
        self.refit_every = refit_every
        self.adaptive = adaptive
        # Token-quota arbitration (repro_torch.serving.token_quota_arbiter):
        # the batcher reports its op count each step so the arbiter's
        # cadence advances with real serving work, not wall clock.
        self.arbiter = arbiter
        self.legacy_loop = legacy_loop
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.realloc_copies = 0
        self.realloc_tokens = 0
        self.completed = 0
        self.rejected = 0
        self.n_refits = 0
        self.refit_decisions: List = []
        self.queue_delays: List[float] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _try_admit(self, observed: List[int], t: int = 0) -> None:
        while (self.queue and self.queue[0].arrival <= t
                and len(self.active) < self.max_batch):
            req = self.queue[0]
            # observed BEFORE the attempt, success or not: the per-alloc
            # path feeds the sketch before its failure exits too, and
            # uncoverable lengths are exactly what a refit must learn
            observed.append(req.kv_len)
            # reserve capacity for the whole expected context
            a = self.pool.alloc(req.rid, req.kv_len, tenant=self.tenant)
            if a is None:
                self.rejected += 1
                self.queue.popleft()
                continue
            self.queue.popleft()
            self.active[req.rid] = req
            self.queue_delays.append(t - req.arrival)

    def step(self, t: int) -> None:
        if self.legacy_loop:
            self.step_legacy(t)
        else:
            self._step_tick(t)

    def _step_tick(self, t: int) -> None:
        """Phase-structured tick: within-chunk decode growth for the
        whole batch lands in ONE ``extend_bulk`` call — the host-side
        shape of the harness's one-dispatch decode tick. Decisions,
        counters and observation order are bit-identical to
        :meth:`step_legacy` (within-chunk growth commutes with the
        allocator's class/quota/freelist decisions; the overflow path
        runs inline, in request order, exactly as before)."""
        observed: List[int] = []
        self._try_admit(observed, t)
        done: List[int] = []
        grown: List[Tuple[int, int]] = []
        for rid, req in self.active.items():
            req.decoded += 1
            old = self.pool.allocation(rid)
            if req.kv_len <= old.chunk:
                grown.append((rid, req.kv_len))
            else:
                new = self.pool.extend(rid, req.kv_len)
                if new is None:      # pool full mid-flight: drop request
                    observed.append(req.kv_len)  # the attempt still counts
                    done.append(rid)
                    self.rejected += 1
                    continue
                if new.start != old.start:   # class overflow -> chunk copy
                    self.realloc_copies += 1
                    self.realloc_tokens += old.length
                    observed.append(req.kv_len)
            if req.decoded >= req.output_len:
                done.append(rid)
                self.completed += 1
        if grown:
            self.pool.extend_bulk(grown)
        self._finish_tick(t, done, observed)

    def step_legacy(self, t: int) -> None:
        """The pre-refactor per-request loop, preserved verbatim as the
        bit-parity oracle for :meth:`_step_tick` (one ``extend`` call
        per active request per tick)."""
        # In batch-observe mode (the pool's device-sketch path) alloc()
        # does not observe per item; the sizes of this step's allocations
        # are collected and handed to the controller as ONE batch below.
        # With the fused observe window (ControllerConfig.fused_observe)
        # these per-step batches just accumulate on host — the whole
        # cadence window folds into the device sketch in a single
        # dispatch at the adaptive drift check.
        observed: List[int] = []
        self._try_admit(observed, t)
        done: List[int] = []
        for rid, req in self.active.items():
            req.decoded += 1
            old = self.pool.allocation(rid)
            new = self.pool.extend(rid, req.kv_len)
            if new is None:          # pool full mid-flight: drop request
                observed.append(req.kv_len)   # the attempt still counts
                done.append(rid)
                self.rejected += 1
                continue
            if new.start != old.start:   # class overflow -> chunk copy
                self.realloc_copies += 1
                self.realloc_tokens += old.length
                observed.append(req.kv_len)
            if req.decoded >= req.output_len:
                done.append(rid)
                self.completed += 1
        self._finish_tick(t, done, observed)

    def _finish_tick(self, t: int, done: List[int],
                     observed: List[int]) -> None:
        """Completion frees, batched observation, arbitration cadence,
        refit policy — shared tail of both tick flavors."""
        for rid in done:
            if rid in self.pool._live:
                self.pool.free(rid)
            del self.active[rid]
        if self.pool.batch_observe and observed:
            self.pool.observe_lengths(np.asarray(observed, dtype=np.int64))
        if self.arbiter is not None:
            # one tick per step per stream: admissions + decodes both
            # already fed the pool's counters this step
            self.arbiter.tick(1)
        if self.adaptive:
            decision = self.pool.maybe_refit()
            if decision is not None:
                self.refit_decisions.append(decision)
                if decision.approved:
                    self.n_refits += 1
        elif self.refit_every and t > 0 and t % self.refit_every == 0:
            before = list(self.pool.chunk_classes)
            self.pool.refit()
            if list(self.pool.chunk_classes) != before:
                self.n_refits += 1

    def run(self, workload: List[Request], steps: int) -> SimResult:
        for r in workload:
            self.submit(r)
        waste_samples = []
        active_samples = []
        for t in range(steps):
            self.step(t)
            st = self.pool.stats()
            if st.active_requests:
                waste_samples.append(st.waste_fraction)
            active_samples.append(st.active_requests)
            if not self.active and not self.queue:
                break
        qd_mean, qd_p50, qd_p99 = queue_delay_stats(self.queue_delays)
        return SimResult(
            steps=t + 1,
            completed=self.completed,
            rejected=self.rejected,
            realloc_copies=self.realloc_copies,
            realloc_tokens=self.realloc_tokens,
            mean_waste_fraction=(float(np.mean(waste_samples))
                                 if waste_samples else 0.0),
            peak_active=int(np.max(active_samples)),
            mean_active=float(np.mean(active_samples)),
            n_refits=self.n_refits,
            queue_delay_mean=qd_mean,
            queue_delay_p50=qd_p50,
            queue_delay_p99=qd_p99)


def lognormal_request_workload(rng: np.random.Generator, n: int, *,
                               prompt_mean: float = 2048.0,
                               prompt_std: float = 700.0,
                               output_mean: float = 256.0,
                               output_std: float = 120.0,
                               arrival_rate: Optional[float] = None
                               ) -> List[Request]:
    """Request lengths log-normal — the serving analogue of the paper's
    traffic model (and what production traces look like).
    ``arrival_rate`` (requests per tick) adds open-loop Poisson
    arrivals: exponential inter-arrival gaps, cumulative; ``None``
    keeps the closed-loop default (everything arrives at 0)."""
    from repro_torch.core.distribution import lognormal_params_from_moments
    pm, ps = lognormal_params_from_moments(prompt_mean, prompt_std)
    om, os_ = lognormal_params_from_moments(output_mean, output_std)
    prompts = np.clip(rng.lognormal(pm, ps, n), 16, None).astype(int)
    outputs = np.clip(rng.lognormal(om, os_, n), 1, None).astype(int)
    arrivals = np.zeros(n)
    if arrival_rate is not None:
        arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate, n))
    return [Request(rid=i, prompt_len=int(p), output_len=int(o),
                    arrival=float(a))
            for i, (p, o, a) in enumerate(zip(prompts, outputs, arrivals))]
