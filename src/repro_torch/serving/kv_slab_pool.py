"""KV-cache slab pool with LEARNED chunk classes — the paper's technique
as a serving-runtime feature.

The mapping (DESIGN.md §2): a serving runtime allocates KV-cache space
per request; request context lengths are the "item sizes", the KV pool
is the memory, and rounding a request up to its allocation is internal
fragmentation of HBM. vLLM-style paging buys ~zero fragmentation with
per-page indirection; this pool allocates each request ONE contiguous
chunk whose size comes from a slab-class schedule *learned from the
observed request-length distribution* (SlabPolicy / the paper's
algorithm). The learned schedule bounds the fragmentation that
contiguity would otherwise cost; the contiguous layout is what the
decode-attention kernel (``csrc/slab_attention.cu``) streams through
with no per-page indirection.

Host code, carried over from the reference unchanged except for where
the shared controller runs: ``torch_device`` (default ``"cuda"``) goes
into the default controller config, so a refit's searches run on the
card; pass ``"cpu"`` for the plain versions.

Implementation notes:
  * allocation granularity is ALIGN tokens (kernel tile = 128), so the
    learner fits on the align-quantized length histogram;
  * per-class free lists + bump pointer, O(1) alloc/free — the memcached
    discipline, in tokens instead of bytes;
  * observation and refitting are delegated to the shared
    ``repro_torch.core.SlabController`` (the paper's "analyse the pattern of
    sizes previously entered" loop): every ``alloc`` feeds the
    controller's decayed sketch, ``refit()`` fits unconditionally through
    it, and ``maybe_refit()`` runs its full drift/hysteresis/cost
    decision pipeline — the same path the memcached simulator uses;
  * finished sequences can be *retained* (``finish(rid, retain=True)``)
    instead of freed — their token chunks stay resident as a prefix
    cache, ranked by the same pluggable
    :class:`~repro_torch.memcached.eviction.EvictionPolicy` contract the
    memcached layer uses (``eviction_policy=``). Under pool pressure,
    ``alloc`` reclaims the retained chunk whose sequence is least
    likely to be re-referenced (``reuse``d) — Memshare's rank-based
    victim selection, with KV token pages as the page unit;
  * per-stream token quotas can be ARBITER-MANAGED: ``token_quota_arbiter``
    wraps each stream in a :class:`KVTenantQuotaView` over a
    ``ResourcePool(kind="kv_tokens")`` so the shared
    :class:`~repro_torch.core.arbiter.TenantArbiter` moves quota between
    streams as their load phases, pricing donors by the retained-
    sequence reclaimable value (see docs/architecture.md, "The second
    resource kind").
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.analysis.registry import hot_path
from repro_torch.core import ControllerConfig, SlabController, SlabPolicy
from repro_torch.core.controller import RefitDecision
from repro_torch.kernels import ops
from repro_torch.memcached.eviction import ColdestLRU, EvictionPolicy

ALIGN = 128  # tokens; matches the attention/scatter kernels' tile


def quantize_lengths(lengths: np.ndarray, align: int = ALIGN) -> np.ndarray:
    """Round lengths up to the allocation grid (the learner's item size)."""
    lengths = np.asarray(lengths, dtype=np.int64)
    return ((lengths + align - 1) // align) * align


@dataclasses.dataclass
class PoolStats:
    active_requests: int
    pool_tokens: int
    allocated_tokens: int      # sum of chunk sizes of live allocations
    used_tokens: int           # sum of true KV lengths
    free_tokens: int
    n_failed: int
    n_retained: int = 0            # finished sequences kept as prefix cache
    retained_tokens: int = 0       # chunk tokens held by retained sequences
    n_retained_reused: int = 0     # retained sequences re-activated
    n_retained_evicted: int = 0    # retained chunks reclaimed under pressure

    @property
    def waste_tokens(self) -> int:
        return self.allocated_tokens - self.used_tokens

    @property
    def utilization(self) -> float:
        return self.used_tokens / max(self.allocated_tokens, 1)

    @property
    def waste_fraction(self) -> float:
        return self.waste_tokens / max(self.allocated_tokens, 1)


@dataclasses.dataclass
class Allocation:
    request_id: int
    start: int          # pool token offset (ALIGN-multiple)
    chunk: int          # slab class size (tokens)
    length: int         # true KV length
    tenant: str = "default"   # serving stream this allocation belongs to


class _RetainedClass:
    """Slab-class view over the retained (finished-sequence) chunks of
    one size, duck-typed for the ``EvictionPolicy`` contract:
    ``lru`` maps request key -> chunk tokens, least recently
    retained/touched first."""

    __slots__ = ("chunk_size", "lru")

    def __init__(self, chunk_size: int):
        self.chunk_size = chunk_size
        self.lru: OrderedDict[str, int] = OrderedDict()


@dataclasses.dataclass
class TenantTokens:
    """Per-tenant accounting inside a shared :class:`KVSlabPool`."""

    quota_tokens: Optional[int] = None   # cap on allocated tokens (None: ∞)
    allocated_tokens: int = 0            # chunk tokens of live allocations
    used_tokens: int = 0                 # true KV tokens of live allocations
    active_requests: int = 0
    n_failed: int = 0                    # allocs refused (pool or quota)
    # retained-chunk (prefix-cache) churn, split the way the memcached
    # layer splits pressure vs migration evictions: pressure reclaims
    # are the arbiter's demand signal, arbiter-driven reclaims must
    # never pollute it
    n_retained_evicted: int = 0          # pressure reclaims (alloc path)
    retained_evicted_tokens: int = 0     # their chunk tokens
    n_quota_reclaims: int = 0            # arbiter-driven reclaims
    quota_reclaimed_tokens: int = 0      # their chunk tokens
    # requests the arbiter's admission gate turned away BEFORE they
    # reached alloc (see TenantArbiter.admission) — kept apart from
    # n_failed so the allocator's own failure ledger stays honest, but
    # folded into the quota view's pressure signal
    n_admission_denied: int = 0


class KVSlabPool:
    """Contiguous KV pool with slab-class allocation.

    One token space, per-class freelists + bump pointer, chunk classes
    learned online through the shared ``SlabController``. Several
    serving streams may share the pool as *tenants*
    (:meth:`register_tenant` / ``alloc(..., tenant=)``): token
    accounting and failures are tracked per stream, an optional
    ``quota_tokens`` caps any one stream's share of HBM, and the
    learned classes come from the merged traffic of all streams.
    """

    def __init__(self, pool_tokens: int, chunk_classes, *,
                 align: int = ALIGN,
                 controller_config: Optional[ControllerConfig] = None,
                 eviction_policy: Optional[EvictionPolicy] = None,
                 device_observe: bool = False,
                 batch_observe: Optional[bool] = None,
                 torch_device="cuda"):
        self.pool_tokens = int(pool_tokens)
        self.align = align
        self.set_classes(chunk_classes)
        self._bump = 0
        self._free: Dict[int, List[int]] = defaultdict(list)
        self._live: Dict[int, Allocation] = {}
        self.n_failed = 0
        self._tenants: Dict[str, TenantTokens] = {}
        self.register_tenant("default")
        # finished-sequence prefix cache, ranked by the eviction policy
        self.eviction_policy: EvictionPolicy = eviction_policy or ColdestLRU()
        self._retained: Dict[int, Allocation] = {}
        self._retained_cls: Dict[int, _RetainedClass] = {}
        self.n_retained_reused = 0
        self.n_retained_evicted = 0
        if controller_config is None:
            # half_life=inf: undecayed sketch == the legacy all-history
            # histogram, so `refit()` behaves exactly as it used to.
            controller_config = ControllerConfig(
                page_size=1 << 22, min_chunk=align, align=align,
                half_life=float("inf"), torch_device=torch_device)
        if device_observe and not controller_config.device:
            # Device-resident observe: the sketch lives in HBM on a
            # bucket grid of ALIGN tokens. The grid must cover every
            # ALLOCATABLE length — refits may grow the top class well
            # past the initial schedule, and a length beyond the pool's
            # own capacity can never be stored anyway, so pool_tokens is
            # the natural ceiling. Huge pools widen the grid (keeping
            # coverage, coarsening resolution) rather than silently
            # clamping allocatable lengths into the top bucket.
            width = align
            buckets = max(64, -(-self.pool_tokens // width))
            while buckets > (1 << 17):
                width *= 2
                buckets = -(-self.pool_tokens // width)
            controller_config = dataclasses.replace(
                controller_config, device=True,
                device_bucket_width=width, device_buckets=int(buckets))
        # Batched observation (the device path's natural feeding mode):
        # per-alloc observes are skipped and the serving loop hands whole
        # batches of lengths to observe_lengths() instead.
        self.batch_observe = (bool(controller_config.device)
                              if batch_observe is None else batch_observe)
        ops.resolve_device(controller_config.torch_device)  # raise early
        self.controller = SlabController(self.chunk_classes,
                                         config=controller_config)

    # -- class management ----------------------------------------------------
    def set_classes(self, chunk_classes) -> None:
        cc = sorted(int(c) for c in chunk_classes)
        if any(c % self.align for c in cc):
            raise ValueError(f"classes must be multiples of {self.align}")
        self.chunk_classes = cc
        if getattr(self, "_free", None):
            self._rehome_stranded_free()

    def _carve_range(self, size: int, start: int) -> None:
        """Split a free token range into current class sizes, largest
        first (a sub-min-class remainder can still strand — bounded by
        one min-chunk per range)."""
        remaining, pos = size, start
        for c in sorted(self.chunk_classes, reverse=True):
            while remaining >= c:
                self._free[c].append(pos)
                pos += c
                remaining -= c

    def _rehome_stranded_free(self) -> None:
        """Re-carve freelist ranges of vanished classes into current
        class sizes so pool tokens don't leak across refits."""
        valid = set(self.chunk_classes)
        stranded = [(size, start)
                    for size, starts in self._free.items()
                    if size not in valid for start in starts]
        for size in [s for s in list(self._free) if s not in valid]:
            del self._free[size]
        for size, start in stranded:
            self._carve_range(size, start)

    def class_for(self, length: int) -> Optional[int]:
        for c in self.chunk_classes:            # K is small
            if c >= length:
                return c
        return None

    # -- tenancy ---------------------------------------------------------------
    def register_tenant(self, name: str, *,
                        quota_tokens: Optional[int] = None) -> TenantTokens:
        """Register one serving stream as a tenant of this pool
        (idempotent; a later call may set/adjust the token quota). All
        tenants share the pool's token space, freelists, and learned
        classes — the controller's sketch sees the merged traffic —
        while allocated/used/failure accounting is kept per tenant and
        ``quota_tokens`` caps any one stream's share of HBM."""
        rec = self._tenants.get(name)
        if rec is None:
            rec = TenantTokens(quota_tokens=quota_tokens)
            self._tenants[name] = rec
        elif quota_tokens is not None:
            rec.quota_tokens = quota_tokens
        return rec

    # -- alloc/free ------------------------------------------------------------
    @hot_path
    def alloc(self, request_id: int, length: int, *,
              tenant: str = "default") -> Optional[Allocation]:
        rec = self._tenants.get(tenant)
        if rec is None:
            # strict: a typo'd tenant name must not silently bypass a
            # registered tenant's quota (PagePool.acquire is equally
            # strict) — and checked first, so the error path leaves no
            # phantom observation in the controller's sketch
            raise KeyError(f"tenant {tenant!r} not registered "
                           "(call register_tenant first)")
        if request_id in self._retained:    # id reuse while a stale
            self._drop_retained(request_id)   # retained chunk exists
        al = self.align
        if not self.batch_observe:
            self.controller.observe((int(length) + al - 1) // al * al)
        chunk = self.class_for(length)
        if chunk is None:
            self.n_failed += 1
            rec.n_failed += 1
            return None
        if (rec.quota_tokens is not None
                and rec.allocated_tokens + chunk > rec.quota_tokens):
            self.n_failed += 1
            rec.n_failed += 1
            return None
        if self._free[chunk]:
            start = self._free[chunk].pop()
        elif self._bump + chunk <= self.pool_tokens:
            start = self._bump
            self._bump += chunk
        else:
            start = self._reclaim_retained(chunk)
            if start is None:
                self.n_failed += 1
                rec.n_failed += 1
                return None
        a = Allocation(request_id, start, chunk, length, tenant)
        self._live[request_id] = a
        rec.allocated_tokens += chunk
        rec.used_tokens += length
        rec.active_requests += 1
        return a

    def extend(self, request_id: int, new_length: int
               ) -> Optional[Allocation]:
        """Grow a request's KV (decode). Within-chunk growth is free; a
        class overflow reallocates into the next class (copy cost is the
        caller's — it shows up in the scheduler's accounting)."""
        a = self._live[request_id]
        if new_length <= a.chunk:
            self._tenants[a.tenant].used_tokens += new_length - a.length
            a.length = new_length
            return a
        self.free(request_id)
        return self.alloc(request_id, new_length, tenant=a.tenant)

    def extend_bulk(self, updates: List[Tuple[int, int]]) -> None:
        """Batched within-chunk decode growth: ``updates`` is
        ``[(request_id, new_length), ...]`` for one tick's worth of
        sequences whose new length still fits their current chunk — the
        host-side analogue of the harness's one-dispatch decode tick
        (no per-request calls, one tenant-accounting pass). Every entry
        MUST fit its allocation's chunk; class overflow must go through
        :meth:`extend`, which reallocates (the caller separates the two
        cases — it needs to know about the chunk copy anyway)."""
        per_tenant: Dict[str, int] = {}
        for rid, new_length in updates:
            a = self._live[rid]
            if new_length > a.chunk:
                raise ValueError(
                    f"extend_bulk: request {rid} new length {new_length} "
                    f"overflows its chunk {a.chunk}; use extend()")
            per_tenant[a.tenant] = (per_tenant.get(a.tenant, 0)
                                    + new_length - a.length)
            a.length = new_length
        for tenant, delta in per_tenant.items():
            self._tenants[tenant].used_tokens += delta

    def free(self, request_id: int) -> None:
        a = self._live.pop(request_id)
        rec = self._tenants[a.tenant]
        rec.allocated_tokens -= a.chunk
        rec.used_tokens -= a.length
        rec.active_requests -= 1
        if a.chunk in self.chunk_classes:
            self._free[a.chunk].append(a.start)
        else:   # class vanished in a refit while this request was live
            self._carve_range(a.chunk, a.start)

    def allocation(self, request_id: int) -> Allocation:
        return self._live[request_id]

    # -- finished-sequence prefix cache (policy-ranked token pages) ----------
    def _drop_retained(self, request_id: int) -> None:
        """Discard a retained entry, returning its token range to the
        freelist (id collision: a new allocation or retention reuses
        the request id while the old retained chunk still exists)."""
        a = self._retained.pop(request_id)
        holder = self._retained_cls[a.chunk]
        del holder.lru[str(request_id)]
        self.eviction_policy.on_remove(holder, str(request_id))
        if a.chunk in self.chunk_classes:
            self._free[a.chunk].append(a.start)
        else:
            self._carve_range(a.chunk, a.start)

    def finish(self, request_id: int, *, retain: bool = True) -> bool:
        """Finish a sequence. ``retain=True`` keeps its KV chunk
        resident as a prefix-cache entry — it leaves the tenant's live
        accounting but stays out of the freelist, evictable under pool
        pressure by the eviction policy's rank. ``retain=False`` frees
        immediately. Returns whether the chunk was retained."""
        if not retain:
            self.free(request_id)
            return False
        if request_id in self._retained:    # stale entry under the same
            self._drop_retained(request_id)   # id: recycle, don't leak
        a = self._live.pop(request_id)
        rec = self._tenants[a.tenant]
        rec.allocated_tokens -= a.chunk
        rec.used_tokens -= a.length
        rec.active_requests -= 1
        self._retained[request_id] = a
        holder = self._retained_cls.get(a.chunk)
        if holder is None:
            holder = self._retained_cls[a.chunk] = _RetainedClass(a.chunk)
        holder.lru[str(request_id)] = a.chunk
        self.eviction_policy.on_insert(holder, str(request_id), a.chunk)
        return True

    def touch_retained(self, request_id: int) -> bool:
        """Mark a retained sequence re-referenced (a prefix-hit probe)
        without re-activating it; False when it is not retained."""
        a = self._retained.get(request_id)
        if a is None:
            return False
        holder = self._retained_cls[a.chunk]
        holder.lru.move_to_end(str(request_id))
        self.eviction_policy.on_access(holder, str(request_id))
        return True

    def reuse(self, request_id: int, *,
              tenant: str = "default") -> Optional[Allocation]:
        """Re-activate a retained sequence (prefix-cache hit): its chunk
        moves back to live accounting under ``tenant``. Returns ``None``
        when the chunk was already evicted, or when the tenant's quota
        has no room (both count as failures) — the caller re-allocates
        and recomputes the prefix."""
        rec = self._tenants.get(tenant)
        if rec is None:
            raise KeyError(f"tenant {tenant!r} not registered "
                           "(call register_tenant first)")
        a = self._retained.get(request_id)
        if a is None:
            return None
        if (rec.quota_tokens is not None
                and rec.allocated_tokens + a.chunk > rec.quota_tokens):
            self.n_failed += 1
            rec.n_failed += 1
            return None
        del self._retained[request_id]
        holder = self._retained_cls[a.chunk]
        del holder.lru[str(request_id)]
        self.eviction_policy.on_remove(holder, str(request_id))
        a.tenant = tenant
        self._live[request_id] = a
        rec.allocated_tokens += a.chunk
        rec.used_tokens += a.length
        rec.active_requests += 1
        self.n_retained_reused += 1
        return a

    def _reclaim_retained(self, chunk: int) -> Optional[int]:
        """Evict the retained sequence least likely to be reused whose
        chunk can hold ``chunk`` tokens (Memshare's rank-based victim
        selection on token pages); returns the start of a range of
        ``chunk`` tokens, or ``None`` when nothing evictable fits. A
        larger victim's remainder is carved back into the freelist."""
        pol = self.eviction_policy
        best = None                     # (weight, holder, key)
        for holder in self._retained_cls.values():
            if holder.chunk_size < chunk or not holder.lru:
                continue
            key = pol.select_victim(holder)
            w = pol.rereference_weight(holder, key)
            if (best is None or w < best[0]
                    or (w == best[0]
                        and holder.chunk_size < best[1].chunk_size)):
                best = (w, holder, key)
        if best is None:
            return None
        _, holder, key = best
        a = self._retained.pop(int(key))
        del holder.lru[key]
        pol.on_remove(holder, key)
        self.n_retained_evicted += 1
        vrec = self._tenants.get(a.tenant)
        if vrec is not None:    # pressure signal: whose prefix cache paid
            vrec.n_retained_evicted += 1
            vrec.retained_evicted_tokens += a.chunk
        if a.chunk > chunk:
            self._carve_range(a.chunk - chunk, a.start + chunk)
        return a.start

    # -- arbiter-facing retained-value surface (token-quota arbitration) -----
    def _retained_ranked(self, tenant: str) -> List[Tuple[float, int, int]]:
        """This tenant's retained chunks as ``(rereference_weight,
        request_id, chunk_tokens)``, cheapest (least likely re-used)
        first — the reclaimable-value signal the quota arbiter prices
        donors with."""
        pol = self.eviction_policy
        out = []
        for rid, a in self._retained.items():
            if a.tenant != tenant:
                continue
            holder = self._retained_cls[a.chunk]
            out.append((pol.rereference_weight(holder, str(rid)), rid,
                        a.chunk))
        out.sort(key=lambda t: (t[0], t[2]))
        return out

    def tenant_release_cost_tokens(self, tenant: str, tokens: int) -> float:
        """Predicted cost (in tokens, re-reference-weighted) of taking
        ``tokens`` of quota away from ``tenant`` right now. Unused
        quota headroom (quota minus live minus retained) goes first and
        is free — nobody is using it; then retained chunks cover the
        release at their policy-priced value (a dead prefix cache
        donates nearly free); only a remaining shortfall has to come
        out of tokens the stream is actively using, charged at full
        rate — the wholesale price of making a live stream fail
        allocations."""
        rec = self._tenants[tenant]
        covered = 0
        if rec.quota_tokens is not None:
            retained = sum(a.chunk for a in self._retained.values()
                           if a.tenant == tenant)
            covered = max(0, rec.quota_tokens - rec.allocated_tokens
                          - retained)
        cost = 0.0
        for w, _rid, chunk in self._retained_ranked(tenant):
            if covered >= tokens:
                break
            cost += w * chunk
            covered += chunk
        if covered < tokens:
            cost += float(tokens - covered)
        return cost

    def reclaim_tenant_retained(self, tenant: str, tokens: int
                                ) -> Tuple[int, int]:
        """Evict ``tenant``'s least-valuable retained chunks until
        ``tokens`` chunk tokens are freed (or its prefix cache is
        empty); the freed ranges re-enter the freelist. The quota
        arbiter's execute step — counted as quota reclaims, NOT as
        pressure evictions. Returns ``(n_evicted, tokens_freed)``."""
        rec = self._tenants[tenant]
        n, freed = 0, 0
        for _w, rid, chunk in self._retained_ranked(tenant):
            if freed >= tokens:
                break
            self._drop_retained(rid)
            n += 1
            freed += chunk
        rec.n_quota_reclaims += n
        rec.quota_reclaimed_tokens += freed
        return n, freed

    # -- learning -------------------------------------------------------------
    @hot_path
    def observe_lengths(self, lengths) -> None:
        """Feed one batch of request KV lengths into the controller's
        sketch (the ``batch_observe`` feeding mode). ``lengths`` may be
        a host array or a device array straight out of a serve step.

        On the device path the RAW lengths are handed over untouched:
        the sketch's bucket grid is a multiple of ALIGN, and
        ``ceil(ceil(s/a)*a / (m*a)) == ceil(s / (m*a))`` — bucketing
        raw lengths lands in exactly the bucket the ALIGN-quantized
        length would, so quantization, bucketing, and the decayed
        update all happen inside the controller's fused observe window
        (one dispatch per cadence, nothing computed per batch on host).
        """
        cfg = self.controller.config
        if cfg.device and cfg.device_bucket_width % self.align == 0:
            self.controller.observe_many(lengths)
            return
        if not hasattr(lengths, "astype"):   # plain python list/tuple
            lengths = np.asarray(lengths)
        al = self.align
        self.controller.observe_many((lengths + (al - 1)) // al * al)

    def refit(self, k: Optional[int] = None, *, method: str = "dp",
              policy: Optional[SlabPolicy] = None) -> np.ndarray:
        """Re-learn chunk classes from observed lengths (paper's loop),
        unconditionally, through the shared controller.

        Only safe when the pool is empty or during a maintenance window
        (live allocations keep their old chunks; new allocations use the
        new schedule — memcached's own constraint when slab_sizes change
        requires a restart, we allow hot refit for new chunks only).
        """
        if self.controller.n_observed == 0:
            return np.asarray(self.chunk_classes)
        new = self.controller.refit_now(k or len(self.chunk_classes),
                                        method=method, policy=policy)
        self.set_classes(new)
        return np.asarray(self.chunk_classes)

    def maybe_refit(self) -> Optional[RefitDecision]:
        """One step of the controller's drift/hysteresis/cost pipeline;
        applies the new classes when a refit is approved. Live
        allocations keep their chunks (hot refit), so no migration cost
        is charged; freelist ranges of vanished classes are re-carved
        into the new class sizes by ``set_classes``. Chunks still held
        by live requests re-enter the freelist at their old size on
        ``free`` and are re-carved at the next class change."""
        decision = self.controller.maybe_refit()
        if decision is not None and decision.approved:
            self.set_classes(decision.chunks)
            self.controller.set_chunks(self.chunk_classes)
        return decision

    # -- measurement ------------------------------------------------------------
    def stats(self) -> PoolStats:
        allocated = sum(a.chunk for a in self._live.values())
        used = sum(a.length for a in self._live.values())
        free_listed = sum(c * len(v) for c, v in self._free.items())
        return PoolStats(
            active_requests=len(self._live),
            pool_tokens=self.pool_tokens,
            allocated_tokens=allocated,
            used_tokens=used,
            free_tokens=self.pool_tokens - self._bump + free_listed,
            n_failed=self.n_failed,
            n_retained=len(self._retained),
            retained_tokens=sum(a.chunk for a in self._retained.values()),
            n_retained_reused=self.n_retained_reused,
            n_retained_evicted=self.n_retained_evicted)

    def stats_by_tenant(self) -> Dict[str, TenantTokens]:
        """Live per-tenant accounting (see :class:`TenantTokens`)."""
        return dict(self._tenants)

    def kernel_args(self, request_ids) -> Tuple[np.ndarray, np.ndarray]:
        """(starts, lens) int32 arrays for slab_decode_attention."""
        starts = np.asarray([self._live[r].start for r in request_ids],
                            dtype=np.int32)
        lens = np.asarray([self._live[r].length for r in request_ids],
                          dtype=np.int32)
        return starts, lens

    @property
    def max_chunk_tokens(self) -> int:
        return max(self.chunk_classes)


class KVTenantQuotaView:
    """One serving stream of a :class:`KVSlabPool`, duck-typed as the
    allocator a :class:`~repro_torch.core.arbiter.TenantArbiter` expects —
    the adapter that makes KV **token quotas** the arbiter's second
    resource kind (``ResourcePool(kind="kv_tokens")``, one unit =
    ``unit_size`` tokens of quota).

    The mapping, column for column against the memcached tenant:

    * pressure — ``n_page_denials`` → the stream's failed allocations
      (quota or pool exhaustion), ``evicted_bytes`` → tokens of ITS
      retained prefix chunks reclaimed under pool pressure;
    * donor cost — ``page_release_cost_bytes`` → the policy-priced
      reclaimable value of one unit of its retained chunks
      (``KVSlabPool.tenant_release_cost_tokens``), shortfall charged
      wholesale;
    * execute — ``release_page`` → evict its least-valuable retained
      chunks for one unit (``reclaim_tenant_retained``) and return the
      unit to the shared pool; ``apply_quota`` pushes the moved quota
      back into ``KVSlabPool.register_tenant(quota_tokens=...)``, so
      the pool's own admission check enforces what the arbiter decided;
    * ownership — ``sync_owned`` re-measures the stream's real token
      usage (live + retained) each arbitration round, because KV
      traffic does not broker every alloc through the ResourcePool.

    Traffic never routes through ``arbiter.set``; the serving loop
    drives the cadence with ``arbiter.tick`` (see ``ContinuousBatcher``).
    """

    def __init__(self, kv: "KVSlabPool", tenant: str, pool):
        if tenant not in kv._tenants:
            raise KeyError(f"tenant {tenant!r} not registered "
                           "(call register_tenant first)")
        self.kv = kv
        self.tenant = tenant
        self.page_pool = pool

    @property
    def _rec(self) -> TenantTokens:
        return self.kv._tenants[self.tenant]

    @property
    def unit(self) -> int:
        return self.page_pool.unit_size

    @property
    def chunk_sizes(self) -> np.ndarray:
        return np.asarray(self.kv.chunk_classes, dtype=np.int64)

    # -- pressure signal -----------------------------------------------------
    @property
    def evicted_bytes(self) -> int:
        return self._rec.retained_evicted_tokens

    @property
    def n_page_denials(self) -> int:
        # admission-gate denials count as pressure too: a stream turned
        # away at the door is starving exactly like one failing allocs
        return self._rec.n_failed + self._rec.n_admission_denied

    def note_admission_denial(self) -> None:
        """Record one arbiter admission-gate denial against this stream
        (the harness's tick-granular admission seam — see
        ``TenantArbiter.admission``)."""
        self._rec.n_admission_denied += 1

    def current_demand_bytes(self) -> float:
        """Live chunk tokens — the demand series the forecaster tracks
        (a stream heading into its peak grows this before it starves)."""
        return float(self._rec.allocated_tokens)

    # -- ownership sync ------------------------------------------------------
    def retained_tokens(self) -> int:
        return sum(a.chunk for a in self.kv._retained.values()
                   if a.tenant == self.tenant)

    def sync_owned(self) -> None:
        self.page_pool.set_owned(
            self.tenant,
            (self._rec.allocated_tokens + self.retained_tokens())
            // self.unit)

    # -- donate --------------------------------------------------------------
    def page_release_cost_bytes(self) -> float:
        return self.kv.tenant_release_cost_tokens(self.tenant, self.unit)

    def release_page(self) -> Tuple[int, int]:
        n, freed = self.kv.reclaim_tenant_retained(self.tenant, self.unit)
        if self.page_pool.owned(self.tenant) > 0:
            self.page_pool.release(self.tenant)
        return n, freed

    def apply_quota(self, units: Optional[int]) -> None:
        if units is not None:
            self.kv.register_tenant(self.tenant,
                                    quota_tokens=units * self.unit)

    # -- controller/stat surface (idle for KV tenants) -----------------------
    def migration_cost_bytes(self, new_chunk_sizes) -> float:
        return 0.0      # KV refits are hot (live chunks keep their ranges)

    def stats(self):
        rec = self._rec
        import types
        return types.SimpleNamespace(
            n_resident=rec.active_requests,
            item_bytes=rec.used_tokens,
            waste=rec.allocated_tokens - rec.used_tokens,
            n_evicted=rec.n_retained_evicted,
            evicted_bytes=rec.retained_evicted_tokens,
            n_page_denials=rec.n_failed,
            migration_evictions=rec.n_quota_reclaims,
            evicted_hot_bytes=0,
            reused_after_evict=0,
            eviction_policy=type(self.kv.eviction_policy).__name__.lower())


def token_quota_arbiter(kv: KVSlabPool, *,
                        unit_tokens: Optional[int] = None,
                        floor_units: int = 1,
                        equal_partition: bool = False,
                        controller_config: Optional[ControllerConfig] = None,
                        **arbiter_kw):
    """Put a :class:`~repro_torch.core.arbiter.TenantArbiter` in charge of a
    KV pool's per-stream token quotas.

    Every stream already registered on ``kv`` becomes a tenant of a
    ``ResourcePool(kind="kv_tokens")`` whose unit is ``unit_tokens``
    (default: 8 allocation grids, i.e. ``8 * kv.align``). A stream's
    existing ``quota_tokens`` converts to its starting unit quota
    (floor division; ``None`` stays unmanaged unless
    ``equal_partition``). From then on the arbiter owns the quotas:
    each round it re-measures real usage, prices donors by the
    retained-sequence reclaimable value (plus the forecast demand
    surcharge when ``forecast=`` is active), and pushes approved moves
    back into ``KVSlabPool.register_tenant(quota_tokens=...)``.

    Drive the cadence from the serving loop:
    ``ContinuousBatcher(pool, tenant=..., arbiter=arb)`` ticks it once
    per step, or call ``arb.tick(n)`` / ``arb.arbitrate()`` yourself.
    """
    from repro_torch.core.arbiter import ResourcePool, TenantArbiter
    unit = int(unit_tokens or 8 * kv.align)
    total_units = max(1, kv.pool_tokens // unit)
    pool = ResourcePool(total_units, unit_size=unit, kind="kv_tokens")
    if controller_config is None:
        # per-tenant controllers are idle here (the pool's own shared
        # controller learns the classes from merged traffic); park the
        # check cadence out of reach
        controller_config = ControllerConfig(
            page_size=unit, check_every=1 << 62,
            torch_device=kv.controller.config.torch_device)
    arb = TenantArbiter(pool, controller_config=controller_config,
                        **arbiter_kw)
    for name, rec in kv._tenants.items():
        quota = (None if rec.quota_tokens is None
                 else max(floor_units, rec.quota_tokens // unit))
        arb.register(name, KVTenantQuotaView(kv, name, pool),
                     floor_pages=floor_units, quota=quota)
    if equal_partition:
        pool.equal_partition(floor=floor_units)
        for t in arb.tenants.values():
            t.allocator.apply_quota(pool.quota(t.name))
    return arb


def default_pow2_classes(min_chunk: int = ALIGN,
                         max_chunk: int = 1 << 17) -> np.ndarray:
    """The un-learned baseline: power-of-two chunk classes (the common
    'just double it' allocator — analogous to memcached's 1.25-geometric
    default, at allocator-friendly granularity)."""
    out = []
    c = min_chunk
    while c <= max_chunk:
        out.append(c)
        c *= 2
    return np.asarray(out, dtype=np.int64)
