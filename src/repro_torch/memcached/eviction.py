"""Pluggable eviction policies for the slab layer — the cost half of
cost-aware refitting.

The paper's greedy refit only pays off when the migration cost it is
charged is honest. ``SlabAllocator`` historically evicted a victim
class's coldest items wholesale and priced every evicted payload byte
at full cost, which inflates the controller's migration cost model and
vetoes refits (and arbiter transfers) that would reduce memory holes.
Memshare (Cidon et al., 2017) shows rank-based victim selection —
evict the page whose residents are least likely to be re-referenced —
recovers most of that cost, and memcached's own segmented LRU is the
stock mechanism for separating one-hit wonders from the working set.

This module makes the eviction decision a *contract* rather than a
hardcoded behaviour (see ``docs/eviction.md`` for the full contract):

* :class:`EvictionPolicy` — the protocol. A policy observes item
  lifecycle events (`on_insert` / `on_access` / `on_remove`), selects
  victims (`select_victim` for one capacity eviction,
  `page_victims` for a page reclaim), and *prices* future evictions
  (`page_reclaim_cost_bytes`, `class_teardown_cost_bytes`) — the two
  numbers the :class:`~repro_torch.core.controller.SlabController` cost
  model and the :class:`~repro_torch.core.arbiter.TenantArbiter` donor
  selection consume.
* :class:`ColdestLRU` — the extracted legacy behaviour: pure
  per-class LRU, wholesale cost accounting (every resident byte of a
  victim is charged). Bit-compatible with the pre-policy allocator.
* :class:`SegmentedLRU` — memcached's HOT/WARM/COLD queues: new items
  enter HOT, re-referenced COLD items are promoted to WARM, a
  per-segment crawl demotes overflow (HOT→WARM when the item was
  re-referenced in HOT, →COLD otherwise). Victims come from COLD
  first; predicted costs weight each byte by its segment's
  re-reference weight.
* :class:`RankedPageEviction` — Memshare-style: every resident keeps
  a decayed re-reference score; a page reclaim evicts the residents
  whose scores are lowest (the cheapest "page"), and predicted costs
  charge only ``bytes x p(re-reference)``.

Policies are duck-typed against a minimal *slab-class view*: any
object with ``chunk_size`` (int) and ``lru`` (an ``OrderedDict``
mapping key → stored size, least recently used first). Both
``repro_torch.memcached.SlabAllocator._SlabClass`` and the retained-chunk
holders inside :class:`repro_torch.serving.KVSlabPool` satisfy it, so the
same three policies price byte chunks and KV token pages.
"""
from __future__ import annotations

import heapq
import math
from collections import OrderedDict
from itertools import islice
from typing import Dict, Iterable, List, Protocol, Tuple, runtime_checkable


@runtime_checkable
class EvictionPolicy(Protocol):
    """The eviction-policy contract (full prose: ``docs/eviction.md``).

    Lifecycle events — called by the owning allocator, after its own
    bookkeeping, so ``cls.lru`` already reflects the event:

    * ``on_insert(cls, key, size)`` — ``key`` became resident in ``cls``.
    * ``on_access(cls, key)``       — resident ``key`` was re-referenced
      (get hit, or overwrite in the same class).
    * ``on_remove(cls, key)``       — ``key`` left ``cls`` (delete,
      eviction, or cross-class move). Must be O(1)-ish and idempotent
      for unknown keys.
    * ``watch(cls)``                — (re)build per-class state from
      ``cls.lru`` (policy attached mid-run, LRU order preserved).
    * ``forget(cls)``               — ``cls`` was torn down
      (``reconfigure``); drop its state.

    Selection — keys must be residents of ``cls``; the caller performs
    the actual removal (and then calls ``on_remove``):

    * ``select_victim(cls)``     — one key for a capacity eviction.
    * ``page_victims(cls, n)``   — ``n`` keys whose eviction frees one
      page, cheapest first (the simulator models "the cheapest page"
      as the n cheapest chunks, since it does not track page
      membership).

    Cost prediction — the honest numbers the refit/transfer cost
    models charge *instead of* wholesale payload loss:

    * ``page_reclaim_cost_bytes(cls, n)``  — predicted payload cost of
      evicting ``page_victims(cls, n)`` now.
    * ``class_teardown_cost_bytes(cls)``   — predicted payload cost of
      evicting every resident of ``cls`` (the ``reconfigure`` term).
    * ``rereference_weight(cls, key)``     — the per-item ``p`` in
      ``[0, 1]`` behind both predictions (1 = certain re-reference,
      charged at full cost).

    Invariant (tested in ``tests/test_eviction.py``): predicted cost
    never exceeds the raw payload bytes of the same victims, and
    ``ColdestLRU`` predicts exactly the realized eviction bytes.
    """

    name: str

    def watch(self, cls) -> None: ...
    def forget(self, cls) -> None: ...
    def on_insert(self, cls, key: str, size: int) -> None: ...
    def on_access(self, cls, key: str) -> None: ...
    def on_remove(self, cls, key: str) -> None: ...
    def select_victim(self, cls) -> str: ...
    def page_victims(self, cls, n: int) -> List[str]: ...
    def page_reclaim_cost_bytes(self, cls, n: int) -> float: ...
    def class_teardown_cost_bytes(self, cls) -> float: ...
    def rereference_weight(self, cls, key: str) -> float: ...


# ---------------------------------------------------------------------------
# ColdestLRU — the legacy behaviour, extracted
# ---------------------------------------------------------------------------

class ColdestLRU:
    """Pure per-class LRU with wholesale cost accounting.

    Victims are the LRU-oldest residents (``cls.lru`` head); predicted
    costs charge every victim byte at full price
    (``rereference_weight == 1``). This is exactly what
    ``SlabAllocator`` did before the policy contract existed — the
    conservative baseline every comparison in ``docs/eviction.md``
    measures against.
    """

    name = "coldest"

    # lifecycle: the allocator's own LRU order is the whole state
    def watch(self, cls) -> None:
        pass

    def forget(self, cls) -> None:
        pass

    def on_insert(self, cls, key: str, size: int) -> None:
        pass

    def on_access(self, cls, key: str) -> None:
        pass

    def on_remove(self, cls, key: str) -> None:
        pass

    def select_victim(self, cls) -> str:
        return next(iter(cls.lru))

    def page_victims(self, cls, n: int) -> List[str]:
        return list(islice(cls.lru, n))

    def page_reclaim_cost_bytes(self, cls, n: int) -> float:
        return sum(islice(cls.lru.values(), n))

    def class_teardown_cost_bytes(self, cls) -> float:
        return sum(cls.lru.values())

    def rereference_weight(self, cls, key: str) -> float:
        return 1.0


# ---------------------------------------------------------------------------
# SegmentedLRU — memcached's HOT/WARM/COLD queues
# ---------------------------------------------------------------------------

class SegmentedLRU:
    """Memcached-style segmented LRU (HOT / WARM / COLD).

    * New items enter HOT.
    * A re-reference marks the item *active* in its segment (HOT/WARM:
      also moves it to the segment's MRU end); a re-referenced COLD
      item is promoted to WARM.
    * The per-segment crawl (run after every mutation) caps HOT and
      WARM at ``hot_max`` / ``warm_max`` fractions of the class's
      residents: overflowing HOT items demote to WARM when active,
      COLD otherwise; overflowing WARM items are re-queued in WARM
      when active (flag cleared), demoted to COLD otherwise.
    * Victims come from COLD first, then WARM, then HOT — each in LRU
      order.

    Predicted costs weight each victim byte by its segment's
    re-reference weight (``w_hot`` / ``w_warm`` / ``w_cold``): a COLD
    byte is nearly free to evict, a HOT byte costs full price. The
    crawl guarantees ``len(HOT) <= ceil(hot_max * n)`` and
    ``len(WARM) <= ceil(warm_max * n)`` after every event (the
    invariant ``tests/test_eviction.py`` checks).
    """

    name = "segmented"

    _HOT, _WARM, _COLD = 0, 1, 2

    def __init__(self, *, hot_max: float = 0.32, warm_max: float = 0.32,
                 w_hot: float = 1.0, w_warm: float = 0.5,
                 w_cold: float = 0.05):
        if not 0.0 < hot_max < 1.0 or not 0.0 < warm_max < 1.0:
            raise ValueError("segment caps must be in (0, 1)")
        self.hot_max = hot_max
        self.warm_max = warm_max
        self.weights = (w_hot, w_warm, w_cold)
        # per-class: three OrderedDicts key -> active flag
        self._segs: Dict[int, Tuple[OrderedDict, OrderedDict, OrderedDict]] \
            = {}

    def _state(self, cls) -> Tuple[OrderedDict, OrderedDict, OrderedDict]:
        st = self._segs.get(id(cls))
        if st is None:
            st = (OrderedDict(), OrderedDict(), OrderedDict())
            self._segs[id(cls)] = st
            for key in cls.lru:       # adopt existing residents (LRU order)
                st[self._HOT][key] = False
            self._crawl(cls, st)
        return st

    def watch(self, cls) -> None:
        self._segs.pop(id(cls), None)
        self._state(cls)

    def forget(self, cls) -> None:
        self._segs.pop(id(cls), None)

    # -- events --------------------------------------------------------------
    def on_insert(self, cls, key: str, size: int) -> None:
        st = self._state(cls)
        st[self._HOT][key] = False
        st[self._HOT].move_to_end(key)
        self._crawl(cls, st)

    def on_access(self, cls, key: str) -> None:
        st = self._state(cls)
        hot, warm, cold = st
        if key in hot:
            hot[key] = True
            hot.move_to_end(key)
        elif key in warm:
            warm[key] = True
            warm.move_to_end(key)
        elif key in cold:
            del cold[key]
            warm[key] = True          # promotion on re-reference
            self._crawl(cls, st)

    def on_remove(self, cls, key: str) -> None:
        st = self._segs.get(id(cls))
        if st is None:
            return
        for seg in st:
            if key in seg:
                del seg[key]
                return

    def _crawl(self, cls, st) -> None:
        """Demote segment overflow until the caps hold."""
        hot, warm, cold = st
        n = len(cls.lru)
        hot_cap = math.ceil(self.hot_max * n)
        warm_cap = math.ceil(self.warm_max * n)
        while len(hot) > hot_cap:
            key, active = hot.popitem(last=False)
            (warm if active else cold)[key] = False
        while len(warm) > warm_cap:
            key, active = warm.popitem(last=False)
            if active:
                warm[key] = False     # second chance at WARM's MRU end
            else:
                cold[key] = False

    # -- selection -----------------------------------------------------------
    def _victim_order(self, cls) -> Iterable[Tuple[str, int]]:
        st = self._state(cls)
        for seg_idx in (self._COLD, self._WARM, self._HOT):
            for key in st[seg_idx]:
                yield key, seg_idx

    def select_victim(self, cls) -> str:
        return next(iter(self._victim_order(cls)))[0]

    def page_victims(self, cls, n: int) -> List[str]:
        return [k for k, _ in islice(self._victim_order(cls), n)]

    # -- cost ----------------------------------------------------------------
    def page_reclaim_cost_bytes(self, cls, n: int) -> float:
        return sum(cls.lru[k] * self.weights[seg]
                   for k, seg in islice(self._victim_order(cls), n))

    def class_teardown_cost_bytes(self, cls) -> float:
        return sum(cls.lru[k] * self.weights[seg]
                   for k, seg in self._victim_order(cls))

    def rereference_weight(self, cls, key: str) -> float:
        st = self._state(cls)
        for seg_idx in (self._HOT, self._WARM, self._COLD):
            if key in st[seg_idx]:
                return self.weights[seg_idx]
        return 1.0     # unknown key: conservative


# ---------------------------------------------------------------------------
# RankedPageEviction — Memshare-style decayed re-reference ranking
# ---------------------------------------------------------------------------

class RankedPageEviction:
    """Rank-based victim selection over decayed re-reference scores.

    Every resident keeps a score that decays exponentially with the
    policy's event clock (half-life ``half_life`` events) and gains
    +1 on each re-reference — a streaming estimate of re-reference
    *rate*, the per-item analogue of the controller's decayed size
    sketch. The mapping ``p = score / (score + 1)`` turns the rate
    into the re-reference likelihood the cost models charge.

    * A page reclaim (``page_victims``) sorts the class's residents by
      decayed score and evicts the lowest — Memshare's "evict the page
      whose residents are least likely to be re-referenced", with the
      n cheapest chunks standing in for the cheapest page (the
      simulator does not track page membership).
    * A single capacity eviction scans only the ``scan_width``
      LRU-oldest residents and evicts the lowest-scored of them
      (bounded work on the hot path, same spirit as Redis's sampled
      LFU) — so a merely-unlucky hot item near the LRU tail survives.
    * Predicted costs are ``sum(bytes_i * p_i)`` over the victims:
      evicting a dead key is (correctly) almost free.
    """

    name = "ranked"

    def __init__(self, *, half_life: float = 4000.0,
                 insert_score: float = 0.5, scan_width: int = 32):
        if half_life <= 0:
            raise ValueError("half_life must be positive")
        self.half_life = float(half_life)
        self.insert_score = float(insert_score)
        self.scan_width = int(scan_width)
        self._decay = math.log(2.0) / self.half_life
        self._tick = 0
        # per-class: key -> (score_at_stamp, stamp)
        self._scores: Dict[int, Dict[str, Tuple[float, int]]] = {}

    def _state(self, cls) -> Dict[str, Tuple[float, int]]:
        st = self._scores.get(id(cls))
        if st is None:
            st = {key: (self.insert_score, self._tick) for key in cls.lru}
            self._scores[id(cls)] = st
        return st

    def watch(self, cls) -> None:
        self._scores.pop(id(cls), None)
        self._state(cls)

    def forget(self, cls) -> None:
        self._scores.pop(id(cls), None)

    def score(self, cls, key: str) -> float:
        """Current (decayed) re-reference score of a resident."""
        st = self._state(cls)
        val, stamp = st.get(key, (self.insert_score, self._tick))
        return val * math.exp(-self._decay * (self._tick - stamp))

    def rereference_weight(self, cls, key: str) -> float:
        s = self.score(cls, key)
        return s / (s + 1.0)

    # -- events --------------------------------------------------------------
    def on_insert(self, cls, key: str, size: int) -> None:
        self._tick += 1
        self._state(cls)[key] = (self.insert_score, self._tick)

    def on_access(self, cls, key: str) -> None:
        self._tick += 1
        self._state(cls)[key] = (self.score(cls, key) + 1.0, self._tick)

    def on_remove(self, cls, key: str) -> None:
        st = self._scores.get(id(cls))
        if st is not None:
            st.pop(key, None)

    # -- selection -----------------------------------------------------------
    def select_victim(self, cls) -> str:
        candidates = islice(cls.lru, self.scan_width)
        return min(candidates, key=lambda k: self.score(cls, k))

    def page_victims(self, cls, n: int) -> List[str]:
        if n >= len(cls.lru):
            return list(cls.lru)
        # O(m log n), not a full sort: donor pricing runs this for every
        # class of every tenant at each arbitration round
        return heapq.nsmallest(n, cls.lru, key=lambda k: self.score(cls, k))

    # -- cost ----------------------------------------------------------------
    def page_reclaim_cost_bytes(self, cls, n: int) -> float:
        return sum(cls.lru[k] * self.rereference_weight(cls, k)
                   for k in self.page_victims(cls, n))

    def class_teardown_cost_bytes(self, cls) -> float:
        return sum(cls.lru[k] * self.rereference_weight(cls, k)
                   for k in cls.lru)


_POLICIES = {
    "coldest": ColdestLRU,
    "segmented": SegmentedLRU,
    "ranked": RankedPageEviction,
}


def make_policy(name: str, **kwargs) -> EvictionPolicy:
    """Build a policy by its registry name (the benchmarks' ``--policy``
    axis): ``"coldest"`` | ``"segmented"`` | ``"ranked"``."""
    try:
        return _POLICIES[name](**kwargs)
    except KeyError:
        raise ValueError(
            f"unknown eviction policy {name!r}; "
            f"choose from {sorted(_POLICIES)}") from None
