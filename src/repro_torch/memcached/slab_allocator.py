"""A Memcached-faithful slab allocator simulator.

Models the storage hierarchy the paper measures:
  * memory is handed out one 1 MB *page* at a time from a global pool,
  * each page is assigned to one *slab class* and carved into fixed-size
    *chunks* (page_size // chunk_size per page; the remainder is page-tail
    waste, tracked separately),
  * an item goes to the smallest class whose chunk fits it; if the class
    has no free chunk and no pages remain, the class's LRU item is evicted
    (memcached's default per-class LRU), and
  * items larger than the largest chunk are rejected (SERVER_ERROR).

The paper's measurement — "Memory wasted" — is the internal fragmentation
of resident items: sum(chunk_size - item_size). That is ``stats().waste``.

Live reconfiguration (the paper's loop, applied): ``reassign`` moves one
page between classes with memcached's ``slabs reassign`` semantics (the
victim class's coldest page is reclaimed, its resident items evicted, the
page re-carved for the recipient class), and ``reconfigure`` retargets the
whole schedule: classes whose chunk size survives keep their pages and
items; vanished classes have every resident item evicted and their pages
parked in a free pool that future page grabs draw from first. Pages are
conserved across both (``pages_allocated`` never changes), and the costs
the controller's model charges — ``migration_evictions`` and
``n_reassigned_pages`` — are tracked in stats.

Multi-tenancy (the arbitration layer): instead of a private
``mem_limit``, an allocator can draw pages from a shared
:class:`repro_torch.core.arbiter.PagePool` (``page_pool=`` + ``tenant=``).
Every page it holds is then tenant-tagged in the pool, ``release_page``
gives the cheapest-to-reclaim page back (the cross-tenant analogue of
``slabs reassign``), and ``page_release_cost_bytes`` prices that release
for the arbiter's cost model. ``evicted_bytes`` / ``n_page_denials``
are the pressure signals the arbiter reads.

Eviction is a pluggable contract (``repro_torch.memcached.eviction``): the
allocator tracks per-item accesses (touch-on-get / touch-on-overwrite),
delegates every victim choice to its :class:`EvictionPolicy`
(``eviction_policy=`` at construction, :meth:`set_policy` live), and
prices future evictions through the policy — ``migration_cost_bytes``
and ``page_release_cost_bytes`` report the policy's *predicted* cost,
not wholesale payload loss, so cost-aware policies approve more refits.
``evicted_hot_bytes`` (payload evicted despite a recent access) and
``reused_after_evict`` (evicted keys the traffic came back for) measure
how often the chosen victims were mistakes.

A key → class index makes ``get``/``delete`` O(1) instead of scanning
every class's LRU; the adaptive benchmarks replay millions of ops.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.distribution import PAGE_SIZE
from repro_torch.memcached.eviction import ColdestLRU, EvictionPolicy


@dataclasses.dataclass
class SlabStats:
    n_resident: int
    n_rejected: int
    n_evicted: int
    pages_allocated: int
    item_bytes: int          # payload bytes of resident items
    allocated_bytes: int     # chunk bytes of resident items
    waste: int               # allocated_bytes - item_bytes (the paper's metric)
    page_tail_waste: int     # per-page remainder not usable as chunks
    per_class_resident: Dict[int, int]
    per_class_waste: Dict[int, int]
    n_reassigned_pages: int = 0   # pages moved between classes (live reconfig)
    migration_evictions: int = 0  # items evicted to reclaim victim pages
    evicted_bytes: int = 0        # payload bytes lost to pressure evictions
    n_page_denials: int = 0       # page grabs refused (mem_limit / pool)
    tenant: str = "default"       # pool ownership tag (multi-tenant mode)
    evicted_hot_bytes: int = 0    # evicted payload accessed < hot_window ago
    reused_after_evict: int = 0   # evicted keys the traffic asked for again
    eviction_policy: str = "coldest"   # the active policy's registry name

    @property
    def waste_fraction(self) -> float:
        return self.waste / max(self.item_bytes, 1)


@dataclasses.dataclass(frozen=True)
class ReconfigureReport:
    """Outcome of one live schedule change (the reconfiguration cost)."""

    evicted_items: int        # items lost from vanished classes
    evicted_bytes: int        # their payload bytes (the migration cost)
    reassigned_pages: int     # pages parked for re-carving
    kept_classes: Tuple[int, ...]
    new_classes: Tuple[int, ...]


class _SlabClass:
    __slots__ = ("chunk_size", "free_chunks", "lru", "pages")

    def __init__(self, chunk_size: int):
        self.chunk_size = chunk_size
        self.free_chunks = 0
        self.pages = 0
        self.lru: OrderedDict[str, int] = OrderedDict()  # key -> item size

    @property
    def resident_bytes(self) -> int:
        return sum(self.lru.values())


class SlabAllocator:
    """Slab allocator with per-class LRU eviction, memcached semantics.

    Memory comes either from an unbounded/`mem_limit`-bounded private
    pool (single-tenant, the paper's experiment shape) or from a shared
    tenant-tagged :class:`~repro_torch.core.arbiter.PagePool`
    (``page_pool=`` + ``tenant=``, the multi-tenant mode the
    ``TenantArbiter`` drives). Live reconfiguration is page-conserving:
    ``reassign`` moves pages between classes, ``reconfigure`` retargets
    the whole schedule, ``release_page`` surrenders a page across
    tenants. ``stats()`` carries the paper's waste metric plus the
    pressure/migration counters the controller and arbiter consume.
    See ``docs/api.md`` for worked examples.
    """

    def __init__(self, chunk_sizes: Sequence[int], *,
                 mem_limit: Optional[int] = None,
                 page_size: int = PAGE_SIZE,
                 item_overhead: int = 0,
                 page_pool=None,
                 tenant: str = "default",
                 eviction_policy: Optional[EvictionPolicy] = None,
                 hot_window: int = 1000,
                 reuse_track_max: int = 100_000):
        chunk_sizes = sorted(int(c) for c in chunk_sizes)
        if not chunk_sizes:
            raise ValueError("need at least one slab class")
        if chunk_sizes[0] <= 0 or chunk_sizes[-1] > page_size:
            raise ValueError(f"chunk sizes must be in (0, {page_size}]")
        if page_pool is not None:
            if mem_limit is not None:
                raise ValueError("page_pool and mem_limit are exclusive")
            if page_pool.page_size != page_size:
                raise ValueError(
                    f"pool page_size {page_pool.page_size} != {page_size}")
            page_pool.register(tenant)
        self.page_size = page_size
        self.item_overhead = item_overhead
        self.chunk_sizes = np.asarray(chunk_sizes, dtype=np.int64)
        self.classes: List[_SlabClass] = [_SlabClass(c) for c in chunk_sizes]
        self.mem_limit = mem_limit
        self.page_pool = page_pool
        self.tenant = tenant
        self.pages_allocated = 0       # pool mode: pages currently owned
        self.free_pages = 0            # reclaimed pages awaiting re-carving
        self.n_rejected = 0
        self.n_evicted = 0
        self.evicted_bytes = 0
        self.n_page_denials = 0
        self.n_reassigned_pages = 0
        self.migration_evictions = 0
        self._total_set = 0
        self._key_class: Dict[str, _SlabClass] = {}  # O(1) get/delete index
        # -- eviction policy + per-item access tracking ----------------------
        self.policy: EvictionPolicy = eviction_policy or ColdestLRU()
        self.hot_window = int(hot_window)        # ops: "recently accessed"
        self.reuse_track_max = int(reuse_track_max)
        self.op_clock = 0                        # set/get/delete event clock
        self.evicted_hot_bytes = 0
        self.reused_after_evict = 0
        self._last_access: Dict[str, int] = {}   # key -> op_clock of touch
        self._evicted_keys: OrderedDict[str, None] = OrderedDict()  # FIFO
        for cls in self.classes:
            self.policy.watch(cls)

    # -- class selection ---------------------------------------------------
    def class_for(self, total_size: int) -> Optional[int]:
        idx = int(np.searchsorted(self.chunk_sizes, total_size, side="left"))
        if idx >= len(self.classes):
            return None
        return idx

    # -- memory management -------------------------------------------------
    def _grab_page(self, cls: _SlabClass) -> bool:
        if self.free_pages:
            self.free_pages -= 1
        elif self.page_pool is not None:
            if not self.page_pool.acquire(self.tenant):
                self.n_page_denials += 1
                return False
            self.pages_allocated += 1
        elif (self.mem_limit is not None
                and (self.pages_allocated + 1) * self.page_size
                > self.mem_limit):
            self.n_page_denials += 1
            return False
        else:
            self.pages_allocated += 1
        cls.pages += 1
        cls.free_chunks += self.page_size // cls.chunk_size
        return True

    # -- eviction bookkeeping ------------------------------------------------
    def set_policy(self, policy: EvictionPolicy) -> None:
        """Swap the eviction policy live. Per-class policy state is
        rebuilt from the current residents (LRU order preserved);
        counters and access history carry over."""
        self.policy = policy
        for cls in self.classes:
            policy.watch(cls)

    def _note_reuse(self, key: str) -> None:
        """The traffic asked for a previously-evicted key — the ground
        truth the predicted eviction costs are judged against."""
        if key in self._evicted_keys:
            del self._evicted_keys[key]
            self.reused_after_evict += 1

    def _track_eviction(self, key: str, vbytes: int) -> None:
        last = self._last_access.pop(key, None)
        if last is not None and self.op_clock - last <= self.hot_window:
            self.evicted_hot_bytes += vbytes
        self._evicted_keys[key] = None
        if len(self._evicted_keys) > self.reuse_track_max:
            self._evicted_keys.popitem(last=False)

    def _evict_item(self, cls: _SlabClass, key: str, *,
                    migration: bool) -> int:
        """Evict one resident of ``cls`` (chosen by the policy), doing
        all index/counter/policy bookkeeping. Returns payload bytes."""
        vbytes = cls.lru.pop(key)
        del self._key_class[key]
        cls.free_chunks += 1
        self._track_eviction(key, vbytes)
        self.policy.on_remove(cls, key)
        if migration:
            self.migration_evictions += 1
        else:
            self.n_evicted += 1
            self.evicted_bytes += vbytes
        return vbytes

    def set(self, key: str, value_size: int) -> bool:
        """Store an item; returns False when rejected (too large)."""
        total = value_size + self.item_overhead
        self._total_set += 1
        self.op_clock += 1
        idx = self.class_for(total)
        if idx is None:
            self.n_rejected += 1
            return False
        self._note_reuse(key)
        cls = self.classes[idx]
        prev = self._key_class.get(key)
        if prev is cls:                         # overwrite in place
            cls.lru.move_to_end(key)
            cls.lru[key] = total
            self._last_access[key] = self.op_clock
            self.policy.on_access(cls, key)
            return True
        if cls.free_chunks == 0 and not self._grab_page(cls):
            if not cls.lru:                     # nothing to evict
                self.n_rejected += 1
                return False
            self._evict_item(cls, self.policy.select_victim(cls),
                             migration=False)
        cls.free_chunks -= 1
        cls.lru[key] = total
        self._key_class[key] = cls
        self._last_access[key] = self.op_clock
        if prev is not None:   # size moved the key to a new class
            del prev.lru[key]
            prev.free_chunks += 1
            self.policy.on_remove(prev, key)
        self.policy.on_insert(cls, key, total)
        return True

    def get(self, key: str) -> bool:
        self.op_clock += 1
        cls = self._key_class.get(key)
        if cls is None:
            self._note_reuse(key)    # a miss on an evicted key: the
            return False             # eviction was a realized mistake
        cls.lru.move_to_end(key)
        self._last_access[key] = self.op_clock
        self.policy.on_access(cls, key)
        return True

    def delete(self, key: str) -> bool:
        cls = self._key_class.pop(key, None)
        if cls is None:
            return False
        del cls.lru[key]
        cls.free_chunks += 1
        self._last_access.pop(key, None)
        self.policy.on_remove(cls, key)
        return True

    # -- live reconfiguration ------------------------------------------------
    def reassign(self, src: int, dst: int) -> int:
        """Move one page from class ``src`` to class ``dst`` (class indexes),
        with memcached ``slabs reassign`` semantics: reclaim the victim
        class's cheapest page (victims chosen by the eviction policy;
        LRU-coldest under the default ``ColdestLRU``) by evicting its
        resident items, then re-carve the page into the recipient's
        chunk size. Returns evicted items.
        """
        if src == dst:
            raise ValueError("src and dst must differ")
        s_cls, d_cls = self.classes[src], self.classes[dst]
        if s_cls.pages == 0:
            raise ValueError(f"class {s_cls.chunk_size} has no pages")
        evicted, _ = self._reclaim_coldest_page(s_cls)
        d_cls.pages += 1
        d_cls.free_chunks += self.page_size // d_cls.chunk_size
        return evicted

    def _reclaim_coldest_page(self, cls: _SlabClass) -> Tuple[int, int]:
        """Reclaim one page from ``cls``: evict the policy's page
        victims until a full page of chunks is free, then un-carve that
        page. (The simulator does not track page membership; "the
        cheapest page" is modelled as the cheapest items beyond the
        free chunks — LRU-oldest under ``ColdestLRU``, lowest-ranked
        under ``RankedPageEviction``.) Returns
        ``(evicted_items, payload_bytes)``.
        """
        per_page = self.page_size // cls.chunk_size
        needed = per_page - cls.free_chunks
        evicted = ebytes = 0
        if needed > 0:
            for victim in self.policy.page_victims(cls, needed):
                ebytes += self._evict_item(cls, victim, migration=True)
                evicted += 1
        cls.free_chunks -= per_page
        cls.pages -= 1
        self.n_reassigned_pages += 1
        return evicted, ebytes

    # -- cross-tenant page surrender (the arbiter's execution primitive) -----
    def _release_cost(self, cls: _SlabClass) -> float:
        """Predicted payload cost if ``cls``'s cheapest page is
        reclaimed now — the eviction policy's
        ``page_reclaim_cost_bytes`` over the residents beyond the free
        chunks (raw bytes under ``ColdestLRU``; re-reference-weighted
        under the cost-aware policies)."""
        per_page = self.page_size // cls.chunk_size
        needed = per_page - cls.free_chunks
        if needed <= 0:
            return 0
        return self.policy.page_reclaim_cost_bytes(cls, needed)

    def _cheapest_release_class(self) -> Optional[_SlabClass]:
        """The class whose coldest page is cheapest to reclaim (None
        when no class holds a page)."""
        candidates = [c for c in self.classes if c.pages]
        if not candidates:
            return None
        return min(candidates, key=self._release_cost)

    def page_release_cost_bytes(self) -> Optional[float]:
        """Predicted eviction cost of :meth:`release_page` right now —
        the donor-side term of the arbiter's transfer cost model, priced
        by the eviction policy (exact payload bytes under ``ColdestLRU``,
        re-reference-weighted under the cost-aware policies). 0 when
        a parked free page can be surrendered without evicting; None
        when the allocator holds no page at all."""
        if self.free_pages:
            return 0
        cls = self._cheapest_release_class()
        return None if cls is None else self._release_cost(cls)

    def release_page(self) -> Tuple[int, int]:
        """Surrender one owned page (to the shared pool when attached).

        Parked free pages go first (no evictions); otherwise the class
        whose coldest page is cheapest to reclaim loses that page with
        ``slabs reassign`` eviction semantics. Returns
        ``(evicted_items, evicted_bytes)``.
        """
        evicted = ebytes = 0
        if self.free_pages:
            self.free_pages -= 1
        else:
            cls = self._cheapest_release_class()
            if cls is None:
                raise ValueError("no page to release")
            evicted, ebytes = self._reclaim_coldest_page(cls)
        self.pages_allocated -= 1
        if self.page_pool is not None:
            self.page_pool.release(self.tenant)
        return evicted, ebytes

    def migration_cost_bytes(self, new_chunk_sizes: Sequence[int]) -> float:
        """Predicted eviction cost of reconfiguring to
        ``new_chunk_sizes`` — the quantity the controller's cost model
        charges against predicted savings. The eviction policy prices
        each vanishing class (``class_teardown_cost_bytes``): under
        ``ColdestLRU`` this is the full resident payload (wholesale
        loss, the conservative legacy model); cost-aware policies
        charge only the bytes likely to be re-referenced."""
        new = {int(c) for c in new_chunk_sizes}
        return sum(self.policy.class_teardown_cost_bytes(cls)
                   for cls in self.classes if cls.chunk_size not in new)

    def reconfigure(self, new_chunk_sizes: Sequence[int]
                    ) -> ReconfigureReport:
        """Retarget the schedule live. Surviving chunk sizes keep their
        pages and resident items; vanished classes evict everything and
        park their pages in the free pool (``pages_allocated`` conserved).
        """
        new_sizes = sorted({int(c) for c in new_chunk_sizes})
        if not new_sizes:
            raise ValueError("need at least one slab class")
        if new_sizes[0] <= 0 or new_sizes[-1] > self.page_size:
            raise ValueError(
                f"chunk sizes must be in (0, {self.page_size}]")
        by_size = {cls.chunk_size: cls for cls in self.classes}
        kept = []
        classes: List[_SlabClass] = []
        for size in new_sizes:
            old = by_size.pop(size, None)
            if old is not None:
                kept.append(size)
                classes.append(old)
            else:
                classes.append(_SlabClass(size))
        evicted_items = 0
        evicted_bytes = 0
        reassigned = 0
        for victim in by_size.values():
            evicted_items += len(victim.lru)
            evicted_bytes += victim.resident_bytes
            for key, vbytes in victim.lru.items():
                del self._key_class[key]
                self._track_eviction(key, vbytes)
            victim.lru.clear()
            self.policy.forget(victim)
            reassigned += victim.pages
            self.free_pages += victim.pages
        self.classes = classes
        self.chunk_sizes = np.asarray(new_sizes, dtype=np.int64)
        self.n_reassigned_pages += reassigned
        self.migration_evictions += evicted_items
        return ReconfigureReport(
            evicted_items=evicted_items, evicted_bytes=evicted_bytes,
            reassigned_pages=reassigned, kept_classes=tuple(kept),
            new_classes=tuple(new_sizes))

    # -- measurement ---------------------------------------------------------
    def referenced_bytes(self, window: int) -> int:
        """Payload bytes of residents touched (set/get) within the last
        ``window`` ops of this allocator's clock — the *useful* half of
        resident payload under re-reference traffic. Resident bytes
        nobody references again are memory holes in every sense that
        matters to an operator; the eviction-policy benchmarks measure
        holes against this instead of raw residency, so a policy cannot
        look good by hoarding dead bytes."""
        cut = self.op_clock - int(window)
        la = self._last_access
        return sum(size for cls in self.classes
                   for key, size in cls.lru.items()
                   if la.get(key, cut) > cut)

    def stats(self) -> SlabStats:
        item_bytes = 0
        allocated = 0
        tail = 0
        per_resident: Dict[int, int] = {}
        per_waste: Dict[int, int] = {}
        n_resident = 0
        for cls in self.classes:
            sizes = cls.lru.values()
            n = len(cls.lru)
            n_resident += n
            b = sum(sizes)
            item_bytes += b
            allocated += n * cls.chunk_size
            tail += cls.pages * (self.page_size % cls.chunk_size)
            per_resident[cls.chunk_size] = n
            per_waste[cls.chunk_size] = n * cls.chunk_size - b
        return SlabStats(
            n_resident=n_resident, n_rejected=self.n_rejected,
            n_evicted=self.n_evicted, pages_allocated=self.pages_allocated,
            item_bytes=item_bytes, allocated_bytes=allocated,
            waste=allocated - item_bytes, page_tail_waste=tail,
            per_class_resident=per_resident, per_class_waste=per_waste,
            n_reassigned_pages=self.n_reassigned_pages,
            migration_evictions=self.migration_evictions,
            evicted_bytes=self.evicted_bytes,
            n_page_denials=self.n_page_denials,
            tenant=self.tenant,
            evicted_hot_bytes=self.evicted_hot_bytes,
            reused_after_evict=self.reused_after_evict,
            eviction_policy=self.policy.name)


def run_workload(chunk_sizes: Sequence[int], sizes: np.ndarray, *,
                 mem_limit: Optional[int] = None,
                 item_overhead: int = 0,
                 page_size: int = PAGE_SIZE) -> SlabStats:
    """Insert ``sizes[i]`` as key ``i`` (unique keys, insert-only — the
    paper's experiment shape) and return final stats."""
    alloc = SlabAllocator(chunk_sizes, mem_limit=mem_limit,
                          page_size=page_size, item_overhead=item_overhead)
    for i, s in enumerate(np.asarray(sizes).tolist()):
        alloc.set(str(i), int(s))
    return alloc.stats()
