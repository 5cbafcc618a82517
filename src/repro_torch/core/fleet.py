"""FleetState — per-tenant arbiter state as stacked arrays.

The legacy :class:`~repro_torch.core.arbiter.TenantArbiter` keeps one Python
object per tenant and loops over all of them every arbitration round:
pressure refresh, forecast surcharges, and donor pricing are each an
O(n_tenants) Python pass, and the drift gate is one device launch per
due tenant. Fine at 4 tenants, dead at 4,000.

This module stacks all of that state into ``[capacity, ...]`` arrays so
every decision stage runs as ONE batched operation over the whole
fleet:

* ownership / quota / floor / denial counters (the
  :class:`~repro_torch.core.arbiter.TenantPages` fields) — int64 rows that
  the shared :class:`~repro_torch.core.arbiter.ResourcePool` reads and
  writes *through* (:class:`_FleetRec` swaps into ``pool._tenants`` as
  an attribute-compatible view, so ``acquire``/``release``/
  ``move_quota``/``equal_partition`` mutate fleet rows transparently),
* pressure-window baselines and the demand-forecast rings
  (:meth:`record_demand` / :meth:`demand_growth` — the batched twins
  of ``DemandForecaster.record_window`` / ``demand_growth``, sharing
  :func:`~repro_torch.core.forecast.acf_period_batch` with the scalar path
  so both are the same bits),
* drift-check cadence mirrors (``since_check`` / ``check_every``) that
  turn the arbiter's per-tick due-scan into one vectorized mask,
* optionally the device observe sketches, one float32 ``[capacity,
  num_buckets]`` tensor on the card with :class:`FleetSketchView`
  giving each tenant's controller a
  :class:`~repro_torch.core.observe.DeviceSizeSketch` whose weight
  vector IS its fleet row (updated in place by the sketch kernel).

Host arrays deliberately stay int64/float64 numpy: the differential
contract of ``TenantArbiter(fleet=True)`` is *bit-identical decisions*
versus the legacy Python loop, and the legacy loop computes in Python
ints and float64 — a float32 device mirror of the pricing stage would
trade that certainty for nothing (the arrays are a few KB; the
O(n_tenants) wins come from replacing Python iteration with vectorized
numpy, and the device wins live where the data already is: the stacked
sketches and the one-launch drift gate in
``repro_torch.kernels.fleet_gate``).

Aliasing: a torch row ``sketch[row]`` is a view, so the sketch kernel
writes a tenant's update straight into the stacked matrix. A view must
therefore never escape as a *value*: :attr:`FleetSketchView.
weights_device` hands out a copy (a controller's drift reference taken
from it stays fixed while the row keeps moving), and the view resolves
its row anew on every access, so a reallocation by :meth:`FleetState.
_grow` never leaves it pointing at the old storage.

Row lifecycle: :meth:`alloc_row` / :meth:`free_row` with a LIFO
free-list, so join/leave chaos reuses rows instead of growing without
bound; a freed row is zeroed everywhere (the "free rows hold zero
mass" invariant ``scenarios.invariants.check_fleet`` enforces).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.forecast import acf_period_batch
import torch

from repro_torch.core.observe import DeviceSizeSketch
from repro_torch.kernels import ops

_QUOTA_NONE = -1          # array sentinel for quota=None (unmanaged)


class _FleetRec:
    """A ``TenantPages``-shaped view over one fleet row.

    Swapped into ``ResourcePool._tenants`` when a tenant joins the
    fleet: every pool operation (acquire/release/set_owned/move_quota/
    equal_partition) keeps mutating plain attributes, and those
    attributes read and write the stacked arrays — one source of truth,
    no sync step. ``quota`` maps ``None`` ↔ the ``-1`` array sentinel.
    """

    __slots__ = ("_fleet", "_row")

    def __init__(self, fleet: "FleetState", row: int):
        object.__setattr__(self, "_fleet", fleet)
        object.__setattr__(self, "_row", row)

    @property
    def owned(self) -> int:
        return int(self._fleet.owned[self._row])

    @owned.setter
    def owned(self, v: int) -> None:
        self._fleet.owned[self._row] = v

    @property
    def quota(self) -> Optional[int]:
        q = int(self._fleet.quota[self._row])
        return None if q == _QUOTA_NONE else q

    @quota.setter
    def quota(self, v: Optional[int]) -> None:
        self._fleet.quota[self._row] = _QUOTA_NONE if v is None else int(v)

    @property
    def floor(self) -> int:
        return int(self._fleet.floor[self._row])

    @floor.setter
    def floor(self, v: int) -> None:
        self._fleet.floor[self._row] = v

    @property
    def n_denied(self) -> int:
        return int(self._fleet.n_denied[self._row])

    @n_denied.setter
    def n_denied(self, v: int) -> None:
        self._fleet.n_denied[self._row] = v


class FleetSketchView(DeviceSizeSketch):
    """A :class:`DeviceSizeSketch` whose weight vector is a fleet row.

    The parent class keeps its state in ``self._weights``; here that
    name is a property resolving ``fleet.sketch[row]`` anew on every
    access (a view of the stacked matrix, valid across
    :meth:`FleetState._grow`), and assigning it copies into the row, so
    every inherited method (observe_many, flush_window, snapshot, drift
    fusion) operates on the stacked ``[capacity, num_buckets]`` fleet
    matrix without knowing it; the sketch kernel's ``out=`` updates the
    row in place. The arbiter's batched drift gate reads the same
    matrix.
    """

    def __init__(self, fleet: "FleetState", row: int, **kwargs):
        # must exist before super().__init__ assigns self._weights
        self._fleet = fleet
        self._row = int(row)
        if fleet.sketch is None:
            raise ValueError("call FleetState.ensure_sketch first")
        super().__init__(**kwargs)
        if fleet.sketch.shape[1] != self.num_buckets:
            raise ValueError(
                f"fleet sketch grid has {fleet.sketch.shape[1]} buckets, "
                f"view wants {self.num_buckets}")

    @property
    def _weights(self) -> torch.Tensor:
        return self._fleet.sketch[self._row]

    @_weights.setter
    def _weights(self, value: torch.Tensor) -> None:
        row = self._fleet.sketch[self._row]
        if value.data_ptr() != row.data_ptr():
            row.copy_(value)

    @property
    def weights_device(self) -> torch.Tensor:
        """A copy of the row (on device, no sync), flushed first. Later
        updates write into the row in place, so handing out the row view
        itself would let a held reference (the controller's drift
        reference) move with the live sketch."""
        self.flush_window()
        return self._weights.clone()


class FleetState:
    """Stacked per-tenant arbiter state with a row free-list.

    Created by ``TenantArbiter(fleet=True)``; not normally constructed
    directly. ``forecaster`` (a ``DemandForecaster`` or None) supplies
    the ring geometry and periodicity thresholds for the stacked
    demand rings.
    """

    def __init__(self, *, capacity: int = 8, forecaster=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        fc_on = bool(getattr(forecaster, "active", False))
        self.ring = int(forecaster.ring) if fc_on else 0
        self._min_cycles = float(forecaster.min_cycles) if fc_on else 2.0
        self._min_confidence = (float(forecaster.min_confidence)
                                if fc_on else 0.1)
        c = self.capacity
        # -- pool-record fields (mutated through _FleetRec views) -----------
        self.owned = np.zeros(c, dtype=np.int64)
        self.quota = np.full(c, _QUOTA_NONE, dtype=np.int64)
        self.floor = np.zeros(c, dtype=np.int64)
        self.n_denied = np.zeros(c, dtype=np.int64)
        # -- pressure-window state ------------------------------------------
        self.evicted0 = np.zeros(c, dtype=np.int64)
        self.denials0 = np.zeros(c, dtype=np.int64)
        self.pressure = np.zeros(c, dtype=np.float64)
        self.window_demand = np.zeros(c, dtype=np.float64)
        self.last_donated = np.full(c, -1, dtype=np.int64)
        # -- drift-check cadence mirror -------------------------------------
        self.since_check = np.zeros(c, dtype=np.int64)
        self.check_every = np.zeros(c, dtype=np.int64)
        # -- forecast demand rings (left-aligned valid prefix per row) ------
        self.demand_ring = np.zeros((c, self.ring), dtype=np.float64)
        self.ring_len = np.zeros(c, dtype=np.int64)
        # -- row bookkeeping -------------------------------------------------
        self.active = np.zeros(c, dtype=bool)
        self.row_of: Dict[str, int] = {}
        self.name_of: List[Optional[str]] = [None] * c
        self._free: List[int] = []            # LIFO reuse
        self._next = 0                        # high-water mark
        # -- stacked device sketches (lazy; torch [capacity, buckets]) ------
        self.sketch: Optional[torch.Tensor] = None
        self.sketch_buckets: Optional[int] = None

    # -- rows ----------------------------------------------------------------
    @property
    def n_active(self) -> int:
        return int(self.active.sum())

    def _grow(self, new_cap: int) -> None:
        old = self.capacity
        self.capacity = new_cap

        def widen(a, fill=0):
            out = np.full(new_cap, fill, dtype=a.dtype)
            out[:old] = a
            return out

        self.owned = widen(self.owned)
        self.quota = widen(self.quota, _QUOTA_NONE)
        self.floor = widen(self.floor)
        self.n_denied = widen(self.n_denied)
        self.evicted0 = widen(self.evicted0)
        self.denials0 = widen(self.denials0)
        self.pressure = widen(self.pressure)
        self.window_demand = widen(self.window_demand)
        self.last_donated = widen(self.last_donated, -1)
        self.since_check = widen(self.since_check)
        self.check_every = widen(self.check_every)
        self.active = widen(self.active)
        ring = np.zeros((new_cap, self.ring), dtype=np.float64)
        ring[:old] = self.demand_ring
        self.demand_ring = ring
        self.ring_len = widen(self.ring_len)
        self.name_of.extend([None] * (new_cap - old))
        if self.sketch is not None:
            grown = self.sketch.new_zeros((new_cap, self.sketch.shape[1]))
            grown[:old] = self.sketch
            self.sketch = grown

    def alloc_row(self, name: str) -> int:
        if name in self.row_of:
            raise ValueError(f"tenant {name!r} already has a fleet row")
        if self._free:
            row = self._free.pop()
        else:
            if self._next >= self.capacity:
                self._grow(2 * self.capacity)
            row = self._next
            self._next += 1
        self.active[row] = True
        self.row_of[name] = row
        self.name_of[row] = name
        return row

    def free_row(self, name: str) -> None:
        """Release a tenant's row: zero every field (the free-rows-hold-
        zero-mass invariant) and push it on the free-list for reuse."""
        row = self.row_of.pop(name)
        self.name_of[row] = None
        self.active[row] = False
        self.owned[row] = 0
        self.quota[row] = _QUOTA_NONE
        self.floor[row] = 0
        self.n_denied[row] = 0
        self.evicted0[row] = 0
        self.denials0[row] = 0
        self.pressure[row] = 0.0
        self.window_demand[row] = 0.0
        self.last_donated[row] = -1
        self.since_check[row] = 0
        self.check_every[row] = 0
        self.demand_ring[row] = 0.0
        self.ring_len[row] = 0
        if self.sketch is not None:
            self.sketch[row].zero_()
        self._free.append(row)

    # -- pool integration ----------------------------------------------------
    def adopt_pool_record(self, pool, name: str) -> None:
        """Copy the tenant's existing ``TenantPages`` record into its
        fleet row and swap a :class:`_FleetRec` view into the pool —
        from here on the pool mutates the stacked arrays directly.
        (The allocator registers itself with the pool before the
        arbiter runs, so the record may already carry owned pages.)"""
        row = self.row_of[name]
        rec = pool._tenants[name]
        self.owned[row] = rec.owned
        self.quota[row] = _QUOTA_NONE if rec.quota is None else rec.quota
        self.floor[row] = rec.floor
        self.n_denied[row] = rec.n_denied
        pool._tenants[name] = _FleetRec(self, row)

    # -- stacked sketches ----------------------------------------------------
    def ensure_sketch(self, num_buckets: int, torch_device="cuda") -> None:
        """Allocate the stacked ``[capacity, num_buckets]`` float32
        sketch matrix on ``torch_device`` (once; later calls check the
        grid)."""
        if self.sketch is None:
            self.sketch_buckets = int(num_buckets)
            self.sketch = torch.zeros(
                (self.capacity, self.sketch_buckets), dtype=torch.float32,
                device=ops.resolve_device(torch_device))
        elif self.sketch_buckets != int(num_buckets):
            raise ValueError(
                f"fleet sketch grid is {self.sketch_buckets} buckets; "
                f"cannot add a {num_buckets}-bucket tenant")

    def sketch_view(self, row: int, config) -> FleetSketchView:
        """A device sketch for ``row`` configured exactly as
        ``SlabController`` would configure its own, but stacked."""
        from repro_torch.core.controller import device_sketch_kwargs
        kwargs = device_sketch_kwargs(config)
        self.ensure_sketch(kwargs["num_buckets"], kwargs["torch_device"])
        return FleetSketchView(self, row, **kwargs)

    # -- batched forecast ring ----------------------------------------------
    def record_demand(self, rows: np.ndarray, values: np.ndarray) -> None:
        """Push one demand window per row — the batched twin of
        ``DemandForecaster.record_window`` (demand scalar only; the
        arbiter never records histograms)."""
        if self.ring == 0:
            return
        rows = np.asarray(rows, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        lens = self.ring_len[rows]
        full = lens >= self.ring
        fr = rows[full]
        if fr.size:
            self.demand_ring[fr, :-1] = self.demand_ring[fr, 1:]
            self.demand_ring[fr, -1] = values[full]
        nr = rows[~full]
        if nr.size:
            self.demand_ring[nr, lens[~full]] = values[~full]
            self.ring_len[nr] = lens[~full] + 1

    def demand_growth(self, rows: np.ndarray, horizon: int = 1
                      ) -> "tuple[np.ndarray, np.ndarray]":
        """(growth bytes, confidence) per row — the batched twin of
        ``DemandForecaster.demand_growth``, decision-identical because
        the periodicity detector IS the scalar one
        (:func:`acf_period_batch`) and the seasonal-naive source index
        replicates ``predict`` exactly (no period / horizon past the
        period / source before the ring ⇒ (0, 0))."""
        if horizon < 1:
            raise ValueError(f"horizon must be >= 1, got {horizon}")
        rows = np.asarray(rows, dtype=np.int64)
        n = rows.size
        growth = np.zeros(n, dtype=np.float64)
        conf = np.zeros(n, dtype=np.float64)
        if self.ring == 0 or n == 0:
            return growth, conf
        lens = self.ring_len[rows]
        series = self.demand_ring[rows]
        lags, confs = acf_period_batch(
            series, lens, min_cycles=self._min_cycles,
            min_confidence=self._min_confidence)
        src = lens - 1 + horizon - lags
        ok = (lags >= 0) & (horizon <= lags) & (src >= 0)
        idx = np.nonzero(ok)[0]
        if idx.size:
            growth[idx] = (series[idx, src[idx]]
                           - series[idx, lens[idx] - 1])
            conf[idx] = confs[idx]
        return growth, conf
