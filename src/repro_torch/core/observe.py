"""Streaming observation of item sizes — the first half of the paper's loop.

The paper's technique is *analyse the sizes of items previously entered,
then re-configure the slab classes*. Everything downstream (the waste
objective, the optimizers, `SlabPolicy`) consumes a `(support, freqs)`
histogram; this module produces that histogram **online** from a stream
of sizes, with exponential decay so the estimate tracks drifting traffic
instead of averaging over the whole past.

`DecayedSizeHistogram` is an exponentially-decayed sparse histogram with
O(1) amortized updates (lazy per-bin decay: each bin stores the step at
which it was last touched and is brought forward only when re-observed,
pruned, or snapshotted). `snapshot()` returns the same `(support, freqs)`
int64 pair as `repro_torch.core.distribution.size_histogram`, so every consumer
of the offline histogram works unchanged on the live sketch.

`DeviceSizeSketch` is the device-resident sibling: a dense
exponentially-decayed bucket histogram living in accelerator memory,
updated one whole batch (or one whole observe window) of sizes per
launch of the ``sketch_window`` CUDA kernel (see
``repro_torch.kernels.sketch_update``). Its ``observe_many``/``snapshot``
API matches the host sketch, but nothing crosses the device→host
boundary until ``snapshot()``/``snapshot_weights()`` is actually called
— both classes count those materializations in ``n_host_syncs`` so the
benchmarks can compare sync traffic. ``histogram_distance_device`` is
the matching on-device drift metric over two dense weight vectors, so
the controller's drift gate runs without materializing the sketch.

`histogram_distance` is the drift signal: normalized L1 (total variation)
or earth-mover's distance between two histograms over their shared
support, both in [0, 1]. The controller compares the live sketch against
the fitting-time reference histogram to decide when the schedule is
stale.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.guards import deliberate_sync
from repro_torch.analysis.registry import hot_path
from repro_torch.kernels import ops
from repro_torch.kernels.sketch_update import bucketize


class DecayedSizeHistogram:
    """Exponentially-decayed sparse size histogram, O(1) per observation.

    ``half_life`` is measured in *observations*: after ``half_life``
    further observations, a sample's weight has halved. ``half_life=None``
    disables decay — the sketch then reproduces ``size_histogram`` of the
    full stream exactly (used by consumers that want the legacy
    every-item-counts behaviour and by round-trip tests).
    """

    def __init__(self, *, half_life: Optional[float] = None,
                 max_bins: int = 1 << 14):
        if half_life is not None and half_life <= 0:
            raise ValueError(f"half_life must be positive, got {half_life}")
        if max_bins < 2:
            raise ValueError("max_bins must be >= 2")
        self.half_life = half_life
        self.max_bins = max_bins
        self._decay = 0.5 ** (1.0 / half_life) if half_life else 1.0
        self._w: Dict[int, float] = {}       # size -> weight at step _last[s]
        self._last: Dict[int, int] = {}      # size -> step of last update
        self._t = 0                          # observation clock
        self.n_observed = 0                  # lifetime count (undecayed)
        self._total = 0.0                    # decayed total weight
        self.n_host_syncs = 0                # snapshot materializations
        self.n_dispatches = 0                # device launches (host: none)

    # -- updates -----------------------------------------------------------
    @hot_path
    def observe(self, size: int, weight: float = 1.0) -> None:
        """Record one size. O(1); decay of other bins is lazy."""
        s = int(size)
        if s < 0:
            raise ValueError(f"size must be non-negative, got {s}")
        self._t += 1
        self.n_observed += 1
        w = self._w.get(s)
        if w is not None:
            self._total = self._total * self._decay + weight
            self._w[s] = w * self._decay ** (self._t - self._last[s]) + weight
        else:
            if len(self._w) >= self.max_bins:
                # _prune syncs the kept bins to the (already stepped)
                # clock and rebuilds _total from them, so only the new
                # item's weight remains to be added.
                self._prune()
                self._total += weight
            else:
                self._total = self._total * self._decay + weight
            self._w[s] = weight
        self._last[s] = self._t

    @hot_path
    def observe_many(self, sizes, weights=None) -> None:
        """Record a batch of sizes, optionally with per-item weights
        (scalar or array-like broadcast against ``sizes``)."""
        sizes = np.asarray(sizes).ravel()
        if weights is None:
            for s in sizes.tolist():
                self.observe(int(s))
            return
        w = np.broadcast_to(np.asarray(weights, dtype=np.float64),
                            sizes.shape).ravel()
        for s, wi in zip(sizes.tolist(), w.tolist()):
            self.observe(int(s), wi)

    # -- views -------------------------------------------------------------
    @property
    def effective_count(self) -> float:
        """Decayed total mass (== n_observed when decay is disabled)."""
        return self._total

    def _synced_weights(self) -> Dict[int, float]:
        """All bins decayed forward to the current step."""
        if self._decay == 1.0:
            return dict(self._w)
        return {s: w * self._decay ** (self._t - self._last[s])
                for s, w in self._w.items()}

    def _prune(self) -> None:
        """Drop the lightest ~10% of bins (called when max_bins is hit)."""
        synced = self._synced_weights()
        keep = sorted(synced, key=synced.__getitem__, reverse=True)
        keep = keep[:max(1, int(self.max_bins * 0.9))]
        t = self._t
        self._w = {s: synced[s] for s in keep if synced[s] > 0.0}
        self._last = {s: t for s in self._w}
        # Dropped bins take their decayed mass with them: recompute the
        # running total from the kept (synced) bins so effective_count
        # never overstates the live mass after a prune.
        self._total = float(sum(self._w.values()))

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(support, freqs)`` int64, compatible with ``size_histogram``.

        Weights are rounded to the nearest integer; bins whose decayed
        weight rounds to zero are dropped (they no longer represent
        current traffic). With decay disabled this is bit-exact with
        ``size_histogram`` over every observed size.
        """
        self.n_host_syncs += 1
        synced = self._synced_weights()
        if not synced:
            return (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64))
        support = np.asarray(sorted(synced), dtype=np.int64)
        freqs = np.rint([synced[int(s)] for s in support]).astype(np.int64)
        keep = freqs > 0
        return support[keep], freqs[keep]

    def snapshot_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """Float-weight variant of :meth:`snapshot` (no rounding) — the
        drift metric uses this to avoid quantization noise."""
        self.n_host_syncs += 1
        synced = self._synced_weights()
        if not synced:
            return (np.zeros(0, dtype=np.int64),
                    np.zeros(0, dtype=np.float64))
        support = np.asarray(sorted(synced), dtype=np.int64)
        w = np.asarray([synced[int(s)] for s in support], dtype=np.float64)
        keep = w > 0.0
        return support[keep], w[keep]

    def reset(self) -> None:
        self._w.clear()
        self._last.clear()
        self._t = 0
        self.n_observed = 0
        self._total = 0.0
        self.n_host_syncs = 0
        self.n_dispatches = 0


class DeviceSizeSketch:
    """Device-resident exponentially-decayed size histogram.

    The same observe/snapshot contract as :class:`DecayedSizeHistogram`,
    but the state is a dense ``(num_buckets,)`` float32 weight tensor on
    ``torch_device``, updated one whole batch (or, with ``window=True``,
    one whole cadence window of batches) per launch of the
    ``sketch_window`` CUDA kernel (the plain PyTorch version on the CPU).
    Sizes are bucketed on a fixed grid: size ``s`` lands in bucket
    ``ceil(s / bucket_width) - 1``, whose representative size is
    ``(bucket + 1) * bucket_width`` — the bucket's inclusive upper edge,
    so the representative always covers the item (the direction slab
    fitting needs). With ``bucket_width=1`` and sizes in
    ``[1, num_buckets]`` the sketch is bit-comparable to the host dict
    (size 0, which the host records verbatim, coarsens into the first
    bucket's representative here). Sizes beyond the grid clamp into the
    top bucket (size the grid to the workload).

    Nothing crosses the device→host boundary until ``snapshot()`` /
    ``snapshot_weights()`` is called; those materializations are counted
    in ``n_host_syncs`` (scalar readbacks like ``effective_count`` and
    the controller's drift gate count in ``n_scalar_syncs``). The drift
    metric consumes :attr:`weights_device` directly via
    :func:`histogram_distance_device`, keeping the whole
    observe → drift loop on device.

    Updates are in place, except while a caller holds the current state
    (:attr:`weights_device` was handed out, e.g. as the controller's
    drift reference): the next launch then writes a fresh tensor, so a
    held reference never changes.
    """

    def __init__(self, *, half_life: Optional[float] = None,
                 num_buckets: int = 1 << 13, bucket_width: int = 1,
                 window: bool = False, max_pending_batches: int = 512,
                 torch_device="cuda"):
        if half_life is not None and half_life <= 0:
            raise ValueError(f"half_life must be positive, got {half_life}")
        if num_buckets < 2:
            raise ValueError("num_buckets must be >= 2")
        if bucket_width < 1:
            raise ValueError("bucket_width must be >= 1")
        self.torch_device = ops.resolve_device(torch_device)
        self.half_life = half_life
        self.num_buckets = num_buckets
        self.bucket_width = bucket_width
        self._decay = 0.5 ** (1.0 / half_life) if half_life else 1.0
        # window=True turns observe_many into an accumulator: batches
        # buffer on host (raw, untouched) and fold into the sketch in
        # ONE launch at flush_window() — or transparently, the moment
        # any state view is read.
        self._window = bool(window)
        self._max_pending = int(max_pending_batches)
        self._pending: list = []    # [(sizes_row, weights_row|None, n), ...]
        self._escaped = False       # a weights_device ref is held outside
        self._weights = torch.zeros(num_buckets, dtype=torch.float32,
                                    device=self.torch_device)
        self.n_observed = 0                  # lifetime count (undecayed)
        self.n_dispatches = 0                # sketch kernel launches
        self.n_host_syncs = 0                # full materializations
        self.n_scalar_syncs = 0              # few-byte scalar readbacks

    # -- updates -----------------------------------------------------------
    def bucket_of(self, sizes) -> torch.Tensor:
        """Bucket ids for an array of sizes (on the sketch's device).

        Size 0 coarsens into the first bucket (representative
        ``bucket_width``) exactly like any other in-bucket size rounds
        up to its representative. Negative sizes map to -1, which the
        update ignores: the host sketch raises on them, but raising here
        would need a device→host readback, so invalid items are dropped
        instead — validate upstream. (They still tick the decay clock
        and ``n_observed``, like any batch item.)
        """
        s = torch.as_tensor(sizes, device=self.torch_device).reshape(-1)
        return bucketize(s, self.bucket_width, self.num_buckets)

    @hot_path(counters=("n_dispatches", "n_scalar_syncs"))
    def observe(self, size: int, weight: float = 1.0) -> None:
        """Record one size (a one-element batch; prefer observe_many)."""
        self.observe_many([int(size)], [float(weight)])

    def _normalize_batch(self, sizes, weights):
        """``(sizes_row, weights_row|None, n)`` with host arrays kept on
        host (stacking them costs one transfer at launch) and device
        tensors left on device."""
        if not isinstance(sizes, torch.Tensor):
            sizes = np.asarray(sizes)
        sizes = sizes.reshape(-1)
        n = int(sizes.shape[0])
        if weights is not None:
            if isinstance(weights, (int, float)):
                weights = np.full(n, weights, dtype=np.float32)
            elif not isinstance(weights, torch.Tensor):
                weights = np.asarray(weights, dtype=np.float32)
        return sizes, weights, n

    @hot_path(counters=("n_dispatches",))
    def observe_many(self, sizes, weights=None) -> None:
        """Record a batch of sizes — ONE kernel launch (or zero, in
        window mode, where batches buffer until ``flush_window``).

        ``sizes`` may be a host array or a device tensor straight out of
        a serve step — either way nothing is pulled back to host, and
        bucketization happens in the kernel (the host hands over raw
        sizes). Each item i of an n-item batch is folded in with
        ``decay**(n-1-i)``, matching n sequential host observations.
        """
        row = self._normalize_batch(sizes, weights)
        if row[2] == 0:
            return
        self.n_observed += row[2]
        if self._window:
            self._pending.append(row)
            if len(self._pending) >= self._max_pending:
                self.flush_window()     # bound host memory, not a sync
            return
        self._launch([row])

    @hot_path(counters=("n_dispatches",))
    def observe_window(self, sizes_chunk, weights_chunk=None, *,
                       reference=None, metric: str = "l1"):
        """Fold a whole chunk of observe batches in ONE launch.

        ``sizes_chunk`` is a sequence of batches (ragged is fine) or a
        2-D ``[n_batches, batch]`` array; ``weights_chunk`` optionally
        matches its shape. Bit-equivalent to calling ``observe_many``
        per batch. Returns the drift of the post-window state against
        ``reference`` as a 0-d device tensor (no host sync) when a
        reference is supplied, else ``None``. Any batches buffered in
        window mode are folded into the same launch first.
        """
        rows = self._pending
        self._pending = []
        for i, batch in enumerate(sizes_chunk):
            w = None if weights_chunk is None else weights_chunk[i]
            row = self._normalize_batch(batch, w)
            if row[2]:
                self.n_observed += row[2]
                rows.append(row)
        if not rows:
            return None
        return self._launch(rows, reference=reference, metric=metric)

    @hot_path(counters=("n_dispatches",))
    def flush_window(self, *, reference=None, metric: str = "l1"):
        """Fold every buffered batch into the sketch in one launch.

        Returns the drift vs ``reference`` as a 0-d device tensor when a
        reference is given, else ``None``; no-op when nothing is
        pending. Reading any state view (``weights_device``,
        ``snapshot*``, ``effective_count``) flushes implicitly, so
        buffering is invisible to consumers of the sketch.
        """
        if not self._pending:
            return None
        rows, self._pending = self._pending, []
        return self._launch(rows, reference=reference, metric=metric)

    def _stacked(self, rows):
        """Stack rows into ``(sizes2d, weights2d, lengths, decay_totals)``
        on the sketch's device, right-padded to the longest row (dead
        positions are exact no-ops in the kernel). Per-row ``decay ** n``
        is computed here, in host float64, and then cast to float32, so
        the window path rounds exactly like the per-batch path."""
        dev = self.torch_device
        lens = [n for (_, _, n) in rows]
        b, nmax = len(rows), max(lens)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        decay_totals = torch.tensor(
            np.asarray([self._decay ** n for n in lens], dtype=np.float32),
            device=dev)
        if any(isinstance(s, torch.Tensor) or isinstance(w, torch.Tensor)
               for (s, w, _) in rows):
            sizes2d = torch.zeros((b, nmax), dtype=torch.int32, device=dev)
            weights2d = torch.ones((b, nmax), dtype=torch.float32,
                                   device=dev)
            for i, (s, w, n) in enumerate(rows):
                sizes2d[i, :n] = torch.as_tensor(s, device=dev)
                if w is not None:
                    weights2d[i, :n] = torch.as_tensor(w, device=dev)
            return sizes2d, weights2d, lengths, decay_totals
        sizes2d = np.zeros((b, nmax), dtype=np.int32)
        weights2d = np.ones((b, nmax), dtype=np.float32)
        for i, (s, w, n) in enumerate(rows):
            sizes2d[i, :n] = s
            if w is not None:
                weights2d[i, :n] = np.broadcast_to(w, (n,))
        return (torch.from_numpy(sizes2d).to(dev),
                torch.from_numpy(weights2d).to(dev), lengths, decay_totals)

    def _launch(self, rows, *, reference=None, metric: str = "l1"):
        """One launch folding ``rows`` into the sketch; returns the drift
        device scalar when ``reference`` is given."""
        sizes2d, weights2d, lengths, decay_totals = self._stacked(rows)
        out = None if self._escaped else self._weights
        self._weights = ops.sketch_window(
            self._weights, sizes2d, weights2d, lengths, self._decay,
            decay_totals, bucket_width=self.bucket_width, out=out)
        self._escaped = False
        self.n_dispatches += 1
        if reference is None:
            return None
        return histogram_distance_device(reference, self._weights,
                                         metric=metric)

    # -- views -------------------------------------------------------------
    @property
    def weights_device(self) -> torch.Tensor:
        """The dense per-bucket weight tensor (on device, no sync).

        Flushes any buffered window first, and marks the tensor as
        escaped: the next launch will not update in place a tensor the
        caller may still be holding."""
        self.flush_window()
        self._escaped = True
        return self._weights

    @property
    def support_device(self) -> torch.Tensor:
        """Representative sizes of every bucket (device tensor)."""
        return ((torch.arange(self.num_buckets, dtype=torch.int32,
                              device=self.torch_device) + 1)
                * self.bucket_width)

    @property
    def effective_count(self) -> float:
        """Decayed total mass (scalar readback, not a materialization)."""
        self.flush_window()
        self.n_scalar_syncs += 1
        with deliberate_sync("DeviceSizeSketch.effective_count"):
            return float(self._weights.sum())

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(support, freqs)`` int64 — THE device→host sync point."""
        self.flush_window()
        self.n_host_syncs += 1
        with deliberate_sync("DeviceSizeSketch.snapshot"):
            w = self._weights.cpu().numpy()
        freqs = np.rint(w).astype(np.int64)
        keep = freqs > 0
        support = (np.nonzero(keep)[0].astype(np.int64) + 1) \
            * self.bucket_width
        return support, freqs[keep]

    def snapshot_weights(self) -> Tuple[np.ndarray, np.ndarray]:
        """Float-weight variant of :meth:`snapshot` (no rounding)."""
        self.flush_window()
        self.n_host_syncs += 1
        with deliberate_sync("DeviceSizeSketch.snapshot_weights"):
            w = self._weights.cpu().numpy().astype(np.float64)
        keep = w > 0.0
        support = (np.nonzero(keep)[0].astype(np.int64) + 1) \
            * self.bucket_width
        return support, w[keep]

    def reset(self) -> None:
        self._weights = torch.zeros(self.num_buckets, dtype=torch.float32,
                                    device=self.torch_device)
        self._pending = []
        self._escaped = False
        self.n_observed = 0
        self.n_dispatches = 0
        self.n_host_syncs = 0
        self.n_scalar_syncs = 0


def _aligned(a: Tuple[np.ndarray, np.ndarray],
             b: Tuple[np.ndarray, np.ndarray]
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    sa, fa = a
    sb, fb = b
    sa = np.asarray(sa, dtype=np.int64)
    sb = np.asarray(sb, dtype=np.int64)
    support = np.union1d(sa, sb)
    pa = np.zeros(len(support), dtype=np.float64)
    pb = np.zeros(len(support), dtype=np.float64)
    pa[np.searchsorted(support, sa)] = np.asarray(fa, dtype=np.float64)
    pb[np.searchsorted(support, sb)] = np.asarray(fb, dtype=np.float64)
    return support, pa, pb


def _dense_distance(wa: torch.Tensor, wb: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """Distance between dense weight tensors on one bucket grid, reduced
    over the last axis: two ``(buckets,)`` vectors give a 0-d float32
    tensor, two ``[n, buckets]`` stacks give ``(n,)`` (the fleet gate),
    on their device with no host sync.

    The sums run in float64 and the result is rounded to float32 once:
    the card reduces a lone vector and the rows of a stack in different
    orders, and float32 sums would then differ in the last bit between a
    tenant's solo gate and the fleet gate. In float64 those differences
    vanish in the final rounding, so both gates give the same float32
    drift."""
    wa = wa.to(torch.float64)
    wb = wb.to(torch.float64)
    ta = wa.sum(dim=-1, keepdim=True)
    tb = wb.sum(dim=-1, keepdim=True)
    pa = wa / torch.clamp(ta, min=1e-30)
    pb = wb / torch.clamp(tb, min=1e-30)
    if metric == "l1":
        d = 0.5 * (pa - pb).abs().sum(dim=-1)
    else:
        # emd on a uniform bucket grid: the bucket width cancels, and
        # the host metric's span is the occupied extent (empty edge
        # buckets contribute zero cdf gap, so only the denominator
        # needs the occupied first/last bucket).
        occupied = ((wa > 0) | (wb > 0)).to(torch.uint8)
        first = torch.argmax(occupied, dim=-1)
        last = wa.shape[-1] - 1 - torch.argmax(occupied.flip(-1), dim=-1)
        cdf_gap = torch.cumsum(pa - pb, dim=-1).abs()[..., :-1]
        d = cdf_gap.sum(dim=-1) / torch.clamp(last - first, min=1)
    # empty-vs-empty is 0, empty-vs-mass is 1 (host semantics)
    ta, tb = ta.squeeze(-1), tb.squeeze(-1)
    both = (ta > 0) & (tb > 0)
    return torch.where(both, d, (ta != tb).to(torch.float64)).to(
        torch.float32)


def histogram_distance_device(wa: torch.Tensor, wb: torch.Tensor, *,
                              metric: str = "l1") -> torch.Tensor:
    """On-device drift: distance in [0, 1] between two DENSE per-bucket
    weight tensors on the same grid (e.g. two
    :attr:`DeviceSizeSketch.weights_device` states). Returns a 0-d
    tensor — nothing is materialized on host until the caller reads the
    scalar. Same semantics as :func:`histogram_distance` over the
    bucket-representative support.
    """
    if metric not in ("l1", "emd"):
        raise ValueError(f"unknown metric {metric!r}")
    return _dense_distance(wa, wb, metric)


def histogram_distance(a, b, *, metric: str = "l1") -> float:
    """Distance in [0, 1] between two ``(support, freqs)`` histograms.

    ``"l1"``  — total variation: ``0.5 * sum |p - q|`` of the normalized
    mass functions over the union support. Insensitive to *how far* mass
    moved; cheap and scale-free.
    ``"emd"`` — earth-mover's (Wasserstein-1) distance of the normalized
    distributions, divided by the span of the union support, so shifting
    all mass from one end to the other scores 1.
    """
    support, pa, pb = _aligned(a, b)
    if support.size == 0:
        return 0.0
    ta, tb = pa.sum(), pb.sum()
    if ta <= 0 or tb <= 0:
        return 0.0 if ta == tb else 1.0
    pa = pa / ta
    pb = pb / tb
    if metric == "l1":
        return float(0.5 * np.abs(pa - pb).sum())
    if metric == "emd":
        if support.size == 1:
            return 0.0
        span = float(support[-1] - support[0])
        cdf_gap = np.abs(np.cumsum(pa - pb))[:-1]
        gaps = np.diff(support).astype(np.float64)
        return float(np.sum(cdf_gap * gaps) / span)
    raise ValueError(f"unknown metric {metric!r}")
