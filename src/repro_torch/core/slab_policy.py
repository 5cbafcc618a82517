"""SlabPolicy — the public API for learning slab-class schedules.

This is the paper's contribution packaged as a composable component:
feed it an observed allocation-size histogram, get back a schedule that
minimizes internal fragmentation. Consumers in this framework:

* ``repro_torch.memcached`` — the paper's own testbed (byte-sized items),
* the controller (``repro_torch.core.controller``), which refits online.

The random searches draw from one ``torch.Generator`` per policy, seeded
by ``seed`` on ``torch_device``; ``"dp"`` and ``"parallel"`` draw nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

import numpy as np
import torch

from repro_torch.core import hillclimb
from repro_torch.core.anneal import anneal as _anneal_fn
from repro_torch.core.dp_optimal import dp_optimal as _dp_optimal_fn
from repro_torch.core.distribution import PAGE_SIZE, size_histogram
from repro_torch.core.waste import (default_waste_fraction, utilization_exact,
                                    waste_exact)
from repro_torch.kernels import ops

Method = Literal["dp", "hillclimb", "parallel", "multi_restart", "anneal"]


def default_memcached_schedule(*, growth_factor: float = 1.25,
                               min_chunk: int = 96,
                               page_size: int = PAGE_SIZE,
                               align: int = 8) -> np.ndarray:
    """Memcached's default geometric schedule (96B * 1.25^n, 8B aligned).

    Reproduces the stock class sizes the paper's "old configurations" are
    drawn from: ... 304, 384, 480, 600, 752, 944, 1184, 1480, 1856, ...
    """
    sizes = []
    size = min_chunk
    while size <= page_size / 2:
        sizes.append(size)
        nxt = int(np.ceil(size * growth_factor))
        if nxt % align:
            nxt += align - nxt % align
        size = max(nxt, size + align)
    sizes.append(page_size)
    return np.asarray(sizes, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class SlabSchedule:
    """A learned (or default) slab-class schedule plus its provenance."""

    chunk_sizes: np.ndarray       # sorted, distinct, int64
    waste: int                    # exact waste on the fitting histogram
    baseline_waste: int           # waste of the baseline schedule
    baseline_chunks: np.ndarray
    method: str
    waste_fraction: float         # waste / total item bytes
    utilization: float            # item bytes / allocated bytes

    @property
    def recovered_frac(self) -> float:
        if self.baseline_waste == 0:
            return 0.0
        return 1.0 - self.waste / self.baseline_waste

    def assign(self, sizes) -> np.ndarray:
        """Class index for each size (== len(chunk_sizes) -> unstorable)."""
        return np.searchsorted(self.chunk_sizes,
                               np.asarray(sizes, dtype=np.int64),
                               side="left")

    def chunk_for(self, sizes) -> np.ndarray:
        idx = self.assign(sizes)
        idx = np.minimum(idx, len(self.chunk_sizes) - 1)
        return self.chunk_sizes[idx]


class SlabPolicy:
    """Learns slab-class schedules from observed allocation sizes."""

    def __init__(self, *, page_size: int = PAGE_SIZE,
                 min_chunk: int = hillclimb.MIN_CHUNK, seed: int = 0,
                 torch_device="cuda"):
        self.page_size = page_size
        self.min_chunk = min_chunk
        self.torch_device = ops.resolve_device(torch_device)
        self._generator = torch.Generator(device=self.torch_device)
        self._generator.manual_seed(seed)

    def fit_sizes(self, sizes: Sequence[int], k: int, *,
                  method: Method = "dp", baseline=None,
                  **kwargs) -> SlabSchedule:
        support, freqs = size_histogram(np.asarray(sizes))
        return self.fit(support, freqs, k, method=method,
                        baseline=baseline, **kwargs)

    def fit(self, support, freqs, k: int, *, method: Method = "dp",
            baseline=None, **kwargs) -> SlabSchedule:
        """Learn a schedule of at most ``k`` classes for the histogram.

        ``baseline`` defaults to the stock geometric classes that cover the
        support (exactly the paper's "old configuration"); it both seeds the
        non-DP searches and anchors ``recovered_frac``.
        """
        support = np.asarray(support, dtype=np.int64)
        freqs = np.asarray(freqs, dtype=np.int64)
        if baseline is None:
            baseline = covering_default_classes(support, k=k,
                                                page_size=self.page_size)
        baseline = np.asarray(baseline, dtype=np.int64)
        init = baseline
        if len(init) != k:  # searches need exactly k movable classes
            init = _pad_or_trim(init, k, support)

        if method == "dp":
            res = _dp_optimal_fn(support, freqs, k)
            chunks, steps = res.chunks, 0
        elif method == "hillclimb":
            r = hillclimb.paper_hillclimb(self._generator, init, support,
                                          freqs, page_size=self.page_size,
                                          min_chunk=self.min_chunk,
                                          torch_device=self.torch_device,
                                          **kwargs)
            chunks = r.chunks
        elif method == "parallel":
            r = hillclimb.parallel_hillclimb(init, support, freqs,
                                             page_size=self.page_size,
                                             min_chunk=self.min_chunk,
                                             torch_device=self.torch_device,
                                             **kwargs)
            chunks = r.chunks
        elif method == "multi_restart":
            r = hillclimb.multi_restart(self._generator, init, support,
                                        freqs, page_size=self.page_size,
                                        min_chunk=self.min_chunk,
                                        torch_device=self.torch_device,
                                        **kwargs)
            chunks = r.chunks
        elif method == "anneal":
            r = _anneal_fn(self._generator, init, support, freqs,
                           page_size=self.page_size,
                           min_chunk=self.min_chunk,
                           torch_device=self.torch_device, **kwargs)
            chunks = r.chunks
        else:
            raise ValueError(f"unknown method {method!r}")

        chunks = np.unique(np.asarray(chunks, dtype=np.int64))
        return SlabSchedule(
            chunk_sizes=chunks,
            waste=waste_exact(chunks, support, freqs,
                              page_size=self.page_size),
            baseline_waste=waste_exact(baseline, support, freqs,
                                       page_size=self.page_size),
            baseline_chunks=baseline,
            method=method,
            waste_fraction=default_waste_fraction(
                chunks, support, freqs, page_size=self.page_size),
            utilization=utilization_exact(chunks, support, freqs,
                                          page_size=self.page_size))


def covering_default_classes(support, *, k: int | None = None,
                             page_size: int = PAGE_SIZE) -> np.ndarray:
    """The stock geometric classes that receive the support's traffic.

    Mirrors how the paper's tables present the "old configuration": the
    subset of default classes spanning [min observed, >= max observed].
    If ``k`` is given and the natural span has fewer classes, extend
    downward (never upward: the top class must still cover max size).
    """
    support = np.asarray(support, dtype=np.int64)
    defaults = default_memcached_schedule(page_size=page_size)
    lo = int(np.searchsorted(defaults, support.min(), side="left"))
    hi = int(np.searchsorted(defaults, support.max(), side="left"))
    hi = min(hi, len(defaults) - 1)
    if k is not None:
        while hi - lo + 1 < k and lo > 0:
            lo -= 1
    return defaults[lo:hi + 1].astype(np.int64)


def schedule_with_default_tail(chunks, *,
                               page_size: int = PAGE_SIZE) -> np.ndarray:
    """Learned classes plus the stock geometric classes above them.

    A real memcached that re-learns classes for its observed traffic span
    still keeps the default classes above that span (items larger than
    anything seen so far must remain storable). The adaptive benchmarks
    deploy every learned schedule this way so an operating-point shift
    degrades gracefully into the geometric tail instead of rejecting.
    """
    chunks = np.unique(np.asarray(chunks, dtype=np.int64))
    defaults = default_memcached_schedule(page_size=page_size)
    return np.unique(np.concatenate(
        [chunks, defaults[defaults > chunks[-1]]]))


def _pad_or_trim(chunks: np.ndarray, k: int, support: np.ndarray
                 ) -> np.ndarray:
    """Give a search exactly k movable classes without losing coverage."""
    chunks = np.unique(chunks)
    max_size = int(support.max())
    if len(chunks) > k:
        keep = np.sort(np.concatenate(
            [chunks[-1:], chunks[:-1][-(k - 1):]]))  # always keep the top
        return keep.astype(np.int64)
    if len(chunks) < k:
        extra = np.linspace(int(support.min()), int(support.max()),
                            num=(k - len(chunks)) + 2,
                            dtype=np.int64)[1:-1]
        merged = np.concatenate([chunks, extra])
        # Nudge duplicates apart; waste is invariant to duplicate classes.
        merged = np.sort(merged)
        for i in range(1, len(merged)):
            if merged[i] <= merged[i - 1]:
                merged[i] = merged[i - 1] + 1
        return merged.astype(np.int64)
    return chunks.astype(np.int64)
