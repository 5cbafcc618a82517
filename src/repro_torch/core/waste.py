"""The waste objective: internal fragmentation of a slab-class schedule.

An item of size ``s`` is stored in the smallest chunk ``c_j >= s``; the
memory hole is ``c_j - s``. Items larger than the largest chunk cannot be
stored at all in Memcached; the optimizer must be discouraged from
uncovering them, so they are charged as if they consumed whole pages:
``ceil(s / page_size) * page_size - s`` extra bytes (at least one page).
For ``s <= page_size`` this is the classic full-page charge
``page_size - s``; for larger items the charge stays non-negative, so a
schedule that covers nothing can never score better than one that covers
everything. Any covering configuration is strictly better, which keeps
the top class above the observed maximum, matching Memcached's real
constraint.

Two implementations:

* ``waste_exact`` — numpy int64, bit-exact; used for all *reported* numbers
  and by the DP optimizer.
* ``waste_torch`` / ``waste_batch_torch`` — float32 results on a torch
  device; used inside search loops (the counterparts of the reference's
  ``waste_jax`` / ``waste_batch_jax``). Sums are taken in float64 and
  rounded once, so with integer freqs the result is the correctly
  rounded exact total, independent of summation order, and equal to the
  ``waste_eval`` kernel's. Final schedules are always re-scored with
  ``waste_exact``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.distribution import PAGE_SIZE


def uncovered_charge(support, *, page_size: int = PAGE_SIZE) -> np.ndarray:
    """Waste charged to sizes no chunk covers: ``ceil(s/page)`` whole
    pages (at least one) minus the item bytes — always >= 0."""
    support = np.asarray(support, dtype=np.int64)
    pages = np.maximum(-(-support // page_size), 1)
    return pages * page_size - support


def waste_exact(chunks, support, freqs, *, page_size: int = PAGE_SIZE) -> int:
    """Exact total waste in bytes (numpy int64)."""
    chunks = np.sort(np.asarray(chunks, dtype=np.int64))
    support = np.asarray(support, dtype=np.int64)
    freqs = np.asarray(freqs, dtype=np.int64)
    idx = np.searchsorted(chunks, support, side="left")
    storable = idx < chunks.shape[0]
    assigned = chunks[np.minimum(idx, chunks.shape[0] - 1)]
    per_size = np.where(storable, assigned - support,
                        uncovered_charge(support, page_size=page_size))
    return int(np.sum(per_size * freqs))


def utilization_exact(chunks, support, freqs, *,
                      page_size: int = PAGE_SIZE) -> float:
    """Fraction of allocated chunk bytes that hold item bytes."""
    chunks = np.sort(np.asarray(chunks, dtype=np.int64))
    support = np.asarray(support, dtype=np.int64)
    freqs = np.asarray(freqs, dtype=np.int64)
    idx = np.searchsorted(chunks, support, side="left")
    storable = idx < chunks.shape[0]
    pages = np.maximum(-(-support // page_size), 1)
    assigned = np.where(storable, chunks[np.minimum(idx, len(chunks) - 1)],
                        pages * page_size)
    alloc = int(np.sum(assigned * freqs))
    used = int(np.sum(np.where(storable, support, 0) * freqs))
    return used / max(alloc, 1)


def per_class_waste_exact(chunks, support, freqs, *,
                          page_size: int = PAGE_SIZE) -> np.ndarray:
    """Waste attributed to each class (sorted order); index K = unstorable."""
    chunks = np.sort(np.asarray(chunks, dtype=np.int64))
    support = np.asarray(support, dtype=np.int64)
    freqs = np.asarray(freqs, dtype=np.int64)
    idx = np.searchsorted(chunks, support, side="left")
    storable = idx < chunks.shape[0]
    assigned = chunks[np.minimum(idx, len(chunks) - 1)]
    per_size = np.where(storable, assigned - support,
                        uncovered_charge(support, page_size=page_size))
    out = np.zeros(len(chunks) + 1, dtype=np.int64)
    np.add.at(out, np.where(storable, idx, len(chunks)), per_size * freqs)
    return out


def waste_torch(chunks: torch.Tensor, support: torch.Tensor,
                freqs: torch.Tensor, *,
                page_size: int = PAGE_SIZE) -> torch.Tensor:
    """Waste of one (K,) schedule as a 0-d float32 tensor on the inputs'
    device. ``chunks`` may be unsorted."""
    return waste_batch_torch(chunks[None, :], support, freqs,
                             page_size=page_size)[0]


def waste_batch_torch(chunk_batch: torch.Tensor, support: torch.Tensor,
                      freqs: torch.Tensor, *,
                      page_size: int = PAGE_SIZE) -> torch.Tensor:
    """(B, K) candidate schedules -> (B,) float32 waste. Plain PyTorch,
    same semantics as the ``waste_eval`` kernel (``kernels.ops``)."""
    chunks = torch.sort(chunk_batch.to(torch.int64), dim=1).values
    b, k = chunks.shape
    s = support.to(torch.int64)
    idx = torch.searchsorted(chunks, s.expand(b, -1).contiguous(),
                             side="left")
    storable = idx < k
    assigned = torch.gather(chunks, 1, idx.clamp(max=k - 1))
    pages = torch.clamp(-torch.div(-s, page_size, rounding_mode="floor"),
                        min=1)
    per_size = torch.where(storable, assigned - s, pages * page_size - s)
    f = freqs.to(torch.float32).to(torch.float64)
    return (per_size.to(torch.float64) * f).sum(dim=1).to(torch.float32)


def default_waste_fraction(chunks, support, freqs, *,
                           page_size: int = PAGE_SIZE) -> float:
    """Waste as a fraction of total item bytes (the paper's ~10% headline)."""
    total_item_bytes = int(np.sum(np.asarray(support, dtype=np.int64)
                                  * np.asarray(freqs, dtype=np.int64)))
    return waste_exact(chunks, support, freqs, page_size=page_size) / max(
        total_item_bytes, 1)
