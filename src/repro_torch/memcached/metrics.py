"""Waste accounting shared by the simulator and the benchmarks."""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.distribution import PAGE_SIZE, size_histogram
from repro_torch.core.waste import waste_exact


@dataclasses.dataclass(frozen=True)
class WasteComparison:
    old_chunks: np.ndarray
    new_chunks: np.ndarray
    old_waste: int
    new_waste: int

    @property
    def recovered_frac(self) -> float:
        if self.old_waste == 0:
            return 0.0
        return 1.0 - self.new_waste / self.old_waste


def compare_schedules(old_chunks: Sequence[int], new_chunks: Sequence[int],
                      sizes: np.ndarray, *,
                      page_size: int = PAGE_SIZE) -> WasteComparison:
    support, freqs = size_histogram(sizes)
    return WasteComparison(
        old_chunks=np.asarray(sorted(old_chunks), dtype=np.int64),
        new_chunks=np.asarray(sorted(new_chunks), dtype=np.int64),
        old_waste=waste_exact(old_chunks, support, freqs,
                              page_size=page_size),
        new_waste=waste_exact(new_chunks, support, freqs,
                              page_size=page_size))
