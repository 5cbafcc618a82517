"""Item-size traffic distributions and histograms.

The paper drives Memcached with log-normal item-size traffic at five
(mu, sigma) operating points (its Tables 1-5). Back-solving the tables
(see DESIGN.md §1) pins the parameterisation as the *byte-space moments*
of the distribution and ~1e6 items per run. We expose both the byte-moment
parameterisation (primary) and a log-space one (sensitivity check).

Histograms are the interface between traffic and the optimizer: the waste
objective only needs (sizes, freqs) of the observed support.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

PAGE_SIZE = 1 << 20  # 1 MB, memcached's page / max-item size


@dataclasses.dataclass(frozen=True)
class PaperWorkload:
    """One operating point from the paper's Tables 1-5."""

    table: int
    mu: float                    # mean item size, bytes
    sigma: float                 # std of item size, bytes (byte-moment reading)
    old_chunks: Tuple[int, ...]  # "Available Chunk Sizes", old configuration
    new_chunks: Tuple[int, ...]  # paper's learned configuration
    old_waste: int               # bytes, as reported
    new_waste: int               # bytes, as reported

    @property
    def recovered_frac(self) -> float:
        return 1.0 - self.new_waste / self.old_waste


PAPER_WORKLOADS: Tuple[PaperWorkload, ...] = (
    PaperWorkload(1, 518.0, 10.5, (304, 384, 480, 600, 752, 944),
                  (461, 510, 557, 614, 702, 943), 62_013_552, 32_809_986),
    PaperWorkload(2, 1210.0, 15.8, (944, 1184, 1480, 1856),
                  (1173, 1280, 1414, 1735), 147_403_935, 74_979_930),
    PaperWorkload(3, 2109.0, 16.6, (1856, 2320, 2904),
                  (2120, 2287, 2643), 230_144_462, 111_980_981),
    PaperWorkload(4, 4133.0, 15.8, (4544, 5680),
                  (4246, 4644), 410_568_873, 181_599_689),
    PaperWorkload(5, 8131.0, 15.2, (8880,),
                  (8628,), 748_193_597, 496_353_869),
)

PAPER_N_ITEMS = 1_000_000


def lognormal_params_from_moments(mean, std):
    """(mu_log, sigma_log) of a LogNormal with the given byte-space moments.

    Accepts scalars (returns floats) or same-shape arrays (returns
    arrays) — the non-stationary traffic generators interpolate the
    moments per item.
    """
    mean = np.asarray(mean, dtype=np.float64)
    std = np.asarray(std, dtype=np.float64)
    if np.any(mean <= 0):
        raise ValueError(f"mean must be positive, got {mean}")
    var_ratio = (std / mean) ** 2
    sigma_log = np.sqrt(np.log1p(var_ratio))
    mu_log = np.log(mean) - 0.5 * sigma_log**2
    if mu_log.ndim == 0:
        return float(mu_log), float(sigma_log)
    return mu_log, sigma_log


def sample_lognormal_sizes(
    rng: np.random.Generator,
    n: int,
    mean: float,
    std: float,
    *,
    min_size: int = 1,
    max_size: int = PAGE_SIZE,
    log_space_sigma: bool = False,
) -> np.ndarray:
    """Integer item sizes from a log-normal.

    ``log_space_sigma=True`` reads ``std`` as sigma/100 of the underlying
    normal (the alternative reading of the paper's tables; see DESIGN.md).
    """
    if log_space_sigma:
        mu_log, sigma_log = float(np.log(mean)), std / 100.0
    else:
        mu_log, sigma_log = lognormal_params_from_moments(mean, std)
    raw = rng.lognormal(mean=mu_log, sigma=sigma_log, size=n)
    return np.clip(np.rint(raw), min_size, max_size).astype(np.int64)


def sample_multimodal_sizes(
    rng: np.random.Generator,
    n: int,
    modes: Tuple[Tuple[float, float, float], ...],
    *,
    min_size: int = 1,
    max_size: int = PAGE_SIZE,
) -> np.ndarray:
    """Mixture of log-normals: modes = ((weight, mean, std), ...).

    Used to *test* the paper's §6.3 global-convergence claim — multimodal
    traffic is where greedy ±1-byte walks can strand classes between modes.
    """
    weights = np.array([m[0] for m in modes], dtype=np.float64)
    weights = weights / weights.sum()
    counts = rng.multinomial(n, weights)
    parts = [
        sample_lognormal_sizes(rng, int(c), mean, std,
                               min_size=min_size, max_size=max_size)
        for c, (_, mean, std) in zip(counts, modes)
    ]
    sizes = np.concatenate(parts)
    rng.shuffle(sizes)
    return sizes


def size_histogram(sizes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(support, freqs): sorted unique sizes and their counts, int64."""
    support, freqs = np.unique(np.asarray(sizes, dtype=np.int64),
                               return_counts=True)
    return support.astype(np.int64), freqs.astype(np.int64)


def dense_histogram(sizes: np.ndarray, max_size: int | None = None
                    ) -> np.ndarray:
    """freqs[s] = count of items of size s, for s in [0, max_size]."""
    sizes = np.asarray(sizes, dtype=np.int64)
    if max_size is None:
        max_size = int(sizes.max())
    return np.bincount(sizes, minlength=max_size + 1).astype(np.int64)


def merge_histograms(a, b) -> Tuple[np.ndarray, np.ndarray]:
    """Merge two (support, freqs) histograms (e.g. from different shards)."""
    sa, fa = a
    sb, fb = b
    support = np.union1d(sa, sb)
    freqs = np.zeros_like(support)
    freqs[np.searchsorted(support, sa)] += fa
    freqs[np.searchsorted(support, sb)] += fb
    return support, freqs
