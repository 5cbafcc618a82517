"""Exact global optimum for the slab-class problem, by dynamic programming.

This is a beyond-paper contribution used to *test* the paper's §6.3 claim
that its greedy search "converges to a global minimum".

Key observation: in an optimal schedule every chunk size can be lowered to
the largest item size it actually covers without increasing waste, so the
optimal chunks can be drawn from the observed support ``s_1 < ... < s_S``.
With boundaries ``0 = j_0 <= j_1 <= ... <= j_K = S`` (class t has chunk
``s_{j_t}`` and covers sizes ``s_{j_{t-1}+1} .. s_{j_t}``):

    cost(i, j) = s_j * (F_j - F_i) - (M_j - M_i)
    dp[t][j]   = min_{i <= j} dp[t-1][i] + cost(i, j)

where F/M are prefix sums of freq and freq*size. The inner minimisation is
over lines ``y_i(x) = -F_i * x + (dp[t-1][i] + M_i)`` evaluated at
``x = s_j``; slopes are strictly decreasing in i and queries strictly
increasing in j, so a monotone convex-hull-trick gives O(K*S) exact
(arbitrary-precision int) time. A O(K*S^2) numpy brute force is kept as a
cross-check oracle for tests.

The top class is pinned to ``s_S`` by construction, so every item is
storable — the same constraint the waste objective enforces by penalty.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from repro_torch.core.distribution import PAGE_SIZE
from repro_torch.core.waste import waste_exact


@dataclasses.dataclass(frozen=True)
class DPResult:
    chunks: np.ndarray   # distinct optimal chunk sizes, sorted (len <= k)
    waste: int           # exact optimal waste (bytes)
    k: int               # class budget requested


def _prefix_sums(support: np.ndarray, freqs: np.ndarray
                 ) -> Tuple[List[int], List[int]]:
    f = [0] * (len(support) + 1)
    m = [0] * (len(support) + 1)
    for i, (s, fr) in enumerate(zip(support.tolist(), freqs.tolist()), 1):
        f[i] = f[i - 1] + fr
        m[i] = m[i - 1] + fr * s
    return f, m


def dp_optimal(support, freqs, k: int) -> DPResult:
    """Exact minimum-waste schedule with at most ``k`` classes."""
    support = np.asarray(support, dtype=np.int64)
    freqs = np.asarray(freqs, dtype=np.int64)
    order = np.argsort(support)
    support, freqs = support[order], freqs[order]
    if np.any(freqs <= 0):
        keep = freqs > 0
        support, freqs = support[keep], freqs[keep]
    s_count = len(support)
    if s_count == 0:
        return DPResult(np.array([], dtype=np.int64), 0, k)
    k_eff = min(k, s_count)

    f_pre, m_pre = _prefix_sums(support, freqs)
    xs = support.tolist()

    inf = float("inf")
    dp_prev: List = [0] + [inf] * s_count
    parents: List[List[int]] = []

    for _t in range(k_eff):
        dp_cur: List = [inf] * (s_count + 1)
        parent = [0] * (s_count + 1)
        dp_cur[0] = dp_prev[0]
        # Monotone CHT: lines (m=-F_i, c=dp_prev[i]+M_i), slopes strictly
        # decreasing in i; queries x = s_j strictly increasing in j.
        hull: List[Tuple[int, int, int]] = []  # (slope, intercept, i)
        ptr = 0

        def add_line(i: int) -> None:
            nonlocal ptr
            if dp_prev[i] == inf:
                return
            m_new, c_new = -f_pre[i], int(dp_prev[i]) + m_pre[i]
            while len(hull) >= 2:
                m1, c1, _ = hull[-2]
                m2, c2, _ = hull[-1]
                # hull[-1] dominated by hull[-2] and the new line?
                if (c_new - c1) * (m1 - m2) <= (c2 - c1) * (m1 - m_new):
                    hull.pop()
                else:
                    break
            # Equal slopes can only happen via duplicate i; keep the lower c.
            if hull and hull[-1][0] == m_new:
                if hull[-1][1] <= c_new:
                    return
                hull.pop()
            hull.append((m_new, c_new, i))
            ptr = min(ptr, len(hull) - 1)

        add_line(0)
        for j in range(1, s_count + 1):
            add_line(j)  # i = j (empty class) is a legal predecessor
            x = xs[j - 1]
            if hull:
                while (ptr + 1 < len(hull)
                       and hull[ptr + 1][0] * x + hull[ptr + 1][1]
                       <= hull[ptr][0] * x + hull[ptr][1]):
                    ptr += 1
                m_b, c_b, i_b = hull[ptr]
                base = m_b * x + c_b
                dp_cur[j] = x * f_pre[j] - m_pre[j] + base
                parent[j] = i_b
        parents.append(parent)
        dp_prev = dp_cur

    # Backtrack boundaries; drop empty classes (duplicate boundaries).
    boundaries = []
    j = s_count
    for t in range(k_eff - 1, -1, -1):
        boundaries.append(j)
        j = parents[t][j]
    boundaries = sorted(set(b for b in boundaries if b > 0))
    chunks = np.array([xs[b - 1] for b in boundaries], dtype=np.int64)
    waste = waste_exact(chunks, support, freqs, page_size=PAGE_SIZE)
    expected = dp_prev[s_count]
    assert waste == expected, (
        f"DP internal inconsistency: backtracked {waste} != dp {expected}")
    return DPResult(chunks=chunks, waste=int(waste), k=k)


def dp_optimal_bruteforce(support, freqs, k: int) -> DPResult:
    """O(K*S^2) reference (numpy int64); for tests on small supports."""
    support = np.asarray(support, dtype=np.int64)
    freqs = np.asarray(freqs, dtype=np.int64)
    order = np.argsort(support)
    support, freqs = support[order], freqs[order]
    s_count = len(support)
    if s_count == 0:
        return DPResult(np.array([], dtype=np.int64), 0, k)
    k_eff = min(k, s_count)
    f_pre = np.concatenate([[0], np.cumsum(freqs)])
    m_pre = np.concatenate([[0], np.cumsum(freqs * support)])

    big = np.iinfo(np.int64).max // 4
    # cost[i, j] for 0 <= i <= j <= S
    jj = np.arange(s_count + 1)
    s_at = np.concatenate([[0], support])           # s_j for j >= 1
    cost = (s_at[None, :] * (f_pre[None, :] - f_pre[:, None])
            - (m_pre[None, :] - m_pre[:, None]))
    cost = np.where(jj[None, :] >= jj[:, None], cost, big)

    dp = np.full(s_count + 1, big, dtype=np.int64)
    dp[0] = 0
    parent = np.zeros((k_eff, s_count + 1), dtype=np.int64)
    for t in range(k_eff):
        tot = dp[:, None] + cost
        parent[t] = np.argmin(tot, axis=0)
        dp = np.min(tot, axis=0)

    boundaries = []
    j = s_count
    for t in range(k_eff - 1, -1, -1):
        boundaries.append(j)
        j = int(parent[t][j])
    boundaries = sorted(set(b for b in boundaries if b > 0))
    chunks = np.array([support[b - 1] for b in boundaries], dtype=np.int64)
    return DPResult(chunks=chunks,
                    waste=waste_exact(chunks, support, freqs,
                                      page_size=PAGE_SIZE), k=k)
