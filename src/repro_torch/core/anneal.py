"""Simulated-annealing slab-class search (beyond-paper variant).

Same move set as the paper's Algorithm 1 but with geometric step sizes and
a Metropolis accept rule, so the walk can cross waste barriers between
modes of a multimodal size distribution — exactly the case where the
paper's strictly-greedy walk strands classes. Runs as a loop of device
tensor operations with every draw taken up front from a
``torch.Generator``; tracks best-so-far and reads it back once.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.guards import deliberate_sync
from repro_torch.core.distribution import PAGE_SIZE
from repro_torch.core.hillclimb import MIN_CHUNK, SearchResult
from repro_torch.core.waste import waste_exact, waste_torch
from repro_torch.kernels import ops


def anneal(generator: torch.Generator, init_chunks, support, freqs, *,
           n_steps: int = 20_000, t0: float | None = None,
           t_final: float = 1.0, page_size: int = PAGE_SIZE,
           min_chunk: int = MIN_CHUNK, torch_device="cuda") -> SearchResult:
    """``generator`` must live on ``torch_device``."""
    dev = ops.resolve_device(torch_device)
    support_t = torch.as_tensor(np.asarray(support), dtype=torch.int32,
                                device=dev)
    freqs_t = torch.as_tensor(np.asarray(freqs), dtype=torch.float32,
                              device=dev)
    init_waste = waste_exact(init_chunks, support, freqs,
                             page_size=page_size)
    if t0 is None:
        t0 = max(float(init_waste) * 1e-3, 1.0)
    alpha = (t_final / t0) ** (1.0 / max(n_steps - 1, 1))
    chunks = torch.as_tensor(np.asarray(init_chunks), dtype=torch.int32,
                             device=dev)
    k = chunks.shape[0]
    cls = torch.randint(0, k, (n_steps,), generator=generator, device=dev)
    mag = 2 ** torch.randint(0, 9, (n_steps,), generator=generator,
                             device=dev)                          # 1..256
    up = torch.randint(0, 2, (n_steps,), generator=generator, device=dev)
    delta = torch.where(up == 1, mag, -mag).to(torch.int32)
    u = torch.rand(n_steps, generator=generator, device=dev)
    cur = waste_torch(chunks, support_t, freqs_t, page_size=page_size)
    best_chunks, best = chunks, cur
    for i in range(n_steps):
        cand = chunks.index_add(0, cls[i:i + 1], delta[i:i + 1])
        cand = cand.clamp(min_chunk, page_size)
        new = waste_torch(cand, support_t, freqs_t, page_size=page_size)
        temp = t0 * alpha ** i
        accept = (new <= cur) | (u[i] < torch.exp(-(new - cur) / temp))
        chunks = torch.where(accept, cand, chunks)
        cur = torch.where(accept, new, cur)
        better = cur < best
        best_chunks = torch.where(better, chunks, best_chunks)
        best = torch.where(better, cur, best)
    with deliberate_sync("anneal.result"):
        chunks_host = np.sort(best_chunks.cpu().numpy().astype(np.int64))
    return SearchResult(
        chunks=chunks_host,
        waste=waste_exact(chunks_host, support, freqs, page_size=page_size),
        init_waste=init_waste, steps=n_steps, method="anneal")
