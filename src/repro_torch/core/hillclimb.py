"""Hill-climbing slab-class search.

``paper_hillclimb`` is a faithful implementation of the paper's Algorithm 1:

    do:
        move one randomly chosen class +-1 byte
        accept iff new_waste <= old_waste       (neutral moves accepted)
    until 1000 consecutive rejections

as a loop of device tensor operations. The moves are drawn from a
``torch.Generator`` in blocks and the loop state stays on the device;
steps after the patience trips are masked out, and the host reads the
stop flag once per block, so the result is that of the sequential loop
with one readback per block instead of one per step.

Beyond-paper variants (same objective, better hardware mapping):

* ``parallel_hillclimb`` — evaluates *all* K x len(deltas) single-class
  moves per iteration as one batched waste evaluation (``batch_eval``:
  the plain ``waste_batch_torch`` by default, or the CUDA kernel
  ``repro_torch.kernels.ops.waste_eval``) and takes the best
  strictly-improving move. Converges to a coordinate-wise local optimum
  in tens of iterations instead of the paper's tens of thousands of
  +-1 steps.
* ``multi_restart`` — restarts from jittered initial schedules; the paper
  ran 100 sequential restarts to argue global convergence (§6.3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.analysis.guards import deliberate_sync
from repro_torch.core.distribution import PAGE_SIZE
from repro_torch.core.waste import waste_batch_torch, waste_exact, waste_torch
from repro_torch.kernels import ops

MIN_CHUNK = 48  # memcached's smallest usable chunk
PATIENCE_BLOCK = 1024  # paper_hillclimb steps between stop-flag readbacks


@dataclasses.dataclass(frozen=True)
class SearchResult:
    chunks: np.ndarray          # learned schedule, sorted int64
    waste: int                  # exact waste of `chunks` (bytes)
    init_waste: int             # exact waste of the initial schedule
    steps: int                  # iterations actually executed
    method: str

    @property
    def recovered_frac(self) -> float:
        if self.init_waste == 0:
            return 0.0
        return 1.0 - self.waste / self.init_waste


def _as_i32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)


def _as_f32(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)


def _host_chunks(chunks: torch.Tensor) -> np.ndarray:
    return np.sort(chunks.cpu().numpy().astype(np.int64))


def paper_hillclimb(generator: torch.Generator, init_chunks, support, freqs,
                    *, patience: int = 1000, max_steps: int = 200_000,
                    page_size: int = PAGE_SIZE, min_chunk: int = MIN_CHUNK,
                    torch_device="cuda") -> SearchResult:
    """The paper's Algorithm 1. ``max_steps`` bounds runtime (the paper runs
    unbounded; with neutral moves accepted, unused classes random-walk and
    the 1000-rejection patience can take arbitrarily long to trip).
    ``generator`` must live on ``torch_device``."""
    dev = ops.resolve_device(torch_device)
    support_t = _as_i32(support, dev)
    freqs_t = _as_f32(freqs, dev)
    chunks = _as_i32(init_chunks, dev)
    k = chunks.shape[0]
    old = waste_torch(chunks, support_t, freqs_t, page_size=page_size)
    count = torch.zeros((), dtype=torch.int64, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    start = 0
    while start < max_steps:
        block = min(PATIENCE_BLOCK, max_steps - start)
        cls = torch.randint(0, k, (block,), generator=generator, device=dev)
        up = torch.randint(0, 2, (block,), generator=generator, device=dev)
        delta = (2 * up - 1).to(torch.int32)
        for t in range(block):
            cand = chunks.index_add(0, cls[t:t + 1], delta[t:t + 1])
            cand = cand.clamp(min_chunk, page_size)
            new = waste_torch(cand, support_t, freqs_t, page_size=page_size)
            live = ~done
            accept = (new <= old) & live
            chunks = torch.where(accept, cand, chunks)
            old = torch.where(accept, new, old)
            count = torch.where(live, torch.where(accept, 0, count + 1),
                                count)
            steps = steps + live
            done = done | (count > patience)
        start += block
        # One readback per block: the stop flag of the whole block.
        with deliberate_sync("hillclimb.paper-patience"):
            if bool(done):
                break
    # Refit-time result readback: one deliberate device->host pull at the
    # end of the whole search.
    with deliberate_sync("hillclimb.paper-result"):
        chunks_host = _host_chunks(chunks)
        steps_host = int(steps)
    return SearchResult(
        chunks=chunks_host,
        waste=waste_exact(chunks_host, support, freqs, page_size=page_size),
        init_waste=waste_exact(init_chunks, support, freqs,
                               page_size=page_size),
        steps=steps_host, method="paper_hillclimb")


DEFAULT_DELTAS: tuple = tuple(
    d for m in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512) for d in (-m, m))


def _parallel_hillclimb(init: torch.Tensor, support: torch.Tensor,
                        freqs: torch.Tensor, *, max_iters: int,
                        page_size: int, min_chunk: int, deltas: tuple,
                        batch_eval: Callable):
    """Best-improvement loop on device tensors; one readback of the
    improvement flag per iteration. Returns ``(chunks, iterations)``."""
    dev = init.device
    k = init.shape[0]
    d = len(deltas)
    deltas_t = torch.tensor(deltas, dtype=torch.int32, device=dev)
    eye = torch.eye(k, dtype=torch.int32, device=dev)
    moves = eye[:, None, :] * deltas_t[None, :, None]            # (K, D, K)
    chunks = init
    old = batch_eval(init[None, :].contiguous(), support, freqs,
                     page_size=page_size)[0]
    it = 0
    while it < max_iters:
        # All K*D single-class moves as one batch.
        cands = (chunks[None, None, :] + moves).clamp(min_chunk, page_size)
        cands = cands.reshape(k * d, k)
        w = batch_eval(cands, support, freqs, page_size=page_size)
        best = torch.argmin(w).reshape(1)
        w_best = w.index_select(0, best)[0]
        it += 1
        with deliberate_sync("hillclimb.parallel-step"):
            improved = bool(w_best < old)
        if not improved:
            break
        chunks = cands.index_select(0, best)[0]
        old = w_best
    return chunks, it


def parallel_hillclimb(init_chunks, support, freqs, *,
                       max_iters: int = 2000, page_size: int = PAGE_SIZE,
                       min_chunk: int = MIN_CHUNK,
                       deltas: Sequence[int] = DEFAULT_DELTAS,
                       batch_eval: Callable | None = None,
                       torch_device="cuda") -> SearchResult:
    """Best-improvement hill climbing over a geometric move set.

    Terminates at a configuration where no single-class move in ``deltas``
    improves waste (a superset of the paper's +-1 moves, so its fixed
    points are at least as good). ``batch_eval(chunk_batch, support,
    freqs, *, page_size)`` scores a (B, K) int32 batch; it defaults to
    ``waste_batch_torch``, and ``repro_torch.kernels.ops.waste_eval``
    runs the evaluation through the CUDA kernel.
    """
    dev = ops.resolve_device(torch_device)
    chunks, iters = _parallel_hillclimb(
        _as_i32(init_chunks, dev), _as_i32(support, dev),
        _as_f32(freqs, dev), max_iters=max_iters, page_size=page_size,
        min_chunk=min_chunk, deltas=tuple(deltas),
        batch_eval=batch_eval or waste_batch_torch)
    with deliberate_sync("hillclimb.parallel-result"):
        chunks_host = _host_chunks(chunks)
    return SearchResult(
        chunks=chunks_host,
        waste=waste_exact(chunks_host, support, freqs, page_size=page_size),
        init_waste=waste_exact(init_chunks, support, freqs,
                               page_size=page_size),
        steps=iters, method="parallel_hillclimb")


def multi_restart(generator: torch.Generator, init_chunks, support, freqs, *,
                  n_restarts: int = 16, jitter: int = 64,
                  page_size: int = PAGE_SIZE, min_chunk: int = MIN_CHUNK,
                  max_iters: int = 2000, torch_device="cuda") -> SearchResult:
    """Parallel hill climbing from jittered restarts; returns the best run.
    ``generator`` must live on ``torch_device``."""
    dev = ops.resolve_device(torch_device)
    support_t = _as_i32(support, dev)
    freqs_t = _as_f32(freqs, dev)
    init = _as_i32(init_chunks, dev)
    noise = torch.randint(-jitter, jitter + 1, (n_restarts, init.shape[0]),
                          generator=generator, device=dev,
                          dtype=torch.int32)
    noise[0] = 0  # restart 0 is the unjittered schedule
    starts = (init[None, :] + noise).clamp(min_chunk, page_size)
    # The top class must keep covering the max observed size.
    top = torch.maximum(starts.max(dim=1).values, support_t.max())
    col = int(np.argmax(np.asarray(init_chunks)))
    starts[:, col] = torch.maximum(starts[:, col], top)
    runs = [_parallel_hillclimb(starts[i].contiguous(), support_t, freqs_t,
                                max_iters=max_iters, page_size=page_size,
                                min_chunk=min_chunk, deltas=DEFAULT_DELTAS,
                                batch_eval=waste_batch_torch)
            for i in range(n_restarts)]
    all_chunks = torch.stack([c for c, _ in runs])
    wastes = waste_batch_torch(all_chunks, support_t, freqs_t,
                               page_size=page_size)
    with deliberate_sync("hillclimb.restart-result"):
        best = int(torch.argmin(wastes))
        chunks_host = _host_chunks(all_chunks[best])
    return SearchResult(
        chunks=chunks_host,
        waste=waste_exact(chunks_host, support, freqs, page_size=page_size),
        init_waste=waste_exact(init_chunks, support, freqs,
                               page_size=page_size),
        steps=max(it for _, it in runs), method="multi_restart")
