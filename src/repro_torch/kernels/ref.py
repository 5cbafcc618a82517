"""Plain PyTorch versions of the port's CUDA kernels (the correctness
contracts). ``kernels.ops`` runs them for CPU tensors; ``chip_smoke.py``
holds each CUDA kernel against its plain version on the card."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.distribution import PAGE_SIZE


def waste_eval_ref(chunk_batch: torch.Tensor, support: torch.Tensor,
                   freqs: torch.Tensor, *,
                   page_size: int = PAGE_SIZE) -> torch.Tensor:
    """(B, K) schedules x (S,) histogram -> (B,) float32 waste.

    Plain version of ``csrc/waste_eval.cu``: each size goes to its
    smallest covering chunk (a minimum over the K chunks); uncovered
    sizes are charged ``max(ceil(s / page_size), 1)`` whole pages. Rows
    need not be sorted. Sums are taken in float64 and rounded once, like
    the kernel's, so the two agree bit for bit on integer freqs.
    """
    return _waste_rows(chunk_batch, support, freqs, page_size)


def waste_eval_fleet_ref(chunk_batch: torch.Tensor, supports: torch.Tensor,
                         freqs: torch.Tensor, *,
                         page_size: int = PAGE_SIZE) -> torch.Tensor:
    """(B, K) schedules x (B, S) PER-ROW histograms -> (B,) float32 waste:
    row b of :func:`waste_eval_ref` against histogram b. Plain version of
    ``csrc/waste_eval.cu``'s fleet entry; the same arithmetic row by row,
    so a replicated histogram gives the bits of :func:`waste_eval_ref`."""
    return _waste_rows(chunk_batch, supports, freqs, page_size)


def _waste_rows(chunk_batch: torch.Tensor, support: torch.Tensor,
                freqs: torch.Tensor, page_size: int) -> torch.Tensor:
    """Waste of each row against a shared ``(S,)`` or per-row ``(B, S)``
    histogram, summed in float64 and rounded once."""
    c = chunk_batch.to(torch.int64)[:, :, None]                 # (B, K, 1)
    s = support.to(torch.int64).unsqueeze(-2)              # (1|B, 1, S)
    big = torch.iinfo(torch.int64).max
    assigned = torch.where(c >= s, c, big).amin(dim=1)           # (B, S)
    s = s.squeeze(-2)                                         # (S,)|(B, S)
    pages = torch.clamp(-torch.div(-s, page_size, rounding_mode="floor"),
                        min=1)
    waste = torch.where(assigned != big, assigned - s, pages * page_size - s)
    f = freqs.to(torch.float32).to(torch.float64)
    return (waste.to(torch.float64) * f).sum(dim=-1).to(torch.float32)


def slab_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                              v_pool: torch.Tensor, starts: torch.Tensor,
                              lens: torch.Tensor, *,
                              sm_scale: Optional[float] = None
                              ) -> torch.Tensor:
    """Decode attention over a contiguous slab KV pool, over the whole
    pool with a mask.

    q (B, Hq, D), k_pool/v_pool (T, Hkv, D), starts/lens (B,) int32 ->
    (B, Hq, D). Sequence b attends over pool rows
    ``[starts[b], starts[b] + lens[b])``; GQA: query head h uses kv head
    ``h // (Hq // Hkv)``. An empty sequence gives 0.
    """
    b, hq, d = q.shape
    t, hkv, _ = k_pool.shape
    g = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    pos = torch.arange(t, device=q.device)[None, :]
    st = starts.to(torch.int64)[:, None]
    valid = (pos >= st) & (pos < st + lens.to(torch.int64)[:, None])
    qf = q.to(torch.float32).reshape(b, hkv, g, d)
    kf = k_pool.to(torch.float32)
    vf = v_pool.to(torch.float32)
    scores = torch.einsum("bhgd,thd->bhgt", qf, kf) * sm_scale
    scores = torch.where(valid[:, None, None, :], scores, -torch.inf)
    out = torch.einsum("bhgt,thd->bhgd", _softmax(scores), vf)
    return out.reshape(b, hq, d).to(q.dtype)


def slab_decode_attention_window_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     starts: torch.Tensor,
                                     lens: torch.Tensor, *,
                                     max_chunk_tokens: int,
                                     sm_scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """:func:`slab_decode_attention_ref` restricted to each sequence's
    chunk window: gathers ``max_chunk_tokens`` rows at ``starts[b]``
    (clamped into the pool) and runs the same masked softmax there,
    positions at or past ``lens[b]`` masked. Plain version of
    ``csrc/slab_attention.cu``."""
    b, hq, d = q.shape
    t, hkv, _ = k_pool.shape
    g = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    w = torch.arange(max_chunk_tokens, device=q.device)
    idx = (starts.to(torch.int64)[:, None] + w[None, :]).clamp(0, t - 1)
    valid = w[None, :] < lens.to(torch.int64)[:, None]           # (B, W)
    qf = q.to(torch.float32).reshape(b, hkv, g, d)
    kf = k_pool[idx].to(torch.float32)                       # (B, W, Hkv, D)
    vf = v_pool[idx].to(torch.float32)
    scores = torch.einsum("bhgd,bwhd->bhgw", qf, kf) * sm_scale
    scores = torch.where(valid[:, None, None, :], scores, -torch.inf)
    out = torch.einsum("bhgw,bwhd->bhgd", _softmax(scores), vf)
    return out.reshape(b, hq, d).to(q.dtype)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    m = x.amax(dim=-1, keepdim=True)
    # fully masked rows (empty sequences): max = -inf -> output 0
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(x - m)
    denom = e.sum(dim=-1, keepdim=True)
    return torch.where(denom > 0, e / torch.clamp(denom, min=1e-30), 0.0)
