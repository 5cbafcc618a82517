"""Plain PyTorch versions of the port's CUDA kernels (the correctness
contracts). ``kernels.ops`` runs them for CPU tensors; ``chip_smoke.py``
holds each CUDA kernel against its plain version on the card."""
from __future__ import annotations

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
    c = chunk_batch.to(torch.int64)[:, :, None]                 # (B, K, 1)
    s = support.to(torch.int64)                                  # (S,)
    big = torch.iinfo(torch.int64).max
    assigned = torch.where(c >= s, c, big).amin(dim=1)           # (B, S)
    pages = torch.clamp(-torch.div(-s, page_size, rounding_mode="floor"),
                        min=1)
    waste = torch.where(assigned != big, assigned - s, pages * page_size - s)
    f = freqs.to(torch.float32).to(torch.float64)
    return (waste.to(torch.float64) * f).sum(dim=1).to(torch.float32)
