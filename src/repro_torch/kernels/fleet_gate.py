"""Fleet-batched drift gate: one batched expression for every due tenant.

The reference's ``repro/kernels/fleet_gate.py::drift_gate_fleet`` is
``jit(vmap(_dense_distance))``, not a Pallas kernel. Here it is the
port's own :func:`repro_torch.core.observe._dense_distance` applied to
whole ``[n, num_buckets]`` stacks (the function reduces over the last
axis), so a fleet row computes the solo gate's arithmetic in one pass of
a few PyTorch kernels over the whole stack, with no per-row launches.
Float32 sums over a stack may differ from the solo gate's in the last
ulp; the arbiter's device path is held to decision-level parity.
"""
from __future__ import annotations

import torch

from repro_torch.core.observe import _dense_distance


def drift_gate_fleet(refs: torch.Tensor, sketches: torch.Tensor, *,
                     metric: str = "l1") -> torch.Tensor:
    """Drift distance per fleet row: ``refs`` and ``sketches`` are
    matching ``[n, num_buckets]`` stacks of dense per-bucket weights
    (reference vs live, same grid). Returns an ``(n,)`` float32 tensor
    of distances in [0, 1] on their device; the caller reads it back in
    one host sync for the whole fleet."""
    if metric not in ("l1", "emd"):
        raise ValueError(f"unknown metric {metric!r}")
    if refs.dim() != 2 or refs.shape != sketches.shape:
        raise ValueError(
            f"need matching [n, buckets] stacks, got {tuple(refs.shape)} "
            f"vs {tuple(sketches.shape)}")
    return _dense_distance(refs, sketches, metric)
