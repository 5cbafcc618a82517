"""The decayed size-sketch update: plain versions and the CUDA launcher.

``csrc/sketch_update.cu`` replaces the TPU kernel
``repro/kernels/sketch_update.py::sketch_update_pallas`` and its scanned
form ``sketch_window_pallas``: one launch folds a whole observe window
(R batches of raw sizes) into the dense sketch. Each block owns 64 bins
dealt in a stride (bins k, k + G, ... of G blocks), so a hot range of
neighbouring sizes spreads over the card; it compacts the window's hits
on its bins into a list in item order (ballots and one scan in shared
memory), and its 64 bin threads walk that list row by row, each adding
its own bin's hits in item order after the row's decay. The work
follows the hits and no float atomic is used. The per-batch
``sketch_update`` is the same kernel with one row of bucket ids that
need no bucketizing. The source note says what bounds it.

The plain versions here restate the reference's scan row by row; the
public, checked entry points are ``kernels/ops.py::sketch_update`` and
``sketch_window``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build


def bucketize(sizes: torch.Tensor, bucket_width: int,
              num_buckets: int) -> torch.Tensor:
    """Bucket ids ``ceil(s / width) - 1`` clipped into the grid; negative
    sizes map to -1, which the update skips."""
    s = sizes.to(torch.int64)
    idx = -torch.div(-s, bucket_width, rounding_mode="floor") - 1
    idx = torch.where(s < 0, -1, idx.clamp(0, num_buckets - 1))
    return idx.to(torch.int32)


def _f32_scalar(x, device: torch.device) -> torch.Tensor:
    """``x`` as a 0-d float32 tensor on ``device``. A Python number is
    filled in on the device: a host-to-device copy would wait for the
    stream to drain."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=device)


def sketch_update_ref(state: torch.Tensor, bucket_idx: torch.Tensor,
                      weights: torch.Tensor, decay_total) -> torch.Tensor:
    """``new[b] = state[b] * decay_total + sum_{i: idx_i == b} w_i``;
    ids outside ``[0, BINS)`` are skipped."""
    state = state.to(torch.float32)
    dt = _f32_scalar(decay_total, state.device)
    valid = (bucket_idx >= 0) & (bucket_idx < state.shape[0])
    idx = torch.where(valid, bucket_idx, 0).to(torch.int64)
    w = torch.where(valid, weights.to(torch.float32), 0.0)
    return (state * dt).index_add(0, idx, w)


def sketch_window_ref(state: torch.Tensor, sizes: torch.Tensor,
                      weights: torch.Tensor, lengths: torch.Tensor, decay,
                      decay_totals: torch.Tensor, *,
                      bucket_width: int = 1) -> torch.Tensor:
    """(BINS,) state x (R, N) raw sizes -> new state: R sequential
    :func:`sketch_update_ref` steps. Item i of row r's ``lengths[r]``-item
    batch carries ``weights[r, i] * decay ** (lengths[r] - 1 - i)``; the
    state decays by ``decay_totals[r]`` first. Positions at or past
    ``lengths[r]`` are dead (exact no-ops), and the decay exponent is
    clamped at 0 there."""
    num_buckets = state.shape[0]
    pos = torch.arange(sizes.shape[1], device=state.device)
    decay_t = _f32_scalar(decay, state.device)
    out = state.to(torch.float32)
    for r in range(sizes.shape[0]):
        n = lengths[r].to(torch.int64)
        live = pos < n
        idx = torch.where(live, bucketize(sizes[r], bucket_width,
                                          num_buckets), -1)
        expo = torch.clamp(n - 1 - pos, min=0).to(torch.float32)
        w = torch.where(live, weights[r].to(torch.float32)
                        * torch.pow(decay_t, expo), 0.0)
        out = sketch_update_ref(out, idx, w, decay_totals[r])
    return out


def _lib() -> ctypes.CDLL:
    lib = build.load("sketch_update")
    fn = lib.sketch_window_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, ctypes.c_float, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def launch(state: torch.Tensor, out: torch.Tensor, sizes: torch.Tensor,
           weights: torch.Tensor, lengths: torch.Tensor,
           decay_totals: torch.Tensor, decay: float, *, bucket_width: int,
           prebucketed: bool) -> None:
    """Enqueue one launch on the current stream. Arguments are checked
    by the caller: contiguous CUDA tensors, float32 (BINS,) state and
    out (which may be the same tensor), int32 (R, N) sizes, float32
    (R, N) weights, int32 (R,) lengths and float32 (R,) decay_totals."""
    rows, n = sizes.shape
    stream = torch.cuda.current_stream(state.device).cuda_stream
    with torch.cuda.device(state.device):
        err = _lib().sketch_window_launch(
            state.data_ptr(), out.data_ptr(), sizes.data_ptr(),
            weights.data_ptr(), lengths.data_ptr(), decay_totals.data_ptr(),
            decay, rows, n, state.shape[0], bucket_width, int(prebucketed),
            stream)
    if err:
        raise RuntimeError(f"sketch_window launch failed: CUDA error {err}")
