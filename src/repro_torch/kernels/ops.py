"""Public wrappers of the port's CUDA kernels.

Each wrapper checks its arguments (device, dtype, shape, contiguity) and
raises on anything else. For CUDA tensors it launches the hand-written
kernel and counts the launch in its ``n_launches`` attribute; for CPU
tensors it runs the kernel's plain PyTorch version, which is how the
tests run the port on a machine without a card. There is no fallback
from a failed launch: it raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.distribution import PAGE_SIZE
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sketch_update as _sketch
from repro_torch.kernels import waste_eval as _waste

_INT32_MAX = (1 << 31) - 1


def resolve_device(torch_device) -> torch.device:
    """``torch_device`` as a ``torch.device``; raises when it names CUDA
    on a machine without it (nothing silently runs on the CPU)."""
    dev = torch.device(torch_device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"torch_device={str(torch_device)!r} but CUDA is not "
                "available; pass torch_device='cpu' to run the plain "
                "PyTorch versions on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported torch_device {str(torch_device)!r}")
    return dev


def _check(t, name: str, dtype: torch.dtype, ndim: int,
           device: Optional[torch.device] = None) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} is on unsupported device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def waste_eval(chunk_batch: torch.Tensor, support: torch.Tensor,
               freqs: torch.Tensor, *,
               page_size: int = PAGE_SIZE) -> torch.Tensor:
    """(B, K) int32 candidate schedules x (S,) int32 support x (S,)
    float32 freqs -> (B,) float32 waste. Rows need not be sorted."""
    _check(chunk_batch, "chunk_batch", torch.int32, 2)
    dev = chunk_batch.device
    _check(support, "support", torch.int32, 1, dev)
    _check(freqs, "freqs", torch.float32, 1, dev)
    if support.shape != freqs.shape:
        raise ValueError(f"support {tuple(support.shape)} and freqs "
                         f"{tuple(freqs.shape)} differ in shape")
    b, k = chunk_batch.shape
    if not 1 <= k <= _waste.MAX_K:
        raise ValueError(f"need 1 <= K <= {_waste.MAX_K} chunks per row, "
                         f"got {k}")
    if not 1 <= page_size <= _INT32_MAX:
        raise ValueError(f"page_size out of range: {page_size}")
    if dev.type == "cpu":
        return _ref.waste_eval_ref(chunk_batch, support, freqs,
                                   page_size=page_size)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    _waste.launch(chunk_batch, support, freqs, out, page_size=page_size)
    waste_eval.n_launches += 1
    return out


waste_eval.n_launches = 0


def _check_out(out, state: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty_like(state)
    _check(out, "out", torch.float32, 1, state.device)
    if out.shape != state.shape:
        raise ValueError(f"out {tuple(out.shape)} must match state "
                         f"{tuple(state.shape)}")
    return out


def sketch_window(state: torch.Tensor, sizes: torch.Tensor,
                  weights: torch.Tensor, lengths: torch.Tensor, decay: float,
                  decay_totals: torch.Tensor, *, bucket_width: int = 1,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold R observe batches of raw sizes into the (BINS,) float32
    sketch in ONE launch (see ``kernels/sketch_update.py``): int32
    (R, N) sizes, float32 (R, N) weights, int32 (R,) live lengths,
    float32 (R,) per-row state decays. Lengths are clamped into
    ``[0, N]`` (checking them would need a readback). Returns the new
    state, written to ``out`` when given (``out=state`` updates in
    place)."""
    _check(state, "state", torch.float32, 1)
    dev = state.device
    _check(sizes, "sizes", torch.int32, 2, dev)
    _check(weights, "weights", torch.float32, 2, dev)
    _check(lengths, "lengths", torch.int32, 1, dev)
    _check(decay_totals, "decay_totals", torch.float32, 1, dev)
    rows = sizes.shape[0]
    if weights.shape != sizes.shape or lengths.shape != (rows,) \
            or decay_totals.shape != (rows,):
        raise ValueError("sizes/weights must share an (R, N) shape and "
                         "lengths/decay_totals must be (R,)")
    if not 1 <= bucket_width <= _INT32_MAX:
        raise ValueError(f"bucket_width out of range: {bucket_width}")
    if state.shape[0] < 1:
        raise ValueError("state must have at least one bin")
    out = _check_out(out, state)
    if dev.type == "cpu":
        return out.copy_(_sketch.sketch_window_ref(
            state, sizes, weights, lengths, decay, decay_totals,
            bucket_width=bucket_width))
    _sketch.launch(state, out, sizes, weights, lengths, decay_totals,
                   float(decay), bucket_width=bucket_width, prebucketed=False)
    sketch_window.n_launches += 1
    return out


sketch_window.n_launches = 0


def sketch_update(state: torch.Tensor, bucket_idx: torch.Tensor,
                  weights: torch.Tensor, decay_total: float, *,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(BINS,) float32 state x (N,) int32 bucket ids x (N,) float32
    already-decayed weights -> ``state * decay_total`` plus each id's
    weights (ids outside ``[0, BINS)`` skipped), in one launch of the
    sketch kernel."""
    _check(state, "state", torch.float32, 1)
    dev = state.device
    _check(bucket_idx, "bucket_idx", torch.int32, 1, dev)
    _check(weights, "weights", torch.float32, 1, dev)
    if weights.shape != bucket_idx.shape:
        raise ValueError("bucket_idx and weights must share a shape")
    if state.shape[0] < 1:
        raise ValueError("state must have at least one bin")
    out = _check_out(out, state)
    if dev.type == "cpu":
        return out.copy_(_sketch.sketch_update_ref(state, bucket_idx,
                                                   weights, decay_total))
    n = bucket_idx.shape[0]
    lengths = torch.full((1,), n, dtype=torch.int32, device=dev)
    totals = torch.full((1,), decay_total, dtype=torch.float32, device=dev)
    _sketch.launch(state, out, bucket_idx.view(1, n), weights.view(1, n),
                   lengths, totals, 1.0, bucket_width=1, prebucketed=True)
    sketch_update.n_launches += 1
    return out


sketch_update.n_launches = 0
