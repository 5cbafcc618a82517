"""Launchers of the batched waste-evaluation CUDA kernel.

``csrc/waste_eval.cu`` replaces the TPU kernels
``repro/kernels/waste_eval.py::waste_eval_pallas`` and
``waste_eval_fleet_pallas``: one block per candidate schedule, the row
sorted in shared memory, a lower-bound search per size, and a
fixed-order double sum rounded once to float32. The fleet entry scores
row b against its own histogram with the same per-row loop. The source
note says what bounds it and why. The plain versions are
``kernels/ref.py::waste_eval_ref`` and ``waste_eval_fleet_ref``; the
public, checked entry points are ``kernels/ops.py::waste_eval`` and
``waste_eval_fleet``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_K = 1024          # chunks per row the kernel's shared memory holds


def _lib() -> ctypes.CDLL:
    lib = build.load("waste_eval")
    fn = lib.waste_eval_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def launch(chunk_batch: torch.Tensor, support: torch.Tensor,
           freqs: torch.Tensor, out: torch.Tensor, *, page_size: int) -> None:
    """Enqueue one launch on the current stream. Arguments are checked
    by the caller: contiguous CUDA tensors, int32 (B, K) with
    1 <= K <= MAX_K, int32 (S,), float32 (S,) and float32 (B,) out."""
    b, k = chunk_batch.shape
    stream = torch.cuda.current_stream(chunk_batch.device).cuda_stream
    with torch.cuda.device(chunk_batch.device):
        err = _lib().waste_eval_launch(
            chunk_batch.data_ptr(), support.data_ptr(), freqs.data_ptr(),
            out.data_ptr(), b, k, support.shape[0], page_size, stream)
    if err:
        raise RuntimeError(f"waste_eval launch failed: CUDA error {err}")


def _fleet_lib() -> ctypes.CDLL:
    lib = build.load("waste_eval")
    fn = lib.waste_eval_fleet_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def launch_fleet(chunk_batch: torch.Tensor, supports: torch.Tensor,
                 freqs: torch.Tensor, out: torch.Tensor, *,
                 page_size: int) -> None:
    """Enqueue one fleet launch (row b against histogram b) on the
    current stream. Arguments are checked by the caller: contiguous CUDA
    tensors, int32 (B, K) with 1 <= K <= MAX_K, int32 (B, S), float32
    (B, S) and float32 (B,) out."""
    b, k = chunk_batch.shape
    stream = torch.cuda.current_stream(chunk_batch.device).cuda_stream
    with torch.cuda.device(chunk_batch.device):
        err = _fleet_lib().waste_eval_fleet_launch(
            chunk_batch.data_ptr(), supports.data_ptr(), freqs.data_ptr(),
            out.data_ptr(), b, k, supports.shape[1], page_size, stream)
    if err:
        raise RuntimeError(f"waste_eval_fleet launch failed: CUDA error {err}")
