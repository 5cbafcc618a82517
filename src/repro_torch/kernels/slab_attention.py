"""Launcher of the decode-attention CUDA kernel.

``csrc/slab_attention.cu`` replaces the TPU kernel
``repro/kernels/slab_attention.py::slab_decode_attention_pallas``:
flash-decoding of q ``(B, Hq, D)`` over contiguous ``(T, Hkv, D)`` slab
pools with GQA, one block per (sequence, kv head) carrying the online
softmax state in float32 over the sequence's live tokens. A sequence's
result does not depend on the batch it is in. The source note says what
bounds it. The plain versions are ``kernels/ref.py::
slab_decode_attention_ref`` and ``slab_decode_attention_window_ref``;
the public, checked entry point is
``kernels/ops.py::slab_decode_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_D = 256   # head dim the kernel's registers hold (8 values a lane)
MAX_G = 8     # query heads per kv head


def _lib() -> ctypes.CDLL:
    lib = build.load("slab_attention")
    fn = lib.slab_decode_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def launch(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
           starts: torch.Tensor, lens: torch.Tensor, out: torch.Tensor, *,
           max_chunk_tokens: int, sm_scale: float) -> None:
    """Enqueue one launch on the current stream. Arguments are checked
    by the caller: contiguous CUDA tensors, float32 q (B, Hq, D) and out,
    float32 (T, Hkv, D) pools with Hq = G * Hkv, G <= MAX_G, D <= MAX_D,
    int32 (B,) starts and lens."""
    b, hq, d = q.shape
    t, hkv, _ = k_pool.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().slab_decode_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            starts.data_ptr(), lens.data_ptr(), out.data_ptr(), b, t, hkv,
            hq // hkv, d, max_chunk_tokens, sm_scale, stream)
    if err:
        raise RuntimeError(
            f"slab_decode_attention launch failed: CUDA error {err}")
