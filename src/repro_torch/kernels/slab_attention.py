"""Launcher of the decode-attention CUDA kernel.

``csrc/slab_attention.cu`` replaces the TPU kernel
``repro/kernels/slab_attention.py::slab_decode_attention_pallas``:
split-KV flash-decoding of q ``(B, Hq, D)`` over contiguous
``(T, Hkv, D)`` slab pools with GQA. A sequence's live tokens are cut by
position into fixed splits (:func:`split_layout`, from the window
alone); a block streams a split's K and V tiles through shared memory
and writes its float32 online-softmax state (m, l, acc) to scratch, and
a second kernel merges the splits in split order. A sequence's result
does not depend on the batch it is in. The source note says what bounds
it. The plain versions are ``kernels/ref.py::
slab_decode_attention_ref`` and ``slab_decode_attention_window_ref``;
the public, checked entry point is
``kernels/ops.py::slab_decode_attention``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_D = 256   # head dim of the kernel's shared-memory rows
MAX_G = 8     # query heads per kv head
SPLIT_TOKENS = 128  # tokens of a split: four of the kernel's 32-token tiles
MAX_SPLITS = 64     # splits of one sequence (the combine's scratch row)
WORKERS = 8         # blocks sharing a (sequence, kv head)'s splits


def split_layout(max_chunk_tokens: int):
    """``(chunk, n_splits, workers)`` for a window of ``max_chunk_tokens``:
    a sequence's tokens are cut by position into splits of ``chunk``
    tokens (``SPLIT_TOKENS``, or a multiple of it when the window would
    need more than ``MAX_SPLITS``), and ``workers`` blocks take a
    (sequence, kv head)'s splits in turn. It depends on the window alone,
    never on the batch or the lengths, so a sequence's bits do not
    either."""
    splits = -(-max_chunk_tokens // SPLIT_TOKENS)
    chunk = SPLIT_TOKENS * max(1, -(-splits // MAX_SPLITS))
    n_splits = -(-max_chunk_tokens // chunk)
    return chunk, n_splits, max(1, min(n_splits, WORKERS))


def scratch_shapes(b: int, hq: int, d: int, max_chunk_tokens: int):
    """Shapes of the splits' float32 scratch: each split's unnormalized
    output ``(B, Hq, n_splits, D)`` and its running max and sum
    ``(B, Hq, n_splits, 2)``."""
    n_splits = split_layout(max_chunk_tokens)[1]
    return (b, hq, n_splits, d), (b, hq, n_splits, 2)


def _lib() -> ctypes.CDLL:
    lib = build.load("slab_attention")
    fn = lib.slab_decode_attention_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                       ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def launch(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
           starts: torch.Tensor, lens: torch.Tensor, out: torch.Tensor, *,
           max_chunk_tokens: int, sm_scale: float) -> None:
    """Enqueue the split and combine kernels on the current stream.
    Arguments are checked by the caller: contiguous CUDA tensors, float32
    q (B, Hq, D) and out, float32 (T, Hkv, D) pools with Hq = G * Hkv,
    G <= MAX_G, D <= MAX_D, int32 (B,) starts and lens. The splits'
    scratch is allocated here, on the stream's allocator (inside a CUDA
    graph's capture it comes from the graph's pool and stays the
    graph's)."""
    b, hq, d = q.shape
    t, hkv, _ = k_pool.shape
    chunk, n_splits, workers = split_layout(max_chunk_tokens)
    acc_shape, ml_shape = scratch_shapes(b, hq, d, max_chunk_tokens)
    part_acc = torch.empty(acc_shape, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(ml_shape, dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = _lib().slab_decode_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            starts.data_ptr(), lens.data_ptr(), out.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), b, t, hkv, hq // hkv,
            d, max_chunk_tokens, chunk, n_splits, workers, sm_scale, stream)
    if err:
        raise RuntimeError(
            f"slab_decode_attention launch failed: CUDA error {err}")
