"""The decode tick's in-place KV-pool scatters: plain versions and the
CUDA launchers.

``csrc/kv_scatter.cu`` replaces the TPU kernels
``repro/kernels/kv_scatter.py::kv_append_pallas`` (one new KV row per
batch slot) and ``kv_chunk_copy_pallas`` (class-overflow chunk moves,
whole 128-token tiles, in array order). The pool is updated in place;
a skipped slot (``rows < 0``, ``n_tokens == 0``) writes nothing. The
TPU kernels park skipped slots on the pool's last tile, so callers keep
the reserved junk tail (the last ``BLOCK_T`` rows hold no real data):
the offline harness pads its pools for it.

The chunk copy runs the moves one after another: a later move may
overwrite a range an earlier move read. The CUDA version is one launch
of one thread-block cluster that walks the moves in order with a
cluster barrier after each (see the source note). The plain
versions restate the reference's ``kv_append_ref`` and the sequential
``kv_chunk_copy_ref``; the public, checked entry points are
``kernels/ops.py::kv_append`` and ``kv_chunk_copy``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

BLOCK_T = 128     # copy tile, tokens; matches the pool's ALIGN
MAX_MOVES = 1024  # moves per call the kernel's shared memory holds


def kv_append_ref(pool: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``pool[rows[b]] = vals[b]`` for every ``rows[b] >= 0``, in place;
    returns ``pool``. Rows past the pool clamp to its last row; a
    skipped slot re-writes the last row with its own content (the
    reference's junk-row parking, a no-op)."""
    t = pool.shape[0]
    rows = rows.to(torch.int64)
    valid = rows >= 0
    idx = torch.where(valid, rows, t - 1).clamp(0, t - 1)
    upd = torch.where(valid[:, None, None], vals.to(pool.dtype), pool[idx])
    pool[idx] = upd
    return pool


def kv_chunk_copy_ref(pool: torch.Tensor, src_starts: torch.Tensor,
                      dst_starts: torch.Tensor, n_tokens: torch.Tensor, *,
                      max_copy_tokens: int,
                      block_t: int = BLOCK_T) -> torch.Tensor:
    """Sequential moves in array order, in place; returns ``pool``.
    Move i copies ``n_tokens[i]`` rounded up to whole ``block_t`` tiles
    (at most ``max_copy_tokens``) from ``src_starts[i]`` to
    ``dst_starts[i]``, both clamped into ``[0, T - max_copy_tokens]``;
    untouched rows keep their content."""
    t = pool.shape[0]
    hi = t - max_copy_tokens
    pos = torch.arange(max_copy_tokens, device=pool.device)
    n = n_tokens.to(torch.int64)
    tiled = torch.div(n + block_t - 1, block_t,
                      rounding_mode="floor") * block_t
    for i in range(src_starts.shape[0]):
        src = src_starts[i].to(torch.int64).clamp(0, hi) + pos
        dst = dst_starts[i].to(torch.int64).clamp(0, hi) + pos
        blk = pool.index_select(0, src)
        cur = pool.index_select(0, dst)
        mask = (pos < tiled[i])[:, None, None]
        pool.index_copy_(0, dst, torch.where(mask, blk, cur))
    return pool


def _lib() -> ctypes.CDLL:
    lib = build.load("kv_scatter")
    if lib.kv_append_launch.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kv_append_launch.argtypes = [p, p, p, i, i, ll, p]
        lib.kv_append_launch.restype = ctypes.c_int
        lib.kv_chunk_copy_launch.argtypes = [p, p, p, p, p, i, i, i, ll, p]
        lib.kv_chunk_copy_launch.restype = ctypes.c_int
    return lib


def launch_append(pool: torch.Tensor, rows: torch.Tensor,
                  vals: torch.Tensor) -> None:
    """Enqueue the append on the current stream. Arguments are checked
    by the caller: contiguous CUDA tensors, float32 (T, H, D) pool, int32
    (B,) rows, float32 (B, H, D) vals."""
    t, h, d = pool.shape
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    with torch.cuda.device(pool.device):
        err = _lib().kv_append_launch(pool.data_ptr(), rows.data_ptr(),
                                      vals.data_ptr(), rows.shape[0], t,
                                      h * d, stream)
    if err:
        raise RuntimeError(f"kv_append launch failed: CUDA error {err}")


def launch_chunk_copy(pool: torch.Tensor, scratch: torch.Tensor,
                      src_starts: torch.Tensor, dst_starts: torch.Tensor,
                      n_tokens: torch.Tensor, *, max_copy_tokens: int) -> None:
    """Enqueue the chunk-copy launch on the current stream. Arguments
    are checked by the caller: contiguous CUDA tensors, float32
    (T, H, D) pool, float32 (max_copy_tokens, H, D) scratch, int32
    (M,) descriptors with M <= MAX_MOVES, max_copy_tokens <= T."""
    t, h, d = pool.shape
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    with torch.cuda.device(pool.device):
        err = _lib().kv_chunk_copy_launch(
            pool.data_ptr(), scratch.data_ptr(), src_starts.data_ptr(),
            dst_starts.data_ptr(), n_tokens.data_ptr(), src_starts.shape[0],
            t, max_copy_tokens, h * d, stream)
    if err:
        raise RuntimeError(f"kv_chunk_copy launch failed: CUDA error {err}")
