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
from repro_torch.kernels import kv_scatter as _kv
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import sketch_update as _sketch
from repro_torch.kernels import slab_attention as _attn
from repro_torch.kernels import waste_eval as _waste

_INT32_MAX = (1 << 31) - 1
_GRID_Y_MAX = 65535   # batch slots ride on the grid's y axis


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


def waste_eval_fleet(chunk_batch: torch.Tensor, supports: torch.Tensor,
                     freqs: torch.Tensor, *,
                     page_size: int = PAGE_SIZE) -> torch.Tensor:
    """(B, K) int32 schedules x (B, S) int32 PER-ROW support x (B, S)
    float32 freqs -> (B,) float32 waste: row b against histogram b, in
    one launch (every pending tenant's frontier at once). Pad histograms
    with size-0/freq-0 entries; a replicated row scores bit for bit as
    :func:`waste_eval` does."""
    _check(chunk_batch, "chunk_batch", torch.int32, 2)
    dev = chunk_batch.device
    _check(supports, "supports", torch.int32, 2, dev)
    _check(freqs, "freqs", torch.float32, 2, dev)
    b, k = chunk_batch.shape
    if supports.shape != freqs.shape or supports.shape[0] != b:
        raise ValueError(f"supports {tuple(supports.shape)} and freqs "
                         f"{tuple(freqs.shape)} must both be (B={b}, S)")
    if not 1 <= k <= _waste.MAX_K:
        raise ValueError(f"need 1 <= K <= {_waste.MAX_K} chunks per row, "
                         f"got {k}")
    if not 1 <= page_size <= _INT32_MAX:
        raise ValueError(f"page_size out of range: {page_size}")
    if dev.type == "cpu":
        return _ref.waste_eval_fleet_ref(chunk_batch, supports, freqs,
                                         page_size=page_size)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    _waste.launch_fleet(chunk_batch, supports, freqs, out,
                        page_size=page_size)
    waste_eval_fleet.n_launches += 1
    return out


waste_eval_fleet.n_launches = 0


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


def _check_pool(pool: torch.Tensor, name: str = "pool") -> None:
    _check(pool, name, torch.float32, 3)
    if pool.shape[0] < 1:
        raise ValueError(f"{name} must have at least one row")


def kv_append(pool: torch.Tensor, rows: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """In place: ``pool[rows[b]] = vals[b]`` for every ``rows[b] >= 0``
    of a float32 (T, H, D) pool, int32 (B,) rows (-1 skips the slot) and
    float32 (B, H, D) vals. Live rows must be distinct. Returns
    ``pool``."""
    _check_pool(pool)
    dev = pool.device
    _check(rows, "rows", torch.int32, 1, dev)
    _check(vals, "vals", torch.float32, 3, dev)
    b = rows.shape[0]
    if vals.shape != (b,) + tuple(pool.shape[1:]):
        raise ValueError(f"vals {tuple(vals.shape)} must be (B={b}, "
                         f"{pool.shape[1]}, {pool.shape[2]})")
    if b > _GRID_Y_MAX:
        raise ValueError(f"at most {_GRID_Y_MAX} slots per call, got {b}")
    if dev.type == "cpu":
        return _kv.kv_append_ref(pool, rows, vals)
    _kv.launch_append(pool, rows, vals)
    kv_append.n_launches += 1
    return pool


kv_append.n_launches = 0


def kv_chunk_copy(pool: torch.Tensor, src_starts: torch.Tensor,
                  dst_starts: torch.Tensor, n_tokens: torch.Tensor, *,
                  max_copy_tokens: int) -> torch.Tensor:
    """In place: M range moves of whole ``BLOCK_T``-token tiles inside a
    float32 (T, H, D) pool, as if run one after another in array order
    (a later move may overwrite what an earlier one read). Int32 (M,)
    descriptors: move i copies ``n_tokens[i]`` rounded up to tiles (at
    most ``max_copy_tokens``; 0 skips) from ``src_starts[i]`` to
    ``dst_starts[i]``, both clamped into ``[0, T - max_copy_tokens]``.
    T must be a multiple of ``BLOCK_T``. On the card one launch runs the
    moves in order, staging a move whose ranges overlap through a
    (max_copy_tokens, H, D) scratch tensor. Returns ``pool``."""
    _check_pool(pool)
    dev = pool.device
    for name, t in (("src_starts", src_starts), ("dst_starts", dst_starts),
                    ("n_tokens", n_tokens)):
        _check(t, name, torch.int32, 1, dev)
    m = src_starts.shape[0]
    if dst_starts.shape != (m,) or n_tokens.shape != (m,):
        raise ValueError("src_starts, dst_starts and n_tokens must share "
                         "an (M,) shape")
    if m > _kv.MAX_MOVES:
        raise ValueError(f"at most {_kv.MAX_MOVES} moves per call, got {m}")
    t = pool.shape[0]
    if t % _kv.BLOCK_T:
        raise ValueError(f"pool rows {t} not a multiple of {_kv.BLOCK_T}")
    if not 1 <= max_copy_tokens <= t:
        raise ValueError(f"max_copy_tokens must be in [1, {t}], got "
                         f"{max_copy_tokens}")
    if dev.type == "cpu":
        return _kv.kv_chunk_copy_ref(pool, src_starts, dst_starts, n_tokens,
                                     max_copy_tokens=max_copy_tokens)
    scratch = torch.empty((max_copy_tokens,) + tuple(pool.shape[1:]),
                          dtype=torch.float32, device=dev)
    _kv.launch_chunk_copy(pool, scratch, src_starts, dst_starts, n_tokens,
                          max_copy_tokens=max_copy_tokens)
    kv_chunk_copy.n_launches += 1
    return pool


kv_chunk_copy.n_launches = 0


def slab_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, starts: torch.Tensor,
                          lens: torch.Tensor, *, max_chunk_tokens: int,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Flash-decoding over a contiguous slab KV pool: float32 q
    (B, Hq, D), float32 (T, Hkv, D) pools, int32 (B,) starts and lens ->
    (B, Hq, D). Sequence b attends over pool rows ``starts[b] + w`` for
    ``w < min(lens[b], max_chunk_tokens)``; GQA with G = Hq / Hkv <= 8,
    D <= 256. An empty sequence gives 0."""
    _check(q, "q", torch.float32, 3)
    dev = q.device
    _check_pool(k_pool, "k_pool")
    _check(v_pool, "v_pool", torch.float32, 3, dev)
    _check(starts, "starts", torch.int32, 1, dev)
    _check(lens, "lens", torch.int32, 1, dev)
    if k_pool.device != dev:
        raise ValueError(f"k_pool is on {k_pool.device}, expected {dev}")
    b, hq, d = q.shape
    t, hkv, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d:
        raise ValueError(f"pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} must be (T, Hkv, D={d})")
    if starts.shape != (b,) or lens.shape != (b,):
        raise ValueError(f"starts and lens must be (B={b},)")
    if hkv < 1 or hq % hkv or not 1 <= hq // hkv <= _attn.MAX_G:
        raise ValueError(f"Hq={hq} must be G * Hkv (Hkv={hkv}) with "
                         f"1 <= G <= {_attn.MAX_G}")
    if not 1 <= d <= _attn.MAX_D:
        raise ValueError(f"need 1 <= D <= {_attn.MAX_D}, got {d}")
    if b > _GRID_Y_MAX:
        raise ValueError(f"at most {_GRID_Y_MAX} sequences per call")
    if not 0 <= max_chunk_tokens <= _INT32_MAX:
        raise ValueError(f"max_chunk_tokens out of range: "
                         f"{max_chunk_tokens}")
    if sm_scale is None:
        sm_scale = 1.0 / (d ** 0.5)
    if dev.type == "cpu":
        return _ref.slab_decode_attention_window_ref(
            q, k_pool, v_pool, starts, lens,
            max_chunk_tokens=max_chunk_tokens, sm_scale=sm_scale)
    out = torch.empty_like(q)
    _attn.launch(q, k_pool, v_pool, starts, lens, out,
                 max_chunk_tokens=max_chunk_tokens, sm_scale=sm_scale)
    slab_decode_attention.n_launches += 1
    return out


slab_decode_attention.n_launches = 0
