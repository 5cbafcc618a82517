"""The serving slice's kernels — the KV-pool scatters and decode
attention — as the port runs them on CPU tensors (their plain versions),
against the reference's Pallas kernels in interpret mode and its
oracles.

Tolerances: the scatters move bits, so they must be bit-identical;
attention within rtol/atol 1e-5 of the reference's oracles (float32
softmax and sums in different orders), and within the reference's own
kernel tolerance (2e-5) of its interpret-mode kernel.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.kv_scatter import (kv_append_pallas,  # noqa: E402
                                      kv_append_ref, kv_chunk_copy_pallas,
                                      kv_chunk_copy_ref)
from repro.kernels.ref import (slab_decode_attention_ref,  # noqa: E402
                               slab_decode_attention_window_ref)
from repro.kernels.slab_attention import \
    slab_decode_attention_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.kv_scatter import BLOCK_T  # noqa: E402

H, D = 2, 8


def _pool(t, seed=0, h=H, d=D):
    return np.random.default_rng(seed).normal(size=(t, h, d)).astype(
        np.float32)


def _i32(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.int32)


# -- kv_append ----------------------------------------------------------------

@pytest.mark.parametrize("rows", [
    [3, -1, 200, 511 - BLOCK_T, -1, 0],    # mixed skips
    [10, 20],
    [-1, -1, -1, -1],                      # all skipped: identity
    [0, 511, 700],                         # past the pool: clamps to T-1
])
def test_kv_append_matches_reference(rows):
    pool = _pool(512)
    vals = _pool(len(rows), seed=1)
    r = np.asarray(rows, np.int32)
    pallas = np.asarray(kv_append_pallas(jnp.asarray(pool), jnp.asarray(r),
                                         jnp.asarray(vals), interpret=True))
    oracle = np.asarray(kv_append_ref(jnp.asarray(pool), jnp.asarray(r),
                                      jnp.asarray(vals)))
    port = torch.from_numpy(pool.copy())
    out = ops.kv_append(port, _i32(r), torch.from_numpy(vals))
    assert out is port                                # in place
    np.testing.assert_array_equal(port.numpy(), oracle)
    if not (r >= 511).any():   # the reference kernel parks skips on T-1
        np.testing.assert_array_equal(port.numpy(), pallas)


def test_kv_append_checks_arguments():
    pool = torch.zeros((8, H, D))
    with pytest.raises(ValueError):
        ops.kv_append(pool, _i32([1, 2]), torch.zeros((3, H, D)))
    with pytest.raises(TypeError):
        ops.kv_append(pool, torch.tensor([1]), torch.zeros((1, H, D)))


# -- kv_chunk_copy ------------------------------------------------------------

CHUNK_CASES = {
    # name: (pool tiles, src, dst, n_tokens, max_copy_tokens)
    "two_moves": (8, [0, 2 * BLOCK_T], [4 * BLOCK_T, 6 * BLOCK_T],
                  [2 * BLOCK_T, BLOCK_T], 2 * BLOCK_T),
    "zero_len": (4, [0], [2 * BLOCK_T], [0], 2 * BLOCK_T),
    "tile_rounding": (4, [0], [2 * BLOCK_T], [5], 2 * BLOCK_T),
    # move 1 writes the range move 0 read (class-overflow WAR)
    "war": (6, [0, 3 * BLOCK_T], [2 * BLOCK_T, 0], [BLOCK_T, BLOCK_T],
            BLOCK_T),
    "junk_tile": (6, [0, BLOCK_T], [2 * BLOCK_T, 3 * BLOCK_T],
                  [BLOCK_T, 0], 4 * BLOCK_T),
    # move 1 reads what move 0 wrote, move 2 rewrites a row move 1 wrote
    "raw_waw": (8, [0, 2 * BLOCK_T, 5 * BLOCK_T],
                [2 * BLOCK_T, 4 * BLOCK_T, 4 * BLOCK_T],
                [BLOCK_T, 2 * BLOCK_T, BLOCK_T], 2 * BLOCK_T),
    # a move overlapping itself reads before it writes
    "self_overlap": (6, [0], [BLOCK_T], [3 * BLOCK_T], 3 * BLOCK_T),
    "negative_len": (4, [0, BLOCK_T], [2 * BLOCK_T, 3 * BLOCK_T],
                     [-200, 3], BLOCK_T),
}


@pytest.mark.parametrize("case", sorted(CHUNK_CASES))
def test_kv_chunk_copy_matches_reference(case):
    tiles, src, dst, n, w = CHUNK_CASES[case]
    pool = _pool(tiles * BLOCK_T, seed=tiles)
    args = [np.asarray(a, np.int32) for a in (src, dst, n)]
    oracle = np.asarray(kv_chunk_copy_ref(
        jnp.asarray(pool), *map(jnp.asarray, args), max_copy_tokens=w))
    port = torch.from_numpy(pool.copy())
    out = ops.kv_chunk_copy(port, *map(_i32, args), max_copy_tokens=w)
    assert out is port
    np.testing.assert_array_equal(port.numpy(), oracle)
    if case != "raw_waw":
        # the reference's own kernel, run in interpret mode, departs from
        # its sequential oracle when a move reads what an earlier move of
        # the call wrote; the port follows the oracle
        pallas = np.asarray(kv_chunk_copy_pallas(
            jnp.asarray(pool), *map(jnp.asarray, args), max_copy_tokens=w,
            interpret=True))
        np.testing.assert_array_equal(port.numpy(), pallas)
    if case == "war":
        np.testing.assert_array_equal(port.numpy()[2 * BLOCK_T:3 * BLOCK_T],
                                      pool[:BLOCK_T])
        np.testing.assert_array_equal(port.numpy()[:BLOCK_T],
                                      pool[3 * BLOCK_T:4 * BLOCK_T])


def test_kv_chunk_copy_checks_arguments():
    pool = torch.zeros((2 * BLOCK_T, H, D))
    with pytest.raises(ValueError):                 # not whole tiles
        ops.kv_chunk_copy(torch.zeros((BLOCK_T + 1, H, D)), _i32([0]),
                          _i32([0]), _i32([1]), max_copy_tokens=BLOCK_T)
    with pytest.raises(ValueError):                 # window past the pool
        ops.kv_chunk_copy(pool, _i32([0]), _i32([0]), _i32([1]),
                          max_copy_tokens=3 * BLOCK_T)
    with pytest.raises(ValueError):
        ops.kv_chunk_copy(pool, _i32([0, 1]), _i32([0]), _i32([1]),
                          max_copy_tokens=BLOCK_T)


# -- decode attention -----------------------------------------------------------

def _attention_case(lens, chunk, g, seed=0, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    b = len(lens)
    t = b * chunk + BLOCK_T            # junk tail past the chunks
    q = rng.normal(size=(b, hkv * g, d)).astype(np.float32)
    k = rng.normal(size=(t, hkv, d)).astype(np.float32)
    v = rng.normal(size=(t, hkv, d)).astype(np.float32)
    starts = (np.arange(b) * chunk).astype(np.int32)
    return q, k, v, starts, np.asarray(lens, np.int32)


@pytest.mark.parametrize("lens", [
    [0, 0, 0, 0],                      # all-empty batch
    [0, 1, BLOCK_T, BLOCK_T + 1],      # straddling the first tile edge
    [2 * BLOCK_T, 2 * BLOCK_T - 1, 17, 0],
    [256, 256, 256, 256],              # len == max_chunk_tokens
    [300, 5, 127, 2],                  # len past the window: clipped
])
@pytest.mark.parametrize("g", [1, 4])
def test_attention_matches_reference(lens, g):
    chunk = 2 * BLOCK_T
    q, k, v, starts, ln = _attention_case(lens, chunk, g)
    ln_win = np.minimum(ln, chunk)     # the full-pool oracle has no window
    jargs = tuple(map(jnp.asarray, (q, k, v, starts)))
    full = np.asarray(slab_decode_attention_ref(*jargs,
                                                jnp.asarray(ln_win)))
    win = np.asarray(slab_decode_attention_window_ref(
        *jargs, jnp.asarray(ln), max_chunk_tokens=chunk))
    pallas = np.asarray(slab_decode_attention_pallas(
        *jargs, jnp.asarray(ln), max_chunk_tokens=chunk, interpret=True))
    targs = (torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
             _i32(starts))
    got = ops.slab_decode_attention(*targs, _i32(ln), max_chunk_tokens=chunk)
    assert got.shape == q.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), win, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), full, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
    port_full = tref.slab_decode_attention_ref(*targs, _i32(ln_win))
    np.testing.assert_allclose(port_full.numpy(), full, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got.numpy()[ln == 0], 0.0)


def test_attention_checks_arguments():
    q = torch.zeros((2, 3, 16))
    pool = torch.zeros((BLOCK_T, 2, 16))
    with pytest.raises(ValueError):                 # Hq not G * Hkv
        ops.slab_decode_attention(q, pool, pool, _i32([0, 0]), _i32([1, 1]),
                                  max_chunk_tokens=BLOCK_T)
    with pytest.raises(ValueError):                 # G > 8
        ops.slab_decode_attention(torch.zeros((2, 18, 16)), pool, pool,
                                  _i32([0, 0]), _i32([1, 1]),
                                  max_chunk_tokens=BLOCK_T)
    with pytest.raises(ValueError):                 # D > 256
        big = torch.zeros((BLOCK_T, 1, 512))
        ops.slab_decode_attention(torch.zeros((1, 1, 512)), big, big,
                                  _i32([0]), _i32([1]),
                                  max_chunk_tokens=BLOCK_T)


@pytest.mark.parametrize("w", [0, 1, 63, 64, 65, 1024, 4096, 4097, 70_000])
def test_attention_split_layout(w):
    """The decode kernel's splits depend on the window alone: whole
    32-token tiles, at most MAX_SPLITS of them covering the window, the
    64-token split whenever it fits, and scratch rows that do not depend
    on the batch."""
    from repro_torch.kernels import slab_attention as sa
    chunk, n_splits, workers = sa.split_layout(w)
    assert chunk % 32 == 0 and chunk % sa.SPLIT_TOKENS == 0
    assert 0 <= n_splits <= sa.MAX_SPLITS
    assert n_splits * chunk >= w and (n_splits - 1) * chunk < max(w, 1)
    if w <= sa.SPLIT_TOKENS * sa.MAX_SPLITS:
        assert chunk == sa.SPLIT_TOKENS
    assert 1 <= workers <= sa.WORKERS and workers <= max(n_splits, 1)
    for b in (1, 64, 128):
        acc, ml = sa.scratch_shapes(b, 32, 128, w)
        assert acc == (b, 32, n_splits, 128) and ml == (b, 32, n_splits, 2)


@pytest.mark.parametrize("g", [1, 2])
def test_attention_split_edges_match_reference(g):
    """Lengths at the kernel's split edges (0, 1, split - 1, split,
    split + 1, two splits and the window) on the plain version against
    the reference's window oracle and its interpret-mode kernel."""
    chunk = 4 * BLOCK_T
    lens = [0, 1, 63, 64, 65, 128, 129, chunk]
    q, k, v, starts, ln = _attention_case(lens, chunk, g, seed=5)
    jargs = tuple(map(jnp.asarray, (q, k, v, starts)))
    win = np.asarray(slab_decode_attention_window_ref(
        *jargs, jnp.asarray(ln), max_chunk_tokens=chunk))
    pallas = np.asarray(slab_decode_attention_pallas(
        *jargs, jnp.asarray(ln), max_chunk_tokens=chunk, interpret=True))
    got = ops.slab_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        _i32(starts), _i32(ln), max_chunk_tokens=chunk)
    np.testing.assert_allclose(got.numpy(), win, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-5, atol=2e-5)
