"""The port's waste objective and waste_eval kernel contract against the
reference: numpy code bit-identical, float32 totals within rtol 1e-6
(the reference kernel test's own tolerance; torch and XLA sum float32 in
different orders, so the last bit may differ)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.core.waste as rw  # noqa: E402
import repro_torch.core.waste as tw  # noqa: E402
from repro.kernels.waste_eval import waste_eval_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import waste_eval_ref  # noqa: E402

PAGE = 4096
CPU = torch.device("cpu")


def _histogram(seed: int, s: int, hi: int):
    rng = np.random.default_rng(seed)
    support = np.sort(rng.choice(hi, size=s, replace=False)) + 1
    return support.astype(np.int64), rng.integers(1, 500, size=s)


def _t(x, dtype):
    return torch.as_tensor(np.asarray(x), dtype=dtype)


@pytest.mark.parametrize("page_size", [PAGE, 1 << 20])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_exact_objectives_identical(seed, page_size):
    support, freqs = _histogram(seed, 300, 3 * page_size)
    rng = np.random.default_rng(seed + 10)
    chunks = rng.integers(48, 2 * page_size, size=7)
    for name in ("waste_exact", "per_class_waste_exact",
                 "utilization_exact", "default_waste_fraction"):
        want = getattr(rw, name)(chunks, support, freqs, page_size=page_size)
        got = getattr(tw, name)(chunks, support, freqs, page_size=page_size)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(
        tw.uncovered_charge(support, page_size=page_size),
        rw.uncovered_charge(support, page_size=page_size))


@pytest.mark.parametrize("b,k,s", [(1, 1, 1), (7, 3, 100), (33, 8, 700),
                                   (120, 6, 257)])
def test_waste_batch_torch_matches_jax(b, k, s):
    support, freqs = _histogram(b + k + s, s, 20_000)
    batch = np.random.default_rng(s).integers(1, 25_000, size=(b, k))
    want = np.asarray(rw.waste_batch_jax(
        jnp.asarray(batch, jnp.int32), jnp.asarray(support, jnp.int32),
        jnp.asarray(freqs, jnp.float32)))
    got = tw.waste_batch_torch(_t(batch, torch.int32),
                               _t(support, torch.int32),
                               _t(freqs, torch.float32)).numpy()
    assert got.dtype == np.float32 and got.shape == (b,)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    one = tw.waste_torch(_t(batch[0], torch.int32), _t(support, torch.int32),
                         _t(freqs, torch.float32))
    np.testing.assert_allclose(float(one), float(rw.waste_jax(
        jnp.asarray(batch[0], jnp.int32), jnp.asarray(support, jnp.int32),
        jnp.asarray(freqs, jnp.float32))), rtol=1e-6)


def test_waste_batch_torch_is_exact_on_integer_freqs():
    """float64 sums of integer terms are exact: the float32 result is the
    exact total rounded once (what the CUDA kernel computes too)."""
    support, freqs = _histogram(4, 400, 3000)
    batch = np.random.default_rng(4).integers(48, 3100, size=(9, 5))
    got = tw.waste_batch_torch(_t(batch, torch.int32),
                               _t(support, torch.int32),
                               _t(freqs, torch.float32)).numpy()
    want = [np.float32(rw.waste_exact(r, support, freqs)) for r in batch]
    np.testing.assert_array_equal(got, np.asarray(want, dtype=np.float32))


@pytest.mark.parametrize("b,k,s", [(1, 1, 1), (7, 3, 100), (9, 8, 700),
                                   (3, 45, 513)])
def test_waste_eval_ref_matches_pallas_interpret(b, k, s):
    """B not a multiple of BLOCK_B (8), S not a multiple of BLOCK_S (512)."""
    support, freqs = _histogram(b * 100 + k + s, s, 20_000)
    batch = np.random.default_rng(k).integers(1, 25_000, size=(b, k))
    want = np.asarray(waste_eval_pallas(
        jnp.asarray(batch, jnp.int32), jnp.asarray(support, jnp.int32),
        jnp.asarray(freqs, jnp.float32), interpret=True))
    got = waste_eval_ref(_t(batch, torch.int32), _t(support, torch.int32),
                         _t(freqs, torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_waste_eval_straddling_page_size_matches_reference():
    """Sizes straddling the page size: the port's plain kernel version,
    the reference's Pallas kernel and the numpy oracle agree for covering
    and non-covering schedules alike."""
    sizes = np.array([PAGE - 1, PAGE, PAGE + 1, 2 * PAGE - 5, 2 * PAGE,
                      2 * PAGE + 3, 5 * PAGE + 11] * 3)
    support, freqs = np.unique(sizes, return_counts=True)
    batch = np.array([[64, 128, 256, 512],
                      [PAGE, 2 * PAGE, 4 * PAGE, 8 * PAGE],
                      [6 * PAGE] * 4])
    got = ops.waste_eval(_t(batch, torch.int32), _t(support, torch.int32),
                         _t(freqs, torch.float32), page_size=PAGE).numpy()
    want = np.asarray(waste_eval_pallas(
        jnp.asarray(batch, jnp.int32), jnp.asarray(support, jnp.int32),
        jnp.asarray(freqs, jnp.float32), page_size=PAGE, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for i, row in enumerate(batch):
        assert got[i] == rw.waste_exact(row, support, freqs, page_size=PAGE)


def test_waste_eval_cpu_runs_plain_version_and_counts_no_launch():
    support, freqs = _histogram(5, 50, 2000)
    batch = _t([[300, 900, 2100], [2100, 300, 900]], torch.int32)
    before = ops.waste_eval.n_launches
    got = ops.waste_eval(batch, _t(support, torch.int32),
                         _t(freqs, torch.float32))
    assert ops.waste_eval.n_launches == before
    assert got[0] == got[1]                     # rows need not be sorted
    assert torch.equal(got, waste_eval_ref(batch, _t(support, torch.int32),
                                           _t(freqs, torch.float32)))


def test_waste_eval_rejects_bad_arguments():
    sup = _t([10, 20], torch.int32)
    frq = _t([1.0, 2.0], torch.float32)
    good = _t([[16, 32]], torch.int32)
    with pytest.raises(TypeError):
        ops.waste_eval(good.to(torch.int64), sup, frq)
    with pytest.raises(TypeError):
        ops.waste_eval(good, sup, frq.to(torch.float64))
    with pytest.raises(ValueError):
        ops.waste_eval(_t([[16, 32, 64, 128]], torch.int32)[:, ::2], sup,
                       frq)                      # not contiguous
    with pytest.raises(ValueError):
        ops.waste_eval(torch.zeros((1, 1025), dtype=torch.int32), sup, frq)
    with pytest.raises(ValueError):
        ops.waste_eval(good, sup, _t([1.0], torch.float32))
    with pytest.raises(TypeError):
        ops.waste_eval(np.asarray([[16, 32]], np.int32), sup, frq)
