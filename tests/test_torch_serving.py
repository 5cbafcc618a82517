"""The serving slice as a whole: the port's offline harness (and the
pool, scheduler and token-quota arbiter it drives) against the
reference's harness, on the CPU where the kernels' plain versions run.

Everything here must be identical: ``HarnessResult.decisions()``, the
generated tokens, the admission counters, and the KV pools themselves
(their content is integer-hash floats, exact on both sides).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.serving as R  # noqa: E402
import repro.serving.offline_harness as r_harness  # noqa: E402
import repro_torch.serving as T  # noqa: E402
import repro_torch.serving.offline_harness as t_harness  # noqa: E402
from repro.core import ControllerConfig as RConfig  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ControllerConfig as TConfig  # noqa: E402

CLASSES = (128, 256, 512, 1024)
SIDES = {"ref": (R, dict(impl="ref")), "port": (T, dict(torch_device="cpu"))}


def _workload(mod, n, seed, output_mean=40.0):
    """The reference serving bench's open-loop workload, with outputs
    long enough that sequences outgrow their slab class."""
    rng = np.random.default_rng(seed)
    return mod.lognormal_request_workload(
        rng, n, prompt_mean=96.0, prompt_std=64.0, output_mean=output_mean,
        output_std=5.0, arrival_rate=4.0)


def _harness(side, mode, batch, *, pool_tokens=32768, quotas=None,
             arbiter=False, adaptive=False):
    mod, kw = SIDES[side]
    pool_kw = {} if side == "ref" else dict(torch_device="cpu")
    pool = mod.KVSlabPool(pool_tokens, CLASSES, **pool_kw)
    for name, q in (quotas or {}).items():
        pool.register_tenant(name, quota_tokens=q)
    arb = (mod.token_quota_arbiter(pool, unit_tokens=512, arbitrate_every=2)
           if arbiter else None)
    return mod.OfflineHarness(pool, max_batch=batch, mode=mode, arbiter=arb,
                              adaptive=adaptive, **kw)


@pytest.mark.parametrize("batch,pool_tokens", [(16, 32768), (64, 32768),
                                               (16, 1536)])
def test_harness_matches_reference(batch, pool_tokens):
    """Same decisions and tokens as the reference harness, in both
    modes; the tight pool forces drops and class-overflow moves."""
    runs = {}
    for side in ("ref", "port"):
        for mode in ("batched", "legacy"):
            h = _harness(side, mode, batch, pool_tokens=pool_tokens)
            runs[(side, mode)] = (h, h.run(_workload(SIDES[side][0], 48, 7)))
    _, base = runs[("ref", "batched")]
    assert base.realloc_copies + base.rejected > 0
    for key, (h, res) in runs.items():
        assert res.decisions() == base.decisions(), key
        assert res.tokens == base.tokens, key
    port_h, port_res = runs[("port", "batched")]
    ref_h, _ = runs[("ref", "batched")]
    assert port_res.n_decode_dispatches <= port_res.ticks
    assert runs[("port", "legacy")][1].n_decode_dispatches \
        == port_res.generated_tokens
    # the pools' contents are exact on both sides
    np.testing.assert_array_equal(port_h._k.numpy(), np.asarray(ref_h._k))
    np.testing.assert_array_equal(port_h._v.numpy(), np.asarray(ref_h._v))


def test_admission_cell_matches_reference():
    """Two out-of-phase tenants over a tight pool, quotas managed by the
    token-quota arbiter: the tick-granular admission gate denies, the
    arbiter moves quota, and both packages agree on every count."""
    quotas = {"a": 4096, "b": 4096}
    results = {}
    for side in ("ref", "port"):
        for mode in ("batched", "legacy"):
            h = _harness(side, mode, 64, pool_tokens=8192, quotas=quotas,
                         arbiter=True)
            res = h.run(_admission_workload(SIDES[side][0]))
            results[(side, mode)] = (h.arbiter, res)
    ref_arb, base = results[("ref", "batched")]
    assert base.n_admission_denials > 0 and ref_arb.n_transfers > 0
    for key, (arb, res) in results.items():
        assert res.decisions() == base.decisions(), key
        assert res.tokens == base.tokens, key
        assert (arb.n_admission_checks, arb.n_admission_denials,
                arb.n_transfers) == (ref_arb.n_admission_checks,
                                     ref_arb.n_admission_denials,
                                     ref_arb.n_transfers), key


def _admission_workload(mod, seed=7, per_tenant=40, gap=30.0, rate=4.0):
    """The reference serving bench's admission cell workload."""
    rng = np.random.default_rng(seed)
    reqs = []
    for k, (tenant, phase) in enumerate((("a", 0.0), ("b", gap))):
        prompts = np.clip(rng.lognormal(5.2, 0.5, per_tenant),
                          16, 1024).astype(int)
        outputs = np.clip(rng.lognormal(2.2, 0.5, per_tenant),
                          1, 64).astype(int)
        arrivals = phase + np.cumsum(rng.exponential(1.0 / rate,
                                                     per_tenant))
        for i in range(per_tenant):
            reqs.append(mod.Request(rid=1000 * k + i,
                                    prompt_len=int(prompts[i]),
                                    output_len=int(outputs[i]),
                                    arrival=float(arrivals[i]),
                                    tenant=tenant))
    return reqs


def test_adaptive_harness_refits_like_reference():
    runs = {}
    for side, config in (("ref", RConfig), ("port", TConfig)):
        mod, kw = SIDES[side]
        pool_kw = {} if side == "ref" else dict(torch_device="cpu")
        cfg = config(page_size=1 << 22, min_chunk=128, align=128,
                     half_life=float("inf"), check_every=16,
                     drift_threshold=0.0, min_items_between_refits=16,
                     min_rel_improvement=0.0, **pool_kw)
        pool = mod.KVSlabPool(32768, (1024, 2048), controller_config=cfg,
                              **pool_kw)
        h = mod.OfflineHarness(pool, max_batch=16, adaptive=True,
                               max_chunk_tokens=2048, **kw)
        runs[side] = h.run(_workload(mod, 60, 3, output_mean=10.0))
    assert runs["ref"].n_refits > 0
    assert runs["port"].decisions() == runs["ref"].decisions()
    assert runs["port"].tokens == runs["ref"].tokens


def test_continuous_batcher_matches_reference():
    results = {}
    for side in ("ref", "port"):
        mod, _ = SIDES[side]
        pool_kw = {} if side == "ref" else dict(torch_device="cpu")
        for legacy in (False, True):
            pool = mod.KVSlabPool(2048, CLASSES, **pool_kw)
            b = mod.ContinuousBatcher(pool, max_batch=12, legacy_loop=legacy)
            results[(side, legacy)] = b.run(_workload(mod, 40, 5), 300)
    base = dataclasses.astuple(results[("ref", False)])
    assert results[("ref", False)].rejected > 0
    assert results[("ref", False)].realloc_copies > 0
    for key, res in results.items():
        assert dataclasses.astuple(res) == base, key


def test_toy_model_hash_matches_reference():
    """uint32 wrap-around of the content hash, held in int64 with masks:
    large request ids and positions included."""
    rng = np.random.default_rng(0)
    rid = rng.integers(0, 2**31 - 1, 50).astype(np.int32)
    pos = rng.integers(0, 2**20, 50).astype(np.int32)
    tok = rng.integers(0, 16, 50).astype(np.int32)
    want = np.asarray(r_harness._kv_content(jnp.asarray(rid),
                                            jnp.asarray(pos),
                                            jnp.asarray(tok), 3, 16))
    got = np.stack([x.numpy() for x in t_harness._kv_content(
        torch.from_numpy(rid), torch.from_numpy(pos), torch.from_numpy(tok),
        3, 16)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_harness._q_content(torch.from_numpy(rid), torch.from_numpy(pos),
                             2, 8).numpy(),
        np.asarray(r_harness._q_content(jnp.asarray(rid), jnp.asarray(pos),
                                        2, 8)))
    # prefill builds the id as float32 first
    ridf = np.arange(0, 3000, 7, dtype=np.float32)
    want = np.asarray(r_harness._mix(jnp.asarray(ridf), jnp.arange(ridf.size),
                                     0, 0x9E37, 1, 4))
    got = t_harness._mix(torch.from_numpy(ridf), torch.arange(ridf.size),
                         torch.zeros(ridf.size), 0x9E37, 1, 4).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_load_harness_pools_from_reference():
    ref = _harness("ref", "batched", 8)
    ref.run(_workload(R, 12, 2))
    port = _harness("port", "batched", 8)
    convert.load_harness_pools(port, np.asarray(ref._k), np.asarray(ref._v))
    np.testing.assert_array_equal(port._v.numpy(), np.asarray(ref._v))
    with pytest.raises(ValueError):
        convert.load_harness_pools(port, np.zeros((4, 1, 16), np.float32),
                                   np.asarray(ref._v))


def test_harness_defaults_to_the_card():
    if torch.cuda.is_available():
        h = T.OfflineHarness(T.KVSlabPool(1024, CLASSES))
        assert h._k.is_cuda
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        T.KVSlabPool(1024, CLASSES)
    pool = T.KVSlabPool(1024, CLASSES, torch_device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        T.OfflineHarness(pool)
