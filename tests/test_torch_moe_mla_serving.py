"""The deepseek-v2-lite-16b smoke config in the serving engine against
the JAX package's (its tokens, steps, pages, sessions and compressed
caches), and the whole-batch prefill's MoE capacity drop that the port
mirrors.  The slowest of the MoE checks, kept apart from
``test_torch_moe_mla.py``, whose helpers and tolerance they use."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.serving import engine as peng  # noqa: E402
from test_torch_moe_mla import DS, TOL, both  # noqa: E402


def _np_tree(t):
    if isinstance(t, dict):
        return {k: _np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def test_serving_engine_deepseek_matches_reference():
    """The serve launcher's workload (12 requests of 3-9 tokens, 8 new,
    ``max_batch=4``) on the deepseek smoke config: the reference's tokens,
    steps, page pool, session stats and compressed caches."""
    jcfg, cfg = jget_smoke(DS), get_smoke_config(DS)
    jp = jinit_params(jcfg, jax.random.key(0))
    pp = params_from_numpy(_np_tree(jp), cfg, "cpu")
    ecfg = {"max_batch": 4, "max_seq": 64}
    je = jeng.ServingEngine(jcfg, jp, jeng.EngineConfig(**ecfg),
                            session_policy="always")
    pe = peng.ServingEngine(cfg, pp, peng.EngineConfig(**ecfg),
                            session_policy="always", device="cpu")
    reqs = []
    for eng, Request in ((je, jeng.Request), (pe, peng.Request)):
        rng = np.random.default_rng(0)
        rs = [Request(rid=1000 + i, prompt=rng.integers(
            0, cfg.vocab, size=rng.integers(3, 10)).astype(np.int32),
            max_new=8) for i in range(12)]
        for r in rs:
            eng.submit(r)
        eng.run_until_drained()
        reqs.append(rs)
    assert [(r.rid, r.done, r.generated) for r in reqs[0]] == \
        [(r.rid, r.done, r.generated) for r in reqs[1]]
    assert pe.steps == je.steps and pe.pool.free == je.pool.free
    assert pe.sessions.stats() == je.sessions.stats()
    for key, c in je.caches.items():
        assert set(pe.caches[key]) == set(c) == {"c_kv", "k_rope", "pos"}
        for name in c:
            np.testing.assert_allclose(pe.caches[key][name].numpy(),
                                       np.asarray(c[name]), rtol=0,
                                       atol=TOL)


def test_prefill_fills_moe_capacity_as_the_reference_does():
    """A reference property the port mirrors (ROADMAP Queue 3): prefill
    decodes the whole batch a prompt token, every other slot on token 0,
    so at ``max_batch=12`` (C = 8 at the decode capacity) the ninth
    request's first prompt token (slot 8) comes after eight rows that
    take its experts, and is dropped.  Captured at that call's first MoE
    layer, the reference's ``moe_ffn`` and the port's change rows 8-11
    (8 real, 9-11 never used) against the same call with no capacity
    limit, and the port's keep mask drops slot 8."""
    from repro_torch.models import blocks, init_params

    jcfg, cfg = jget_smoke(DS), get_smoke_config(DS)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = peng.ServingEngine(cfg, params, peng.EngineConfig(max_batch=12,
                                                            max_seq=64),
                             session_policy="always", device="cpu")
    rng = np.random.default_rng(0)
    reqs = [peng.Request(rid=1000 + i, prompt=rng.integers(
        0, cfg.vocab, size=rng.integers(3, 10)).astype(np.int32), max_new=4)
        for i in range(12)]
    call = sum(int(r.prompt.shape[0]) for r in reqs[:8])
    seen, real = [], blocks.moe_ffn

    def spy(h, p, *a, **kw):
        seen.append((h, p))
        return real(h, p, *a, **kw)
    blocks.moe_ffn = spy
    try:
        for r in reqs:
            eng.submit(r)
        eng.step()                            # admission: every prefill
    finally:
        blocks.moe_ffn = real
    h, p = seen[2 * call]                     # first MoE layer
    jp = both({k: (v.numpy() if not isinstance(v, dict) else
                   {kk: vv.numpy() for kk, vv in v.items()})
               for k, v in p.items()})[1]
    runs = (lambda cf: jmoe.moe_ffn(jnp.asarray(h.numpy()), jp, jcfg,
                                    "silu", capacity_factor=cf)[0],
            lambda cf: pmoe.moe_ffn(h, p, cfg, "silu",
                                    capacity_factor=cf)[0])
    for run in runs:
        diff = np.abs(np.asarray(run(2.0)) - np.asarray(run(100.0)))
        assert np.flatnonzero(diff.max(axis=(1, 2)) > 0).tolist() == \
            [8, 9, 10, 11]
    keep = pmoe.route(h.reshape(1, 12, -1), p["router"], cfg.top_k, 8)[3]
    assert not keep.reshape(12, cfg.top_k)[8].all()
    assert keep.reshape(12, cfg.top_k)[:8].all()
