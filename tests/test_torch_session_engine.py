"""The port's serving path against the JAX package's: the Bourbon session
index (``SessionStore``) on the same register/lookup/evict traffic, the
``ServingEngine`` on the reference's own serving workloads (the workload of
test_substrates.py::test_serving_engine_end_to_end and the defaults of
``launch/serve.py``), and the serve launcher's line.

Model parameters come from the reference's ``init_params`` through
``convert.params_from_numpy``; in float32 both packages' logits agree
within 1e-5 (test_torch_models.py), so every generated token must be
equal.  Where one is not, the test fails unless the reference's own top-2
logit margin at that step is below 1e-6, a tie that an ulp decides; the
smallest margin the reference met is printed either way.  After such a tie
the two engines feed different tokens back, so their KV caches are no
longer compared; steps, the page pool and the session stats still are."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro.serving.session_store import SessionStore as JSessionStore  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import engine as peng  # noqa: E402
from repro_torch.serving.session_store import PageRecord, SessionStore  # noqa: E402

SENTINEL = np.iinfo(np.int64).max
N_LEVELS = 7
TIE = 1e-6


def np_tree(t):
    """A JAX parameter tree as numpy (the smoke configs are float32)."""
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    return np.asarray(t)


def _session_ids(rng, n):
    """n distinct signed 64-bit hashes, never the store's sentinel."""
    ids = np.unique(rng.integers(np.iinfo(np.int64).min, SENTINEL, n,
                                 dtype=np.int64))
    return rng.permutation(ids)


def _recs(ids):
    return [PageRecord(int(i) & 0xFFFF, 1 + int(i) % 7, int(i) % 1000)
            for i in ids]


@pytest.mark.parametrize("policy", ["cba", "always"])
def test_session_store_matches_reference(policy):
    """~60K sessions in batches of 4096, 10% of each batch evicted a batch
    later, lookups of live, evicted and absent ids (small batches the host
    answers, large ones the device path) after every fifth batch: found flags,
    records and stats() equal.  The reference engine caches a stacked level
    by its version alone, so a file learned after its level was stacked
    keeps no model on the device and its keys read as absent (ROADMAP
    Queue 3); each reference GET restacks first, as test_torch_store.py's
    do."""
    rng = np.random.default_rng(19)
    ids = _session_ids(rng, 15 * 4096 + 1024)
    absent, ids = ids[:1024], ids[1024:]
    ref, port = JSessionStore(policy=policy), SessionStore(policy=policy,
                                                           device="cpu")
    evicted = np.zeros(0, np.int64)
    for b in range(15):
        batch = ids[b * 4096:(b + 1) * 4096]
        for st in (ref, port):
            st.register_batch(batch, _recs(batch))
        if b:
            prev = ids[(b - 1) * 4096:b * 4096]
            gone = rng.choice(prev, 410, replace=False)
            for st in (ref, port):
                st.evict_batch(gone)
            evicted = np.concatenate([evicted, gone])
        if b % 5 != 4:
            continue
        live = ids[:(b + 1) * 4096]
        for size in (96, 1536):
            q = np.concatenate([rng.choice(live, size // 2),
                                rng.choice(absent, size // 4),
                                rng.choice(evicted, size // 4)
                                if evicted.shape[0] else
                                rng.choice(absent, size // 4)])
            ref.store.engine._state_versions = [-1] * N_LEVELS
            jf, jr = ref.lookup_batch(q)
            pf, pr = port.lookup_batch(q)
            assert np.array_equal(jf, pf)
            assert [None if r is None else (r.first_page, r.n_pages,
                                            r.prefix_len) for r in jr] == \
                [None if r is None else (r.first_page, r.n_pages,
                                         r.prefix_len) for r in pr]
            want = np.isin(q, live) & ~np.isin(q, evicted)
            assert np.array_equal(pf, want)
            hit = np.flatnonzero(pf)
            assert all(pr[i] == _recs(q[i:i + 1])[0] for i in hit[:64])
    js, ps = ref.stats(), port.stats()
    assert js == ps
    assert ps["n_files"] > 4 and ps["n_learned"] > 0
    assert ps["filter_host_answered"] > 0
    assert 0 < ps["model_path_frac"] <= 1


def _pair_engine(ecfg_kw, reqs_of, session_policy="always"):
    """Run the reference engine and the port's on the same parameters and
    requests; returns (ref engine, port engine, ref requests, port
    requests, per-step (ref logits, port logits, active slots))."""
    jcfg, cfg = jget_smoke("qwen2-0.5b"), get_smoke_config("qwen2-0.5b")
    jp = jinit_params(jcfg, jax.random.key(0))
    pp = params_from_numpy(np_tree(jp), cfg, "cpu")
    je = jeng.ServingEngine(jcfg, jp, jeng.EngineConfig(**ecfg_kw),
                            session_policy=session_policy)
    pe = peng.ServingEngine(cfg, pp, peng.EngineConfig(**ecfg_kw),
                            session_policy=session_policy, device="cpu")
    steps = {"ref": [], "port": []}
    for tag, eng, tonp in (("ref", je, np.asarray),
                           ("port", pe, lambda t: t.float().numpy())):
        admitting = [False]
        admit, decode = eng._admit, eng._decode

        def admit_(admit=admit, admitting=admitting):
            admitting[0] = True
            admit()
            admitting[0] = False

        def decode_(*a, decode=decode, admitting=admitting, eng=eng,
                    tag=tag, tonp=tonp):
            out = decode(*a)
            if not admitting[0]:          # the step's own decode
                lg = out[0] if isinstance(out, tuple) else out
                steps[tag].append((tonp(lg)[:, 0, :], [
                    s for s, r in enumerate(eng._slot_rid) if r is not None]))
            return out

        eng._admit, eng._decode = admit_, decode_
    jreqs, preqs = reqs_of(jeng.Request), reqs_of(peng.Request)
    for eng, reqs in ((je, jreqs), (pe, preqs)):
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
    return je, pe, jreqs, preqs, list(zip(steps["ref"], steps["port"]))


def _check_tokens(jreqs, preqs, steps) -> bool:
    """Equal tokens, or a first difference at a reference tie; prints the
    smallest top-2 margin the reference's argmax met.  True when a tie was
    accepted."""
    margins = []
    first_diff = None
    for (jl, slots), (pl, _) in steps:
        top2 = np.sort(jl[slots], axis=-1)[:, -2:]
        margins.append(float((top2[:, 1] - top2[:, 0]).min()))
        diff = [s for s in slots if jl[s].argmax() != pl[s].argmax()]
        if diff and first_diff is None:
            t = np.sort(jl[diff[0]])[-2:]
            first_diff = float(t[1] - t[0])
    print(f"reference top-2 margin: min {min(margins):.3e} over "
          f"{len(steps)} steps; first differing step's margin: {first_diff}")
    if first_diff is not None:
        assert first_diff < TIE, first_diff
        return True
    for j, p in zip(jreqs, preqs):
        assert (j.rid, j.done, j.generated) == (p.rid, p.done, p.generated)
    return False


def _substrates_reqs(Request):
    rng = np.random.default_rng(0)
    return [Request(rid=100 + i, prompt=rng.integers(0, 512, 4).astype(
        np.int32), max_new=4) for i in range(5)]


def _serve_reqs(Request):
    rng = np.random.default_rng(0)
    return [Request(rid=1000 + i, prompt=rng.integers(
        0, 512, size=rng.integers(3, 10)).astype(np.int32), max_new=8)
        for i in range(12)]


@pytest.mark.parametrize("workload", ["substrates", "serve"])
def test_serving_engine_matches_reference(workload):
    ecfg, reqs = {"substrates": ({"max_batch": 2, "max_seq": 64},
                                 _substrates_reqs),
                  "serve": ({"max_batch": 4, "max_seq": 64},
                            _serve_reqs)}[workload]
    je, pe, jreqs, preqs, steps = _pair_engine(ecfg, reqs)
    tie = _check_tokens(jreqs, preqs, steps)
    assert pe.steps == je.steps and len(steps) == je.steps
    assert pe.pool.free == je.pool.free
    assert len(pe.pool.free) == pe.ecfg.n_pages
    assert pe.sessions.stats() == je.sessions.stats()
    if tie:
        return
    for name in ("k", "v", "pos"):
        np.testing.assert_allclose(
            pe.caches["s0_attn_mlp"][name].numpy(),
            np.asarray(je.caches["s0_attn_mlp"][name]), rtol=0, atol=1e-5)


def test_serving_engine_end_to_end():
    """The port case of test_substrates.py's: its own parameters."""
    cfg = get_smoke_config("qwen2-0.5b")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = peng.ServingEngine(cfg, params,
                             peng.EngineConfig(max_batch=2, max_seq=64),
                             device="cpu")
    reqs = _substrates_reqs(peng.Request)
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    for r in reqs:
        assert r.done and len(r.generated) == 4
        assert all(0 <= t < cfg.vocab for t in r.generated)
    # all pages returned to the pool
    assert len(eng.pool.free) == eng.ecfg.n_pages
    # the session store actually served lookups
    st = eng.sessions.stats()
    assert eng.steps >= 10
    assert st["n_gets"] > 0 and st["n_records"] >= 0


def test_serve_launcher_prints_the_reference_line(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve"])
    jserve.main()
    want = capsys.readouterr().out
    pserve.main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert want.startswith("served 12 requests in ") and got == want

