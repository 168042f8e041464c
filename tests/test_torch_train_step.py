"""The port's optimizer, schedules and step functions against the
reference's (``repro.optim``, ``repro.launch.steps``), on identical trees
drawn from a numpy seed and converted with ``params_from_numpy`` /
``opt_state_from_numpy``; and every remat choice against no remat.

Tolerances: one AdamW update in float32 follows the reference's
operations in its order, so new parameters, moments and master copies are
held within ADAMW_TOL of each leaf's scale (the pow of the bias
corrections and the order of the norm's sums may differ by an ulp);
bf16 parameters within one bf16 ulp of the master's rounding.  Three
train steps of qwen2's smoke config hold loss and grad norm within
STEP_TOL relative, and each parameter within PARAM_TOL = lr / 10
absolute: Adam divides each gradient entry by its own root mean square,
so an entry whose gradient is rounding noise on both sides (the key bias,
whose true gradient is 0, as softmax ignores a constant a query) moves by
a share of lr set by that noise (readings: 6.5e-6 at most, lr 3e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_training import (flat, grads_of, make_batch, np_tree, pair,
                             rel_err, to_jax, to_torch)
from repro.launch import steps as jsteps  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedule as jschedule  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import opt_state_from_numpy  # noqa: E402
from repro_torch.launch.steps import (TrainConfig,  # noqa: E402
                                      build_serve_step, build_train_step,
                                      init_train_state)
from repro_torch.models import (decode_step, init_caches,  # noqa: E402
                                loss_fn, param_shapes)
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               adamw_state_shapes, adamw_update,
                               global_norm, lr_schedule)

ADAMW_TOL = 1e-6
STEP_TOL = 1e-6
B, S = 2, 16


def _tree(rng):
    """A small nested tree of f32 arrays, sorted keys differing from
    insertion order."""
    return {"z": rng.standard_normal((8, 16)).astype(np.float32),
            "a": {"w": rng.standard_normal((3, 5, 7)).astype(np.float32),
                  "b": rng.standard_normal((7,)).astype(np.float32)},
            "m": rng.standard_normal((300,)).astype(np.float32)}


def _torch_tree(t, dtype=torch.float32):
    if isinstance(t, dict):
        return {k: _torch_tree(v, dtype) for k, v in t.items()}
    return torch.from_numpy(t.copy()).to(dtype)


def _jax_tree(t, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), t)


@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("master", [True, False], ids=["master", "nomaster"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(clip, master, dtype):
    rng = np.random.default_rng(7)
    p_np, g_np = _tree(rng), _tree(rng)
    g_np = jax.tree.map(lambda a: a * 0.3, g_np)
    cfg_kw = dict(clip_norm=0.5 if clip else 1e6, master_f32=master)
    jcfg, cfg = jadamw.AdamWConfig(**cfg_kw), AdamWConfig(**cfg_kw)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jp, jg = _jax_tree(p_np, jdt), _jax_tree(g_np, jdt)
    p, g = _torch_tree(p_np, tdt), _torch_tree(g_np, tdt)
    js, st = jadamw.adamw_init(jp, jcfg), adamw_init(p, cfg)
    assert set(st) == set(js)
    update = jax.jit(lambda p, g, s: jadamw.adamw_update(p, g, s, jcfg))
    for step in range(3):           # bias corrections at steps 1-3
        jp, js, jm = update(jp, jg, js)
        p2, st2, m = adamw_update(p, g, st, cfg)
        assert p2 is p and st2 is st
        gn = float(jm["grad_norm"])
        assert abs(float(m["grad_norm"]) - gn) <= ADAMW_TOL * gn
        assert int(st["step"]) == int(js["step"]) == step + 1
    scale = float(jm["grad_norm"])
    assert (jcfg.clip_norm / scale < 1) == clip
    want = flat(np_tree(js))
    for key in ("m", "v", "master"):
        for name, t in flat(st.get(key, {})).items():
            assert t.dtype == torch.float32
            assert rel_err(t, want[f"{key}.{name}"]) <= ADAMW_TOL, \
                (key, name)
    jpp = flat(np_tree(jp))
    for name, t in flat(p).items():
        assert t.dtype == tdt
        if dtype == "float32":
            assert rel_err(t, jpp[name]) <= ADAMW_TOL, name
        else:                   # one bf16 ulp (2^-8 relative) at most
            w = jpp[name]
            assert (np.abs(t.float().numpy() - w)
                    <= np.abs(w) * 2.0 ** -8 + 1e-30).all(), name


def test_global_norm_sums_leaves_in_sorted_order():
    rng = np.random.default_rng(8)
    t = _tree(rng)
    want = float(jadamw.global_norm(_jax_tree(t)))
    assert abs(float(global_norm(_torch_tree(t))) - want) <= 1e-6 * want


def test_state_shapes_mirror_init():
    cfg = get_smoke_config("qwen2-0.5b")
    specs = param_shapes(cfg)
    for master in (True, False):
        ocfg = AdamWConfig(master_f32=master)
        shapes = adamw_state_shapes(specs, ocfg)
        assert set(shapes) == ({"step", "m", "v", "master"} if master
                               else {"step", "m", "v"})
        assert shapes["step"].shape == () and \
            shapes["step"].dtype == torch.int32
        for key in set(shapes) - {"step"}:
            leaves = tree_leaves(shapes[key])
            assert [s.shape for s in leaves] == \
                [s.shape for s in tree_leaves(specs)]
            assert all(s.dtype == torch.float32 for s in leaves)


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_the_reference(kind):
    steps = np.array([0, 1, 5, 50, 99, 100, 101, 1000, 5000, 9999, 10000,
                      20000], np.int32)
    want = np.asarray(jschedule.lr_schedule(jnp.asarray(steps), kind=kind))
    got = lr_schedule(torch.from_numpy(steps), kind=kind)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    for s in (0, 150, 12000):
        assert abs(float(lr_schedule(s, kind=kind, warmup=10, total=200))
                   - float(jschedule.lr_schedule(
                       jnp.asarray(s), kind=kind, warmup=10, total=200))
                   ) <= 1e-7


@pytest.mark.parametrize("microbatch", [1, 2])
def test_train_step_matches_the_reference_over_three_steps(microbatch):
    cfg, jcfg, jp, model = pair("qwen2-0.5b")
    jtc = jsteps.TrainConfig(remat="none", microbatch=microbatch)
    tc = TrainConfig(remat="none", microbatch=microbatch)
    js = jadamw.adamw_init(jp, jtc.optim)
    st = opt_state_from_numpy(np_tree(js), cfg, "cpu")
    jstep = jax.jit(jsteps.build_train_step(jcfg, jtc))
    step = build_train_step(cfg, tc)
    lr = tc.optim.lr
    for i in range(3):
        nb = make_batch(cfg, 2 * B, S, seed=10 + i)
        jp, js, jm = jstep(jp, js, to_jax(nb))
        model, st, m = step(model, st, to_torch(nb))
        for key in ("loss", "grad_norm"):
            want = float(jm[key])
            assert abs(float(m[key]) - want) <= STEP_TOL * want, (i, key)
    want = flat(np_tree(jp))
    for name, t in flat(model.tree()).items():
        err = float(np.abs(t.detach().numpy() - want[name]).max())
        assert err <= lr / 10, (name, err)
    assert int(st["step"]) == 3


def test_microbatches_split_the_batch_and_average():
    """microbatch 2 at grad_accum_dtype bfloat16 still averages: its loss
    is the mean of the two halves' losses."""
    cfg, _, _, model = pair("qwen2-0.5b")
    nb = to_torch(make_batch(cfg, 2 * B, S, seed=20))
    halves = [float(loss_fn(model, cfg, {k: v[i * B: (i + 1) * B]
                                         for k, v in nb.items()},
                            remat="none")[0]) for i in range(2)]
    st = adamw_init(model, AdamWConfig())
    step = build_train_step(cfg, TrainConfig(
        remat="none", microbatch=2, grad_accum_dtype="bfloat16"))
    _, _, m = step(model, st, nb)
    assert abs(float(m["loss"]) - sum(halves) / 2) <= 1e-6


def test_serve_step_is_decode_step():
    cfg, _, _, model = pair("qwen2-0.5b")
    toks = torch.from_numpy(make_batch(cfg, B, 1, seed=21)["tokens"])
    c1, c2 = init_caches(cfg, B, 8, "cpu"), init_caches(cfg, B, 8, "cpu")
    serve = build_serve_step(cfg)
    got, _ = serve(model, c1, {"tokens": toks})
    with torch.no_grad():
        want, _ = decode_step(model, cfg, c2, tokens=toks)
    assert torch.equal(got, want)


def test_init_train_state_and_no_mesh_yet(monkeypatch):
    cfg = get_smoke_config("qwen2-0.5b")
    tc = TrainConfig()
    params, st = init_train_state(cfg, tc, torch.Generator().manual_seed(0),
                                  "cpu")
    assert all(p.requires_grad for p in params.parameters())
    assert set(st) == {"step", "m", "v", "master"}
    with pytest.raises(NotImplementedError, match="7e"):
        build_train_step(cfg, tc, rules=object())
    with pytest.raises(NotImplementedError, match="7e"):
        build_serve_step(cfg, mesh=object())
    with pytest.raises(ValueError):
        build_train_step(cfg, dataclasses.replace(tc, remat="everything"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(cfg, tc, torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "hymba-1.5b",
                                  "deepseek-v2-lite-16b"])
def test_every_remat_computes_the_same_values(arch):
    """"full", "dots", "dots_no_batch" and "nested" change only what the
    backward keeps: on the CPU each equals "none" bit for bit, loss and
    every gradient (deepseek's prologue run is one layer, so "nested"
    checkpoints it alone)."""
    cfg, _, _, model = pair(arch, n_units=4)
    batch = to_torch(make_batch(cfg, B, S, seed=2))
    model.trainable()
    l0, _, g0 = grads_of(model, cfg, batch, "none")
    for remat in ("full", "dots", "dots_no_batch", "nested", None):
        loss, _, grads = grads_of(model, cfg, batch, remat)
        assert torch.equal(loss, l0), remat
        for name, g in grads.items():
            assert torch.equal(g, g0[name]), (remat, name)
