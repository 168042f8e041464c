"""The port's ``launch`` layout modules against the reference's:
``elastic``, ``sharding`` (specs of every parameter of all ten full
configs), ``inputs`` and ``steps.opt_state_specs`` (every leaf of every
applicable cell), the train and serve steps under sharding rules, the
checkpoint restored onto shardings, and the roofline arithmetic.

The reference's specs need a JAX mesh of the production shape, so its side
runs in a subprocess (this file run as a script under
``--xla_force_host_platform_device_count=512``) that hands back JSON.  A
spec is compared as a list of entries (None, an axis name, or a list of
names), after ``PartitionSpec``'s own normalization; every comparison here
is exact, except the reference's step against the port's, held within
the tolerances of ``tests/test_torch_train_step.py``."""

import dataclasses
import json
import math
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import ARCHS, SHAPES, cells  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.core.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.launch import elastic, roofline, sharding  # noqa: E402
from repro_torch.launch.inputs import input_specs  # noqa: E402
from repro_torch.launch.mesh import (HW, batch_axes,  # noqa: E402
                                     make_production_mesh)
from repro_torch.launch.sharding import (DEFAULT_RULES, P,  # noqa: E402
                                         Sharded, ShardingRules,
                                         constraint, param_constraint,
                                         rules_ctx)
from repro_torch.launch.steps import (TrainConfig,  # noqa: E402
                                      build_serve_step, build_train_step,
                                      opt_state_specs)
from repro_torch.models import param_shapes  # noqa: E402

RULE_SETS = {"default": {}, "seq=model": {"seq": "model"},
             "experts=None": {"experts": None}}
MESHES = {"single": False, "multi": True}
APPLICABLE = [(a, s) for a, s, ok, _ in cells() if ok]


def _spec_json(spec) -> list:
    return [list(p) if isinstance(p, tuple) else p for p in spec]


def _flat(tree, prefix=()):
    """[(dotted path, leaf)] of nested dicts/tuples in sorted key order
    (JAX's flattening order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k],
                                                       prefix + (str(k),))]
    if isinstance(tree, tuple):
        return [x for i, v in enumerate(tree)
                for x in _flat(v, prefix + (str(i),))]
    return [(".".join(prefix), tree)]


# ----------------------------------------------------- the reference's side

def reference_specs() -> dict:
    """Every spec the reference resolves on the two production meshes (run
    in a process JAX started with 512 host devices)."""
    import jax
    import numpy as jnp_np
    from repro.configs.base import SHAPES as RSHAPES, get_config as rget
    from repro.launch import sharding as rsh
    from repro.launch.inputs import input_specs as rinput_specs
    from repro.launch.mesh import make_production_mesh as rmesh
    from repro.launch.steps import TrainConfig as RTC
    from repro.launch.steps import opt_state_specs as ropt
    from repro.models import param_shapes as rshapes

    def path_str(path):
        return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)

    def leaf_rec(path, s):
        return [path_str(path), list(s.shape), jnp_np.dtype(s.dtype).name,
                _spec_json(s.sharding.spec),
                list(s.sharding.shard_shape(s.shape))]

    out = {"params": {}, "cells": {}}
    for tag, mp in MESHES.items():
        mesh = rmesh(multi_pod=mp)
        sizes = dict(zip(mesh.axis_names, mesh.shape.values()))
        for rname, over in RULE_SETS.items():
            rules = rsh.ShardingRules(rsh.DEFAULT_RULES)
            rules.update(over)
            for arch in ARCHS:
                shapes = rshapes(rget(arch))
                recs = []
                sharded = jax.tree_util.tree_flatten_with_path(
                    rsh.param_sharding(mesh, rules, shapes))[0]
                flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
                for (path, s), (_, sd) in zip(flat, sharded):
                    recs.append([
                        path_str(path),
                        _spec_json(rsh.logical_to_spec(
                            rules, s.axes, shape=s.shape, mesh=mesh)),
                        _spec_json(rsh.logical_to_spec(
                            rules, s.axes, param=False, shape=s.shape,
                            mesh=mesh)),
                        _spec_json(rsh._filter_spec(rules.spec(s.axes),
                                                    sizes, s.shape)),
                        _spec_json(rsh._filter_spec(rules.spec(s.axes),
                                                    sizes)),
                        _spec_json(sd.sharding.spec)])
                out["params"][f"{tag}|{rname}|{arch}"] = recs
        rules = rsh.ShardingRules(rsh.DEFAULT_RULES)
        for arch, sname in APPLICABLE:
            cfg, shape = rget(arch), RSHAPES[sname]
            recs = [leaf_rec(p, s) for p, s in
                    jax.tree_util.tree_flatten_with_path(
                        rinput_specs(cfg, shape, mesh, rules))[0]]
            opt = []
            if shape.kind == "train":
                opt = [leaf_rec(p, s) for p, s in
                       jax.tree_util.tree_flatten_with_path(
                           ropt(cfg, mesh, rules, RTC()))[0]]
            out["cells"][f"{tag}|{arch}|{sname}"] = {"inputs": recs,
                                                     "opt": opt}
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("launch_ref") / "ref.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO, "src"), os.path.join(REPO, "port")]))
    subprocess.run([sys.executable, os.path.abspath(__file__), out],
                   env=env, check=True, timeout=300, cwd=REPO)
    with open(out) as f:
        return json.load(f)


def _meta_mesh(multi: bool) -> Mesh:
    return make_production_mesh(multi_pod=multi, devices="meta")


# ------------------------------------------------------------------ elastic

def test_shrink_plan_equals_the_reference_everywhere():
    from repro.launch import elastic as relastic
    for n in range(1, 65):
        for f in range(n):
            assert elastic.shrink_plan(n, f) == relastic.shrink_plan(n, f)
    # tests/test_substrates.py's cases
    assert [elastic.shrink_plan(16, f) for f in (0, 1, 8, 9)] == \
        [16, 8, 8, 4]


@pytest.mark.parametrize("events", [
    [("fail", 3, 10), ("slow", 5, 10)],                    # test_substrates
    [],
    [("slow", 0, 1), ("slow", 1, 1)],
    [("fail", 0, 1), ("fail", 1, 2), ("fail", 2, 3), ("slow", 7, 3)],
    [("slow", h, 4) for h in range(8)],                    # every host slow
    [("fail", h, 5) for h in range(7)],                    # one survivor
    [("fail", 2, 1), ("slow", 2, 2), ("slow", 6, 2), ("fail", 6, 9)],
], ids=["substrates", "healthy", "two_slow", "three_dead", "all_slow",
        "one_left", "mixed"])
def test_elastic_controller_equals_the_reference(events):
    from repro.launch import elastic as relastic
    for n in (8, 12):
        got, want = elastic.ElasticController(n), \
            relastic.ElasticController(n)
        for kind, host, step in events:
            for c in (got, want):
                (c.fail if kind == "fail" else c.mark_slow)(host, step)
            assert got.alive == want.alive
            for step_ in (step, step + 1):
                assert got.assignment(step_) == want.assignment(step_)
        assert got.events == want.events
    ec = elastic.ElasticController(8)
    ec.fail(3, step=10)
    ec.mark_slow(5, step=10)
    asg = ec.assignment(step=11)
    assert sorted(s for lst in asg.values() for s in lst) == \
        list(range(elastic.shrink_plan(8, 1)))
    assert 3 not in asg and 5 not in asg


# ------------------------------------------------------------- the specs

def test_production_mesh_and_hw():
    m = _meta_mesh(False)
    assert (m.shape, m.axis_names, m.size) == ((16, 16), ("data", "model"),
                                               256)
    assert batch_axes(m) == ("data",)
    mm = _meta_mesh(True)
    assert mm.axis_sizes == {"pod": 2, "data": 16, "model": 16}
    assert batch_axes(mm) == ("pod", "data")
    assert {d.type for d in mm.devices} == {"meta"}
    cpu = make_production_mesh(devices=["cpu"] * 256)
    assert set(cpu.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError):
        make_production_mesh(devices=["cpu"] * 4)
    # the H100 SXM5 figures, not the TPU's
    assert (HW.PEAK_BF16_FLOPS, HW.HBM_BW, HW.NVLINK_BW, HW.IB_BW) == \
        (989e12, 3.35e12, 450e9, 50e9)


def test_partition_spec_normalizes_as_jax_does():
    from jax.sharding import PartitionSpec as JP
    for parts in [(), (None,), (("a",),), ((),), (("a", "b"), None, "c"),
                  (None, ("x",), ())]:
        assert tuple(P(*parts)) == tuple(JP(*parts)), parts
    assert P(("a",)) == P("a") and P(()) == P(None)


@pytest.mark.parametrize("mesh_tag", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(ref, arch, mesh_tag):
    mesh = _meta_mesh(MESHES[mesh_tag])
    shapes = param_shapes(get_config(arch))
    for rname, over in RULE_SETS.items():
        rules = ShardingRules(DEFAULT_RULES)
        rules.update(over)
        sharded = dict(_flat(sharding.param_sharding(mesh, rules, shapes)))
        got = []
        for path, s in _flat(shapes):
            got.append([
                path,
                _spec_json(sharding.logical_to_spec(
                    rules, s.axes, shape=s.shape, mesh=mesh)),
                _spec_json(sharding.logical_to_spec(
                    rules, s.axes, param=False, shape=s.shape, mesh=mesh)),
                _spec_json(sharding._filter_spec(rules.spec(s.axes),
                                                 mesh.axis_sizes, s.shape)),
                _spec_json(sharding._filter_spec(rules.spec(s.axes),
                                                 mesh.axis_sizes)),
                _spec_json(sharded[path].spec)])
        assert got == ref["params"][f"{mesh_tag}|{rname}|{arch}"], rname


def _leaf_recs(tree) -> list:
    return [[path, list(s.shape), str(s.dtype).replace("torch.", ""),
             _spec_json(s.spec), list(s.shard_shape())]
            for path, s in _flat(tree)]


@pytest.mark.parametrize("mesh_tag", list(MESHES))
@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_input_and_opt_state_specs_equal_the_reference(ref, arch, shape,
                                                       mesh_tag):
    mesh = _meta_mesh(MESHES[mesh_tag])
    cfg, rules = get_config(arch), ShardingRules(DEFAULT_RULES)
    want = ref["cells"][f"{mesh_tag}|{arch}|{shape}"]
    specs = input_specs(cfg, SHAPES[shape], mesh, rules)
    assert _leaf_recs(specs) == want["inputs"]
    if SHAPES[shape].kind == "train":
        assert _leaf_recs(opt_state_specs(cfg, mesh, rules,
                                          TrainConfig())) == want["opt"]
    # what the dry run sums as its argument bytes
    bytes_ = sum(math.prod(r[4]) * getattr(torch, r[2]).itemsize
                 for r in want["inputs"] + want["opt"])
    from repro_torch.launch.plan import tree_bytes
    got = sum(tree_bytes(t) for t in specs)
    if SHAPES[shape].kind == "train":
        got += tree_bytes(opt_state_specs(cfg, mesh, rules, TrainConfig()))
    assert got == bytes_


def test_constraint_checks_and_returns_the_tensor():
    x = torch.zeros(4, 6, 8)
    assert constraint(x, ("batch", "seq", "embed")) is x   # no rules
    one = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    with rules_ctx(ShardingRules(DEFAULT_RULES), one):
        assert constraint(x, ("batch", "seq", "mlp")) is x
        assert param_constraint(x, ("embed", "mlp", "heads")) is x
        assert param_constraint(x, ("embed",)) is x         # rank differs
        with pytest.raises(ValueError, match="more entries"):
            constraint(torch.zeros(4), ("batch", "seq"))
        meta = torch.zeros(4, 6, 8, device="meta")
        with pytest.raises(ValueError, match="under a mesh of"):
            constraint(meta, ("batch", "seq", "embed"))
    assert sharding.current_rules() == (None, None)
    two = Mesh((torch.device("cuda", 0), torch.device("cuda", 1)),
               ("data",), (2,))
    with rules_ctx(ShardingRules(DEFAULT_RULES), two):
        with pytest.raises(NotImplementedError, match="multi-card"):
            constraint(x, ("batch", "seq", "embed"))
        with pytest.raises(NotImplementedError, match="multi-card"):
            param_constraint(x, ("embed", "mlp", "heads"))
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_shape((6, 8), P("data"), {"data": 4})
    with pytest.raises(ValueError, match="more entries"):
        sharding.shard_shape((6,), P("data", None), {"data": 2})


# ------------------------------------------------------- steps under rules

@pytest.fixture
def deterministic():
    """Torch's deterministic algorithms for a bit-for-bit comparison (the
    embedding gradient's accumulation on the CPU is in no fixed order at
    larger sizes otherwise)."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield
    torch.use_deterministic_algorithms(was[0], warn_only=was[1])


@pytest.mark.parametrize("fsdp", [False, True], ids=["plain", "scan_fsdp"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_train_step_under_rules_is_the_step_without(deterministic, shape,
                                                     fsdp):
    """Two steps of qwen2's smoke config under DEFAULT_RULES on a cpu mesh
    are bit for bit the same steps with rules=None, and within the
    train-step tolerances of the reference's step."""
    import jax
    from repro.launch import steps as jsteps
    from repro.optim import adamw as jadamw
    from _torch_training import flat, make_batch, np_tree, pair, to_jax, \
        to_torch
    from repro_torch.convert import opt_state_from_numpy
    from repro_torch.convert import params_from_numpy
    cfg, jcfg, jp, model = pair("qwen2-0.5b")
    other = params_from_numpy(np_tree(jp), cfg, "cpu")
    mesh = make_mesh(shape, ("data", "model"), ["cpu"] * math.prod(shape))
    tc = TrainConfig(remat="full", scan_param_fsdp=fsdp)
    js = jadamw.adamw_init(jp, jsteps.TrainConfig().optim)
    st = opt_state_from_numpy(np_tree(js), cfg, "cpu")
    st2 = opt_state_from_numpy(np_tree(js), cfg, "cpu")
    ruled = build_train_step(cfg, tc, ShardingRules(DEFAULT_RULES), mesh)
    plain = build_train_step(cfg, dataclasses.replace(
        tc, scan_param_fsdp=False))
    jstep = jax.jit(jsteps.build_train_step(jcfg, jsteps.TrainConfig(
        remat="none")))
    for i in range(2):
        nb = make_batch(cfg, 4, 16, seed=30 + i)
        model, st, m = ruled(model, st, to_torch(nb))
        other, st2, m2 = plain(other, st2, to_torch(nb))
        jp, js, jm = jstep(jp, js, to_jax(nb))
        assert torch.equal(m["loss"], m2["loss"])
        assert torch.equal(m["grad_norm"], m2["grad_norm"])
        for key in ("loss", "grad_norm"):
            assert abs(float(m[key]) - float(jm[key])) <= \
                1e-6 * float(jm[key])
    for (n, a), (_, b) in zip(flat(model.tree()).items(),
                              flat(other.tree()).items()):
        assert torch.equal(a, b), n
    for n, a in flat(st).items():
        assert torch.equal(a, flat(st2)[n]), n
    want = flat(np_tree(jp))
    for name, t in flat(model.tree()).items():
        assert float(np.abs(t.detach().numpy() - want[name]).max()) <= \
            tc.optim.lr / 10, name


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_serve_step_under_rules_is_the_step_without(deterministic, shape):
    import jax.numpy as jnp
    from repro.launch import steps as jsteps
    from repro.models import init_caches as jinit_caches
    from _torch_training import make_batch, pair
    from repro_torch.models import init_caches
    cfg, jcfg, jp, model = pair("qwen2-0.5b")
    mesh = make_mesh(shape, ("data", "model"), ["cpu"] * math.prod(shape))
    ruled = build_serve_step(cfg, ShardingRules(DEFAULT_RULES), mesh)
    plain = build_serve_step(cfg)
    jserve = jsteps.build_serve_step(jcfg)
    c1, c2 = init_caches(cfg, 4, 8, "cpu"), init_caches(cfg, 4, 8, "cpu")
    jc = jinit_caches(jcfg, 4, 8)
    for i in range(3):
        toks = make_batch(cfg, 4, 1, seed=40 + i)["tokens"]
        got, _ = ruled(model, c1, {"tokens": torch.from_numpy(toks)})
        want, _ = plain(model, c2, {"tokens": torch.from_numpy(toks)})
        jl, jc = jserve(jp, jc, {"tokens": jnp.asarray(toks)})
        assert torch.equal(got, want)
        jl = np.asarray(jl, np.float32)
        assert np.abs(got.numpy() - jl).max() <= 1e-5 * np.abs(jl).max()
    for a, b in zip(_flat(dict(c1)), _flat(dict(c2))):
        assert torch.equal(a[1], b[1]), a[0]


def test_a_mesh_of_distinct_cards_raises():
    cfg = get_smoke_config("qwen2-0.5b")
    two = make_mesh((1, 2), ("data", "model"), ["cuda:0", "cuda:1"])
    rules = ShardingRules(DEFAULT_RULES)
    with pytest.raises(NotImplementedError, match="multi-card"):
        build_train_step(cfg, TrainConfig(), rules, two)
    with pytest.raises(NotImplementedError, match="multi-card"):
        build_serve_step(cfg, rules, two)


def test_trainer_under_rules_trains_as_without(deterministic, tmp_path):
    from repro_torch.data.pipeline import (DataConfig, TokenDataset,
                                           synthetic_tokens)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = get_smoke_config("qwen2-0.5b")
    ds = TokenDataset(synthetic_tokens(20_000, cfg.vocab),
                      DataConfig(seq_len=16, global_batch=4))
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    out = []
    for i, (rules, m) in enumerate([(ShardingRules(DEFAULT_RULES), mesh),
                                    (None, None)]):
        tc = TrainerConfig(steps=3, ckpt_every=100, log_every=1,
                           ckpt_dir=str(tmp_path / str(i)))
        out.append(Trainer(cfg, tc, ds, rules=rules, mesh=m,
                           device="cpu").run())
    assert out[0]["losses"] == out[1]["losses"]


def test_restore_onto_shardings(tmp_path):
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.launch.sharding import param_sharding
    from repro_torch.models.layers import Spec
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(4, 8),
            "b": torch.arange(8, dtype=torch.bfloat16)}
    specs = {"w": Spec((4, 8), torch.float32, ("embed", "mlp")),
             "b": Spec((8,), torch.bfloat16, ("mlp",))}
    save(tree, tmp_path, 3)
    like = {k: torch.zeros_like(v) for k, v in tree.items()}
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    shd = param_sharding(mesh, ShardingRules(DEFAULT_RULES), specs)
    assert shd["w"].spec == P("data", "model") and \
        shd["w"].shard_shape() == (2, 4)
    got, step = restore(like, tmp_path, shardings=shd)
    assert step == 3
    for k in tree:
        assert torch.equal(got[k], tree[k]) and got[k].device == \
            torch.device("cpu")
    two = make_mesh((2, 2), ("data", "model"), ["cuda:0", "cuda:1"] * 2)
    with pytest.raises(NotImplementedError, match="multi-card"):
        restore(like, tmp_path, shardings=param_sharding(
            two, ShardingRules(DEFAULT_RULES), specs))
    with pytest.raises(ValueError, match="shardings for"):
        restore(like, tmp_path, shardings={"w": shd["w"]})
    bad = dict(shd, w=Sharded((8, 4), torch.float32, P(), mesh))
    with pytest.raises(ValueError, match="sharding of shape"):
        restore(like, tmp_path, shardings=bad)


# --------------------------------------------------------------- roofline

@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _, _ in cells()])
def test_model_flops_equal_the_reference(arch, shape):
    from repro.launch import roofline as rroof
    assert roofline.model_flops(arch, shape) == rroof.model_flops(arch,
                                                                  shape)


def test_analyze_cell_is_the_reference_over_the_h100_figures():
    from repro.launch import roofline as rroof
    from repro.launch.mesh import HW as RHW
    full = {
        "arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "16x16",
        "n_devices": 256,
        "cost": {"flops": 1e12, "bytes accessed": 1e11},
        "collectives": {"all-gather": 5e9},
        "memory": {"peak_bytes": 8 << 30},
        "compile_s": 1.0,
    }
    # the port's plan counts every layer: its record is the reference's
    # with depth-corrected counts, so the reference is given none
    for mesh, link, rlink in (("16x16", HW.NVLINK_BW, RHW.ICI_BW),
                              ("2x16x16", HW.IB_BW, RHW.DCI_BW)):
        f = dict(full, mesh=mesh)
        got, want = roofline.analyze_cell(f), rroof.analyze_cell(f)
        for key in ("flops_per_dev", "bytes_per_dev",
                    "collective_bytes_per_dev", "model_flops",
                    "useful_ratio", "memory_peak_gib"):
            assert got[key] == want[key], key
        assert got["t_compute_s"] == pytest.approx(
            want["t_compute_s"] * RHW.PEAK_BF16_FLOPS / HW.PEAK_BF16_FLOPS,
            rel=1e-12)
        assert got["t_memory_s"] == pytest.approx(
            want["t_memory_s"] * RHW.HBM_BW / HW.HBM_BW, rel=1e-12)
        assert got["t_collective_s"] == pytest.approx(
            want["t_collective_s"] * rlink / link, rel=1e-12)
        assert got["fits_hbm"] and got["metered"] and not want["metered"]
    assert set(got) == set(want)
    for key in ("skipped", "error"):
        rec = {"arch": "a", "shape": "s", key: "why"}
        assert roofline.analyze_cell(rec) == rroof.analyze_cell(rec)


@pytest.mark.parametrize("u", [None, "u1", "both", "nocost"])
def test_extrapolated_is_the_reference(u):
    from repro.launch import roofline as rroof
    full = {"cost": {"flops": 7.5e12, "bytes accessed": 3.25e11}}
    u1 = {"cost": {"flops": 4.1e11, "bytes accessed": 5.3e10}}
    u2 = {"cost": {"flops": 5.7e11, "bytes accessed": 6.9e10}}
    args = {None: (None, None), "u1": (u1, None), "both": (u1, u2),
            "nocost": ({}, u2)}[u]
    for key in ("flops", "bytes accessed", "missing"):
        for n in (1, 2, 24, 27):
            assert roofline._extrapolated(full, *args, key, n) == \
                rroof._extrapolated(full, *args, key, n)


if __name__ == "__main__":
    with open(sys.argv[1], "w") as f:
        json.dump(reference_specs(), f)
