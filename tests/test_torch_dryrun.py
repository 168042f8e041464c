"""The port's dry run (``launch/dryrun``, ``launch/plan``) on the CPU: its
argument bytes against the reference's shard shapes, its meters on small
hand-counted cases, the store cell on a mesh of four ``cpu`` positions
against the reference's ``build_dist_get`` on four host devices, the
store's plan on ``meta`` at the paper's scale, the CLI, the sweep and the
roofline report over its records.

The reference's side runs in a subprocess (this file run as a script under
``--xla_force_host_platform_device_count=512``) that hands back JSON and
numpy arrays."""

import json
import math
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro_torch.configs.base as cbase  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core import distributed as PD  # noqa: E402
from repro_torch.core.mesh import make_mesh  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.plan import (COLLECTIVES, StepMeter,  # noqa: E402
                                     param_collectives)
from repro_torch.launch.sharding import P, Sharded  # noqa: E402

# full-size cells whose plans are quick on the CPU: (arch, shape, units,
# multi_pod); argument bytes held to the reference's shard shapes
BYTE_CELLS = [("qwen2-0.5b", "train_4k", 1, False),
              ("qwen2-0.5b", "prefill_32k", 1, False),
              ("qwen2-0.5b", "decode_32k", None, False),
              ("deepseek-v2-lite-16b", "decode_32k", None, False),
              ("hymba-1.5b", "long_500k", None, False),
              ("mixtral-8x22b", "train_4k", 1, True)]
STORE_KEYS, STORE_PROBES = 1 << 14, 1 << 10
STORE_CASES = [("reduce_scatter", "bisect"), ("allreduce", "bisect"),
               ("reduce_scatter", "compare")]
# the step kinds at widths the CPU plans in a moment
SMALL_SHAPES = {"train_4k": ShapeSpec("train_4k", 32, 32, "train"),
                "prefill_32k": ShapeSpec("prefill_32k", 32, 32, "prefill"),
                "decode_32k": ShapeSpec("decode_32k", 32, 32, "decode"),
                "long_500k": ShapeSpec("long_500k", 128, 1, "decode")}


def _store_state(n_rows: int):
    """The store cell's stacked state as numpy, and GET 0's probes and
    answers, at the test's size."""
    cfg = PD.DistStoreConfig(n_keys=STORE_KEYS, probe_batch=STORE_PROBES)
    rows = [dryrun.store_row(s, n_rows, cfg, torch.device("cpu"))
            for s in range(n_rows)]
    state = {k: torch.cat([r[k] for r in rows]).numpy() for k in rows[0]}
    probes, found, vptr = dryrun.store_probes(cfg, 0, torch.device("cpu"),
                                              n_rows)
    return cfg, state, probes.numpy(), found.numpy(), vptr.numpy()


# ----------------------------------------------------- the reference's side

def reference_side() -> dict:
    """The reference's shard bytes of BYTE_CELLS and its four-device GET of
    the store state (in a process JAX started with 512 host devices)."""
    import jax
    import jax.numpy as jnp
    import repro.core.distributed as RD
    from repro.configs.base import SHAPES, get_config
    from repro.core.jaxcompat import make_mesh as rmake_mesh, set_mesh
    from repro.launch.inputs import input_specs
    from repro.launch.mesh import make_production_mesh as rmesh
    from repro.launch.sharding import DEFAULT_RULES, ShardingRules
    from repro.launch.steps import TrainConfig, opt_state_specs

    def nbytes(tree):
        return sum(math.prod(s.sharding.shard_shape(s.shape))
                   * np.dtype(s.dtype).itemsize
                   for s in jax.tree.leaves(tree))

    out = {}
    for arch, shape, units, multi in BYTE_CELLS:
        cfg = get_config(arch)
        cfg = cfg.scaled(units) if units else cfg
        mesh, rules = rmesh(multi_pod=multi), ShardingRules(DEFAULT_RULES)
        b = nbytes(input_specs(cfg, SHAPES[shape], mesh, rules))
        if SHAPES[shape].kind == "train":
            b += nbytes(opt_state_specs(cfg, mesh, rules, TrainConfig()))
        out[f"{arch}|{shape}|{units}|{multi}"] = b
    cfg, state, probes, _, _ = _store_state(4)
    mesh = rmake_mesh((2, 2), ("data", "model"), devices=jax.devices()[:4])
    for combine, seg in STORE_CASES:
        fn = RD.build_dist_get(mesh, RD.DistStoreConfig(
            n_keys=cfg.n_keys, probe_batch=cfg.probe_batch), seg, combine)
        with set_mesh(mesh):
            f, v = fn({k: jnp.asarray(a) for k, a in state.items()},
                      jnp.asarray(probes))
        out[f"store|{combine}|{seg}"] = [np.asarray(f).astype(int).tolist(),
                                         np.asarray(v).tolist()]
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun_ref") / "ref.json")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO, "src"), os.path.join(REPO, "port")]))
    subprocess.run([sys.executable, os.path.abspath(__file__), out],
                   env=env, check=True, timeout=300, cwd=REPO)
    with open(out) as f:
        return json.load(f)


# ------------------------------------------------------------- the meters

def test_step_meter_counts_live_storages_and_operand_bytes():
    x = torch.empty(1000, device="meta")
    with StepMeter() as m:
        y = x * 2                      # +4000
        z = y + 1                      # +4000
        del y                          # -4000
        w = z.view(10, 100)            # a view: no storage, no bytes
        z.add_(1)                      # in place: no storage
        u = torch.cat([z, z])          # +8000: 12000 live at once
        del u, w, z
    assert (m.peak, m.live) == (12000, 0)
    assert m.accessed == 8000 + 8000 + 8000 + 16000
    p = torch.empty(100, 100, device="meta", requires_grad=True)
    a = torch.empty(8, 100, device="meta")
    with StepMeter() as m:
        g, = torch.autograd.grad((a @ p).sum(), [p])
    assert m.live >= 40000 and m.peak >= m.live


def test_param_collectives_by_hand():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), ["meta"] * 8)
    params = {
        # FSDP over pod x data, TP over model: a (2, 4) shard of bf16
        "w": Sharded((8, 8), torch.bfloat16, P(("pod", "data"), "model"),
                     mesh),
        # replicated over the batch axes: all-reduced in training
        "b": Sharded((8,), torch.float32, P("model"), mesh),
        # FSDP over data only: gathered 2 ways, all-reduced over pod
        "n": Sharded((8,), torch.float32, P("data"), mesh),
    }
    ax = ("pod", "data")
    got = param_collectives(params, ax, "train", microbatch=3)
    w, b, n = 2 * 4 * 2, 4 * 4, 4 * 4
    assert got == {"all-gather": 6 * (w * 4 + n * 2), "all-reduce": b + n,
                   "reduce-scatter": w + n, "all-to-all": 0,
                   "collective-permute": 0}
    assert param_collectives(params, ax, "decode") == dict(
        dict.fromkeys(COLLECTIVES, 0), **{"all-gather": w * 4 + n * 2})


# ---------------------------------------------------------- the model plan

def _small(monkeypatch) -> None:
    """Plan the arch's smoke config at SMALL_SHAPES."""
    monkeypatch.setattr(cbase, "SHAPES", SMALL_SHAPES)
    monkeypatch.setattr(dryrun, "get_config", get_smoke_config)


def test_run_cell_skips_what_the_reference_skips(monkeypatch):
    _small(monkeypatch)
    r = dryrun.run_cell("qwen2-0.5b", "long_500k")
    assert "pure full-attention" in r["skipped"]
    r = dryrun.run_cell("hymba-1.5b", "long_500k", multi_pod=True)
    assert r["mesh"] == "2x16x16" and r["n_devices"] == 512
    assert r["per_position_batch"] == 1


@pytest.mark.parametrize("arch,shape,units,multi", BYTE_CELLS)
def test_argument_bytes_are_the_reference_shard_bytes(ref, arch, shape,
                                                      units, multi):
    r = dryrun.run_cell(arch, shape, units=units, multi_pod=multi)
    assert r["memory"]["argument_bytes"] == \
        ref[f"{arch}|{shape}|{units}|{multi}"]


# ---------------------------------------------------------- the store cell

@pytest.mark.parametrize("combine,seg_search", STORE_CASES)
def test_store_cell_on_four_cpu_positions(ref, combine, seg_search):
    r = dryrun.run_store_cell(devices=["cpu"] * 4, n_keys=STORE_KEYS,
                              probe_batch=STORE_PROBES, combine=combine,
                              seg_search=seg_search)
    m = r["measured"]
    assert (r["mesh"], r["n_devices"], m["device"]) == ("2x2", 4, "cpu")
    assert m["answers_checked"] == dryrun.STORE_GETS * STORE_PROBES
    assert m["peak_device_bytes"] is None and "card" not in m
    assert set(m["launches_per_get"].values()) == {0}   # plain versions
    # the same state and probes through build_dist_get, against the
    # reference's on four host devices and the closed form
    cfg, state, probes, found, vptr = _store_state(4)
    mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
    fn = PD.build_dist_get(mesh, cfg, seg_search, combine)
    f, v = fn(PD.place_dist_state(state, mesh), torch.from_numpy(probes))
    order = np.arange(STORE_PROBES)
    if combine == "allreduce":
        f, v = f[:1], v[:1]
        # the reference gathers the probes one mesh axis at a time, which
        # on a (2, 2) mesh lines the four slices up as 0, 2, 1, 3 while
        # the batch lies in row-major order, and its allreduce returns
        # them so (ROADMAP Queue 3); the port answers in batch order
        q = STORE_PROBES // 4
        order = np.concatenate([np.arange(q) + s * q for s in (0, 2, 1, 3)])
    f, v = torch.cat(f).numpy(), torch.cat(v).numpy()
    want_f, want_v = ref[f"store|{combine}|{seg_search}"]
    np.testing.assert_array_equal(f[order].astype(int), want_f)
    np.testing.assert_array_equal(v[order], want_v)
    np.testing.assert_array_equal(f, found)
    np.testing.assert_array_equal(v, vptr)
    assert found.sum() == STORE_PROBES // 2


def test_store_cell_fails_on_a_wrong_answer(monkeypatch):
    real = dryrun.store_probes

    def off_by_one(cfg, g, dev, n_rows):
        probes, found, vptr = real(cfg, g, dev, n_rows)
        return probes, found, vptr + 1
    monkeypatch.setattr(dryrun, "store_probes", off_by_one)
    with pytest.raises(RuntimeError, match="vptr answers"):
        dryrun.run_store_cell(devices=["cpu"] * 4, n_keys=STORE_KEYS,
                              probe_batch=STORE_PROBES)


@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_store_plan_on_meta_at_the_papers_scale(multi):
    r = dryrun.run_store_cell(multi_pod=multi, devices="meta")
    S = 512 if multi else 256
    cap = PD.DistStoreConfig(n_keys=1 << 30, probe_batch=1 << 20) \
        .shard_cap(S)
    assert "measured" not in r and r["n_devices"] == S
    row = cap * 16 + 3 * 512 * 8 + 4 + 8 + 8 + 4
    assert r["memory"]["argument_bytes"] == row + (1 << 20) // S * 8
    assert r["collectives"]["all-gather"] == (1 << 20) * 8
    assert r["collectives"]["reduce-scatter"] == (1 << 20) // S * 9
    specs = PD.dist_state_specs(make_production_mesh(
        multi_pod=multi, devices="meta"), PD.DistStoreConfig(
            n_keys=1 << 30, probe_batch=1 << 20))
    assert sum(t.numel() * t.element_size() for t in specs.values()) == \
        row * S


# ------------------------------------------------- the CLI, sweep, report

def test_cli_sweep_and_report(tmp_path, capsys):
    out = tmp_path / "store.json"
    dryrun.main(["--store", "--devices", "meta", "--out", str(out)])
    assert json.loads(out.read_text())["arch"] == "bourbon_kv"
    assert json.loads(capsys.readouterr().out)["mesh"] == "16x16"
    d = tmp_path / "sweep"
    dryrun.sweep(str(d), False, False, jobs=[("no-such-arch", "train_4k")])
    rec = json.loads((d / "no-such-arch__train_4k__single.json").read_text())
    assert "unknown arch" in rec["error"]
    capsys.readouterr()
    dryrun.main(["--arch", "hymba-1.5b", "--shape", "long_500k", "--out",
                 str(d / "hymba-1.5b__long_500k__single.json")])
    for units in (1, 2):
        dryrun.main(["--arch", "hymba-1.5b", "--shape", "long_500k",
                     "--units", str(units), "--metering", "--out",
                     str(d / f"hymba-1.5b__long_500k__single__u{units}.json")])
    cells = roofline.load_cells(str(d))
    assert cells["no-such-arch__train_4k"]["error"]
    h = cells["hymba-1.5b__long_500k"]
    assert h["metered"] and h["dominant"] in ("compute", "memory",
                                              "collective")
    full = json.loads((d / "hymba-1.5b__long_500k__single.json").read_text())
    # each unit costs the same, so the depth-delta reproduces the count
    assert h["flops_per_dev"] == pytest.approx(full["cost"]["flops"],
                                               rel=1e-9)
    rep = roofline.report(str(d)).splitlines()
    assert rep[0].startswith("arch\tshape") and len(rep) == 3
    assert any(line.endswith("ERROR") for line in rep)


if __name__ == "__main__":
    with open(sys.argv[1], "w") as f:
        json.dump(reference_side(), f)
