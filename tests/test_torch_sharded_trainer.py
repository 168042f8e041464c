"""The port's ``Trainer`` on a process mesh: qwen2's smoke config under
``DEFAULT_RULES`` on a (data 2, model 2) mesh of four gloo processes on
the CPU, initialised through ``convert.shard_params`` from
``init_leaves``, each step's batch split over "data", checkpoints
gathered and written by rank 0 (``checkpoint/ckpt.py``).

- A run that fails at step FAIL and resumes from its last checkpoint ends
  bit for bit equal to an uninterrupted run: its final parameters and its
  final checkpoint, every leaf.
- That checkpoint, written on the mesh, restores unsharded in the port
  (equal to the gathered parameters) and is read by the reference's
  ``repro.checkpoint.ckpt.restore`` (the same layout).
- The dry run's qwen2 train cell is planned on DTensor placements, the
  train step run sharded at one position of a fake process group of 256
  (in a subprocess: the fake group is this process's default group while
  it is open); so is every block's train cell on (16, 16) (hymba's plan
  is ``test_torch_sharded_plan.py``'s), and none on (2, 16, 16)."""

import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint.ckpt import latest_step, restore  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import tree_to_numpy  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch.sharding import (DEFAULT_RULES,  # noqa: E402
                                         ShardingRules)
from repro_torch.launch.steps import TrainConfig  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.layers import tree_paths  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from test_torch_sharded_serve import AXES, MESH  # noqa: E402

ARCH = "qwen2-0.5b"
STEPS, EVERY, FAIL = 6, 2, 3
SEQ, BATCH = 16, 4


def trainer(ckpt_dir: str, fail=None, mesh=None, device="cpu",
            arch: str = ARCH, steps: int = STEPS):
    from repro_torch.data.pipeline import (DataConfig, TokenDataset,
                                           synthetic_tokens)
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_smoke_config(arch)
    ds = TokenDataset(synthetic_tokens(50_000, cfg.vocab),
                      DataConfig(seq_len=SEQ, global_batch=BATCH,
                                 vocab=cfg.vocab))
    tc = TrainerConfig(steps=steps, ckpt_every=EVERY, ckpt_dir=ckpt_dir,
                       fail_at_step=fail, log_every=1,
                       train=TrainConfig(remat="full"))
    return Trainer(cfg, tc, ds, ShardingRules(DEFAULT_RULES), mesh,
                   device=device)


def rank_body(rank: int, device, resumed: str, whole: str,
              arch: str = ARCH, steps: int = STEPS) -> dict:
    """The failing run of ``arch``'s smoke config and its resumption in
    ``resumed``, an uninterrupted run in ``whole``; rank 0 returns both
    runs' losses, what the failing run raised, the step each checkpoint
    directory ended at between the two, and both runs' final parameters
    gathered."""
    mesh = make_process_mesh(MESH, AXES, device)
    out = {}
    try:
        trainer(resumed, FAIL, mesh, arch=arch, steps=steps).run()
        out["failed"] = None
    except RuntimeError as e:             # the injected failure, asserted
        out["failed"] = str(e)
    out["after_failure"] = latest_step(resumed)
    r = trainer(resumed, None, mesh, arch=arch, steps=steps).run()
    u = trainer(whole, None, mesh, arch=arch, steps=steps).run()
    out["losses"] = (r["losses"], u["losses"])
    out["params"] = (tree_to_numpy(r["params"].tree()),
                     tree_to_numpy(u["params"].tree()))
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        resumed, whole = (os.path.join(tmp, d) for d in ("resumed", "whole"))
        out = spmd.run(rank_body, ["cpu"] * 4, "gloo", (resumed, whole))[0]
        out["ckpt"] = {k: _read(d) for k, d in (("resumed", resumed),
                                                 ("whole", whole))}
        out["reference_read"] = _reference_restore(resumed)
        yield out


def _like():
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    return {"p": params.tree(), "o": adamw_init(params,
                                                TrainConfig().optim)}


def _read(d: str) -> dict:
    """The final checkpoint in ``d`` restored unsharded by the port, as
    numpy, and its step."""
    tree, step = restore(_like(), d)
    return {"step": step, "tree": tree_to_numpy(tree)}


def _reference_restore(d: str) -> dict:
    """The reference's ``ckpt.restore`` of the final checkpoint in ``d``
    into the reference's own tree of the same config, as numpy."""
    import jax
    from repro.checkpoint import ckpt as rckpt
    from repro.configs import get_smoke_config as rcfg
    from repro.models import init_params as rinit
    from repro.optim import AdamWConfig, adamw_init as radamw_init

    cfg = rcfg(ARCH)
    params = rinit(cfg, jax.random.key(0))
    tree, step = rckpt.restore(
        {"p": params, "o": radamw_init(params, AdamWConfig())}, d)
    return {"step": step,
            "tree": dict(tree_paths(jax.tree.map(np.asarray, tree)))}


def test_run_fails_at_step_3_and_resumes(runs):
    assert runs["failed"] == f"injected failure at step {FAIL}"
    assert runs["after_failure"] == EVERY       # step 2's committed
    resumed, whole = runs["losses"]
    assert [s for s, _ in resumed] == list(range(FAIL, STEPS))
    assert [s for s, _ in whole] == list(range(STEPS))
    assert dict(resumed) == {s: v for s, v in whole if s >= FAIL}
    assert all(np.isfinite(v) for _, v in whole)


def test_resumed_run_equals_an_uninterrupted_one_bit_for_bit(runs):
    got, want = runs["params"]
    assert [n for n, _ in tree_paths(got)] == [n for n, _ in tree_paths(want)]
    for (name, g), (_, w) in zip(tree_paths(got), tree_paths(want)):
        assert np.array_equal(g, w), name
    a, b = runs["ckpt"]["resumed"], runs["ckpt"]["whole"]
    assert a["step"] == b["step"] == STEPS - 1
    for (name, g), (_, w) in zip(tree_paths(a["tree"]),
                                 tree_paths(b["tree"])):
        assert np.array_equal(g, w), name


def test_mesh_checkpoint_restores_unsharded(runs):
    """The final checkpoint, restored into an unsharded tree, holds the
    parameters the ranks gathered, bit for bit; the AdamW step too."""
    tree = runs["ckpt"]["resumed"]["tree"]
    got = dict(tree_paths(tree["p"]))
    for name, w in tree_paths(runs["params"][0]):
        assert np.array_equal(got[name], w), name
    assert int(tree["o"]["step"]) == STEPS


def test_reference_reads_the_mesh_checkpoint(runs):
    ref = runs["reference_read"]
    assert ref["step"] == STEPS - 1
    mine = dict(tree_paths(runs["ckpt"]["resumed"]["tree"]))
    assert set(ref["tree"]) == set(mine)
    for name, a in ref["tree"].items():
        assert np.array_equal(np.asarray(a, mine[name].dtype), mine[name]), \
            name


def plans() -> dict:
    """The dry run's train cells (in a process of its own)."""
    from repro_torch.launch import dryrun

    out = {}
    for arch in ("qwen2-0.5b",):
        r = dryrun.run_cell(arch, "train_4k", units=1)
        out[arch] = {k: r.get(k) for k in (
            "collectives", "collectives_scope", "collective_counts",
            "temp_scope", "memory", "argument_parts")}
    return out


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("train_plan") / "plans.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "port"))
    subprocess.run([sys.executable, os.path.abspath(__file__), path],
                   env=env, check=True, timeout=600, cwd=REPO)
    with open(path) as f:
        return json.load(f)


def test_train_cell_plans_on_dtensor_placements(planned):
    """qwen2-0.5b x train_4k on the (16, 16) mesh at full width, one
    unit: every collective of the forward, the backward (with remat
    "full", the recomputed forward's too) and the update, counted."""
    c = planned["qwen2-0.5b"]
    assert c["collectives_scope"] == "all (DTensor placements)"
    assert c["temp_scope"] == "one position's shard (DTensor placements)"
    counts = c["collective_counts"]
    assert counts["all-reduce"] > 0 and counts["all-gather"] > 0
    assert all((counts[k] > 0) == (v > 0)
               for k, v in c["collectives"].items())
    mem = c["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"] - mem["alias_bytes"])
    assert sum(c["argument_parts"].values()) == mem["argument_bytes"]


def test_later_blocks_train_cells_keep_the_parameter_count():
    """Every block's train step runs on a process mesh, so a train cell
    of hymba-1.5b is planned on DTensor placements wherever qwen2's is:
    on the two-axis (16, 16) mesh (its plan is
    ``test_torch_sharded_plan.py``'s, made once); on the (2, 16, 16)
    mesh every train cell keeps the parameters' and gradients' count
    (``dryrun.mesh_trains``: DTensor's planner spends minutes on three
    axes)."""
    from repro_torch.launch import dryrun

    single = dryrun.make_production_mesh(devices="meta")
    multi = dryrun.make_production_mesh(multi_pod=True, devices="meta")
    assert (single.shape, multi.shape) == ((16, 16), (2, 16, 16))
    assert dryrun.mesh_trains(single) and not dryrun.mesh_trains(multi)


if __name__ == "__main__":
    with open(sys.argv[1], "w") as f:
        json.dump(plans(), f)
