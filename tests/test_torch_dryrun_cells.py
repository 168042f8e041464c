"""The port's dry run (``launch/dryrun``) on the CPU: the plan of every
arch's smoke config and every step kind on ``meta``, at small shapes
(``test_torch_dryrun.SMALL_SHAPES``).  Every block runs on a process mesh,
so every decode and prefill cell is planned on DTensor placements
(``dryrun.sharded_plan``, in a fake process group this process opens and
closes), and so is every train cell, as every block's train step runs on
a process mesh (``dryrun.mesh_trains``: on the two-axis production mesh
these cells use; on (2, 16, 16) a train cell counts its parameters' and
gradients' collectives)."""

import json
import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

from repro_torch.configs.base import ARCHS  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.plan import COLLECTIVES  # noqa: E402
from test_torch_dryrun import _small  # noqa: E402


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_plans_every_smoke_config_on_meta(monkeypatch, arch, shape):
    _small(monkeypatch)
    r = dryrun.run_cell(arch, shape)
    mem = r["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"] - mem["alias_bytes"])
    assert mem["temp_bytes"] > 0 and mem["argument_bytes"] > 0
    assert r["cost"]["flops"] > 0 and r["cost"]["bytes accessed"] > 0
    assert set(r["collectives"]) == set(COLLECTIVES)
    c = r["collectives"]
    # a train cell reduces every gradient over the batch; a serving cell,
    # run on DTensors, the activations' partial sums
    assert c["reduce-scatter"] + c["all-reduce"] > 0
    sharded = shape != "train_4k" or dryrun.mesh_trains(
        dryrun.make_production_mesh(devices="meta"))
    assert (r["temp_scope"], r["cost_split"], r["collectives_scope"]) == ((
        "one position's shard (DTensor placements)", "even",
        "all (DTensor placements)") if sharded else (
        "model axis unsplit (upper bound)", "even",
        "parameters and gradients"))
    assert sum(r["argument_parts"].values()) == mem["argument_bytes"]
    assert r["n_devices"] == 256 and r["per_position_batch"] == 2
    if shape == "prefill_32k":
        assert mem["alias_bytes"] == 0
    else:
        assert 0 < mem["alias_bytes"] < mem["output_bytes"]
    json.dumps(r)
