"""The dry run's serving cells, and hymba's train cell, on DTensor
placements (``launch/dryrun``'s
``sharded_plan``, ``launch/plan``'s ``ShardMeter`` and
``fake_process_group``): every collective DTensor issues at one position
of a fake process group, by kind and result bytes.

A fake process group is a default process group, which is global to a
process, so every plan here runs in a subprocess (this file run as a
script) that hands back JSON.

The hand counts take each collective's result bytes from the shapes the
specs give one position.  Which collective carries a piece from one
layout to another is DTensor's choice, and GSPMD chooses others for the
same specs, which is why the two packages' figures are compared, not
held equal."""

import dataclasses
import json
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))

import pytest  # noqa: E402

F32 = 4
# the one-layer decode: qwen2.5-14b's smoke widths, one unit, no biases,
# B rows, a cache of T (under 256, so its context is not split), on a
# (data 2, model 2) mesh with the parameters' FSDP split off
B, T = 4, 32
LAYER = {"n_units": 1, "qkv_bias": False}
# the one-layer MoE decode: mixtral's smoke widths (D 128, 4 experts of
# F 256, top-2), one unit, the same B and T, the parameters' FSDP split on
MOE_LAYER = {"n_units": 1}


def plans() -> dict:
    """Every plan of this file (in a process of its own)."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.plan import ShardMeter, fake_process_group
    from repro_torch.launch.sharding import DEFAULT_RULES, ShardingRules

    out = {"redistribute": {}}
    with fake_process_group(4):
        dm = make_process_mesh((2, 2), ("data", "model"), "meta").device_mesh
        for name, src, dst in (
                ("shard_to_replicate", [Shard(0), Replicate()],
                 [Replicate(), Replicate()]),
                ("partial_to_replicate", [Replicate(), Partial()],
                 [Replicate(), Replicate()]),
                ("partial_to_shard", [Replicate(), Partial()],
                 [Replicate(), Shard(1)])):
            x = DTensor.from_local(torch.empty(4, 8, device="meta"), dm, src,
                                   run_check=False)
            with ShardMeter() as m:
                x.redistribute(dm, dst)
            out["redistribute"][name] = [m.collectives, m.counts]
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-14b"), **LAYER)
    rules = ShardingRules(DEFAULT_RULES, embed_fsdp=None)
    out["layer"] = dryrun.sharded_plan(
        cfg, ShapeSpec("layer", T, B, "decode"),
        make_mesh((2, 2), ("data", "model"), ["meta"] * 4), rules)
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"), **MOE_LAYER)
    out["moe_layer"] = dryrun.sharded_plan(
        cfg, ShapeSpec("layer", T, B, "decode"),
        make_mesh((2, 2), ("data", "model"), ["meta"] * 4),
        ShardingRules(DEFAULT_RULES))
    from repro_torch.configs import get_config
    from repro_torch.launch.inputs import param_specs_sharded
    prod = make_mesh((16, 16), ("data", "model"), ["meta"] * 256)
    moe = param_specs_sharded(get_config("mixtral-8x22b"), prod,
                              ShardingRules(DEFAULT_RULES))[
        "stages"]["s0_attn_moe"]["moe"]
    out["mixtral_specs"] = {k: list(moe[k].spec) for k in ("w1", "w2")}
    out["cells"] = {}
    for arch, shape, units in (("qwen2-0.5b", "decode_32k", 1),
                               ("qwen2-0.5b", "prefill_32k", 1),
                               ("hymba-1.5b", "train_4k", 1),
                               ("deepseek-v2-lite-16b", "decode_32k", 1),
                               ("mixtral-8x22b", "decode_32k", 1),
                               ("hymba-1.5b", "decode_32k", 1),
                               ("xlstm-1.3b", "decode_32k", 1),
                               ("llama-3.2-vision-11b", "decode_32k", 1)):
        r = dryrun.run_cell(arch, shape, units=units)
        out["cells"][f"{arch}|{shape}"] = {
            k: r.get(k) for k in ("collectives", "collectives_scope",
                                  "collective_counts", "temp_scope",
                                  "memory", "argument_parts")}
    return out


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("sharded_plan") / "plans.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "port"))
    subprocess.run([sys.executable, os.path.abspath(__file__), path],
                   env=env, check=True, timeout=600, cwd=REPO)
    with open(path) as f:
        return json.load(f)


def _kinds(**got) -> dict:
    out = {"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
           "all-to-all": 0, "collective-permute": 0}
    out.update(got)
    return out


def test_meter_counts_each_redistribution_by_its_result(planned):
    """A (4, 8) f32 piece a position: gathered over "data" to (8, 8); a
    partial sum over "model" reduced whole (4, 8) or scattered to (4, 4)."""
    r = planned["redistribute"]
    assert r["shard_to_replicate"] == [_kinds(**{"all-gather": 8 * 8 * F32}),
                                       _kinds(**{"all-gather": 1})]
    assert r["partial_to_replicate"] == [
        _kinds(**{"all-reduce": 4 * 8 * F32}), _kinds(**{"all-reduce": 1})]
    assert r["partial_to_shard"] == [
        _kinds(**{"reduce-scatter": 4 * 4 * F32}),
        _kinds(**{"reduce-scatter": 1})]


def test_one_layer_decode_collectives_by_hand(planned):
    """One attn_mlp layer's decode step, position (0, 0): D 128, 8 heads
    of 16 in 2 kv groups (one a model position), b = B / 2 rows a data
    position, the weights split over "model" only.  Three partial sums
    over "model" are all-reduced, each b rows of D: the embedding's (its
    vocabulary is split), the attention output's and the layer's (the
    output products' rows are split).  Three pieces split over "model"
    are gathered whole: the new k and v rows for the cache write (b x KV x
    hd each) and the queries for the scores (b x H x hd)."""
    D, H, KV, hd = 128, 8, 2, 16
    b = B // 2
    layer = planned["layer"]
    assert layer["collectives"] == _kinds(**{
        "all-reduce": 3 * b * D * F32,
        "all-gather": 2 * b * KV * hd * F32 + b * H * hd * F32})
    assert layer["counts"] == _kinds(**{"all-gather": 3, "all-reduce": 3})
    assert layer["temp_bytes"] > 0


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_serving_cells_report_every_collective(planned, shape):
    c = planned["cells"][f"qwen2-0.5b|{shape}"]
    assert c["collectives_scope"] == "all (DTensor placements)"
    assert c["temp_scope"] == "one position's shard (DTensor placements)"
    assert sum(c["collectives"].values()) > 0
    assert set(c["collective_counts"]) == set(c["collectives"])
    assert all((c["collective_counts"][k] > 0) == (v > 0)
               for k, v in c["collectives"].items())
    mem = c["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"] - mem["alias_bytes"])
    assert sum(c["argument_parts"].values()) == mem["argument_bytes"]


def test_one_layer_moe_decode_collectives_by_hand(planned):
    """One attn_moe layer's decode step, position (0, 0), under
    DEFAULT_RULES: D 128, 4 experts of F 256 (two a model position), top
    2, b = B / 2 rows a data position, the weights' "embed" split over
    "data".  The dispatch group is all B tokens (capacity C 8), spanning
    both data ranks, and its rows move to the experts' weights: two
    all-to-alls of (2 ranks, 2 experts, C, D / 2) rows, there and back.
    Five all-reduces: the two partial products h1 and h3 over "data" (1
    group, 2 experts, C, F), the experts' partial sum over "model" (b
    rows of D), and, as DTensor lays out the embedding and the attention
    output, two of B rows of D / 2 (their "embed" split over "data").
    The all-gathers are DTensor's (the attention's weights, the router,
    the rank offsets' counts) and never an expert weight's FSDP piece."""
    D, E, Fe, C = 128, 4, 256, 8
    El, b = E // 2, B // 2
    layer = planned["moe_layer"]
    got = layer["collectives"]
    assert got["all-to-all"] == 2 * 2 * El * C * (D // 2) * F32
    assert got["all-reduce"] == (2 * El * C * Fe + b * D
                                 + 2 * B * (D // 2)) * F32
    assert layer["counts"]["all-to-all"] == 2
    assert layer["counts"]["all-reduce"] == 5
    assert 0 < got["all-gather"] < El * D * Fe * F32
    assert got["reduce-scatter"] == got["collective-permute"] == 0


def test_mixtral_experts_whole_mlp_on_model(planned):
    """On the (16, 16) mesh mixtral's 8 experts do not divide "model":
    they stay whole, and the per-expert "mlp" dimension takes it."""
    assert planned["mixtral_specs"] == {"w1": [None, None, "data", "model"],
                                        "w2": [None, None, "model", "data"]}


@pytest.mark.parametrize("cell", ["deepseek-v2-lite-16b|decode_32k",
                                  "mixtral-8x22b|decode_32k"])
def test_moe_serving_cells_report_every_collective(planned, cell):
    """The MoE and MLA decode cells are planned on DTensors, the
    all-to-alls of the experts' dispatch rows counted."""
    c = planned["cells"][cell]
    assert c["collectives_scope"] == "all (DTensor placements)"
    assert c["temp_scope"] == "one position's shard (DTensor placements)"
    assert c["collective_counts"]["all-to-all"] > 0
    assert c["collectives"]["all-to-all"] > 0
    assert all((c["collective_counts"][k] > 0) == (v > 0)
               for k, v in c["collectives"].items())
    mem = c["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"] - mem["alias_bytes"])


@pytest.mark.parametrize("cell", ["hymba-1.5b|decode_32k",
                                  "xlstm-1.3b|decode_32k",
                                  "llama-3.2-vision-11b|decode_32k"])
def test_recurrent_and_cross_attention_cells_report_every_collective(
        planned, cell):
    """The recurrent and cross-attention decode cells are planned on
    DTensors too: the activations' partial sums are reduced, and the
    recurrent states (hymba's Mamba state, xlstm's mLSTM and sLSTM
    states) written back, as the step runs them."""
    c = planned["cells"][cell]
    assert c["collectives_scope"] == "all (DTensor placements)"
    assert c["temp_scope"] == "one position's shard (DTensor placements)"
    assert c["collective_counts"]["all-reduce"] > 0
    assert c["collectives"]["all-gather"] > 0
    assert all((c["collective_counts"][k] > 0) == (v > 0)
               for k, v in c["collectives"].items())
    mem = c["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"] - mem["alias_bytes"])
    assert sum(c["argument_parts"].values()) == mem["argument_bytes"]


@pytest.mark.parametrize("cell", ["hymba-1.5b|train_4k"])
def test_other_cells_keep_the_parameter_count(planned, cell):
    """No block's train cell keeps the parameter count on (16, 16) any
    more: hymba's train step is planned on DTensor placements, as
    qwen2's (``test_torch_sharded_trainer.py``), the backward's
    collectives of attention beside Mamba counted."""
    c = planned["cells"][cell]
    assert c["collectives_scope"] == "all (DTensor placements)"
    assert c["temp_scope"] == "one position's shard (DTensor placements)"
    counts = c["collective_counts"]
    assert counts is not None and counts["all-reduce"] > 0 and \
        counts["reduce-scatter"] > 0 and counts["all-gather"] > 0
    assert all((counts[k] > 0) == (v > 0)
               for k, v in c["collectives"].items())
    mem = c["memory"]
    assert mem["peak_bytes"] == (mem["argument_bytes"] + mem["temp_bytes"]
                                 + mem["output_bytes"] - mem["alias_bytes"])


@pytest.mark.parametrize("name", ["propagate_op_sharding_non_cached",
                                  "_propagate_tensor_meta_non_cached"])
def test_meter_raises_without_the_propagation_methods(monkeypatch, name):
    """A torch whose sharding propagator lacks one of the private methods
    the meter wraps fails the plan instead of counting DTensor's
    global-shape ops as the position's."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    from repro_torch.launch.plan import ShardMeter

    monkeypatch.delattr(ShardingPropagator, name)
    with pytest.raises(RuntimeError, match=name):
        with ShardMeter():
            pass


if __name__ == "__main__":
    with open(sys.argv[1], "w") as f:
        json.dump(plans(), f)
