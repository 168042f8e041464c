"""The port's sharded serve step: decode and prefill of every ``attn_mlp``
arch's smoke config under ``DEFAULT_RULES`` on a (data 2, model 2) mesh of
four gloo processes on the CPU (``launch/spmd``), every parameter, cache
and input a ``DTensor``.

Each case is held to the same steps unsharded in this process and to the
reference's own sharded ``build_serve_step`` and prefill on a (2, 2) mesh
of four host devices, run in a subprocess (this file as a script under
``--xla_force_host_platform_device_count=4``), all three from the same
numpy parameters and inputs.  The four ranks are spawned once for the
module (each imports this module, which loads no JAX: the reference's
side imports it inside ``reference_side``); the subprocess runs
meanwhile.

Tolerance: float32, TOL absolute on logits of magnitude ~1 and on the
caches.  The three sides run the same operations, but a product split
over "model" sums its halves in another order, and where the reference
and DTensor reduce differs (GSPMD and DTensor choose their collectives
independently), so the sums round differently: a few float32 ulps a
layer, under 1e-6 at these widths; 1e-5 is the bound the port's unsharded
model is held to against the reference (``test_torch_models.py``)."""

import dataclasses
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, shard_params  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch.inputs import shard_batch, shard_caches  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch.sharding import (DEFAULT_RULES,  # noqa: E402
                                         ShardingRules, shard_shape)
from repro_torch.launch.steps import (build_prefill_step,  # noqa: E402
                                      build_serve_step)
from repro_torch.models import init_caches, param_shapes  # noqa: E402
from repro_torch.models.layers import (tree_paths,  # noqa: E402
                                       tree_unflatten)
from repro_torch.models.model import Caches  # noqa: E402

# ------------------------------------------- inputs and the rank body

ARCHS = ("qwen2-0.5b", "qwen2.5-14b", "glm4-9b", "command-r-plus-104b",
         "musicgen-large")
# an arch of each recurrent and cross-attention block, whose layer, weights
# and steps run here at a glance (test_torch_sharded_ssm.py and
# test_torch_sharded_xattn.py hold them to the reference; the MoE and MLA
# blocks, test_torch_sharded_moe.py)
OTHER_ARCHS = {"hybrid": "hymba-1.5b", "mlstm": "xlstm-1.3b",
               "slstm": "xlstm-1.3b",
               "cross_attn_mlp": "llama-3.2-vision-11b"}
MESH, AXES = (2, 2), ("data", "model")
B, S, STEPS = 4, 8, 3
# T >= 256 puts the caches' context on "model" (inputs.cache_specs), so
# that a decode write lands on one rank's piece; CACHE_T_SMALL keeps it
# whole (the qwen2 case "t32")
CACHE_T, CACHE_T_SMALL = 256, 32
# the "cross" case decodes on from caches whose first CROSS_POS slots are
# written: its three steps write slots T/2 - 2, T/2 - 1 (the first piece
# over "model") and T/2 (the second), and attend to keys in both pieces
CROSS_POS = CACHE_T // 2 - 2
SEED = 0


def cases() -> list:
    """(case name, arch, cache length, slots written before the decode)."""
    return [(a, a, CACHE_T, 0) for a in ARCHS] + \
        [("qwen2-0.5b-t32", "qwen2-0.5b", CACHE_T_SMALL, 0),
         ("command-r-plus-104b-cross", "command-r-plus-104b", CACHE_T,
          CROSS_POS)]


def np_params(cfg, seed: int = SEED) -> dict:
    """Every leaf of ``param_shapes(cfg)`` as float32 numpy, from ``seed``:
    matrices N(0, 0.02), norm scales 1 + N(0, 0.1), biases N(0, 0.1), so
    that no scale or bias is trivial."""
    rng = np.random.default_rng(seed)
    shapes = param_shapes(cfg)
    leaves = []
    for name, s in tree_paths(shapes):
        norm = "norm" in name or name.rsplit(".", 1)[-1] in ("ln1", "ln2")
        if len(s.shape) >= 2 and not norm:
            a = rng.standard_normal(s.shape) * 0.02
        else:
            a = norm + rng.standard_normal(s.shape) * 0.1
        leaves.append(a.astype(np.float32))
    return tree_unflatten(shapes, leaves)


def np_inputs(cfg, seed: int = SEED + 1) -> dict:
    """The prompts (B, S) and one token a decode step (STEPS, B, 1), or
    embeddings for a config that takes them."""
    rng = np.random.default_rng(seed)
    if cfg.inputs_embeds:
        return {"embeds": rng.standard_normal((B, S, cfg.d_model))
                .astype(np.float32),
                "step_embeds": rng.standard_normal(
                    (STEPS, B, 1, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "step_tokens": rng.integers(0, cfg.vocab, (STEPS, B, 1))
            .astype(np.int32)}


def np_caches(cfg, T: int, pos: int, seed: int = SEED + 2) -> dict:
    """``init_caches(cfg, B, T)`` as numpy with the first ``pos`` slots of
    every k and v N(0, 1) from ``seed`` and every ``pos`` leaf at ``pos``:
    caches a decode goes on from."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, c in init_caches(cfg, B, T, device="cpu").items():
        out[key] = {}
        for n, v in sorted(c.items()):
            a = np.zeros(tuple(v.shape), _np(v).dtype)
            if n == "pos":
                a = np.full(tuple(v.shape), pos, np.int32)
            else:
                a[:, :, :pos] = rng.standard_normal(a[:, :, :pos].shape)
            out[key][n] = a
    return out


def torch_caches(cfg, T: int, pos: int, device) -> Caches:
    """:func:`np_caches` as the port's caches on ``device``."""
    return Caches({k: {n: torch.from_numpy(v).to(device)
                       for n, v in c.items()}
                   for k, c in np_caches(cfg, T, pos).items()})


def _batches(cfg, x: dict) -> tuple:
    key = "embeds" if cfg.inputs_embeds else "tokens"
    prompt = {key: torch.from_numpy(x[key])}
    steps = [{key: torch.from_numpy(t)} for t in x["step_" + key]]
    return prompt, steps


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def run_steps(params, cfg, caches, x: dict, rules=None, mesh=None,
              to_global=lambda t: t, lay_out=lambda b: b) -> dict:
    """The prefill's logits, each decode step's and the caches after them,
    as numpy."""
    prefill = build_prefill_step(cfg, rules, mesh)
    serve = build_serve_step(cfg, rules, mesh)
    prompt, steps = _batches(cfg, x)
    out = {"prefill": _np(to_global(prefill(params, lay_out(prompt)))),
           "decode": []}
    for b in steps:
        logits, caches = serve(params, caches, lay_out(b))
        out["decode"].append(_np(to_global(logits)))
    out["caches"] = {k: {n: _np(to_global(v)) for n, v in c.items()}
                     for k, c in caches.items()}
    return out


def unsharded_steps(arch: str, T: int, pos: int) -> dict:
    """The same steps on one process, no rules, on the CPU."""
    cfg = get_smoke_config(arch)
    params = params_from_numpy(np_params(cfg), cfg, "cpu")
    return run_steps(params, cfg, torch_caches(cfg, T, pos, "cpu"),
                     np_inputs(cfg))


def _local_shapes(tree, specs) -> list:
    """(name, local shape, shard_shape of the spec) of every leaf."""
    return [(name, tuple(t.to_local().shape),
             shard_shape(s.shape, s.spec, s.mesh.axis_sizes))
            for (name, t), (_, s) in zip(tree_paths(tree), tree_paths(specs))]


def rank_body(rank: int, device, cases_: list, other: dict,
              staged: bool = False) -> dict:
    """One rank of the (2, 2) mesh: each case's steps sharded under
    DEFAULT_RULES, its local shapes, and what each other block's config
    gave (:func:`other_block`).  ``staged``: the collectives run through
    ``spmd.stage_through_host`` (the card's gloo path) on the CPU."""
    from repro_torch.launch import spmd
    from repro_torch.launch.inputs import cache_specs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.sharding import param_sharding

    if staged:
        spmd.stage_through_host("CPU")
    mesh = make_process_mesh(MESH, AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    out = {"coordinate": mesh.coordinate, "cases": {}, "other": {}}
    for name, arch, T, pos in cases_:
        cfg = get_smoke_config(arch)
        params = shard_params(params_from_numpy(np_params(cfg), cfg, device),
                              mesh, rules)
        caches = shard_caches(cfg, B, T, mesh, rules, whole=(
            torch_caches(cfg, T, pos, device) if pos else None))
        shapes = _local_shapes(params.tree(),
                               param_sharding(mesh, rules, param_shapes(cfg)))
        shapes += _local_shapes(dict(caches), cache_specs(
            cfg, ShapeSpec("serve", T, B, "decode"), mesh, rules))
        res = run_steps(params, cfg, caches, np_inputs(cfg), rules, mesh,
                        to_global=lambda t: t.full_tensor(),
                        lay_out=lambda b: shard_batch(b, mesh))
        res["shapes"] = shapes
        out["cases"][name] = res
    for block, arch in other.items():
        out["other"][block] = other_block(block, arch, mesh, rules, device)
    return out


def other_block(block: str, arch: str, mesh, rules, device) -> dict:
    """``arch``'s smoke config (one unit) on the process mesh: whether
    ``shard_params`` made every parameter a DTensor, and the global shape
    and finiteness of what the prefill step, a decode step and the first
    ``block`` layer itself (on a batch-split input) return."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.sharding import P, distribute, rules_ctx

    cfg = dataclasses.replace(get_smoke_config(arch), n_units=1)
    model = shard_params(params_from_numpy(np_params(cfg), cfg, device),
                         mesh, rules)
    out = {"shard_params": all(isinstance(t, DTensor)
                               for t in model.parameters())}
    x = np_inputs(cfg)
    aux = {}
    if cfg.n_image_tokens:
        aux["image_embed"] = torch.ones(B, cfg.n_image_tokens, cfg.d_model,
                                        device=device)

    def seen(t) -> tuple:
        return (isinstance(t, DTensor), tuple(t.shape),
                bool(torch.isfinite(t.full_tensor()).all()))

    def batch(tokens):
        return shard_batch({"tokens": torch.from_numpy(tokens).to(device),
                            **aux}, mesh)

    out["prefill_step"] = seen(build_prefill_step(cfg, rules, mesh)(
        model, batch(x["tokens"])))
    caches = shard_caches(cfg, B, CACHE_T_SMALL, mesh, rules)
    out["serve_step"] = seen(build_serve_step(cfg, rules, mesh)(
        model, caches, batch(x["step_tokens"][0]))[0])
    layer = next(m for m in model.blocks if m.block == block)
    h = distribute(torch.ones(B, S, cfg.d_model, device=device), P("data"),
                   mesh)
    with rules_ctx(rules, mesh), torch.inference_mode():
        y, _ = layer(h, cfg, {k: distribute(v, P("data"), mesh)
                              for k, v in aux.items()})
    out["layer"] = seen(y)
    return out


def failing_body(rank: int, device) -> int:
    """Rank 1 raises; rank 0 would run on for a minute."""
    if rank == 1:
        raise ValueError("rank 1 fails")
    time.sleep(60)
    return rank


# ------------------------------------------------------------- the tests

TOL = 1e-5
CASES = [c[0] for c in cases()]


# ----------------------------------------------------- the reference's side

def reference_side(path: str) -> None:
    """The reference's sharded prefill and decode of every case on a (2, 2)
    mesh of four host devices, saved to ``path`` (npz)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import get_smoke_config
    from repro.configs.base import ShapeSpec
    from repro.core.jaxcompat import make_mesh, set_mesh
    from repro.launch.inputs import _bspec, cache_specs, param_specs_sharded
    from repro.launch.sharding import DEFAULT_RULES, ShardingRules, rules_ctx
    from repro.launch.steps import build_serve_step
    from repro.models import forward
    from repro_torch.configs import get_smoke_config as pcfg

    mesh = make_mesh(MESH, AXES, devices=jax.devices()[:4])
    rules = ShardingRules(DEFAULT_RULES)
    out = {}
    with set_mesh(mesh):
        for name, arch, T, pos in cases():
            cfg = get_smoke_config(arch)
            x = np_inputs(pcfg(arch))
            specs = param_specs_sharded(cfg, mesh, rules)
            params = jax.tree.map(
                lambda a, s: jax.device_put(jnp.asarray(a, s.dtype),
                                            s.sharding),
                np_params(pcfg(arch)), specs)
            caches = jax.tree.map(
                lambda a, s: jax.device_put(jnp.asarray(a, s.dtype),
                                            s.sharding),
                np_caches(pcfg(arch), T, pos),
                cache_specs(cfg, ShapeSpec("serve", T, B, "decode"), mesh,
                            rules))
            key = "embeds" if cfg.inputs_embeds else "tokens"
            bsh = NamedSharding(mesh, _bspec(mesh, B))

            def prefill(params, batch):
                with rules_ctx(rules, mesh):
                    return forward(params, cfg, remat="none", last_only=True,
                                   **batch)[0]

            out[f"{name}|prefill"] = np.asarray(jax.jit(prefill)(
                params, {key: jax.device_put(x[key], bsh)}))
            step = jax.jit(build_serve_step(cfg, rules, mesh))
            for i, t in enumerate(x["step_" + key]):
                logits, caches = step(params, caches,
                                      {key: jax.device_put(t, bsh)})
                out[f"{name}|decode{i}"] = np.asarray(logits)
            for k, c in caches.items():
                for n, v in c.items():
                    out[f"{name}|cache|{k}|{n}"] = np.asarray(v)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def results():
    """(the four ranks' results, the reference's arrays): the reference's
    subprocess runs while the ranks do."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(REPO, "src"), os.path.join(REPO, "port")]))
        ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                path], env=env, cwd=REPO)
        try:
            ranks = spmd.run(rank_body, ["cpu"] * 4, "gloo",
                             (cases(), OTHER_ARCHS))
        finally:
            rc = ref.wait(timeout=300)
        assert rc == 0, "the reference's side failed"
        with np.load(path) as z:
            return ranks, dict(z)


@pytest.fixture(scope="module")
def unsharded():
    return {name: unsharded_steps(arch, T, pos)
            for name, arch, T, pos in cases()}


def _close(got, want) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


# ------------------------------------------------------------- the cases

@pytest.mark.parametrize("case", CASES)
def test_sharded_steps_match_unsharded(results, unsharded, case):
    """Prefill, three decode steps and the caches after them, on every
    rank (each gathers the global logits) against one process."""
    ranks, _ = results
    want = unsharded[case]
    for r in ranks:
        got = r["cases"][case]
        _close(got["prefill"], want["prefill"])
        assert got["prefill"].shape == (B, 1, want["prefill"].shape[-1])
        assert len(got["decode"]) == STEPS
        for g, w in zip(got["decode"], want["decode"]):
            _close(g, w)
        for k, c in want["caches"].items():
            for n, v in c.items():
                _close(got["caches"][k][n], v)
    if case.endswith("-cross"):
        # the last step wrote the second piece's first slot, and no later
        for c in want["caches"].values():
            assert c["k"][:, :, CACHE_T // 2].any()
            assert not c["k"][:, :, CACHE_T // 2 + 1:].any()


@pytest.mark.parametrize("case", CASES)
def test_sharded_steps_match_reference_sharded(results, case):
    ranks, ref = results
    got = ranks[0]["cases"][case]
    _close(got["prefill"], ref[f"{case}|prefill"])
    for i, g in enumerate(got["decode"]):
        _close(g, ref[f"{case}|decode{i}"])
    for k, c in got["caches"].items():
        for n, v in c.items():
            _close(v, ref[f"{case}|cache|{k}|{n}"])


@pytest.mark.parametrize("case", CASES)
def test_local_shards_have_shard_shape(results, case):
    """Every rank's piece of every parameter and cache leaf has the shape
    ``shard_shape`` gives its spec; the large matrices (``wq``, ``w1``)
    are split four ways (nothing quietly replicated); the four ranks sit
    at the mesh's four positions."""
    ranks, _ = results
    arch = dict((c[0], c[1]) for c in cases())[case]
    for r in ranks:
        shapes = r["cases"][case]["shapes"]
        assert shapes and all(local == want for _, local, want in shapes), \
            [s for s in shapes if s[1] != s[2]]
    leaves = dict(tree_paths(param_shapes(get_smoke_config(arch))))
    split = [p for p, local, _ in ranks[0]["cases"][case]["shapes"]
             if p in leaves
             and np.prod(local) * 4 == np.prod(leaves[p].shape)]
    assert any("w1" in p for p in split) and any("wq" in p for p in split)
    assert {r["coordinate"] for r in ranks} == {(0, 0), (0, 1), (1, 0),
                                                (1, 1)}


@pytest.mark.parametrize("block", sorted(OTHER_ARCHS))
def test_other_blocks_run_on_a_process_mesh(results, block):
    """``shard_params``, both steps and the block's layer itself run on the
    process mesh, each returning a DTensor of the global shape, finite."""
    ranks, _ = results
    cfg = get_smoke_config(OTHER_ARCHS[block])
    for r in ranks:
        got = r["other"][block]
        assert got == {"shard_params": True,
                       "prefill_step": (True, (B, 1, cfg.vocab), True),
                       "serve_step": (True, (B, 1, cfg.vocab), True),
                       "layer": (True, (B, S, cfg.d_model), True)}, got


def test_host_staged_collectives_match_unsharded(unsharded):
    """The collectives staged through host copies, as on a card shared by
    gloo ranks (``spmd.stage_through_host``), give the same steps."""
    case = cases()[3]                      # command-r: parallel block
    r = spmd.run(rank_body, ["cpu"] * 4, "gloo", ([case], {}, True))
    want = unsharded[case[0]]
    for got in (x["cases"][case[0]] for x in r):
        _close(got["prefill"], want["prefill"])
        for g, w in zip(got["decode"], want["decode"]):
            _close(g, w)


def test_a_rank_exception_fails_the_launcher():
    """The parent raises rank 1's error, with its traceback, and ends rank
    0 long before it would have returned."""
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="rank 1 fails"):
        spmd.run(failing_body, ["cpu"] * 2, "gloo")
    assert time.perf_counter() - t0 < 50


# ------------------------------------------------ spec -> placements

def _fake_mesh(shape, axes, coordinate=None):
    """A stand-in ProcessMesh: the axes and shape of a DeviceMesh, with no
    process group."""
    from repro_torch.core.mesh import ProcessMesh

    class Grid:
        mesh_dim_names = tuple(axes)
        mesh = torch.empty(shape)

        def get_coordinate(self):
            return list(coordinate)

    return ProcessMesh(Grid(), "cpu")


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.sharding import (P, _filter_spec,
                                             logical_to_spec, placements)

    mesh = _fake_mesh((2, 4, 2), ("pod", "data", "model"))
    R = Replicate()
    assert placements(P(), mesh) == (R, R, R)
    assert placements(P(None, "model"), mesh) == (R, R, Shard(1))
    # two axes on one dimension, in mesh order (major to minor)
    assert placements(P(("pod", "data"), "model"), mesh) == \
        (Shard(0), Shard(0), Shard(1))
    assert placements(P("model", ("pod", "data")), mesh) == \
        (Shard(1), Shard(1), Shard(0))
    with pytest.raises(ValueError, match="order"):
        placements(P(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="twice"):
        placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="not an axis"):
        placements(P("expert"), mesh)
    # an axis that does not divide its dimension is skipped by the
    # resolution, so the dimension stays whole
    spec = logical_to_spec({"vocab": "model", "embed_fsdp": ("pod", "data")},
                           ("vocab", "embed"), shape=(7, 16),
                           mesh=_fake_mesh((2, 4, 2),
                                           ("pod", "data", "model")))
    assert spec == P(None, ("pod", "data"))
    assert placements(spec, mesh) == (Shard(1), Shard(1), R)
    assert _filter_spec(P(("pod", "data")), mesh.axis_sizes, (12,)) == P(None)


def test_local_shard_by_hand():
    from repro_torch.launch.sharding import P, local_shard

    t = torch.arange(8 * 6).reshape(8, 6)
    # ("pod", "data") on dim 0: pod-major, so position (1, 0) holds rows
    # 4-5 of 8 (pod 1 of 2, data 0 of 2), and "model" 1 of 3 columns 2-3
    m = _fake_mesh((2, 2, 3), ("pod", "data", "model"), (1, 0, 1))
    got = local_shard(t, P(("pod", "data"), "model"), m)
    assert torch.equal(got, t[4:6, 2:4])
    m = _fake_mesh((2, 2, 3), ("pod", "data", "model"), (0, 1, 2))
    assert torch.equal(local_shard(t, P("data", "model"), m), t[4:8, 4:6])
    with pytest.raises(ValueError, match="split"):
        local_shard(t, P("model", "data"), m)


def test_constraint_raises_on_a_plain_tensor_under_a_process_mesh():
    from repro_torch.launch.sharding import (DEFAULT_RULES, ShardingRules,
                                             constraint, rules_ctx)

    mesh = _fake_mesh((2, 2), ("data", "model"), (0, 0))
    with rules_ctx(ShardingRules(DEFAULT_RULES), mesh):
        with pytest.raises(TypeError, match="plain"):
            constraint(torch.zeros(4, 2, 8), ("batch", "seq", "embed"))
    # without a mesh of processes, a layout hint is the tensor itself
    x = torch.zeros(4, 2, 8)
    with rules_ctx(ShardingRules(DEFAULT_RULES)):
        assert constraint(x, ("batch", "seq", "embed")) is x


def test_one_process_mesh_of_distinct_devices_still_raises():
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch.steps import build_serve_step

    mesh = make_mesh((2,), ("model",), ["cpu", "meta"])
    with pytest.raises(NotImplementedError, match="in one process"):
        mesh.device()
    with pytest.raises(NotImplementedError):
        build_serve_step(get_smoke_config("qwen2-0.5b"), None, mesh)


if __name__ == "__main__":
    reference_side(sys.argv[1])
