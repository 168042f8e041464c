"""The port's sharded serve step for the recurrent blocks: decode and
prefill of the ``hybrid`` block (hymba-1.5b: attention and Mamba heads
side by side) under ``DEFAULT_RULES`` on a (data 2, model 2) mesh of four
gloo processes on the CPU (``launch/spmd``), every parameter, cache and
input a ``DTensor``; ``test_torch_sharded_xlstm.py`` holds ``mlstm`` and
``slstm`` (xlstm-1.3b) and ``test_torch_sharded_xattn.py``
``cross_attn_mlp`` the same way, with this file's helpers.

As ``test_torch_sharded_serve.py`` does for ``attn_mlp``: each case is held
to the same steps unsharded in this process and to the reference's own
sharded ``build_serve_step`` and prefill on a (2, 2) mesh of four host
devices, run in a subprocess (the test file as a script under
``--xla_force_host_platform_device_count=4``), all three from the same
numpy parameters, inputs and caches, within TOL (1e-5) in float32 on
logits and whole caches (every leaf of the nested ``hybrid`` cache and the
recurrent states).  A decode that goes on from written slots also starts
from recurrent states drawn from the seed, so that its write-back replaces
a state, not zeros.  The cases:

- the smoke config at T 256;
- a window of 256 at T 512, decoding on from slot 254: the ring (256 =
  the window) splits over "model" at 128 and wraps from its second piece
  to its first;
- prefills of 512 and 1024 tokens: one chunk of Mamba's scan
  (``MAMBA_CHUNK``), and two with the state carried across."""

import dataclasses
import os
import subprocess
import sys
import tempfile

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
                                         ShardingRules)
from repro_torch.launch.steps import (build_prefill_step,  # noqa: E402
                                      build_serve_step)
from repro_torch.models import init_caches, param_shapes  # noqa: E402
from repro_torch.models.layers import tree_paths, tree_unflatten  # noqa: E402
from repro_torch.models.model import Caches  # noqa: E402
from test_torch_sharded_serve import (AXES, MESH, STEPS, TOL,  # noqa: E402
                                      _local_shapes, _np)

HY = "hymba-1.5b"
B = 4
SEED = 0
GATE = 0.5        # the cross-attention gates (0 at init: the identity)


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    arch: str
    T: int = 256                   # cache length
    pos: int = 0                   # slots written before the decode
    S: int = 8                     # prompt length
    replace: tuple = ()            # config fields replaced

    def cfg(self, get=get_smoke_config):
        return dataclasses.replace(get(self.arch), **dict(self.replace))


CASES = [Case(HY, HY),
         Case(f"{HY}-ring", HY, T=512, pos=254, replace=(("window", 256),)),
         Case(f"{HY}-s512", HY, S=512, replace=(("n_units", 1),)),
         Case(f"{HY}-s1024", HY, S=1024, replace=(("n_units", 1),))]


def np_params(cfg, seed: int = SEED) -> dict:
    """Every leaf of ``param_shapes(cfg)`` as float32 numpy, from ``seed``:
    matrices N(0, 0.02), norm scales (hymba's ``na`` and ``nm`` too)
    1 + N(0, 0.1), other vectors N(0, 0.1); every gate GATE."""
    rng = np.random.default_rng(seed)
    shapes = param_shapes(cfg)
    leaves = []
    for name, s in tree_paths(shapes):
        last = name.rsplit(".", 1)[-1]
        norm = "norm" in name or last in ("ln1", "ln2", "na", "nm")
        if len(s.shape) >= 2 and not norm:
            a = rng.standard_normal(s.shape) * 0.02
        else:
            a = norm + rng.standard_normal(s.shape) * 0.1
        if "gate" in last:
            a = np.full(s.shape, GATE)
        leaves.append(a.astype(np.float32))
    return tree_unflatten(shapes, leaves)


def np_inputs(case, seed: int = SEED + 1) -> dict:
    """The prompts (B, S), one token a decode step (STEPS, B, 1) and, for
    a config with image tokens, the image embeddings (B, I, D) N(0, 1)."""
    cfg = case.cfg()
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, case.S)).astype(np.int32),
           "step_tokens": rng.integers(0, cfg.vocab, (STEPS, B, 1))
           .astype(np.int32)}
    if cfg.n_image_tokens:
        out["image"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return out


def np_caches(case, seed: int = SEED + 2) -> dict:
    """``init_caches(cfg, B, T)`` as numpy, every ``pos`` leaf at ``pos``.
    With ``pos`` > 0 the first ``pos`` slots of every k and v are N(0, 1)
    from ``seed``, and so is every recurrent state leaf whole (the
    normalizers ``n`` their magnitudes): the state a decode goes on
    from."""
    rng = np.random.default_rng(seed)

    def fill(path, v):
        a = np.zeros(tuple(v.shape), _np(v).dtype if v.is_floating_point()
                     else np.int32)
        name = path[-1]
        if name == "pos":
            a[...] = case.pos
        elif not case.pos:
            pass
        elif name in ("k", "v"):
            a[:, :, :case.pos] = rng.standard_normal(
                a[:, :, :case.pos].shape)
        else:
            a[...] = rng.standard_normal(a.shape)
            if name == "n":
                a = np.abs(a)
        return a

    return _walk(fill, dict(init_caches(case.cfg(), B, case.T, device="cpu")))


def _walk(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return {k: _walk(fn, tree[k], path + (k,)) for k in sorted(tree)}
    return fn(path, tree)


def torch_caches(case, device) -> Caches:
    return Caches(_walk(lambda _, a: torch.from_numpy(a).to(device),
                        np_caches(case)))


def _batch(x: dict, tokens) -> dict:
    out = {"tokens": torch.from_numpy(tokens)}
    if "image" in x:
        out["image_embed"] = torch.from_numpy(x["image"]).to(torch.bfloat16)
    return out


def run_steps(params, case, caches, rules=None, mesh=None,
              to_global=lambda t: t, lay_out=lambda b: b) -> dict:
    """The prefill's logits, each decode step's and the caches after them
    (by dotted path), as numpy."""
    cfg = case.cfg()
    x = np_inputs(case)
    prefill = build_prefill_step(cfg, rules, mesh)
    serve = build_serve_step(cfg, rules, mesh)
    out = {"prefill": _np(to_global(prefill(
        params, lay_out(_batch(x, x["tokens"]))))), "decode": []}
    for t in x["step_tokens"]:
        logits, caches = serve(params, caches, lay_out(_batch(x, t)))
        out["decode"].append(_np(to_global(logits)))
    out["caches"] = {p: _np(to_global(v)) for p, v in tree_paths(dict(caches))}
    return out


def unsharded_steps(case) -> dict:
    """The same steps on one process, no rules, on the CPU."""
    cfg = case.cfg()
    params = params_from_numpy(np_params(cfg), cfg, "cpu")
    return run_steps(params, case, torch_caches(case, "cpu"))


def rank_body(rank: int, device, cases: list) -> dict:
    """One rank of the (2, 2) mesh: each case's steps sharded under
    DEFAULT_RULES and its local shapes."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.inputs import cache_specs
    from repro_torch.launch.sharding import param_sharding

    mesh = make_process_mesh(MESH, AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    out = {"coordinate": mesh.coordinate, "cases": {}}
    for case in cases:
        cfg = case.cfg()
        params = shard_params(params_from_numpy(np_params(cfg), cfg, device),
                              mesh, rules)
        caches = shard_caches(cfg, B, case.T, mesh, rules, whole=(
            torch_caches(case, device) if case.pos else None))
        shapes = _local_shapes(params.tree(),
                               param_sharding(mesh, rules, param_shapes(cfg)))
        shapes += _local_shapes(dict(caches), cache_specs(
            cfg, ShapeSpec("serve", case.T, B, "decode"), mesh, rules))
        res = run_steps(params, case, caches, rules, mesh,
                        to_global=lambda t: t.full_tensor(),
                        lay_out=lambda b: shard_batch(b, mesh))
        res["shapes"] = shapes
        x = np_inputs(case)
        if "image" in x:
            res["image_local"] = tuple(shard_batch(
                _batch(x, x["tokens"]), mesh)["image_embed"].to_local().shape)
        out["cases"][case.name] = res
    return out


# ----------------------------------------------------- the reference's side

def reference_side(cases: list, path: str) -> None:
    """The reference's sharded prefill and decode of every case on a (2, 2)
    mesh of four host devices, saved to ``path`` (npz)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import get_smoke_config as rcfg
    from repro.configs.base import ShapeSpec
    from repro.core.jaxcompat import make_mesh, set_mesh
    from repro.launch.inputs import _bspec, cache_specs, param_specs_sharded
    from repro.launch.sharding import (DEFAULT_RULES as RULES,
                                       ShardingRules as Rules, rules_ctx)
    from repro.launch.steps import build_serve_step as serve_step
    from repro.models import forward

    mesh = make_mesh(MESH, AXES, devices=jax.devices()[:4])
    rules = Rules(RULES)
    out = {}

    def put(tree, specs):
        return jax.tree.map(lambda a, s: jax.device_put(
            jnp.asarray(a, s.dtype), s.sharding), tree, specs)

    with set_mesh(mesh):
        for case in cases:
            cfg = case.cfg(rcfg)
            x = np_inputs(case)
            params = put(np_params(case.cfg()),
                         param_specs_sharded(cfg, mesh, rules))
            caches = put(np_caches(case), cache_specs(
                cfg, ShapeSpec("serve", case.T, B, "decode"), mesh, rules))
            bsh = NamedSharding(mesh, _bspec(mesh, B))

            def batch(tokens):
                b = {"tokens": jax.device_put(tokens, bsh)}
                if "image" in x:
                    b["image_embed"] = jax.device_put(
                        jnp.asarray(x["image"], jnp.bfloat16), bsh)
                return b

            def prefill(params, b):
                with rules_ctx(rules, mesh):
                    return forward(params, cfg, tokens=b["tokens"],
                                   aux={k: v for k, v in b.items()
                                        if k == "image_embed"},
                                   remat="none", last_only=True)[0]

            out[f"{case.name}|prefill"] = np.asarray(
                jax.jit(prefill)(params, batch(x["tokens"])))
            step = jax.jit(serve_step(cfg, rules, mesh))
            for i, t in enumerate(x["step_tokens"]):
                logits, caches = step(params, caches, batch(t))
                out[f"{case.name}|decode{i}"] = np.asarray(logits)
            for p, v in tree_paths(caches):
                out[f"{case.name}|cache|{p}"] = np.asarray(v)
    np.savez(path, **out)


def launch(script: str, cases: list, timeout: int = 400) -> tuple:
    """(the four ranks' results, the reference's arrays): ``script`` (a
    test file) run as the reference's subprocess while the ranks run."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(REPO, "src"), os.path.join(REPO, "port"),
                        os.path.dirname(os.path.abspath(__file__))]))
        ref = subprocess.Popen([sys.executable, os.path.abspath(script),
                                path], env=env, cwd=REPO)
        try:
            ranks = spmd.run(rank_body, ["cpu"] * 4, "gloo", (cases,))
        finally:
            rc = ref.wait(timeout=timeout)
        assert rc == 0, "the reference's side failed"
        with np.load(path) as z:
            return ranks, dict(z)


def _close(got, want) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def check_unsharded(ranks: list, want: dict) -> None:
    """Prefill, three decode steps and every cache leaf after them, on
    every rank (each gathers the global tensors) against one process."""
    for r in ranks:
        got = r["prefill"]
        _close(got, want["prefill"])
        assert got.shape == (B, 1, want["prefill"].shape[-1])
        assert len(r["decode"]) == STEPS
        for g, w in zip(r["decode"], want["decode"]):
            _close(g, w)
        assert set(r["caches"]) == set(want["caches"])
        for p, v in want["caches"].items():
            _close(r["caches"][p], v)


def check_reference(got: dict, ref: dict, name: str) -> None:
    _close(got["prefill"], ref[f"{name}|prefill"])
    for i, g in enumerate(got["decode"]):
        _close(g, ref[f"{name}|decode{i}"])
    for p, v in got["caches"].items():
        _close(v, ref[f"{name}|cache|{p}"])


def check_shapes(ranks: list, name: str) -> None:
    """Every rank's piece of every parameter and cache leaf has the shape
    ``shard_shape`` gives its spec; the four ranks sit at the mesh's four
    positions."""
    for r in ranks:
        shapes = r["cases"][name]["shapes"]
        assert shapes and all(local == want for _, local, want in shapes), \
            [s for s in shapes if s[1] != s[2]]
    assert {r["coordinate"] for r in ranks} == {(0, 0), (0, 1), (1, 0),
                                                (1, 1)}


def local_of(ranks: list, name: str) -> dict:
    """Rank 0's local shape of each leaf of case ``name``."""
    return {p: local for p, local, _ in ranks[0]["cases"][name]["shapes"]}


def check_states_moved(case, want: dict) -> None:
    """A decode from written slots changed every recurrent state leaf from
    the state it started from (no write-back left a leaf as it was)."""
    if not case.pos:
        return
    first = dict(tree_paths(np_caches(case)))
    for p, v in want["caches"].items():
        if p.rsplit(".", 1)[-1] not in ("k", "v", "pos"):
            assert (v != first[p]).all(), p


def check_split_four_ways(ranks: list, case, leaves: tuple) -> None:
    """Each leaf whose path ends with one of ``leaves`` is split four ways
    on rank 0 ("data" on "embed", "model" on "mlp"): nothing quietly
    replicated."""
    whole = dict(tree_paths(param_shapes(case.cfg())))
    split = [p for p, local in local_of(ranks, case.name).items()
             if p in whole and np.prod(local) * 4 == np.prod(whole[p].shape)]
    for w in leaves:
        assert any(p.endswith(w) for p in split), (w, split)


# ------------------------------------------------------------- the cases

NAMES = [c.name for c in CASES]
BY_NAME = {c.name: c for c in CASES}


@pytest.fixture(scope="module")
def results():
    return launch(__file__, CASES)


@pytest.fixture(scope="module")
def unsharded():
    return {c.name: unsharded_steps(c) for c in CASES}


@pytest.mark.parametrize("case", NAMES)
def test_sharded_steps_match_unsharded(results, unsharded, case):
    ranks, _ = results
    check_unsharded([r["cases"][case] for r in ranks], unsharded[case])
    check_states_moved(BY_NAME[case], unsharded[case])


@pytest.mark.parametrize("case", NAMES)
def test_sharded_steps_match_reference_sharded(results, case):
    ranks, ref = results
    check_reference(ranks[0]["cases"][case], ref, case)


@pytest.mark.parametrize("case", NAMES)
def test_local_shards_have_shard_shape(results, case):
    """As ``shard_shape`` says, Mamba's ``in_proj`` and the MLP's ``w1``
    split four ways."""
    ranks, _ = results
    check_shapes(ranks, case)
    check_split_four_ways(ranks, BY_NAME[case], ("mamba.in_proj", "mlp.w1"))


def test_hymba_ring_splits_and_wraps(results, unsharded):
    """The ring of 256 slots (the window) splits over "model" at 128; the
    three steps from slot 254 write slots 254, 255 (the second piece) and
    0 (the first), over what the caches held; the Mamba state and the
    conv history split only the batch."""
    case = BY_NAME[f"{HY}-ring"]
    ranks, _ = results
    local = local_of(ranks, case.name)
    L = case.cfg().n_units
    k = next(v for p, v in local.items() if p.endswith("attn.k"))
    assert k[:3] == (L, B // 2, 128)
    h = next(v for p, v in local.items() if p.endswith("mamba.h"))
    Di = case.cfg().ssm_expand * case.cfg().d_model
    assert h == (L, B // 2, Di, case.cfg().ssm_state)
    first = dict(tree_paths(np_caches(case)))
    for p, v in unsharded[case.name]["caches"].items():
        if p.endswith("attn.k"):
            assert (case.pos + STEPS - 1) % case.cfg().window == 0
            assert (v[:, :, 0] != first[p][:, :, 0]).all()
            assert (v[:, :, 254:256] != first[p][:, :, 254:256]).all()
            np.testing.assert_array_equal(v[:, :, 1:254],
                                          first[p][:, :, 1:254])


if __name__ == "__main__":
    reference_side(CASES, sys.argv[1])
