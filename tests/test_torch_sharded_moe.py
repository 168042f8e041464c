"""The port's sharded serve step for the MoE and MLA blocks: decode and
prefill of ``attn_moe`` (mixtral-8x22b) and ``mla_dense`` + ``mla_moe``
(deepseek-v2-lite-16b) smoke configs under ``DEFAULT_RULES`` on a (data 2,
model 2) mesh of four gloo processes on the CPU (``launch/spmd``), every
parameter, cache and input a ``DTensor``.

As ``test_torch_sharded_serve.py`` does for ``attn_mlp``: each case is held
to the same steps unsharded in this process and to the reference's own
sharded ``build_serve_step`` and prefill on a (2, 2) mesh of four host
devices, run in a subprocess (this file as a script under
``--xla_force_host_platform_device_count=4``), all three from the same
numpy parameters and inputs, within TOL (1e-5) in float32 on logits and
whole caches.  The cases:

- both configs at T 256 (deepseek's MLA cache, c_kv and k_rope, splits
  its context over "model"; mixtral's 64-slot window ring does not);
- deepseek decoding on from 126 written slots, across the split at 128;
- deepseek prefilling prompts of one repeated id, so that every token
  routes to the same experts and the unsharded port drops assignments
  past the capacity: the kept slots of every MoE layer's dispatch are
  the same on all three sides (the group of all 32 tokens spans both
  data ranks, whose slots are ranked one after the other);
- a prefill of 4 x 512 tokens: two groups of 1024, one a data rank;
- mixtral with 3 experts: they do not divide "model", so the experts
  stay whole and the per-expert "mlp" dimension takes "model";
- mixtral with a window of 256 at T 512, decoding on from slot 254: the
  ring (split over "model" at 128) wraps from its second piece to its
  first."""

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
from repro_torch.models import init_caches, param_shapes  # noqa: E402
from repro_torch.models.model import Caches  # noqa: E402
from test_torch_sharded_serve import (AXES, MESH, STEPS, TOL,  # noqa: E402
                                      _local_shapes, _np, np_params,
                                      run_steps)

DS, MX = "deepseek-v2-lite-16b", "mixtral-8x22b"
B = 4
SEED = 0


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    arch: str
    T: int = 256                   # cache length
    pos: int = 0                   # slots written before the decode
    S: int = 8                     # prompt length
    repeat: bool = False           # prompts of one repeated id
    replace: tuple = ()            # config fields replaced

    def cfg(self, get=get_smoke_config):
        return dataclasses.replace(get(self.arch), **dict(self.replace))


CASES = [Case(DS, DS), Case(MX, MX),
         Case(f"{DS}-cross", DS, pos=126),
         Case(f"{DS}-drops", DS, repeat=True),
         Case(f"{DS}-s512", DS, S=512),
         Case(f"{MX}-e3", MX, replace=(("n_experts", 3),)),
         Case(f"{MX}-ring", MX, T=512, pos=254,
              replace=(("window", 256),))]
NAMES = [c.name for c in CASES]
BY_NAME = {c.name: c for c in CASES}


def np_inputs(case: Case, seed: int = SEED + 1) -> dict:
    """The prompts (B, S) and one token a decode step (STEPS, B, 1)."""
    cfg = case.cfg()
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, case.S)).astype(np.int32)
    if case.repeat:
        tokens[:] = tokens[0, 0]
    return {"tokens": tokens,
            "step_tokens": rng.integers(0, cfg.vocab, (STEPS, B, 1))
            .astype(np.int32)}


def np_caches(case: Case, seed: int = SEED + 2) -> dict:
    """``init_caches(cfg, B, T)`` as numpy with the first ``pos`` slots of
    every cache leaf but ``pos`` N(0, 1) from ``seed`` and every ``pos``
    leaf at ``pos``."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, c in init_caches(case.cfg(), B, case.T, device="cpu").items():
        out[key] = {}
        for n, v in sorted(c.items()):
            a = np.zeros(tuple(v.shape), _np(v).dtype)
            if n == "pos":
                a = np.full(tuple(v.shape), case.pos, np.int32)
            else:
                a[:, :, :case.pos] = rng.standard_normal(
                    a[:, :, :case.pos].shape)
            out[key][n] = a
    return out


def torch_caches(case: Case, device) -> Caches:
    return Caches({k: {n: torch.from_numpy(v).to(device)
                       for n, v in c.items()}
                   for k, c in np_caches(case).items()})


class Routes:
    """While open: each ``moe.route`` call's kept slots, as (keep, dest)
    numpy arrays, in call order (the prefill's MoE layers first), and
    ``by_tokens``: the calls whose expert rows moved to the weights
    (``moe._experts_by_tokens``)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.calls, self.by_tokens = moe, [], []
        self.real = moe.route, moe._experts_by_tokens

        def spy(xg, router, K, C, before=None):
            out = self.real[0](xg, router, K, C, before)
            self.calls.append((out[3].numpy(), out[4].numpy()))
            return out

        def moved(*args):
            self.by_tokens.append(len(self.calls) - 1)
            return self.real[1](*args)
        moe.route, moe._experts_by_tokens = spy, moved
        return self

    def __exit__(self, *exc):
        self.moe.route, self.moe._experts_by_tokens = self.real


def occupied(calls: list) -> list:
    """Each call's sorted dispatch rows (group, row) of its kept slots."""
    return [sorted({(g, int(d)) for g in range(keep.shape[0])
                    for d in dest[g][keep[g]]}) for keep, dest in calls]


def rank_body(rank: int, device, cases: list) -> dict:
    """One rank: each case's steps sharded under DEFAULT_RULES, its local
    shapes, and each MoE dispatch's kept slots."""
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
        with Routes() as routes:
            res = run_steps(params, cfg, caches, np_inputs(case), rules,
                            mesh, to_global=lambda t: t.full_tensor(),
                            lay_out=lambda b: shard_batch(b, mesh))
        res["shapes"] = shapes
        res["routes"] = routes.calls
        res["by_tokens"] = routes.by_tokens
        out["cases"][case.name] = res
    return out


def unsharded_steps(case: Case) -> dict:
    cfg = case.cfg()
    params = params_from_numpy(np_params(cfg), cfg, "cpu")
    with Routes() as routes:
        out = run_steps(params, cfg, torch_caches(case, "cpu"),
                        np_inputs(case))
    out["routes"] = routes.calls
    return out


# ----------------------------------------------------- the reference's side

def reference_side(path: str) -> None:
    """The reference's sharded prefill and decode of every case on a (2, 2)
    mesh of four host devices, and the kept dispatch rows of the drops
    case's prefill (run unrolled and eagerly, its dispatch buffers read at
    their layout hint), saved to ``path`` (npz)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    import repro.models.moe as rmoe
    from repro.configs import get_smoke_config as rcfg
    from repro.configs.base import ShapeSpec
    from repro.core.jaxcompat import make_mesh, set_mesh
    from repro.launch.inputs import _bspec, cache_specs, param_specs_sharded
    from repro.launch.sharding import (DEFAULT_RULES as RULES,
                                       ShardingRules as Rules, rules_ctx)
    from repro.launch.steps import build_serve_step
    from repro.models import forward

    mesh = make_mesh(MESH, AXES, devices=jax.devices()[:4])
    rules = Rules(RULES)
    out = {}
    with set_mesh(mesh):
        for case in CASES:
            cfg = case.cfg(rcfg)
            x = np_inputs(case)
            specs = param_specs_sharded(cfg, mesh, rules)
            params = jax.tree.map(
                lambda a, s: jax.device_put(jnp.asarray(a, s.dtype),
                                            s.sharding),
                np_params(case.cfg()), specs)
            caches = jax.tree.map(
                lambda a, s: jax.device_put(jnp.asarray(a, s.dtype),
                                            s.sharding),
                np_caches(case),
                cache_specs(cfg, ShapeSpec("serve", case.T, B, "decode"),
                            mesh, rules))
            bsh = NamedSharding(mesh, _bspec(mesh, B))
            prompt = jax.device_put(x["tokens"], bsh)

            def prefill(params, tokens, unroll=False):
                with rules_ctx(rules, mesh):
                    return forward(params, cfg, remat="none", last_only=True,
                                   unroll=unroll, tokens=tokens)[0]

            out[f"{case.name}|prefill"] = np.asarray(
                jax.jit(prefill)(params, prompt))
            if case.repeat:
                seen, real = [], rmoe.shard

                def spy(t, axes):
                    if axes == ("batch", "experts", None, "embed"):
                        seen.append(np.asarray(t))
                    return real(t, axes)
                rmoe.shard = spy
                try:
                    prefill(params, prompt, unroll=True)
                finally:
                    rmoe.shard = real
                for i, eb in enumerate(seen):          # (G, E, C, D)
                    G, E, C, _ = eb.shape
                    out[f"{case.name}|kept{i}"] = (
                        np.abs(eb).max(axis=-1) > 0).reshape(G, E * C)
            step = jax.jit(build_serve_step(cfg, rules, mesh))
            for i, t in enumerate(x["step_tokens"]):
                logits, caches = step(params, caches,
                                      {"tokens": jax.device_put(t, bsh)})
                out[f"{case.name}|decode{i}"] = np.asarray(logits)
            for k, c in caches.items():
                for n, v in c.items():
                    out[f"{case.name}|cache|{k}|{n}"] = np.asarray(v)
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
                       [os.path.join(REPO, "src"), os.path.join(REPO, "port"),
                        os.path.dirname(os.path.abspath(__file__))]))
        ref = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                path], env=env, cwd=REPO)
        try:
            ranks = spmd.run(rank_body, ["cpu"] * 4, "gloo", (CASES,))
        finally:
            rc = ref.wait(timeout=400)
        assert rc == 0, "the reference's side failed"
        with np.load(path) as z:
            return ranks, dict(z)


@pytest.fixture(scope="module")
def unsharded():
    return {c.name: unsharded_steps(c) for c in CASES}


def _close(got, want) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _n_moe(case: Case) -> int:
    """MoE layers a forward runs."""
    cfg = case.cfg()
    return sum(st.layers * (1 if st in cfg.prologue else cfg.n_units)
               for st in cfg.prologue + cfg.pattern
               if st.block.endswith("moe"))


# ------------------------------------------------------------- the cases

@pytest.mark.parametrize("case", NAMES)
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
    c = BY_NAME[case]
    if c.pos:
        # the last step wrote across a piece's end: MLA's first slot of
        # the split's second piece (T/2), and no later one; the ring's
        # slot 0, its first piece's, over what the caches held
        first = np_caches(c)
        for key, leaves in want["caches"].items():
            name = "c_kv" if c.arch == DS else "k"
            kv, old = leaves[name], first[key][name]
            if c.arch == DS:
                assert c.pos + STEPS - 1 == c.T // 2
                assert kv[:, :, c.T // 2].any()
                assert not kv[:, :, c.T // 2 + 1:].any()
            else:
                assert (c.pos + STEPS - 1) % c.cfg().window == 0
                assert (kv[:, :, 0] != old[:, :, 0]).all()


@pytest.mark.parametrize("case", NAMES)
def test_sharded_steps_match_reference_sharded(results, case):
    ranks, ref = results
    got = ranks[0]["cases"][case]
    _close(got["prefill"], ref[f"{case}|prefill"])
    for i, g in enumerate(got["decode"]):
        _close(g, ref[f"{case}|decode{i}"])
    for k, c in got["caches"].items():
        for n, v in c.items():
            _close(v, ref[f"{case}|cache|{k}|{n}"])


@pytest.mark.parametrize("case", NAMES)
def test_local_shards_have_shard_shape(results, case):
    """Every rank's piece of every parameter and cache leaf has the shape
    ``shard_shape`` gives its spec; the expert weights are split four
    ways (experts or "mlp" over "model", "embed" over "data")."""
    ranks, _ = results
    for r in ranks:
        shapes = r["cases"][case]["shapes"]
        assert shapes and all(local == want for _, local, want in shapes), \
            [s for s in shapes if s[1] != s[2]]
    leaves = dict(_local_shapes_of(BY_NAME[case]))
    split = [p for p, local, _ in ranks[0]["cases"][case]["shapes"]
             if p in leaves and np.prod(local) * 4 == np.prod(leaves[p])]
    assert any(p.endswith("moe.w1") for p in split)
    assert any(p.endswith("attn.wq") for p in split)


def _local_shapes_of(case: Case) -> list:
    from repro_torch.models.layers import tree_paths
    return [(p, s.shape) for p, s in tree_paths(param_shapes(case.cfg()))]


@pytest.mark.parametrize("case", [c.name for c in CASES if c.arch == MX])
def test_experts_follow_the_weights_layout(results, case):
    """Mixtral's 4 experts split over "model" (two a rank); 3 experts do
    not divide it, so each rank holds all three and half of each one's
    "mlp" dimension."""
    ranks, _ = results
    cfg = BY_NAME[case].cfg()
    E, D, Fe = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    shapes = {p: local for p, local, _ in ranks[0]["cases"][case]["shapes"]}
    w1 = next(v for p, v in shapes.items() if p.endswith("moe.w1"))
    L = w1[0]
    assert w1 == ((L, E // 2, D // 2, Fe) if E % 2 == 0
                  else (L, E, D // 2, Fe // 2))


def test_drops_keep_the_same_assignments(results, unsharded):
    """Prompts of one repeated id: every MoE layer of the prefill drops
    assignments past the capacity in the unsharded port.  The sharded
    ranks keep the same (token, k) slots, token by token in the data
    ranks' order, in the same dispatch rows (no two ranks filling one
    row); the reference fills the same rows of its dispatch buffer."""
    case = BY_NAME[f"{DS}-drops"]
    ranks, ref = results
    n = _n_moe(case)
    calls = unsharded[case.name]["routes"][:n]
    want = occupied(calls)
    K = case.cfg().top_k
    assert all(0 < len(w) < B * case.S * K for w in want), \
        [len(w) for w in want]
    data = sorted((r for r in ranks if r["coordinate"][1] == 0),
                  key=lambda r: r["coordinate"][0])
    for i in range(n):
        got = [r["cases"][case.name]["routes"][i] for r in data]
        keep = np.concatenate([k.reshape(-1) for k, _ in got])
        np.testing.assert_array_equal(keep, calls[i][0].reshape(-1))
        rows = sorted(x for r in data
                      for x in occupied(r["cases"][case.name]["routes"])[i])
        assert rows == want[i], i
        kept = ref[f"{case.name}|kept{i}"]
        assert sorted((g, int(d)) for g, d in zip(*np.nonzero(kept))) \
            == want[i], i
    # the two model ranks of a data rank route its tokens alike
    for d in (0, 1):
        same = [occupied(r["cases"][case.name]["routes"]) for r in ranks
                if r["coordinate"][0] == d]
        assert len(same) == 2 and same[0] == same[1]


def test_long_prefill_groups_within_a_data_rank(results):
    """4 x 512 tokens are two groups of 1024: each data rank routes one
    whole group, with no offset."""
    ranks, _ = results
    case = BY_NAME[f"{DS}-s512"]
    for r in ranks:
        keep, _ = r["cases"][case.name]["routes"][0]
        assert keep.shape == (1, 1024 * case.cfg().top_k)


@pytest.mark.parametrize("case", NAMES)
def test_expert_rows_move_where_fewer_bytes(results, case):
    """Every decode step's and the short prefills' dispatch rows go to
    the weights (all-to-all over "data"); the 4 x 512 prefill's 320-row
    capacity makes the weights' FSDP pieces the smaller move, so they are
    gathered instead."""
    ranks, _ = results
    c = BY_NAME[case]
    n = _n_moe(c)
    for r in ranks:
        got = r["cases"][case]
        calls = range(len(got["routes"]))
        assert len(got["routes"]) == n * (1 + STEPS)
        want = [i for i in calls if i >= n or c.S * B <= 32]
        assert got["by_tokens"] == want


if __name__ == "__main__":
    reference_side(sys.argv[1])
