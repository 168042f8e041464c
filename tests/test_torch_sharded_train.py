"""The port's sharded train step: ``build_train_step`` of ``attn_mlp``
smoke configs under ``DEFAULT_RULES`` on a (data 2, model 2) mesh of four
gloo processes on the CPU (``launch/spmd``), the parameters, the AdamW
state and the batch ``DTensor``s.

Each case takes STEPS AdamW steps from the same numpy parameters and
batches, and is held to the same steps unsharded in this process and to
the reference's own jitted sharded ``build_train_step`` on a (2, 2) mesh
of four host devices, run in a subprocess (this file as a script under
``--xla_force_host_platform_device_count=4``).  The four ranks are spawned
once for the module and run meanwhile.  The cases: qwen2 and command-r
(a parallel block) at remat "full", qwen2 at remat "none", at microbatch
2 and with ``scan_param_fsdp``; the other three ``attn_mlp`` configs are
``test_torch_sharded_train_dense.py``'s (each new config costs DTensor's
sharding propagation tens of seconds on the CPU, so the files split them
to stay under ~150 s each).

Tolerances, float32 (readings on this file's cases in the comments):

- loss and grad norm of every step within TOL (1e-5) relative;
- ``m`` and ``v`` after the first step within TOL of each leaf's largest
  magnitude: they are the gradient and its square, scaled, so this holds
  every gradient leaf;
- ``m`` and ``v`` after the last step within MV_TOL (1e-4) of each leaf's
  largest magnitude, and the parameters and master within PARAM_TOL = lr
  / 10 absolute.  Adam divides each gradient entry by its own root mean
  square, so an entry whose gradient is near rounding noise on both sides
  moves by a share of lr that noise sets, and the next step's gradient
  follows from the parameters so moved; ``test_torch_train_step.py``
  holds the unsharded port to the reference by the same PARAM_TOL for the
  same reason.  The bound is absolute, in lr's units, because that is
  what such an entry's move scales with, whatever the leaf's magnitude.
  Readings after two steps over the cases of the four
  ``test_torch_sharded_train*.py`` files, against the unsharded port
  and against the reference's sharded step: parameters and master up to
  1.13e-5 absolute (lr / 27; deepseek at S 8, against the reference),
  which is 1.35e-4 of that leaf's largest magnitude; m and v up to
  3.6e-5 of a leaf's largest magnitude, and up to 1.9e-6 after one step.
  So after two steps the parameters, master, m and v are not held to
  1e-5 of each leaf's largest magnitude: no pair of f32 runs that sum in
  different orders meets that."""

import contextlib
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
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 shard_opt_state, shard_params,
                                 tree_to_numpy)
from repro_torch.launch import spmd  # noqa: E402
from repro_torch.launch.inputs import shard_batch  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch.sharding import (DEFAULT_RULES,  # noqa: E402
                                         ShardingRules)
from repro_torch.launch.steps import TrainConfig, build_train_step  # noqa
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.layers import tree_paths, tree_unflatten  # noqa
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from test_torch_sharded_serve import AXES, MESH, np_params  # noqa: E402

B, STEPS = 4, 2
TOL, MV_TOL = 1e-5, 1e-4
PARAM_TOL = AdamWConfig().lr / 10


@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    arch: str
    remat: str = "full"
    microbatch: int = 1
    fsdp: bool = False             # scan_param_fsdp
    S: int = 32                    # sequence length
    replace: tuple = ()            # config fields replaced
    gate: float | None = None      # every gate leaf's value (0 at init)
    chunks: tuple = ()             # (name, value) of ``models.ssm``

    def cfg(self, get=get_smoke_config):
        return dataclasses.replace(get(self.arch), **dict(self.replace))

    def train(self, tc=TrainConfig):
        return tc(remat=self.remat, microbatch=self.microbatch,
                  scan_param_fsdp=self.fsdp)

    def params(self, cfg) -> dict:
        """``np_params(cfg)``, every gate leaf at ``gate``."""
        tree = np_params(cfg)
        if self.gate is None:
            return tree
        return tree_unflatten(tree, [
            np.full_like(a, self.gate) if "gate" in n.rsplit(".", 1)[-1]
            else a for n, a in tree_paths(tree)])

    @contextlib.contextmanager
    def patched(self, ssm):
        """``ssm`` (either package's ``models.ssm``) with ``chunks`` set."""
        with pytest.MonkeyPatch.context() as mp:
            for name, value in self.chunks:
                mp.setattr(ssm, name, value)
            yield


QW = "qwen2-0.5b"
CASES = [Case(QW, QW), Case("command-r-plus-104b", "command-r-plus-104b"),
         Case(f"{QW}-none", QW, remat="none"),
    Case(f"{QW}-mb2", QW, microbatch=2),
    Case(f"{QW}-fsdp", QW, fsdp=True)]
NAMES = [c.name for c in CASES]
BY_NAME = {c.name: c for c in CASES}


def np_batch(cfg, S: int, step: int, seed: int = 10) -> dict:
    """Step ``step``'s batch of B rows: labels and tokens, or embeddings
    for a config that takes them; image embeddings (B, I, D) N(0, 1) for
    a config with image tokens."""
    rng = np.random.default_rng(seed + step)
    b = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.inputs_embeds:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)) \
            .astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.n_image_tokens:
        b["image_embed"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def run_case(case: Case, device, mesh=None, rules=None) -> dict:
    """STEPS train steps of ``case`` on ``device`` (sharded on ``mesh``):
    each step's loss and grad norm, the AdamW moments after the first
    step, and the parameters and AdamW state after the last, as numpy
    (every rank of a mesh joins the gathers)."""
    with case.patched(ssm):
        return _run_case(case, device, mesh, rules)


def _run_case(case: Case, device, mesh, rules) -> dict:
    cfg, tc = case.cfg(), case.train()
    model = params_from_numpy(case.params(cfg), cfg, device).trainable()
    opt = adamw_init(model, tc.optim)
    lay_out = lambda b: b                                 # noqa: E731
    if mesh is not None:
        opt = shard_opt_state(opt, mesh, rules, cfg)
        model = shard_params(model, mesh, rules)
        lay_out = lambda b: shard_batch(b, mesh)          # noqa: E731
    step = build_train_step(cfg, tc, rules, mesh)
    out = {"loss": [], "grad_norm": []}
    for i in range(STEPS):
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in np_batch(cfg, case.S, i).items()}
        model, opt, m = step(model, opt, lay_out(batch))
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if i == 0:
            out["first"] = tree_to_numpy({"m": opt["m"], "v": opt["v"]})
    out["params"] = tree_to_numpy(model.tree())
    out["opt"] = tree_to_numpy({k: v for k, v in opt.items()
                                if k != "step"})
    out["step"] = int(opt["step"])
    return out


def rank_body(rank: int, device, cases: list) -> dict:
    """One rank of the (2, 2) mesh: every case's steps; rank 0 returns
    them."""
    mesh = make_process_mesh(MESH, AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    out = {c.name: run_case(c, device, mesh, rules) for c in cases}
    return out if rank == 0 else None


# ----------------------------------------------------- the reference's side

def reference_side(path: str, names: list, by_name: dict) -> None:
    """The reference's jitted sharded train step of each named case of
    ``by_name`` on a (2, 2) mesh of four host devices, saved to ``path``
    (npz)."""
    import jax
    from repro.core.jaxcompat import make_mesh, set_mesh
    from repro.launch.sharding import (DEFAULT_RULES as RULES,
                                       ShardingRules as Rules)
    from repro.models import ssm as rssm

    mesh = make_mesh(MESH, AXES, devices=jax.devices()[:4])
    rules = Rules(RULES)
    out = {}
    with set_mesh(mesh):
        for name in names:
            with by_name[name].patched(rssm):
                out.update(_reference_case(by_name[name], mesh, rules))
    np.savez(path, **out)


def _reference_case(case: Case, mesh, rules) -> dict:
    """The reference's arrays of ``case``, keyed ``name|...``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro.configs import get_smoke_config as rcfg
    from repro.launch import steps as rsteps
    from repro.launch.inputs import _bspec, param_specs_sharded
    from repro.models import loss_fn
    from repro.optim import adamw_init as radamw_init

    name, out = case.name, {}

    def put(a, s):
        return jax.device_put(jnp.asarray(a, s.dtype), s.sharding)

    def flat(tree, prefix):
        for leaf, a in tree_paths(jax.tree.map(np.asarray, tree)):
            out[f"{prefix}|{leaf}"] = a

    cfg, pcfg = case.cfg(rcfg), case.cfg()
    tc = case.train(rsteps.TrainConfig)
    params = jax.tree.map(put, case.params(pcfg),
                          param_specs_sharded(cfg, mesh, rules))
    opt = jax.tree.map(put, radamw_init(params, tc.optim),
                       rsteps.opt_state_specs(cfg, mesh, rules, tc))
    bsh = NamedSharding(mesh, _bspec(mesh, B))
    if pcfg.n_experts:
        b0 = {k: jax.device_put(v, bsh)
              for k, v in np_batch(pcfg, case.S, 0).items()}

        def aux_of(p, b):
            with rsteps.rules_ctx(rules, mesh):
                return loss_fn(p, cfg, b, remat="none")[1]["aux"]
        out[f"{name}|aux"] = np.asarray(jax.jit(aux_of)(params, b0))
    step = jax.jit(rsteps.build_train_step(cfg, tc, rules, mesh))
    for i in range(STEPS):
        batch = {k: jax.device_put(v, bsh)
                 for k, v in np_batch(pcfg, case.S, i).items()}
        params, opt, m = step(params, opt, batch)
        out[f"{name}|loss{i}"] = np.asarray(m["loss"])
        out[f"{name}|grad_norm{i}"] = np.asarray(m["grad_norm"])
        if i == 0:
            flat({"m": opt["m"], "v": opt["v"]}, f"{name}|first")
    flat(params, f"{name}|params")
    flat({k: v for k, v in opt.items() if k != "step"}, f"{name}|opt")
    return out


def spawn_with_reference(script: str, body, args: tuple, names: list):
    """(rank 0's result of ``body`` on four gloo ranks, the reference's
    arrays): ``script`` (a test module run as the reference's side) runs
    in a subprocess under four forced host devices while the ranks do."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   PYTHONPATH=os.pathsep.join(
                       [os.path.join(REPO, "src"), os.path.join(REPO, "port"),
                        os.path.dirname(os.path.abspath(__file__))]))
        ref = subprocess.Popen([sys.executable, os.path.abspath(script),
                                path, *names], env=env, cwd=REPO)
        try:
            ranks = spmd.run(body, ["cpu"] * 4, "gloo", args)
        finally:
            rc = ref.wait(timeout=400)
        assert rc == 0, "the reference's side failed"
        with np.load(path) as z:
            return ranks[0], dict(z)


@pytest.fixture(scope="module")
def results():
    return spawn_with_reference(__file__, rank_body, (CASES,), NAMES)


@pytest.fixture(scope="module")
def unsharded():
    return {c.name: run_case(c, "cpu") for c in CASES}


# ------------------------------------------------------------ comparisons

def share(got, want) -> float:
    """max |got - want| over max |want| (the difference itself when want
    is all zero)."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    return err / scale if scale else err


def check_steps(got: dict, want: dict) -> None:
    """``got``'s steps against ``want``'s (both as :func:`run_case`
    returns them)."""
    for key in ("loss", "grad_norm"):
        for g, w in zip(got[key], want[key], strict=True):
            assert abs(g - w) <= TOL * abs(w), (key, g, w)
    for k in ("m", "v"):
        for name, w in tree_paths(want["first"][k]):
            assert share(dict(tree_paths(got["first"][k]))[name], w) \
                <= TOL, ("first", k, name)
        for name, w in tree_paths(want["opt"][k]):
            assert share(dict(tree_paths(got["opt"][k]))[name], w) \
                <= MV_TOL, (k, name)
    for tree, wtree in ((got["params"], want["params"]),
                        (got["opt"]["master"], want["opt"]["master"])):
        g = dict(tree_paths(tree))
        for name, w in tree_paths(wtree):
            assert float(np.abs(g[name] - w).max()) <= PARAM_TOL, name


def reference_steps(ref: dict, name: str) -> dict:
    """The reference's arrays of case ``name`` as :func:`run_case` returns
    a case."""
    def tree(prefix):
        pre = f"{name}|{prefix}|"
        return _nest({k[len(pre):]: v for k, v in ref.items()
                      if k.startswith(pre)})
    return {"loss": [float(ref[f"{name}|loss{i}"]) for i in range(STEPS)],
            "grad_norm": [float(ref[f"{name}|grad_norm{i}"])
                          for i in range(STEPS)],
            "first": tree("first"), "params": tree("params"),
            "opt": tree("opt")}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        d = out
        for p in path:
            d = d.setdefault(p, {})
        d[leaf] = v
    return out


# ------------------------------------------------------------- the cases

@pytest.mark.parametrize("case", NAMES)
def test_sharded_train_step_matches_unsharded(results, unsharded, case):
    got, _ = results
    check_steps(got[case], unsharded[case])
    assert got[case]["step"] == STEPS


@pytest.mark.parametrize("case", NAMES)
def test_sharded_train_step_matches_reference_sharded(results, case):
    got, ref = results
    check_steps(got[case], reference_steps(ref, case))


@pytest.mark.parametrize("case", NAMES)
def test_grad_norm_clips(unsharded, case):
    """At these parameters every step's gradient norm is above
    ``clip_norm``, so a norm over a rank's own pieces would change every
    update (``shard_tol_control.py``'s fault ``local_norm``)."""
    assert min(unsharded[case]["grad_norm"]) > \
        TrainConfig().optim.clip_norm


def test_other_blocks_refuse_a_process_mesh():
    """No block refuses a process mesh any more: ``build_train_step``
    builds for every arch of ``ARCHS`` under ``DEFAULT_RULES`` on a
    stand-in (data 2, model 2) process mesh."""
    from repro_torch.configs.base import ARCHS
    from test_torch_sharded_serve import _fake_mesh

    mesh = _fake_mesh(MESH, AXES, (0, 0))
    for arch in ARCHS:
        assert callable(build_train_step(
            get_smoke_config(arch), TrainConfig(),
            ShardingRules(DEFAULT_RULES), mesh)), arch


if __name__ == "__main__":
    reference_side(sys.argv[1], sys.argv[2:], BY_NAME)
