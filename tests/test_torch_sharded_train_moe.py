"""The port's sharded train step for the MoE and MLA blocks:
``build_train_step`` of deepseek-v2-lite-16b (``mla_dense`` + ``mla_moe``)
and mixtral-8x22b (``attn_moe``) smoke configs under ``DEFAULT_RULES`` on
a (data 2, model 2) mesh of four gloo processes on the CPU.

As ``test_torch_sharded_train.py`` does for ``attn_mlp`` (whose helpers,
cases' form and tolerances this file takes): each case is held to the same
steps unsharded in this process and to the reference's jitted sharded step
in a subprocess.  Besides:

- the aux loss of the first batch, from the parameters before any step,
  within AUX_TOL (1e-6) of the unsharded port's and the reference's, and
  nonzero; its gradient alone with respect to each MoE layer's router
  within TOL of the unsharded one's, and nonzero;
- the side of ``_moe_ffn_mesh``'s byte rule each case takes, asserted:
  at 64 tokens a row the expert weights' FSDP pieces are gathered, at 8
  the tokens' dispatch rows move to the weights
  (``moe._experts_by_tokens``, two all-to-alls forward and two back);
- deepseek at microbatch 2, whose chunks must hold the reference's rows
  for its MoE groups to be the same (its chunks of 2 x 64 tokens move
  their rows to the weights);
- the backward run on another thread than the forward, with the
  caller's dispatch state but none of its Python thread-locals (its
  ``rules_ctx``), as autograd runs it on a card (a device thread, the
  caller waiting inside its context): remat
  "full"'s recomputation and the hand collectives' backward (the
  all-to-all's, the experts' gradient sums) give the same gradients, bit
  for bit; then that thread runs an unsharded remat step, which sees no
  rules or mesh of the sharded backward before it."""

import dataclasses
import os
import sys
import threading

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy, shard_params  # noqa
from repro_torch.launch.inputs import shard_batch  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch.sharding import (DEFAULT_RULES,  # noqa: E402
                                         ShardingRules, rules_ctx)
from repro_torch.models import loss_fn  # noqa: E402
from repro_torch.models.layers import tree_paths  # noqa: E402
from test_torch_sharded_serve import AXES, MESH, np_params  # noqa: E402
from test_torch_sharded_train import (STEPS, TOL, Case,  # noqa: E402
                                      check_steps, np_batch,
                                      reference_side, reference_steps,
                                      run_case, spawn_with_reference)

DS, MX = "deepseek-v2-lite-16b", "mixtral-8x22b"
AUX_TOL = 1e-6
CASES = [Case(DS, DS, S=64), Case(f"{DS}-s8", DS, S=8),
         Case(MX, MX, S=64), Case(f"{MX}-s8", MX, S=8),
         Case(f"{DS}-mb2", DS, S=64, microbatch=2)]
NAMES = [c.name for c in CASES]
BY_NAME = {c.name: c for c in CASES}
# the side of the byte rule: expert rows moved to the weights?
BY_TOKENS = {DS: False, f"{DS}-s8": True, MX: False, f"{MX}-s8": True,
             f"{DS}-mb2": True}


class Sides:
    """While open: the number of MoE FFN calls on a process mesh and of
    those whose expert rows moved to the weights."""

    def __enter__(self):
        from repro_torch.models import moe

        self.moe, self.calls, self.by_tokens = moe, 0, 0
        self.real = moe._moe_ffn_mesh, moe._experts_by_tokens

        def ffn(*args):
            self.calls += 1
            return self.real[0](*args)

        def moved(*args):
            self.by_tokens += 1
            return self.real[1](*args)
        moe._moe_ffn_mesh, moe._experts_by_tokens = ffn, moved
        return self

    def __exit__(self, *exc):
        self.moe._moe_ffn_mesh, self.moe._experts_by_tokens = self.real


def aux_and_router_grads(case: Case, device, mesh=None, rules=None):
    """(the aux loss of the first batch, {router leaf: the aux loss's
    gradient alone}) from the case's parameters before any step."""
    cfg = case.cfg()
    model = params_from_numpy(np_params(cfg), cfg, device).trainable()
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in np_batch(cfg, case.S, 0).items()}
    if mesh is not None:
        model = shard_params(model, mesh, rules).trainable()
        batch = shard_batch(batch, mesh)
    routers = [(n, t) for n, t in tree_paths(model.tree())
               if n.endswith("moe.router")]
    with rules_ctx(rules, mesh):
        _, m = loss_fn(model, cfg, batch, remat="none")
        grads = torch.autograd.grad(m["aux"], [t for _, t in routers])
    aux = m["aux"].detach()
    if hasattr(aux, "full_tensor"):
        aux = aux.full_tensor()
        grads = [g.full_tensor() for g in grads]
    return float(aux), {n: g.detach().numpy() for (n, _), g
                        in zip(routers, grads)}


def plain_grads(case: Case, device) -> list:
    """The gradients of the case's loss at remat "full", unsharded, under
    no ``rules_ctx``."""
    cfg = case.cfg()
    model = params_from_numpy(np_params(cfg), cfg, device).trainable()
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in np_batch(cfg, case.S, 0).items()}
    loss, _ = loss_fn(model, cfg, batch, remat="full")
    leaves = [t for _, t in tree_paths(model.tree())]
    return [g.numpy() for g in torch.autograd.grad(loss, leaves)]


def backward_threads(case: Case, device, mesh, rules) -> tuple:
    """({leaf: (gradient with the backward on this thread, on another)},
    gathered, of the case's loss at remat "full"; [(gradient of the
    unsharded loss on this thread, on the other after its sharded
    backward)])."""
    cfg = case.cfg()
    model = shard_params(params_from_numpy(np_params(cfg), cfg, device),
                         mesh, rules).trainable()
    batch = shard_batch({k: torch.from_numpy(v).to(device)
                         for k, v in np_batch(cfg, case.S, 0).items()}, mesh)
    leaves = [t for _, t in tree_paths(model.tree())]
    grads = []
    for threaded in (False, True):
        with rules_ctx(rules, mesh):
            loss, _ = loss_fn(model, cfg, batch, remat="full")
            if not threaded:
                grads.append(torch.autograd.grad(loss, leaves))
                continue
            # the caller waits inside its rules_ctx, as on a card, while
            # the backward runs on a thread that has the caller's dispatch
            # state (autograd hands its device thread that) but none of
            # Python's thread-locals
            got = []

            def backward():
                from torch.distributed.tensor import DTensor
                DTensor._op_dispatcher._allow_implicit_replication = True
                try:
                    got.append(torch.autograd.grad(loss, leaves))
                    got.append(plain_grads(case, device))
                except BaseException as e:     # raised again below
                    got.append(e)
            t = threading.Thread(target=backward)
            t.start()
            t.join()
        if isinstance(got[-1], BaseException):
            raise got[-1]
        grads.append(got[0])
    return ({n: (a.full_tensor().numpy(), b.full_tensor().numpy())
             for (n, _), a, b in zip(tree_paths(model.tree()), *grads)},
            list(zip(plain_grads(case, device), got[1])))


THREADED = f"{DS}-s8"          # the case whose backward runs both ways


def rank_body(rank: int, device, cases: list) -> dict:
    mesh = make_process_mesh(MESH, AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    threads, after = backward_threads(BY_NAME[THREADED], device, mesh, rules)
    out = {"threads": threads, "after": after}
    for c in cases:
        aux, grads = aux_and_router_grads(c, device, mesh, rules)
        with Sides() as sides:
            res = run_case(c, device, mesh, rules)
        res.update(aux=aux, router_grads=grads, calls=sides.calls,
                   by_tokens=sides.by_tokens)
        out[c.name] = res
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def results():
    return spawn_with_reference(__file__, rank_body, (CASES,), NAMES)


@pytest.fixture(scope="module")
def unsharded():
    out = {}
    for c in CASES:
        out[c.name] = run_case(c, "cpu")
        out[c.name]["aux"], out[c.name]["router_grads"] = \
            aux_and_router_grads(c, "cpu")
    return out


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
def test_aux_loss_matches_and_reaches_the_router(results, unsharded, case):
    got, ref = results
    aux = got[case]["aux"]
    assert aux > 0
    assert abs(aux - unsharded[case]["aux"]) <= AUX_TOL
    assert abs(aux - float(ref[f"{case}|aux"])) <= AUX_TOL
    want = unsharded[case]["router_grads"]
    assert want and set(got[case]["router_grads"]) == set(want)
    for name, w in want.items():
        g = got[case]["router_grads"][name]
        assert np.abs(w).max() > 0, name
        assert np.abs(g - w).max() <= TOL * np.abs(w).max(), name


def test_backward_on_another_thread(results):
    got, _ = results
    pairs = got["threads"]
    assert any(n.endswith("moe.router") for n in pairs)
    for name, (here, there) in pairs.items():
        assert np.array_equal(here, there), name


def test_unsharded_step_after_a_backward_on_another_thread(results):
    got, _ = results
    assert got["after"]
    for here, there in got["after"]:
        assert np.array_equal(here, there)


@pytest.mark.parametrize("case", NAMES)
def test_byte_rule_side(results, case):
    """Every MoE call of the case's steps took the side asserted (the
    forward and, under remat "full", its recomputation)."""
    got, _ = results
    calls = got[case]["calls"]
    moe_layers = BY_NAME[case].cfg().n_units
    assert calls >= STEPS * moe_layers * BY_NAME[case].microbatch
    assert got[case]["by_tokens"] == (calls if BY_TOKENS[case] else 0)


if __name__ == "__main__":
    reference_side(sys.argv[1], sys.argv[2:], BY_NAME)
