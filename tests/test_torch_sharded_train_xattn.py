"""The port's sharded train step of the ``cross_attn_mlp`` block
(llama-3.2-vision-11b's smoke config: two ``attn_mlp`` layers and one
``cross_attn_mlp`` a unit) under ``DEFAULT_RULES`` on a (data 2, model 2)
mesh of four gloo processes on the CPU, the image embeddings (B, I, D)
in the batch and split over "data" as every input, held to the unsharded
port and to the reference's jitted sharded ``build_train_step`` as
``test_torch_sharded_train.py`` holds the attention stacks (its helpers,
cases' form and tolerances).

Both gates (``xattn.gate`` and ``mlp_gate``) are 0 at init, where every
other gradient of the block is zero; here they are at GATE.  A gate is a
replicated (1,) leaf whose gradient comes back a partial sum over
"data".  The cases, each at remat "full":

- the smoke config;
- at microbatch 2: ``steps._chunk`` cuts the image embeddings with the
  tokens;
- 6 query heads in 3 KV groups: "model" 2 splits the query heads but
  not the groups, so attention's groups are gathered whole
  (``sharding.by_heads``), and the backward of their merge into heads,
  whose gradient comes back split 3 heads a rank, gathers it before it
  cuts it into groups (``sharding._CutGrad``)."""

import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch.sharding import (DEFAULT_RULES,  # noqa: E402
                                         ShardingRules)
from repro_torch.launch.steps import TrainConfig  # noqa: E402
from repro_torch.models.layers import tree_paths  # noqa: E402
from test_torch_sharded_serve import AXES, MESH  # noqa: E402
from test_torch_sharded_train import (STEPS, Case,  # noqa: E402
                                      check_steps, reference_side,
                                      reference_steps, run_case,
                                      spawn_with_reference)

LV = "llama-3.2-vision-11b"
GATE = 0.5
CASES = [Case(LV, LV, gate=GATE),
         Case(f"{LV}-mb2", LV, gate=GATE, microbatch=2),
         Case(f"{LV}-h6kv3", LV, gate=GATE,
              replace=(("n_heads", 6), ("n_kv_heads", 3), ("head_dim", 16)))]
NAMES = [c.name for c in CASES]
BY_NAME = {c.name: c for c in CASES}


def merge_backward(mesh, rules) -> float:
    """The gradient of ``sum(by_heads(x, heads) * w)`` with respect to x,
    3 KV groups of 2 heads merged into 6, whose gradient comes back split
    3 heads a rank over "model" (w's layout): its largest gap to w, the
    exact gradient, cut back into groups."""
    import torch
    from repro_torch.launch.sharding import P, by_heads, distribute, rules_ctx

    gen = torch.Generator().manual_seed(3)
    x0 = torch.randn((4, 5, 3, 2, 8), generator=gen)
    w0 = torch.randn((4, 5, 6, 8), generator=gen)
    with rules_ctx(rules, mesh):
        x = distribute(x0, P("data"), mesh).requires_grad_()
        w = distribute(w0, P("data", None, "model"), mesh)
        y = by_heads(x, (4, 5, 6, 8)) * w
        g, = torch.autograd.grad(y.to_local().sum(), [x])
        got = g.full_tensor()
    return float((got - w0.reshape(x0.shape)).abs().max())


def rank_body(rank: int, device, cases: list) -> dict:
    mesh = make_process_mesh(MESH, AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    out = {c.name: run_case(c, device, mesh, rules) for c in cases}
    out["merge_backward"] = merge_backward(mesh, rules)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def results():
    return spawn_with_reference(__file__, rank_body, (CASES,), NAMES)


@pytest.fixture(scope="module")
def unsharded():
    return {c.name: run_case(c, "cpu") for c in CASES}


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
def test_every_gradient_leaf_is_nonzero(unsharded, case):
    """m after the first step is the clipped gradient, scaled: no leaf of
    it is zero (both gates and the cross-attention's projections among
    them)."""
    m = dict(tree_paths(unsharded[case]["first"]["m"]))
    zero = [n for n, a in m.items() if not np.abs(a).max() > 0]
    assert not zero, zero
    assert any(n.endswith("xattn.gate") for n in m)


def test_heads_merge_gathers_an_uneven_gradient(results):
    """``by_heads``' merge of 3 groups of 2 heads, its gradient handed back
    split 3 heads a rank: exact (a strict view's backward refuses to cut
    3 groups over "model" 2)."""
    assert results[0]["merge_backward"] == 0.0


@pytest.mark.parametrize("case", NAMES)
def test_grad_norm_clips(unsharded, case):
    assert min(unsharded[case]["grad_norm"]) > \
        TrainConfig().optim.clip_norm


if __name__ == "__main__":
    reference_side(sys.argv[1], sys.argv[2:], BY_NAME)
