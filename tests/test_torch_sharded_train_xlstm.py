"""The port's sharded train step of the ``mlstm`` and ``slstm`` blocks
(xlstm-1.3b) under ``DEFAULT_RULES`` on a (data 2, model 2) mesh of four
gloo processes on the CPU, held to the unsharded port and to the
reference's jitted sharded ``build_train_step`` as
``test_torch_sharded_train.py`` holds the attention stacks (its helpers,
cases' form and tolerances).  The cases, each at remat "full":

- the smoke config (two mLSTM layers and one sLSTM a unit, two units):
  the mLSTM's parallel form and the sLSTM's time loop, both on each
  rank's batch rows and heads;
- one mLSTM layer alone at S 64 with ``MLSTM_CHUNK`` 16 on both sides:
  the chunkwise form, its state carried across four chunks (a one-stage
  pattern, so that no sLSTM loop runs 64 steps).

Every gradient leaf of each case is nonzero.  The sLSTM's time loop
issues no collective, forward or backward, in the smoke config's two
steps (``chip_smoke.SlstmLoopMeter``: ``plan.ShardMeter`` over each
loop's forward and over its backward), so none a token."""

import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path[:0] = [os.path.join(REPO, "port"), REPO]

import numpy as np  # noqa: E402
import pytest  # noqa: E402
from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch.sharding import (DEFAULT_RULES,  # noqa: E402
                                         ShardingRules)
from repro_torch.launch.steps import TrainConfig  # noqa: E402
from repro_torch.models.config import StageSpec  # noqa: E402
from repro_torch.models.layers import tree_paths  # noqa: E402
from test_torch_sharded_serve import AXES, MESH  # noqa: E402
from test_torch_sharded_train import (STEPS, Case,  # noqa: E402
                                      check_steps, reference_side,
                                      reference_steps, run_case,
                                      spawn_with_reference)

XL = "xlstm-1.3b"
CASES = [Case(XL, XL),
         Case(f"{XL}-chunk", XL, S=64,
              replace=(("pattern", (StageSpec("mlstm", 1),)),
                       ("n_units", 1)),
              chunks=(("MLSTM_CHUNK", 16),))]
NAMES = [c.name for c in CASES]
BY_NAME = {c.name: c for c in CASES}


def rank_body(rank: int, device, cases: list) -> dict:
    """Every case's steps, the first case's under
    ``chip_smoke.SlstmLoopMeter``."""
    from chip_smoke import SlstmLoopMeter
    from repro_torch.launch.plan import ShardMeter

    mesh = make_process_mesh(MESH, AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    with ShardMeter() as meter, SlstmLoopMeter(meter) as loop:
        out = {cases[0].name: run_case(cases[0], device, mesh, rules)}
    out.update((c.name, run_case(c, device, mesh, rules))
               for c in cases[1:])
    out["loop"] = {"counts": loop.counts, "tokens": loop.tokens,
                   "loops": loop.loops, "backwards": loop.backwards,
                   "step": sum(meter.counts.values())}
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
    it is zero (the sLSTM's R and bias among them)."""
    zero = [n for n, a in tree_paths(unsharded[case]["first"]["m"])
            if not np.abs(a).max() > 0]
    assert not zero, zero


@pytest.mark.parametrize("case", NAMES[:1])
def test_grad_norm_clips(unsharded, case):
    assert min(unsharded[case]["grad_norm"]) > \
        TrainConfig().optim.clip_norm


def test_slstm_loop_issues_no_collective_a_token(results):
    """Of the collectives the two steps issued, none inside a loop: the
    loops' forwards (each layer's, and its recomputation under remat
    "full") and their backwards."""
    loop = results[0]["loop"]
    # two units a step, each loop's forward recomputed once
    assert (loop["loops"], loop["backwards"]) == (STEPS * 2 * 2, STEPS * 2)
    assert loop["tokens"] == loop["loops"] * CASES[0].S
    assert loop["step"] > 0 and loop["counts"] == {}, loop


if __name__ == "__main__":
    reference_side(sys.argv[1], sys.argv[2:], BY_NAME)
