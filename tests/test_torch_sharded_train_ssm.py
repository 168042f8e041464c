"""The port's sharded train step of the ``hybrid`` block (hymba-1.5b:
attention and Mamba side by side, their outputs normalized and averaged)
under ``DEFAULT_RULES`` on a (data 2, model 2) mesh of four gloo
processes on the CPU, held to the unsharded port and to the reference's
jitted sharded ``build_train_step`` as ``test_torch_sharded_train.py``
holds the attention stacks (its helpers, cases' form and tolerances).
The cases, each at remat "full":

- the smoke config (5 query and 5 KV heads: "model" 2 splits neither, so
  attention runs on each rank's batch rows with its heads whole);
- one layer at S 64 with ``MAMBA_CHUNK`` 16 on both sides: Mamba's chunk
  loop, the state carried across four chunks, and a window (32) shorter
  than the sequence.

Every gradient leaf of each case is nonzero.  The mesh ``Trainer`` of
hymba's smoke config fails at step 3 (after step 2's checkpoint) and
resumes bit for bit, as ``test_torch_sharded_trainer.py``'s qwen2 run
does."""

import os
import sys
import tempfile

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro_torch.launch import spmd  # noqa: E402
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
import test_torch_sharded_trainer as trainer_test  # noqa: E402

HY = "hymba-1.5b"
CASES = [Case(HY, HY),
         Case(f"{HY}-chunk", HY, S=64, replace=(("n_units", 1),),
              chunks=(("MAMBA_CHUNK", 16),))]
NAMES = [c.name for c in CASES]
BY_NAME = {c.name: c for c in CASES}
TRAINER_STEPS = 4            # the Trainer runs: fail at 3, resume to 3


def rank_body(rank: int, device, cases: list, resumed: str,
              whole: str) -> dict:
    """Every case's steps, then the mesh Trainer's failing, resumed and
    uninterrupted runs of hymba's smoke config."""
    mesh = make_process_mesh(MESH, AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    out = {c.name: run_case(c, device, mesh, rules) for c in cases}
    out["trainer"] = trainer_test.rank_body(rank, device, resumed, whole,
                                            HY, TRAINER_STEPS)
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as tmp:
        dirs = tuple(os.path.join(tmp, d) for d in ("resumed", "whole"))
        return spawn_with_reference(__file__, rank_body, (CASES, *dirs),
                                    NAMES)


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
    it is zero (Mamba's A_log, Dskip, dt_bias and conv_w among them)."""
    zero = [n for n, a in tree_paths(unsharded[case]["first"]["m"])
            if not np.abs(a).max() > 0]
    assert not zero, zero


@pytest.mark.parametrize("case", NAMES)
def test_grad_norm_clips(unsharded, case):
    assert min(unsharded[case]["grad_norm"]) > \
        TrainConfig().optim.clip_norm


def test_mesh_trainer_fails_and_resumes_bit_for_bit(results):
    out = results[0]["trainer"]
    assert out["failed"] == f"injected failure at step {trainer_test.FAIL}"
    assert out["after_failure"] == trainer_test.EVERY
    resumed, whole = out["losses"]
    assert [s for s, _ in resumed] == list(range(trainer_test.FAIL,
                                                 TRAINER_STEPS))
    assert dict(resumed) == {s: v for s, v in whole
                             if s >= trainer_test.FAIL}
    got, want = out["params"]
    for (name, g), (_, w) in zip(tree_paths(got), tree_paths(want),
                                 strict=True):
        assert np.array_equal(g, w), name


if __name__ == "__main__":
    reference_side(sys.argv[1], sys.argv[2:], BY_NAME)
