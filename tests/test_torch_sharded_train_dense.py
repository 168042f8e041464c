"""The port's sharded train step of the other ``attn_mlp`` smoke configs:
qwen2.5-14b (untied head), glm4-9b and musicgen-large (inputs as
embeddings, GELU without a gate) at remat "full", under ``DEFAULT_RULES``
on a (data 2, model 2) mesh of four gloo processes on the CPU, held to
the unsharded port and to the reference's jitted sharded step as
``test_torch_sharded_train.py`` holds qwen2 and command-r (its helpers,
cases' form and tolerances)."""

import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))

import pytest  # noqa: E402

from repro_torch.launch.mesh import make_process_mesh  # noqa: E402
from repro_torch.launch.sharding import (DEFAULT_RULES,  # noqa: E402
                                         ShardingRules)
from test_torch_sharded_serve import AXES, MESH  # noqa: E402
from test_torch_sharded_train import (STEPS, Case,  # noqa: E402
                                      check_steps, reference_side,
                                      reference_steps, run_case,
                                      spawn_with_reference)

CASES = [Case(a, a) for a in ("qwen2.5-14b", "glm4-9b", "musicgen-large")]
NAMES = [c.name for c in CASES]
BY_NAME = {c.name: c for c in CASES}


def rank_body(rank: int, device, cases: list) -> dict:
    mesh = make_process_mesh(MESH, AXES, device)
    rules = ShardingRules(DEFAULT_RULES)
    out = {c.name: run_case(c, device, mesh, rules) for c in cases}
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


if __name__ == "__main__":
    reference_side(sys.argv[1], sys.argv[2:], BY_NAME)
