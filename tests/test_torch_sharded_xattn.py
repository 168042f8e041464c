"""The port's sharded serve step for the cross-attention block:
decode and prefill of llama-3.2-vision-11b's smoke config (two
``attn_mlp`` layers and one ``cross_attn_mlp`` a unit) under
``DEFAULT_RULES`` on a (data 2, model 2) mesh of four gloo processes on the
CPU, every parameter, cache and input a ``DTensor``, the image embeddings
(B, I, D) in bfloat16 split over the batch as ``inputs.shard_batch`` lays
out every input.

The reference's ``ServingEngine`` passes no image, so the block is held
through the steps, as the single-card tests hold it through ``forward``
and ``decode_step``: against the same steps unsharded in this process and
the reference's own sharded ``build_serve_step`` and prefill on a (2, 2)
mesh of four host devices (this file as a script, as
``test_torch_sharded_ssm.py`` runs its own), within TOL (1e-5) in float32.
Both gates (``xattn.gate`` and ``mlp_gate``) are 0 at init, which makes the
block the identity; here they are at 0.5 on every side.  The cases: the
smoke config at T 256 (its context splits over "model"), and decoding on
from 126 written slots, across that split at 128."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import test_torch_sharded_ssm as ssm  # noqa: E402
from test_torch_sharded_ssm import (GATE, Case, check_reference,  # noqa: E402
                                    check_shapes, check_unsharded, launch,
                                    local_of, reference_side,
                                    unsharded_steps)

LV = "llama-3.2-vision-11b"
CASES = [Case(LV, LV), Case(f"{LV}-cross", LV, pos=126)]
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


@pytest.mark.parametrize("case", NAMES)
def test_sharded_steps_match_reference_sharded(results, case):
    ranks, ref = results
    check_reference(ranks[0]["cases"][case], ref, case)


@pytest.mark.parametrize("case", NAMES)
def test_local_shards_have_shard_shape(results, case):
    """As ``shard_shape`` says; the cross-attention's query and the MLP's
    ``w1`` split four ways; the image embeddings' batch over "data"."""
    ranks, _ = results
    check_shapes(ranks, case)
    local = local_of(ranks, case)
    cfg = BY_NAME[case].cfg()
    D, H, hd = cfg.d_model, cfg.n_heads, cfg.hd
    wq = next(v for p, v in local.items() if p.endswith("xattn.wq"))
    assert wq[1:] == (D // 2, H * hd // 2)
    w1 = next(v for p, v in local.items()
              if "cross_attn_mlp" in p and p.endswith("mlp.w1"))
    assert w1[1:] == (D // 2, cfg.d_ff // 2)
    for r in ranks:
        assert r["cases"][case]["image_local"] == (
            2, cfg.n_image_tokens, D)


def test_decode_crosses_the_context_split(unsharded):
    """The last of three steps from slot 126 wrote slot 128, the first of
    the second piece over "model", and no later one."""
    c = BY_NAME[f"{LV}-cross"]
    for p, v in unsharded[c.name]["caches"].items():
        if p.endswith(".k"):
            assert c.pos + 2 == c.T // 2
            assert v[:, :, c.T // 2].any()
            assert not v[:, :, c.T // 2 + 1:].any()


def test_gates_move_the_logits(unsharded):
    """At 0.5 the gates make the block more than the identity: the same
    steps with both gates at 0 give other logits."""
    c = BY_NAME[LV]
    real = ssm.np_params
    try:
        ssm.np_params = lambda cfg: _zero_gates(real(cfg))
        closed = unsharded_steps(c)
    finally:
        ssm.np_params = real
    assert GATE == 0.5
    assert np.abs(closed["prefill"] - unsharded[c.name]["prefill"]).max() \
        > 1e-2
    for a, b in zip(closed["decode"], unsharded[c.name]["decode"]):
        assert np.abs(a - b).max() > 1e-2


def _zero_gates(tree: dict) -> dict:
    return {k: _zero_gates(v) if isinstance(v, dict) else
            (np.zeros_like(v) if "gate" in k else v)
            for k, v in tree.items()}


if __name__ == "__main__":
    reference_side(CASES, sys.argv[1])
