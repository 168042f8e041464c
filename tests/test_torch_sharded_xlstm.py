"""The port's sharded serve step for the ``mlstm`` and ``slstm`` blocks:
decode and prefill of xlstm-1.3b's smoke config (2 mLSTM and 1 sLSTM
layers a unit) under ``DEFAULT_RULES`` on a (data 2, model 2) mesh of four
gloo processes on the CPU, every parameter, cache and input a
``DTensor``, held as ``test_torch_sharded_ssm.py`` holds ``hybrid``, with
its helpers: against the same steps unsharded in this process and the
reference's own sharded ``build_serve_step`` and prefill on a (2, 2) mesh
of four host devices (this file as a script), within TOL (1e-5) in
float32 on logits and every state leaf.  The cases:

- the smoke config at T 256;
- mLSTM prefills of 256 and 512 tokens: the parallel form at
  ``MLSTM_CHUNK``, and the chunkwise form above it (one unit; the sLSTM's
  time loop runs 512 steps on DTensors);
- d_model 512 and 4 heads (hd 256) at T 256, decoding on from states
  drawn from the seed: the cache rule (a dimension of 256 or more equal
  to T goes on "model") then splits the mLSTM state ``C`` on its first
  hd and ``n`` on its hd, as at full width (hd 1024 at T 1024)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402

from test_torch_sharded_ssm import (B, Case, check_reference,  # noqa: E402
                                    check_shapes, check_split_four_ways,
                                    check_states_moved, check_unsharded,
                                    launch, local_of, reference_side,
                                    unsharded_steps)

XL = "xlstm-1.3b"
CASES = [Case(XL, XL),
         Case(f"{XL}-s256", XL, S=256, replace=(("n_units", 1),)),
         Case(f"{XL}-s512", XL, S=512, replace=(("n_units", 1),)),
         Case(f"{XL}-hd256", XL, pos=3, replace=(("d_model", 512),
                                                 ("n_units", 1)))]
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
    """As ``shard_shape`` says, the mLSTM's ``up`` and the sLSTM's ``W``
    split four ways."""
    ranks, _ = results
    check_shapes(ranks, case)
    check_split_four_ways(ranks, BY_NAME[case], ("cell.up", "cell.W"))


def test_mlstm_state_splits_on_hd(results):
    """At hd 256 = T the cache rule puts "model" on the mLSTM state's
    first hd dimension (``C``, (L, B, H, hd, hd)) and on ``n``'s hd, as
    the reference's rule does at full width."""
    case = BY_NAME[f"{XL}-hd256"]
    ranks, _ = results
    cfg = case.cfg()
    hd = cfg.mlstm_pf * cfg.d_model // cfg.n_heads
    assert hd == case.T
    local = local_of(ranks, case.name)
    C = next(v for p, v in local.items() if p.endswith("mlstm.C"))
    n = next(v for p, v in local.items() if p.endswith("mlstm.n"))
    assert C[1:] == (B // 2, cfg.n_heads, hd // 2, hd)
    assert n[1:] == (B // 2, cfg.n_heads, hd // 2)




if __name__ == "__main__":
    reference_side(CASES, sys.argv[1])
