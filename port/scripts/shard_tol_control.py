#!/usr/bin/env python
"""Phase M1's logit comparison, for the sound port and for controls that
carry a deliberate fault in the sharded run: the readings that
chip_smoke.py's M_TOL["M1"] is set between.

    python port/scripts/shard_tol_control.py

Needs a CUDA card.  For each of SEEDS it runs phase M1 as
``chip_smoke.py`` does (command-r-plus-104b at full width, 4 units, bf16,
on a (data 2, model 2) mesh of four processes under DEFAULT_RULES) and
the same unsharded, and reads the largest gap of each step's logits over
the unsharded logits' largest magnitude.  Each control patches one fault
into the sharded run's processes only, on seed 0:

  norm_bf16  LayerNorm computed in bf16, not in f32
  slot_late  each decode step's k and v written one cache slot late (the
             slot an offset error in the split cache write would pick)

Prints one JSON line a reading, then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

import chip_smoke  # noqa: E402
import numpy as np  # noqa: E402

SEEDS = (0, 1, 2)
FAULTS = ("norm_bf16", "slot_late")


def _layer_norm_bf16(x, scale, eps):
    import torch
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.to(x.dtype)


def faulty_rank(rank, device, fault, *args):
    """``chip_smoke.m_rank`` with ``fault`` patched into this process."""
    from repro_torch.models import attention, layers

    if fault == "norm_bf16":
        layers.layer_norm = _layer_norm_bf16
    elif fault == "slot_late":
        write = attention.index_copy_
        attention.index_copy_ = (
            lambda dst, dim, index, src: write(dst, dim, index + 1, src))
    elif fault is not None:
        raise ValueError(fault)
    return chip_smoke.m_rank(rank, device, *args)


def gap(got: list, want: list) -> float:
    return max(float(np.abs(g - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


def main() -> int:
    import torch
    from repro_torch.launch import spmd

    if not torch.cuda.is_available():
        print("shard_tol_control: no CUDA device", file=sys.stderr)
        return 1
    dtype, units = chip_smoke.M_RUNS["M1"]
    backend, devices = spmd.card_layout(chip_smoke.M_PROCS)
    for seed in SEEDS:
        want = chip_smoke.m_unsharded(dtype, units, seed)["logits"]
        torch.cuda.empty_cache()
        for fault in (None,) + (FAULTS if seed == 0 else ()):
            got = spmd.run(faulty_rank, devices, backend,
                           (fault, dtype, units, seed))[0]["logits"]
            print(json.dumps({"seed": seed, "fault": fault,
                              "err_frac": gap(got, want),
                              "backend": backend}), flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
