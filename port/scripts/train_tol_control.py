#!/usr/bin/env python
"""Phase K2's comparisons over several seeds, for the sound port and for
controls that carry a deliberate fault on the card: the readings that
chip_smoke.py's K2_LOSS_TOL, K2_GRAD_TOL and K2_ADAMW_TOL are set between.

    python port/scripts/train_tol_control.py

Needs one CUDA card.  For each of SEEDS it takes
``chip_smoke.train_grad_readings``: qwen2-0.5b and hymba-1.5b (2 layers
each) at full width in f32, the card's ``loss_fn`` and every gradient leaf
against the CPU's from the same parameters, and one ``adamw_update`` on
identical trees.  Then the same under each of CONTROLS: every float32
product on the card in TF32 (a fault in the loss and the gradients), and
two faults of the card's AdamW step, its moments kept in bfloat16 and its
weight decay dropped.

Prints one JSON line a reading, then the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

import chip_smoke  # noqa: E402
import torch  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402
from repro_torch.optim import adamw_update  # noqa: E402

SEEDS = (0, 1, 2, 3)


def bf16_moments(params, grads, state, cfg):
    """``adamw_update`` with ``m`` and ``v`` stored in bfloat16."""
    out = adamw_update(params, grads, state, cfg)
    with torch.no_grad():
        for t in tree_leaves({"m": state["m"], "v": state["v"]}):
            t.copy_(t.to(torch.bfloat16))
    return out


def no_decay(params, grads, state, cfg):
    """``adamw_update`` without its decoupled weight decay."""
    return adamw_update(params, grads, state,
                        dataclasses.replace(cfg, weight_decay=0.0))


# name -> keyword arguments of train_grad_readings
CONTROLS = {"sound": {}, "tf32": {"tf32": True},
            "bf16_moments": {"card_adamw": bf16_moments},
            "no_decay": {"card_adamw": no_decay}}


def main() -> int:
    if not torch.cuda.is_available():
        print("train_tol_control: no CUDA device", file=sys.stderr)
        return 1
    for seed in SEEDS:
        for name, kw in CONTROLS.items():
            t0 = time.perf_counter()
            rec = chip_smoke.train_grad_readings(seed, "cuda", **kw)
            for arch, r in rec.items():
                print(json.dumps({
                    "seed": seed, "arch": arch, "control": name,
                    "loss_rel_err": r["loss"]["rel_err"],
                    "grad_max": r["grads"]["max"],
                    "grad_worst": r["grads"]["worst"],
                    "adamw_max": r["adamw"]["max"],
                    "adamw_worst": r["adamw"]["worst"],
                    "tol": {"loss": chip_smoke.K2_LOSS_TOL,
                            "grads": chip_smoke.K2_GRAD_TOL,
                            "adamw": chip_smoke.K2_ADAMW_TOL},
                    "s": time.perf_counter() - t0}), flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
