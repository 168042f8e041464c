#!/usr/bin/env python
"""chip_smoke.py's phases P and Q alone: the sharded train step on four
processes of the card (``chip_smoke.drive_sharded_train``), its lines
and its summary printed, then the card's name and power limit.

    python port/scripts/phase_p.py [--seed N] [--tags P1 P2 P3 Q1 Q2 Q3]

Needs a CUDA card.  The ranks are spawned and import ``chip_smoke`` by
name, which is why the phases run from a script file and not from
``python -c``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

import chip_smoke  # noqa: E402


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tags", nargs="+", default=list(chip_smoke.P_TAGS),
                    choices=list(chip_smoke.P_TAGS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("phase_p: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_line()
    t0 = time.perf_counter()
    out = chip_smoke.drive_sharded_train(args.seed, card, tuple(args.tags))
    print(json.dumps({"phase": "PQ", **out,
                      "s": time.perf_counter() - t0, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
