#!/usr/bin/env python
"""Phase J2's logit comparisons over several seeds, for the sound port and
for controls that carry a deliberate precision fault on the card: the
readings that chip_smoke.py's J2_F32_TOL and J2_DECODE_TOL are set
between.

    python port/scripts/ssm_tol_control.py

Needs one CUDA card.  For each of SEEDS it takes
``chip_smoke.ssm_logit_readings``: hymba-1.5b (2 layers) and xlstm-1.3b
(one unit) at full width in f32, the card's ``forward`` at S = 8 and past
each chunk threshold and its decode against the same port on the CPU, the
card's decode against its ``forward``, and the CPU's own one-ulp
sensitivity (``cpu_ulp_perturbation``).  Each control sets one fault for
its own reading; TF32 applies to CUDA products only, so the CPU side is
unchanged and only the card carries it:

  tf32        every float32 product on the card in TF32
  mlstm_tf32  only the mLSTM cell's products (the parallel and chunkwise
              forms) in TF32

Prints one JSON line a reading (``err_frac`` is the error over the
reference's largest logit, ``tol_frac`` the bound), then the card's name
and power limit.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

import chip_smoke  # noqa: E402
import torch  # noqa: E402
from repro_torch.models import ssm  # noqa: E402

SEEDS = (0, 1, 2, 3)


@contextlib.contextmanager
def tf32():
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _in_tf32(fn):
    @functools.wraps(fn)
    def run(*args, **kw):
        with tf32():
            return fn(*args, **kw)
    return run


@contextlib.contextmanager
def mlstm_tf32():
    old = ssm._mlstm_parallel, ssm._mlstm_chunkwise
    ssm._mlstm_parallel, ssm._mlstm_chunkwise = map(_in_tf32, old)
    try:
        yield
    finally:
        ssm._mlstm_parallel, ssm._mlstm_chunkwise = old


CONTROLS = {"sound": contextlib.nullcontext, "tf32": tf32,
            "mlstm_tf32": mlstm_tf32}
BOUNDS = {"forward": chip_smoke.J2_F32_TOL, "forward_long":
          chip_smoke.J2_F32_TOL, "decode": chip_smoke.J2_F32_TOL,
          "decode_vs_forward": chip_smoke.J2_DECODE_TOL}


def main() -> int:
    if not torch.cuda.is_available():
        print("ssm_tol_control: no CUDA device", file=sys.stderr)
        return 1
    for seed in SEEDS:
        for control, fault in CONTROLS.items():
            with fault():
                out = chip_smoke.ssm_logit_readings(seed, "cuda")
            for arch, rec in out.items():
                for tag, x in rec.items():
                    if not isinstance(x, dict):
                        continue
                    bound = BOUNDS.get(tag)
                    print(json.dumps({
                        "seed": seed, "control": control, "arch": arch,
                        "comparison": tag, **x,
                        "err_frac": x["max_abs_err"] / x["logit_scale"],
                        "tol_frac": bound[arch] if bound else None}),
                        flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
