#!/usr/bin/env python
"""Phase H's logit comparisons, for the sound port and for controls that
carry a deliberate precision fault: the readings that chip_smoke.py's
H_LOGIT_TOL is set between.

    python port/scripts/logit_tol_control.py

Needs one CUDA card.  For each of SEEDS it builds qwen2-0.5b at full
width in bf16 on the card (``init_params`` from a generator seeded with
it, as phase H does) and takes ``chip_smoke.lm_logit_readings``: the bf16 decode
against ``forward`` and against the same port in f32 on the CPU.  Each
control patches one fault into the port's modules for its own reading.
Every fault computes in the input's dtype, so the f32 side on the CPU is
unchanged and only the card's bf16 side carries it:

  norm_bf16          RMSNorm in bf16, not in f32
  softmax_bf16       the attention softmax in bf16, not in f32
  rope_bf16          the rotary rotation in bf16, not in f32
  divide_after_cast  scores divided by sqrt(hd) after the f32 cast, not
                     before it (exact when sqrt(hd) is a power of two)

Prints one JSON line a reading (``err_frac`` is the error over the
reference's largest logit), then the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

import chip_smoke  # noqa: E402
import torch  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import attention, layers  # noqa: E402
from repro_torch.models import init_params  # noqa: E402


def _rms_norm_in_dtype(x, scale, eps):
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return x * scale.to(x.dtype)


def _rope_in_dtype(x, positions, theta, rotary_dim=None):
    hd = x.shape[-1]
    rd = rotary_dim or hd
    half = rd // 2
    ang = positions[..., None].float() * layers._rope_freqs(
        float(theta), rd, x.device)
    cos = torch.cos(ang)[..., None, :].to(x.dtype)
    sin = torch.sin(ang)[..., None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:rd]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out, x[..., rd:]], dim=-1) if rd < hd else out


def _sdpa_dense_with(softmax_dtype: bool, divide_after: bool):
    def sdpa(q, k, v, mask):
        B, S, H, hd = q.shape
        KV = k.shape[2]
        q = q.reshape(B, S, KV, H // KV, hd)
        scores = torch.einsum("bskgh,btkh->bkgst", q, k)
        if divide_after:
            scores = scores.float() / attention._sqrt_as(hd, torch.float32)
        else:
            scores = scores / attention._sqrt_as(hd, q.dtype)
        scores = scores.float() + mask
        if softmax_dtype:
            scores = scores.to(q.dtype)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bkgst,btkh->bskgh", probs, v)
        return out.reshape(B, S, H, v.shape[-1])
    return sdpa


SEEDS = (0, 1, 2, 3)
CONTROLS = {
    "sound": (),
    "norm_bf16": ((layers, "rms_norm", _rms_norm_in_dtype),),
    "softmax_bf16": ((attention, "_sdpa_dense",
                      _sdpa_dense_with(True, False)),),
    "rope_bf16": ((attention, "rope", _rope_in_dtype),),
    "divide_after_cast": ((attention, "_sdpa_dense",
                           _sdpa_dense_with(False, True)),),
}


@contextlib.contextmanager
def patched(patches):
    old = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in old:
            setattr(mod, name, fn)


def main() -> int:
    if not torch.cuda.is_available():
        print("logit_tol_control: no CUDA device", file=sys.stderr)
        return 1
    cfg = get_config(chip_smoke.H_ARCH)
    for seed in SEEDS:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        params = init_params(cfg, gen, device="cuda")
        for control, patches in CONTROLS.items():
            with patched(patches):
                r = chip_smoke.lm_logit_readings(params, cfg, seed, "cuda")
            for tag, x in r.items():
                print(json.dumps({
                    "seed": seed, "control": control, "comparison": tag,
                    **x, "err_frac": x["max_abs_err"] / x["logit_scale"],
                    "tol_frac": chip_smoke.H_LOGIT_TOL}), flush=True)
        del params
        torch.cuda.empty_cache()
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
