"""Serve a small model with batched requests through the continuous-batching
engine; the Bourbon learned index is the session -> KV-page table.  The
PyTorch port of examples/serve_kv_cache.py.

  python port/examples/serve_kv_cache.py                 # on the card
  python port/examples/serve_kv_cache.py --device cpu

Expect every one of the 16 requests served with 6 new tokens.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving.engine import (EngineConfig, Request,  # noqa: E402
                                        ServingEngine)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("qwen2-0.5b")
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=args.device)
    eng = ServingEngine(cfg, params, EngineConfig(max_batch=4, max_seq=64),
                        session_policy="always", device=args.device)

    rng = np.random.default_rng(0)
    reqs = []
    for i in range(16):
        prompt = rng.integers(0, cfg.vocab, int(rng.integers(3, 12))
                              ).astype(np.int32)
        reqs.append(Request(rid=5000 + i, prompt=prompt, max_new=6))
        eng.submit(reqs[-1])

    eng.run_until_drained()
    served = sum(r.done and len(r.generated) == r.max_new for r in reqs)
    if served != len(reqs):
        raise RuntimeError(f"{len(reqs) - served} requests not served")
    st = eng.sessions.stats()
    print(f"served {served} requests in {eng.steps} engine steps "
          f"(continuous batching, max_batch=4)")
    print(f"session store: {st['n_records']} live records, "
          f"model-path fraction {st['model_path_frac']:.2f}, "
          f"files learned {st['files_learned']}")
    return {"served": served, "steps": eng.steps, "stats": st}


if __name__ == "__main__":
    main()
