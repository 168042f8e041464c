"""Serving launcher: batched requests through the engine + Bourbon session
store.

  python -m repro_torch.launch.serve --arch qwen2-0.5b --requests 12 \
      [--device cuda|cpu]

(with ``port/`` on ``PYTHONPATH``).  The model is the arch's smoke config,
initialized from a seeded ``torch.Generator``; it runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import EngineConfig, Request, ServingEngine

    cfg = get_smoke_config(args.arch)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device=args.device)
    eng = ServingEngine(cfg, params, EngineConfig(max_batch=4, max_seq=64),
                        device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(3, 10)
                              ).astype(np.int32)
        eng.submit(Request(rid=1000 + i, prompt=prompt,
                           max_new=args.max_new))
    eng.run_until_drained()
    st = eng.sessions.stats()
    print(f"served {args.requests} requests in {eng.steps} engine steps; "
          f"session-store model-path fraction: {st['model_path_frac']:.2f}")


if __name__ == "__main__":
    main()
