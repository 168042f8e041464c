"""End to end: train a ~100M-param qwen2-family model for a few
hundred steps on synthetic data with checkpointing.  The PyTorch port of
examples/train_lm.py.

  python port/examples/train_lm.py [--steps 200]            # on the card
  python port/examples/train_lm.py --device cpu --d-model 64 --layers 2 \
      --steps 21

Checkpoints go to a temporary directory, removed at the end.  Expect the
loss to fall.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.engine import resolve_device  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, TokenDataset,  # noqa: E402
                                       synthetic_tokens)
from repro_torch.launch.steps import TrainConfig  # noqa: E402
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    # ~100M params at the defaults: d=512, 8L, vocab 32k
    cfg = dataclasses.replace(
        get_config("qwen2-0.5b"), d_model=args.d_model, n_heads=8,
        n_kv_heads=2, d_ff=4 * args.d_model, vocab=32768,
        n_units=args.layers, dtype="float32", tie_embeddings=True)

    ds = TokenDataset(synthetic_tokens(8_000_000, cfg.vocab),
                      DataConfig(seq_len=256, global_batch=8,
                                 vocab=cfg.vocab))
    ckpt = tempfile.mkdtemp(prefix="repro_torch_example_")
    try:
        tr = Trainer(cfg, TrainerConfig(steps=args.steps, ckpt_every=50,
                                        ckpt_dir=ckpt, log_every=20,
                                        train=TrainConfig(remat="none")),
                     ds, device=args.device)
        out = tr.run()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    for step, loss in out["losses"]:
        print(f"step {step:5d}  loss {loss:.4f}")
    first, last = out["losses"][0][1], out["losses"][-1][1]
    if not last < first:
        raise RuntimeError(f"loss should decrease: {first} -> {last}")
    print(f"loss {first:.3f} -> {last:.3f} over {args.steps} steps")
    return out["losses"]


if __name__ == "__main__":
    main()
