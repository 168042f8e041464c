"""Training launcher (end to end).

  python -m repro_torch.launch.train --arch qwen2-0.5b \
      --steps 50 --seq 128 --batch 8 [--smoke] [--device cuda|cpu]

(with ``port/`` on ``PYTHONPATH``).  Runs the Trainer (data pipeline ->
eager train step -> async checkpoints) on the card unless ``--device
cpu``; use ``--smoke`` for the reduced config.  Checkpoints go to
``--ckpt-dir`` (by default under the system's temporary directory), which
is emptied first unless ``--resume``.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import shutil

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.core.engine import resolve_device
    from repro_torch.data.pipeline import (DataConfig, TokenDataset,
                                           synthetic_tokens)
    from repro_torch.launch.steps import TrainConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab=cfg.vocab)
    tokens = synthetic_tokens(args.seq * args.batch * (args.steps + 4) + 1,
                              cfg.vocab)
    ds = TokenDataset(tokens, dcfg)
    if not args.resume:
        shutil.rmtree(args.ckpt_dir, ignore_errors=True)
    tr = Trainer(cfg, TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                                    train=TrainConfig(remat="none")), ds,
                 device=args.device)
    out = tr.run()
    first, last = out["losses"][0], out["losses"][-1]
    print(f"step {first[0]}: loss {first[1]:.4f}  ->  "
          f"step {last[0]}: loss {last[1]:.4f}")
    return out


if __name__ == "__main__":
    main()
