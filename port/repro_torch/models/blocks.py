"""Transformer block variants, each with shapes / forward / decode.

Block contract (the reference's ``repro.models.blocks``):
  shapes(cfg, dtype)                         -> param tree of layers.Spec
  forward(x, p, cfg, aux)                    -> (x, aux_loss)
  decode(x, p, cfg, cache, aux)              -> (x, new_cache)
  init_cache(cfg, B, T, dtype, device)       -> cache tree (zeros)

aux carries cross-modal inputs (image embeddings) and layer metadata.
This slice ports ``attn_mlp``, the block of the dense GQA configs
(qwen2, qwen2.5, glm4, command-r, musicgen); the others follow in ROADMAP
Queue 1 item 7d, and asking ``BLOCKS`` for one raises a ``KeyError`` that
says so.
"""

from __future__ import annotations

import torch

from .attention import gqa_attention, gqa_decode, gqa_shapes
from .layers import apply_norm, glu_mlp, mlp_shapes, norm_shapes

__all__ = ["BLOCKS", "AttnMlp"]


# --------------------------------------------------------------- attn_mlp

class AttnMlp:
    """Pre-norm GQA attention + gated MLP; optional parallel block
    (command-r) and sliding window."""

    @staticmethod
    def shapes(cfg, dtype):
        p = {
            "ln1": norm_shapes(cfg, torch.float32),
            "attn": gqa_shapes(cfg, dtype),
            "mlp": mlp_shapes(cfg, cfg.d_ff, dtype),
        }
        if not cfg.parallel_block:
            p["ln2"] = norm_shapes(cfg, torch.float32)
        return p

    @staticmethod
    def forward(x, p, cfg, aux):
        if cfg.parallel_block:
            h = apply_norm(x, p["ln1"], cfg)
            return x + gqa_attention(h, p["attn"], cfg, window=cfg.window) \
                + glu_mlp(h, p["mlp"], cfg.act), 0.0
        h = apply_norm(x, p["ln1"], cfg)
        x = x + gqa_attention(h, p["attn"], cfg, window=cfg.window)
        h = apply_norm(x, p["ln2"], cfg)
        return x + glu_mlp(h, p["mlp"], cfg.act), 0.0

    @staticmethod
    def decode(x, p, cfg, cache, aux):
        if cfg.parallel_block:
            h = apply_norm(x, p["ln1"], cfg)
            a, cache = gqa_decode(h, p["attn"], cfg, cache, window=cfg.window)
            return x + a + glu_mlp(h, p["mlp"], cfg.act), cache
        h = apply_norm(x, p["ln1"], cfg)
        a, cache = gqa_decode(h, p["attn"], cfg, cache, window=cfg.window)
        x = x + a
        h = apply_norm(x, p["ln2"], cfg)
        return x + glu_mlp(h, p["mlp"], cfg.act), cache

    @staticmethod
    def init_cache(cfg, B, T, dtype, device):
        Tc = min(T, cfg.window) if cfg.window else T
        kv = (B, Tc, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device),
                "pos": torch.zeros((), dtype=torch.int32, device=device)}


class _Blocks(dict):
    """The block registry; a block not ported yet raises a KeyError that
    names it."""

    def __missing__(self, block):
        raise KeyError(f"block {block!r} is not ported to repro_torch yet "
                       f"(ROADMAP Queue 1 item 7d); ported: {sorted(self)}")


BLOCKS = _Blocks({"attn_mlp": AttnMlp})
