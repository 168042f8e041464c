"""Transformer block variants, each with shapes / forward / decode.

Block contract (the reference's ``repro.models.blocks``):
  shapes(cfg, dtype)                         -> param tree of layers.Spec
  forward(x, p, cfg, aux)                    -> (x, aux_loss)
  decode(x, p, cfg, cache, aux)              -> (x, new_cache)
  init_cache(cfg, B, T, dtype, device)       -> cache tree (zeros)

aux carries cross-modal inputs (image embeddings) and layer metadata.
Ported: ``attn_mlp`` (the dense GQA configs: qwen2, qwen2.5, glm4,
command-r, musicgen), ``attn_moe`` (mixtral), ``mla_dense`` and
``mla_moe`` (deepseek) and ``cross_attn_mlp`` (llama-vision).  The
recurrent blocks (``hybrid``, ``mlstm``, ``slstm``) follow in ROADMAP
Queue 1 item 7d, and asking ``BLOCKS`` for one raises a ``KeyError`` that
says so.
"""

from __future__ import annotations

import torch

from .attention import (cross_attention, cross_attn_shapes, gqa_attention,
                        gqa_decode, gqa_shapes, mla_attention, mla_decode,
                        mla_shapes)
from .layers import Spec, apply_norm, glu_mlp, mlp_shapes, norm_shapes
from .moe import moe_ffn, moe_shapes

__all__ = ["BLOCKS", "AttnMlp", "AttnMoe", "MlaMoe", "MlaDense",
           "CrossAttnMlp"]


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


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
        return {"k": _zeros(kv, dtype, device),
                "v": _zeros(kv, dtype, device),
                "pos": _zeros((), torch.int32, device)}


# --------------------------------------------------------------- attn_moe

class AttnMoe(AttnMlp):
    @staticmethod
    def shapes(cfg, dtype):
        return {
            "ln1": norm_shapes(cfg, torch.float32),
            "attn": gqa_shapes(cfg, dtype),
            "ln2": norm_shapes(cfg, torch.float32),
            "moe": moe_shapes(cfg, dtype),
        }

    @staticmethod
    def forward(x, p, cfg, aux):
        h = apply_norm(x, p["ln1"], cfg)
        x = x + gqa_attention(h, p["attn"], cfg, window=cfg.window)
        h = apply_norm(x, p["ln2"], cfg)
        y, aux_l = moe_ffn(h, p["moe"], cfg, cfg.act)
        return x + y, aux_l

    @staticmethod
    def decode(x, p, cfg, cache, aux):
        h = apply_norm(x, p["ln1"], cfg)
        a, cache = gqa_decode(h, p["attn"], cfg, cache, window=cfg.window)
        x = x + a
        h = apply_norm(x, p["ln2"], cfg)
        y, _ = moe_ffn(h, p["moe"], cfg, cfg.act, capacity_factor=2.0,
                       with_aux=False)
        return x + y, cache


# --------------------------------------------------------------- mla_moe

class MlaMoe:
    @staticmethod
    def shapes(cfg, dtype):
        return {
            "ln1": norm_shapes(cfg, torch.float32),
            "attn": mla_shapes(cfg, dtype),
            "ln2": norm_shapes(cfg, torch.float32),
            "moe": moe_shapes(cfg, dtype),
        }

    @staticmethod
    def forward(x, p, cfg, aux):
        h = apply_norm(x, p["ln1"], cfg)
        x = x + mla_attention(h, p["attn"], cfg)
        h = apply_norm(x, p["ln2"], cfg)
        y, aux_l = moe_ffn(h, p["moe"], cfg, cfg.act)
        return x + y, aux_l

    @staticmethod
    def decode(x, p, cfg, cache, aux):
        h = apply_norm(x, p["ln1"], cfg)
        a, cache = mla_decode(h, p["attn"], cfg, cache)
        x = x + a
        h = apply_norm(x, p["ln2"], cfg)
        y, _ = moe_ffn(h, p["moe"], cfg, cfg.act, capacity_factor=2.0,
                       with_aux=False)
        return x + y, cache

    @staticmethod
    def init_cache(cfg, B, T, dtype, device):
        return {"c_kv": _zeros((B, T, cfg.kv_lora_rank), dtype, device),
                "k_rope": _zeros((B, T, cfg.qk_rope_dim), dtype, device),
                "pos": _zeros((), torch.int32, device)}


# ------------------------------------------------------------- mla_dense

class MlaDense(MlaMoe):
    """DeepSeek prologue layer: MLA attention + dense MLP."""

    @staticmethod
    def shapes(cfg, dtype):
        return {
            "ln1": norm_shapes(cfg, torch.float32),
            "attn": mla_shapes(cfg, dtype),
            "ln2": norm_shapes(cfg, torch.float32),
            "mlp": mlp_shapes(cfg, cfg.d_ff, dtype),
        }

    @staticmethod
    def forward(x, p, cfg, aux):
        h = apply_norm(x, p["ln1"], cfg)
        x = x + mla_attention(h, p["attn"], cfg)
        h = apply_norm(x, p["ln2"], cfg)
        return x + glu_mlp(h, p["mlp"], cfg.act), 0.0

    @staticmethod
    def decode(x, p, cfg, cache, aux):
        h = apply_norm(x, p["ln1"], cfg)
        a, cache = mla_decode(h, p["attn"], cfg, cache)
        x = x + a
        h = apply_norm(x, p["ln2"], cfg)
        return x + glu_mlp(h, p["mlp"], cfg.act), cache


# ---------------------------------------------------------- cross_attn_mlp

class CrossAttnMlp:
    """Llama-3.2-vision cross-attention layer: gated cross-attn to image
    embeddings + MLP (self-attn free, per the HF architecture)."""

    @staticmethod
    def shapes(cfg, dtype):
        return {
            "ln1": norm_shapes(cfg, torch.float32),
            "xattn": cross_attn_shapes(cfg, dtype),
            "ln2": norm_shapes(cfg, torch.float32),
            "mlp": mlp_shapes(cfg, cfg.d_ff, dtype),
            "mlp_gate": Spec((1,), torch.float32, (None,)),
        }

    @staticmethod
    def forward(x, p, cfg, aux):
        img = aux["image_embed"]          # (B, I, D)
        h = apply_norm(x, p["ln1"], cfg)
        x = x + cross_attention(h, img, p["xattn"], cfg)
        h = apply_norm(x, p["ln2"], cfg)
        y = glu_mlp(h, p["mlp"], cfg.act)
        return x + y * torch.tanh(p["mlp_gate"]).to(y.dtype), 0.0

    @staticmethod
    def decode(x, p, cfg, cache, aux):
        # the image K/V are projected again each step, as in the reference;
        # the cache's position never advances
        out, _ = CrossAttnMlp.forward(x, p, cfg, aux)
        return out, cache

    @staticmethod
    def init_cache(cfg, B, T, dtype, device):
        return {"pos": _zeros((), torch.int32, device)}


UNPORTED = ("hybrid", "mlstm", "slstm")   # the recurrent blocks (ssm.py)


class _Blocks(dict):
    """The block registry; a block of the reference not ported yet raises
    a KeyError that names it and the ROADMAP item that ports it."""

    def __missing__(self, block):
        if block in UNPORTED:
            raise KeyError(f"block {block!r} is not ported to repro_torch "
                           f"yet (ROADMAP Queue 1 item 7d: ssm.py with "
                           f"{', '.join(UNPORTED)}); ported: {sorted(self)}")
        raise KeyError(f"unknown block {block!r}; known: {sorted(self)}")


BLOCKS = _Blocks({
    "attn_mlp": AttnMlp,
    "attn_moe": AttnMoe,
    "mla_moe": MlaMoe,
    "mla_dense": MlaDense,
    "cross_attn_mlp": CrossAttnMlp,
})
