"""Transformer block variants, each with shapes / forward / decode.

Block contract (the reference's ``repro.models.blocks``):
  shapes(cfg, dtype)                         -> param tree of layers.Spec
  forward(x, p, cfg, aux)                    -> (x, aux_loss)
  decode(x, p, cfg, cache, aux)              -> (x, new_cache)
  init_cache(cfg, B, T, dtype, device)       -> cache tree (zeros)

aux carries cross-modal inputs (image embeddings) and layer metadata.
Every block of the reference is here: ``attn_mlp`` (the dense GQA configs:
qwen2, qwen2.5, glm4, command-r, musicgen), ``attn_moe`` (mixtral),
``mla_dense`` and ``mla_moe`` (deepseek), ``hybrid`` (hymba), ``mlstm``
and ``slstm`` (xlstm) and ``cross_attn_mlp`` (llama-vision).  A decode
returns the block's cache tree, nested for ``hybrid``; the recurrent
blocks' new state comes back as new tensors, which ``model.Layer.decode``
writes into the caches.
"""

from __future__ import annotations

import torch

from .attention import (cross_attention, cross_attn_shapes, gqa_attention,
                        gqa_decode, gqa_shapes, mla_attention, mla_decode,
                        mla_shapes)
from .layers import Spec, apply_norm, glu_mlp, mlp_shapes, norm_shapes
from .moe import moe_ffn, moe_shapes
from .ssm import (mamba, mamba_decode, mamba_shapes, mlstm, mlstm_decode,
                  mlstm_shapes, slstm, slstm_decode, slstm_shapes)

__all__ = ["BLOCKS", "AttnMlp", "AttnMoe", "MlaMoe", "MlaDense", "Hybrid",
           "MLstm", "SLstm", "CrossAttnMlp"]


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


# ----------------------------------------------------------------- hybrid

class Hybrid:
    """Hymba: attention and mamba heads in parallel on the same input,
    outputs normalized and averaged; then MLP."""

    @staticmethod
    def shapes(cfg, dtype):
        return {
            "ln1": norm_shapes(cfg, torch.float32),
            "attn": gqa_shapes(cfg, dtype),
            "mamba": mamba_shapes(cfg, dtype),
            "na": norm_shapes(cfg, torch.float32),
            "nm": norm_shapes(cfg, torch.float32),
            "ln2": norm_shapes(cfg, torch.float32),
            "mlp": mlp_shapes(cfg, cfg.d_ff, dtype),
        }

    @staticmethod
    def forward(x, p, cfg, aux):
        h = apply_norm(x, p["ln1"], cfg)
        a = gqa_attention(h, p["attn"], cfg, window=cfg.window)
        m = mamba(h, p["mamba"], cfg)
        mix = 0.5 * (apply_norm(a, p["na"], cfg) + apply_norm(m, p["nm"], cfg))
        x = x + mix
        h = apply_norm(x, p["ln2"], cfg)
        return x + glu_mlp(h, p["mlp"], cfg.act), 0.0

    @staticmethod
    def decode(x, p, cfg, cache, aux):
        h = apply_norm(x, p["ln1"], cfg)
        a, ac = gqa_decode(h, p["attn"], cfg, cache["attn"], window=cfg.window)
        m, mc = mamba_decode(h, p["mamba"], cfg, cache["mamba"])
        mix = 0.5 * (apply_norm(a, p["na"], cfg) + apply_norm(m, p["nm"], cfg))
        x = x + mix
        h = apply_norm(x, p["ln2"], cfg)
        return x + glu_mlp(h, p["mlp"], cfg.act), {"attn": ac, "mamba": mc}

    @staticmethod
    def init_cache(cfg, B, T, dtype, device):
        Di = cfg.ssm_expand * cfg.d_model
        return {
            "attn": AttnMlp.init_cache(cfg, B, T, dtype, device),
            "mamba": {"h": _zeros((B, Di, cfg.ssm_state), torch.float32,
                                  device),
                      "conv": _zeros((B, cfg.ssm_conv - 1, Di), dtype,
                                     device)},
        }


# ------------------------------------------------------------------ xLSTM

class MLstm:
    @staticmethod
    def shapes(cfg, dtype):
        return {"ln1": norm_shapes(cfg, torch.float32),
                "cell": mlstm_shapes(cfg, dtype)}

    @staticmethod
    def forward(x, p, cfg, aux):
        return x + mlstm(apply_norm(x, p["ln1"], cfg), p["cell"], cfg), 0.0

    @staticmethod
    def decode(x, p, cfg, cache, aux):
        y, cache = mlstm_decode(apply_norm(x, p["ln1"], cfg), p["cell"], cfg,
                                cache)
        return x + y, cache

    @staticmethod
    def init_cache(cfg, B, T, dtype, device):
        H = cfg.n_heads
        hd = cfg.mlstm_pf * cfg.d_model // H
        return {"C": _zeros((B, H, hd, hd), torch.float32, device),
                "n": _zeros((B, H, hd), torch.float32, device),
                "m": _zeros((B, H), torch.float32, device)}


class SLstm:
    @staticmethod
    def shapes(cfg, dtype):
        return {"ln1": norm_shapes(cfg, torch.float32),
                "cell": slstm_shapes(cfg, dtype)}

    @staticmethod
    def forward(x, p, cfg, aux):
        return x + slstm(apply_norm(x, p["ln1"], cfg), p["cell"], cfg), 0.0

    @staticmethod
    def decode(x, p, cfg, cache, aux):
        y, cache = slstm_decode(apply_norm(x, p["ln1"], cfg), p["cell"], cfg,
                                cache)
        return x + y, cache

    @staticmethod
    def init_cache(cfg, B, T, dtype, device):
        H = cfg.slstm_heads
        z = (B, H, cfg.d_model // H)
        return {"c": _zeros(z, torch.float32, device),
                "n": _zeros(z, torch.float32, device),
                "h": _zeros(z, torch.float32, device),
                "m": _zeros((B, H), torch.float32, device)}


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


class _Blocks(dict):
    """The block registry; an unknown block raises a KeyError naming the
    known ones."""

    def __missing__(self, block):
        raise KeyError(f"unknown block {block!r}; known: {sorted(self)}")


BLOCKS = _Blocks({
    "attn_mlp": AttnMlp,
    "attn_moe": AttnMoe,
    "mla_moe": MlaMoe,
    "mla_dense": MlaDense,
    "hybrid": Hybrid,
    "mlstm": MLstm,
    "slstm": SLstm,
    "cross_attn_mlp": CrossAttnMlp,
})
