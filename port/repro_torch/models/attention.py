"""Attention variants: GQA (with RoPE / bias / sliding window), MLA
(DeepSeek-V2 latent compression), and gated cross-attention (Llama-3.2
vision).  Each has a train-time (full-sequence) form and a decode form over
a KV cache.

The port of ``repro.models.attention``.  Scores and softmax keep the
reference's operation order and dtypes (scores divided by ``sqrt(hd)``
cast to the query's dtype, then the f32 cast and the additive mask,
softmax in f32 cast back to the values' dtype), so the products stay plain
``torch.einsum`` rather than a library attention call.

Decode writes the caches in place (``index_copy_`` at a device index;
``launch/sharding.index_copy_`` on a cache split over a process mesh):
the step makes no host read, and the returned cache holds the same cache
tensors it was given.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.launch.sharding import by_heads, index_copy_, on_pieces

from .layers import Spec, rms_norm, rope, shard

__all__ = ["gqa_shapes", "gqa_attention", "gqa_decode",
           "mla_shapes", "mla_attention", "mla_decode",
           "cross_attn_shapes", "cross_attention", "gated", "causal_mask"]

NEG_INF = -1e30


FLASH_THRESHOLD = 2048   # S*T above threshold^2 -> chunked online-softmax
FLASH_KV_CHUNK = 512


@functools.lru_cache(maxsize=None)
def _sqrt_as(hd: int, dtype: torch.dtype) -> float:
    """``sqrt(hd)`` rounded to ``dtype``, as a Python float."""
    return torch.tensor(math.sqrt(hd), dtype=torch.float64).to(dtype).item()


@functools.lru_cache(maxsize=None)
def _inv_sqrt_f32(hd: int) -> float:
    """``1 / f32(sqrt(hd))`` divided in float32, as a Python float (exact
    in float32, so a product with it rounds as the reference's does)."""
    return (1.0 / torch.tensor(_sqrt_as(hd, torch.float32))).item()


def _sdpa_dense(q, k, v, mask):
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    g = H // KV
    q = by_heads(q, (B, S, KV, g, hd))
    scores = torch.einsum("bskgh,btkh->bkgst", q, k) / _sqrt_as(hd, q.dtype)
    scores = scores.float() + mask
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v)
    return by_heads(out, (B, S, H, v.shape[-1]))


def _sdpa_chunked(q, k, v, window):
    """Flash-style causal attention: a loop over KV chunks with online
    softmax.  Never materializes (S, T) scores — memory O(S * chunk).
    Assumes self-attention with S == T (train/prefill).  The reference
    checkpoints each chunk step for its backward pass; without a gradient
    a plain loop computes the same values."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    g = H // KV
    ck = min(FLASH_KV_CHUNK, T)
    n_chunks = T // ck
    if T % ck:
        raise ValueError(f"T={T} is not a multiple of the chunk {ck}")
    dev = q.device
    qr = by_heads(q, (B, S, KV, g, hd))
    scale = _inv_sqrt_f32(hd)
    qpos = torch.arange(S, device=dev)[:, None]

    m = torch.full((B, KV, g, S), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, g, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, KV, g, vd), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        kch = k[:, ci * ck:(ci + 1) * ck]
        vch = v[:, ci * ck:(ci + 1) * ck]
        s = torch.einsum("bskgh,btkh->bkgst", qr, kch).float() * scale
        kpos = ci * ck + torch.arange(ck, device=dev)[None, :]
        ok = kpos <= qpos
        if window is not None:
            ok &= kpos > qpos - window
        s = torch.where(ok, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard -inf - -inf
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(ok, p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkh->bskgh", p.to(v.dtype), vch).float()
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    lt = torch.clamp(l.permute(0, 3, 1, 2)[..., None], min=1e-30)
    out = (acc / lt).to(v.dtype)
    return by_heads(out, (B, S, H, vd))


def _sdpa(q, k, v, mask, window=None, chunked=None):
    """q (B,S,H,hd), k (B,T,KV,hd), v (B,T,KV,vd); mask (S,T) additive or
    None for chunked causal.  Chunked path auto-selected for long self-attn.
    On a process mesh outside inference mode (training), with q split
    over the batch and heads only, each rank attends its own rows and
    heads on its pieces (``sharding.on_pieces``; k and v laid out as q)."""
    split = on_pieces(q, (k, v), (0, 2))
    if split is not None:
        (ql, kl, vl), wrap = split
        return wrap(_sdpa(ql, kl, vl, mask, window, chunked),
                    tuple(q.shape[:3]) + (v.shape[-1],))
    S, T = q.shape[1], k.shape[1]
    if chunked is None:
        chunked = (S == T and S * T > FLASH_THRESHOLD ** 2)
    if chunked and S == T:
        return _sdpa_chunked(q, k, v, window)
    return _sdpa_dense(q, k, v, mask)


def causal_mask(S: int, T: int, window: int | None = None, device=None):
    """(S, T) additive mask; queries at positions T-S..T-1."""
    qpos = torch.arange(T - S, T, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok &= kpos > qpos - window
    return torch.where(ok, 0.0, NEG_INF).float()


# ------------------------------------------------------------------------ GQA

def gqa_shapes(cfg, dtype):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {
        "wq": Spec((D, H * hd), dtype, ("embed", "heads")),
        "wk": Spec((D, KV * hd), dtype, ("embed", "kv_heads")),
        "wv": Spec((D, KV * hd), dtype, ("embed", "kv_heads")),
        "wo": Spec((H * hd, D), dtype, ("heads", "embed")),
    }
    if cfg.qkv_bias:
        p["bq"] = Spec((H * hd,), dtype, ("heads",))
        p["bk"] = Spec((KV * hd,), dtype, ("kv_heads",))
        p["bv"] = Spec((KV * hd,), dtype, ("kv_heads",))
    return p


def _qkv(x, p, cfg):
    B, S, D = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (by_heads(q, (B, S, H, hd)), by_heads(k, (B, S, KV, hd)),
            by_heads(v, (B, S, KV, hd)))


def gqa_attention(x, p, cfg, positions=None, window=None):
    """Full-sequence causal attention. x (B,S,D)."""
    B, S, D = x.shape
    q, k, v = _qkv(x, p, cfg)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = shard(q, ("batch", "seq", "heads", None))
    k = shard(k, ("batch", "seq", "kv_heads", None))
    if S * S > FLASH_THRESHOLD ** 2:
        out = _sdpa(q, k, v, None, window=window, chunked=True)
    else:
        out = _sdpa(q, k, v, causal_mask(S, S, window, device=x.device),
                    window=window)
    out = by_heads(out, (B, S, cfg.n_heads * cfg.hd))
    return out @ p["wo"]


def gqa_decode(x, p, cfg, cache, window=None):
    """One-token decode. x (B,1,D); cache dict with k/v (B,T,KV,hd) ring or
    linear buffer and pos () int32, one position shared by every row of
    the batch, as in the reference.  Writes k/v in place; returns (out,
    cache with pos + 1)."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    pos = cache["pos"]
    q, k, v = _qkv(x, p, cfg)
    posb = pos.reshape(1, 1).expand(B, 1)
    q = rope(q, posb, cfg.rope_theta)
    k = rope(k, posb, cfg.rope_theta)
    slot = (pos % T) if window is not None else torch.clamp(pos, max=T - 1)
    idx = slot.reshape(1).long()
    ck = index_copy_(cache["k"], 1, idx, k)
    cv = index_copy_(cache["v"], 1, idx, v)
    kpos = torch.arange(T, device=x.device)
    if window is not None:
        # ring buffer: valid entries are the last min(pos+1, T) writes
        age = pos - ((pos - kpos) % T)      # absolute position of each slot
        ok = (age >= 0) & (age >= pos - (window - 1)) & (age <= pos)
    else:
        ok = kpos <= pos
    mask = torch.where(ok, 0.0, NEG_INF).float()[None, :]
    out = _sdpa(q, ck, cv, mask)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd) @ p["wo"]
    return out, {"k": ck, "v": cv, "pos": pos + 1}


# ------------------------------------------------------------------------ MLA

def mla_shapes(cfg, dtype):
    """DeepSeek-V2 multi-head latent attention (no q-lora in the Lite cfg)."""
    D, H = cfg.d_model, cfg.n_heads
    nope, rpe, vd, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    return {
        "wq": Spec((D, H * (nope + rpe)), dtype, ("embed", "heads")),
        "wkv_a": Spec((D, r + rpe), dtype, ("embed", "lora")),
        "kv_norm": Spec((r,), torch.float32, ("lora",)),
        "wkv_b": Spec((r, H * (nope + vd)), dtype, ("lora", "heads")),
        "wo": Spec((H * vd, D), dtype, ("heads", "embed")),
    }


def mla_attention(x, p, cfg, positions=None):
    B, S, D = x.shape
    H = cfg.n_heads
    nope, rpe, vd, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    q = by_heads(x @ p["wq"], (B, S, H, nope + rpe))
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)
    kv = x @ p["wkv_a"]                              # (B,S,r+rpe)
    c_kv = rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope = rope(kv[..., None, r:], positions, cfg.rope_theta)  # (B,S,1,rpe)
    kvb = by_heads(c_kv @ p["wkv_b"], (B, S, H, nope + vd))
    k_nope, v = kvb[..., :nope], kvb[..., nope:]
    k_rope_b = k_rope.expand(B, S, H, rpe)
    # laid out by batch and heads, as gqa_attention's q and k (on a
    # process mesh DTensor may leave the products partial sums)
    q_full = shard(torch.cat([q_nope, q_rope], dim=-1),
                   ("batch", "seq", "heads", None))
    k_full = shard(torch.cat([k_nope, k_rope_b], dim=-1),
                   ("batch", "seq", "heads", None))
    if S * S > FLASH_THRESHOLD ** 2:
        out = _sdpa(q_full, k_full, v, None, chunked=True)   # H == KV here
    else:
        out = _sdpa(q_full, k_full, v, causal_mask(S, S, device=x.device))
    out = by_heads(out, (B, S, H * vd))
    return out @ p["wo"]


def mla_decode(x, p, cfg, cache):
    """Decode with the *compressed* cache: (c_kv (B,T,r), k_rope (B,T,rpe))
    and pos () int32, one position shared by every row of the batch, as in
    the reference; a write past T lands in slot T-1.  Writes c_kv and
    k_rope in place; returns (out, cache with pos + 1)."""
    B = x.shape[0]
    H = cfg.n_heads
    nope, rpe, vd, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim, cfg.kv_lora_rank
    T = cache["c_kv"].shape[1]
    pos = cache["pos"]
    posb = pos.reshape(1, 1).expand(B, 1)
    q = (x @ p["wq"]).reshape(B, 1, H, nope + rpe)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = rope(q_rope, posb, cfg.rope_theta)
    kv = x @ p["wkv_a"]
    c_new = rms_norm(kv[..., :r], p["kv_norm"], cfg.norm_eps)
    k_rope_new = rope(kv[..., None, r:], posb, cfg.rope_theta)[:, :, 0, :]
    idx = torch.clamp(pos, max=T - 1).reshape(1).long()
    c_kv = index_copy_(cache["c_kv"], 1, idx, c_new)
    kr = index_copy_(cache["k_rope"], 1, idx, k_rope_new)
    # absorbed attention: score = q_nope . (c @ Wb_k) + q_rope . k_rope
    wkv_b = p["wkv_b"].reshape(r, H, nope + vd)
    wb_k, wb_v = wkv_b[..., :nope], wkv_b[..., nope:]
    q_lat = torch.einsum("bohn,rhn->bohr", q_nope, wb_k)     # (B,1,H,r)
    s_lat = torch.einsum("bohr,btr->bhot", q_lat, c_kv)
    s_rope = torch.einsum("bohp,btp->bhot", q_rope, kr)
    scores = (s_lat + s_rope).float() * _inv_sqrt_f32(nope + rpe)
    ok = torch.arange(T, device=x.device) <= pos
    scores = scores + torch.where(ok, 0.0, NEG_INF).float()
    probs = torch.softmax(scores, dim=-1).to(x.dtype)
    o_lat = torch.einsum("bhot,btr->bohr", probs, c_kv)      # (B,1,H,r)
    out = torch.einsum("bohr,rhv->bohv", o_lat, wb_v)
    out = out.reshape(B, 1, H * vd) @ p["wo"]
    return out, {"c_kv": c_kv, "k_rope": kr, "pos": pos + 1}


# ----------------------------------------------------------------- cross-attn

def cross_attn_shapes(cfg, dtype):
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": Spec((D, H * hd), dtype, ("embed", "heads")),
        "wk": Spec((D, KV * hd), dtype, ("embed", "kv_heads")),
        "wv": Spec((D, KV * hd), dtype, ("embed", "kv_heads")),
        "wo": Spec((H * hd, D), dtype, ("heads", "embed")),
        "gate": Spec((1,), torch.float32, (None,)),
    }


def cross_attention(x, kv_src, p, cfg):
    """Gated cross-attention (Llama-3.2 vision).  kv_src (B, I, D) image
    embeddings; output is tanh-gated (zero-init -> identity at init)."""
    B, S, D = x.shape
    I = kv_src.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = by_heads(x @ p["wq"], (B, S, H, hd))
    # bf16 embeddings into f32 weights promote, as ``jnp.matmul`` does
    kv_src = kv_src.to(torch.promote_types(kv_src.dtype, p["wk"].dtype))
    k = by_heads(kv_src @ p["wk"], (B, I, KV, hd))
    v = by_heads(kv_src @ p["wv"], (B, I, KV, hd))
    # laid out by batch and heads, as gqa_attention's q and k
    q = shard(q, ("batch", "seq", "heads", None))
    k = shard(k, ("batch", "seq", "kv_heads", None))
    mask = torch.zeros((S, I), dtype=torch.float32, device=x.device)
    out = _sdpa(q, k, v, mask)
    out = by_heads(out, (B, S, H * hd)) @ p["wo"]
    return gated(out, p["gate"])


def gated(y, gate):
    """``y`` scaled by ``tanh(gate)``, a (1,) f32 gate (0 at init: the
    identity of the residual it feeds)."""
    return y * torch.tanh(gate).to(y.dtype)
