"""Mixture-of-experts FFN: top-k routing, capacity-bucketed dispatch, batched
expert GEMMs, optional shared experts (DeepSeekMoE), load-balance aux loss.

The port of ``repro.models.moe``.  Dispatch is scatter-based (linear in
tokens): tokens are ranked within their expert via a one-hot cumsum,
scattered into an (E, C, D) buffer (overflow dropped at capacity C =
ceil(T*K/E)*capacity_factor, rounded up to 8), processed by one batched
product per weight and combined back with their gates.

The reference's order is kept where it decides a value: the top-k is a
stable descending sort of the probabilities, so ties go to the lower
expert as ``jax.lax.top_k`` gives them, and ranks follow the (token, k)
slots in token-major order, so the same assignments are dropped.  The
capacity is Python arithmetic on static ints, and nothing here reads a
device value on the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Spec, glu_mlp, mlp_shapes, shard

__all__ = ["moe_shapes", "moe_ffn", "route", "capacity", "GROUP_TOKENS"]


def moe_shapes(cfg, dtype):
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {
        "router": Spec((D, E), torch.float32, ("embed", "experts")),
        "w1": Spec((E, D, Fe), dtype, ("experts", "embed", "mlp")),
        "w3": Spec((E, D, Fe), dtype, ("experts", "embed", "mlp")),
        "w2": Spec((E, Fe, D), dtype, ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_shapes(cfg, cfg.moe_d_ff * cfg.n_shared_experts,
                                 dtype)
    return p


GROUP_TOKENS = 1024   # dispatch-group size (bounds per-group capacity)


def capacity(tg: int, K: int, E: int, capacity_factor: float) -> int:
    """Slots an expert has in a group of ``tg`` tokens: the reference's
    static arithmetic, rounded up to a multiple of 8."""
    C = int(max(K, -(-tg * K // E) * capacity_factor))
    return -(-C // 8) * 8


def route(xg, router, K: int, C: int):
    """Top-k routing of the groups ``xg`` (G, tg, D) over the f32
    ``router`` (D, E).  Returns (probs (G,tg,E) f32, idx (G,tg,K),
    gates (G,tg*K) f32, keep (G,tg*K) bool, dest (G,tg*K)): each (token,
    k) slot's expert, its renormalized gate, whether it fits the expert's
    capacity ``C``, and its row of the (E*C + 1)-row dispatch buffer (the
    last row is the overflow sink)."""
    G, tg, _ = xg.shape
    E = router.shape[1]
    logits = xg.float() @ router                               # (G,t,E)
    probs = torch.softmax(logits, dim=-1)
    # stable descending sort: ties to the lower expert, as lax.top_k
    gate_vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, idx = gate_vals[..., :K], idx[..., :K]          # (G,t,K)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # rank within (group, expert) over the t*K assignment slots; the
    # one-hot is laid out (G, E, tK) so that the scan runs along the
    # innermost axis (a scan over an outer axis is one thread a column)
    flat_e = idx.reshape(G, tg * K)
    experts = torch.arange(E, device=xg.device)[:, None]
    oh = (flat_e[:, None, :] == experts).to(torch.int32)       # (G,E,tK)
    pos = torch.cumsum(oh, dim=2, dtype=torch.int32) - oh
    pos_in_e = torch.gather(pos, 1, flat_e[:, None, :])[:, 0]  # (G,tK)
    keep = pos_in_e < C
    dest = torch.where(keep, flat_e * C + pos_in_e, E * C)     # overflow sink
    return probs, idx, gate_vals.reshape(G, tg * K), keep, dest


def moe_ffn(x, p, cfg, act: str, capacity_factor: float = 1.25,
            with_aux: bool = True):
    """x (B,S,D) -> ((B,S,D), aux_loss f32).

    Tokens are split into GROUP_TOKENS-sized groups (``B*S`` must be a
    multiple of the group size, as in the reference); each group scatters
    into an (E, C_group, D) buffer.  ``with_aux=False`` skips the aux loss
    and returns None in its place: the reference's decode computes it and
    discards it, so no value that is read changes."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    tg = min(GROUP_TOKENS, T)
    G = T // tg
    xg = x.reshape(G, tg, D)
    C = capacity(tg, K, E, capacity_factor)
    probs, idx, flat_g, keep, dest = route(xg, p["router"], K, C)

    aux = None
    if with_aux:
        # load-balance aux loss (Switch): E * sum_e f_e * P_e
        one_hot_k = F.one_hot(idx, E).float()                  # (G,t,K,E)
        frac_tokens = one_hot_k.sum(dim=2).mean(dim=(0, 1)) / K
        frac_probs = probs.mean(dim=(0, 1))
        aux = E * torch.sum(frac_tokens * frac_probs) * cfg.router_aux_coef

    # dispatch: every kept slot has a row of its own; only the sink row
    # (never read) sees duplicates
    rows_g = E * C + 1
    tok = torch.arange(tg * K, device=x.device) // K
    base = torch.arange(G, device=x.device)[:, None] * rows_g
    buf = torch.zeros((G * rows_g, D), dtype=x.dtype, device=x.device)
    buf.index_add_(0, (base + dest).reshape(-1),
                   xg[:, tok].reshape(G * tg * K, D))
    eb = buf.view(G, rows_g, D)[:, :E * C].reshape(G, E, C, D)
    eb = shard(eb, ("batch", "experts", None, "embed"))

    h1 = torch.einsum("gecd,edf->gecf", eb, p["w1"])
    h3 = torch.einsum("gecd,edf->gecf", eb, p["w3"])
    a = F.silu(h1) if act == "silu" else F.gelu(h1, approximate="tanh")
    hact = shard(a * h3, ("batch", "experts", None, "mlp"))
    out = torch.einsum("gecf,efd->gecd", hact, p["w2"])        # (G,E,C,D)

    # combine: per-group gather of each kept assignment's output row
    out_flat = torch.cat([out.reshape(G, E * C, D),
                          torch.zeros((G, 1, D), dtype=out.dtype,
                                      device=out.device)], dim=1)
    rows = out_flat.reshape(G * rows_g, D).index_select(
        0, (base + dest).reshape(-1)).reshape(G, tg * K, D)
    w = (flat_g * keep).to(out.dtype)[..., None]
    y = torch.sum((rows * w).reshape(G, tg, K, D), dim=2).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + glu_mlp(x, p["shared"], act)
    return y, aux
