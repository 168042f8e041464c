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


def route(xg, router, K: int, C: int, before=None):
    """Top-k routing of the groups ``xg`` (G, tg, D) over the f32
    ``router`` (D, E).  Returns (probs (G,tg,E) f32, idx (G,tg,K),
    gates (G,tg*K) f32, keep (G,tg*K) bool, dest (G,tg*K)): each (token,
    k) slot's expert, its renormalized gate, whether it fits the expert's
    capacity ``C``, and its row of the (E*C + 1)-row dispatch buffer (the
    last row is the overflow sink).  ``before``: for groups whose earlier
    slots lie elsewhere (on the data ranks before this one), a function
    of these groups' (G, E) assignment counts giving the count of each
    expert's earlier slots, by which every rank is offset."""
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
    if before is not None:
        pos = pos + before(oh.sum(dim=2, dtype=torch.int32))[..., None]
    pos_in_e = torch.gather(pos, 1, flat_e[:, None, :])[:, 0]  # (G,tK)
    keep = pos_in_e < C
    dest = torch.where(keep, flat_e * C + pos_in_e, E * C)     # overflow sink
    return probs, idx, gate_vals.reshape(G, tg * K), keep, dest


def _dispatch(xg, dest, rows_g: int):
    """The (G * rows_g, D) dispatch buffer of the groups ``xg`` (G, tg,
    D): each kept slot's token in its row ``dest`` of its group (every
    kept slot has a row of its own; only the sink row, never read, sees
    duplicates)."""
    G, tg, D = xg.shape
    K = dest.shape[1] // tg
    tok = torch.arange(tg * K, device=xg.device) // K
    base = torch.arange(G, device=xg.device)[:, None] * rows_g
    buf = torch.zeros((G * rows_g, D), dtype=xg.dtype, device=xg.device)
    buf.index_add_(0, (base + dest).reshape(-1),
                   xg[:, tok].reshape(G * tg * K, D))
    return buf


def _experts(eb, w1, w3, w2, act: str, hint=shard):
    """The expert FFN of the dispatch buffer ``eb`` (G, E, C, D) with the
    stacked weights (E, D, F), (E, D, F), (E, F, D); ``hint`` lays out
    the activations (a rank's pieces take none)."""
    h1 = torch.einsum("gecd,edf->gecf", eb, w1)
    h3 = torch.einsum("gecd,edf->gecf", eb, w3)
    a = F.silu(h1) if act == "silu" else F.gelu(h1, approximate="tanh")
    hact = hint(a * h3, ("batch", "experts", None, "mlp"))
    return torch.einsum("gecf,efd->gecd", hact, w2)            # (G,E,C,D)


def _combine(out_flat, dest, flat_g, keep, K: int):
    """Each token's sum of its kept slots' rows of ``out_flat`` (G,
    rows_g, D), weighted by their gates: (G, tg, D)."""
    G, rows_g, D = out_flat.shape
    tg = dest.shape[1] // K
    base = torch.arange(G, device=dest.device)[:, None] * rows_g
    rows = out_flat.reshape(G * rows_g, D).index_select(
        0, (base + dest).reshape(-1)).reshape(G, tg * K, D)
    w = (flat_g * keep).to(out_flat.dtype)[..., None]
    return torch.sum((rows * w).reshape(G, tg, K, D), dim=2)


def _aux(probs, idx, E: int, K: int, coef: float):
    """The load-balance aux loss (Switch): E * sum_e f_e * P_e."""
    one_hot_k = F.one_hot(idx, E).float()                      # (G,t,K,E)
    frac_tokens = one_hot_k.sum(dim=2).mean(dim=(0, 1)) / K
    frac_probs = probs.mean(dim=(0, 1))
    return E * torch.sum(frac_tokens * frac_probs) * coef


def moe_ffn(x, p, cfg, act: str, capacity_factor: float = 1.25,
            with_aux: bool = True):
    """x (B,S,D) -> ((B,S,D), aux_loss f32).

    Tokens are split into GROUP_TOKENS-sized groups (``B*S`` must be a
    multiple of the group size, as in the reference); each group scatters
    into an (E, C_group, D) buffer.  ``with_aux=False`` skips the aux loss
    and returns None in its place: the reference's decode computes it and
    discards it, so no value that is read changes.  On a process mesh
    (``x`` a DTensor) see :func:`_moe_ffn_mesh`."""
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return _moe_ffn_mesh(x, p, cfg, act, capacity_factor, with_aux)
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    tg = min(GROUP_TOKENS, T)
    G = T // tg
    xg = x.reshape(G, tg, D)
    C = capacity(tg, K, E, capacity_factor)
    probs, idx, flat_g, keep, dest = route(xg, p["router"], K, C)
    aux = _aux(probs, idx, E, K, cfg.router_aux_coef) if with_aux else None

    rows_g = E * C + 1
    buf = _dispatch(xg, dest, rows_g)
    eb = buf.view(G, rows_g, D)[:, :E * C].reshape(G, E, C, D)
    eb = shard(eb, ("batch", "experts", None, "embed"))
    out = _experts(eb, p["w1"], p["w3"], p["w2"], act)         # (G,E,C,D)

    # combine: per-group gather of each kept assignment's output row
    out_flat = torch.cat([out.reshape(G, E * C, D),
                          torch.zeros((G, 1, D), dtype=out.dtype,
                                      device=out.device)], dim=1)
    y = _combine(out_flat, dest, flat_g, keep, K).reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + glu_mlp(x, p["shared"], act)
    return y, aux


def _moe_ffn_mesh(x, p, cfg, act: str, capacity_factor: float,
                  with_aux: bool):
    """:func:`moe_ffn` on a process mesh, dispatch and combine by hand on
    each rank's pieces (DTensor has no strategy for the stable sort, the
    scan over slots or the scatter of the dispatch, or would gather the
    whole batch for them).

    - Each rank routes the tokens it holds: ``x`` laid out as the
      residual, its batch split over the data axes and whole over the
      rest, with the router gathered whole.  The capacity is the global
      group's.  A group of the reference (``GROUP_TOKENS``, or all ``B*S``
      tokens when fewer) that spans data ranks ranks each expert's slots
      over the whole group in token-major order: each rank's ranks are
      offset by the earlier ranks' counts of that group (an all-gather of
      an (E,) count over the data axes).  A group within one rank needs
      none.  So the same assignments are kept and dropped as in the
      reference.
    - The expert weights stay split over "model" on the experts (a rank
      runs its experts' rows of the dispatch buffer) or, where the experts
      do not divide it, on "mlp" (a rank runs its slice of every expert).
      The activations are whole over "model", so reaching a rank's
      experts moves no token.  Over the FSDP ("embed") split, which is the
      data axis, either the weights' pieces are gathered (as the reference
      gathers its parameters) or the tokens' dispatch rows go to the
      weights (:func:`_experts_by_tokens`: two all-to-alls and two
      all-reduces), whichever moves fewer bytes: the rows in a decode,
      the weights in a long prefill.
    - Each rank combines its own experts' (or its "mlp" slice's) rows into
      its tokens: the output is a partial sum over those axes, reduced
      where the residual reads it (one all-reduce of (B, S, D)).
    - The aux loss is the reference's over the global group: each rank's
      per-expert assignment counts and probability sums, summed over the
      data axes, over the global token count (:func:`_aux_mesh`).
    - The backward follows the same pieces.  Every rank along "model"
      routes the same tokens, and each runs only its experts' (or its
      slice's) share of them: the dispatched tokens and the gates enter
      that share through ``sharding.grad_summed``, whose backward sums
      their gradients over those axes, so that each rank holds the whole
      gradient of its tokens, as the residual's layout says.  A parameter
      gathered whole over the data axes (the router, and the expert
      weights when they are gathered) is read on each data rank's own
      tokens: its piece's gradient is declared a partial sum over those
      axes, which DTensor reduces into the parameter's layout.

    The shared experts and the rest are DTensor ops."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.launch import sharding as sh

    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    tg = min(GROUP_TOKENS, T)
    if T % tg:
        raise ValueError(f"{T} tokens in groups of {tg}")
    C = capacity(tg, K, E, capacity_factor)
    x = shard(x, ("batch", "seq", "embed"))
    baxes = sh.split_axes(x, 0)
    if any(p_.is_shard() for i, p_ in enumerate(x.placements)
           if i not in baxes):
        raise ValueError(f"MoE input laid out as {x.placements}")
    xl = x.to_local()
    r, n_ranks = sh.rank_index(baxes)
    n = xl.shape[0] * S                        # this rank's tokens
    if n % tg == 0:                            # groups within the rank
        G, tl, span, before = n // tg, tg, 1, None
    elif tg % n == 0:
        span = tg // n                         # ranks a group spans
        G, tl = 1, n

        def before(counts):
            every = sh.gather_ranks(counts, baxes)        # (ranks, 1, E)
            return every[r - r % span:r].sum(dim=0, dtype=torch.int32)
    else:
        raise ValueError(f"{n} tokens a rank in groups of {tg}")
    xg = xl.reshape(G, tl, D)
    router = _read_whole(sh.whole_over(p["router"], (0, 1)), baxes)
    probs, idx, flat_g, keep, dest = route(xg, router, K, C, before)
    aux = _aux_mesh(probs, idx, E, K, cfg.router_aux_coef, baxes, T) \
        if with_aux else None

    w1, w3, w2 = p["w1"], p["w3"], p["w2"]
    eaxes, faxes = sh.split_axes(w1, 0), sh.split_axes(w1, 2)
    daxes = sh.split_axes(w1, 1)
    if any((sh.split_axes(w, 0), sh.split_axes(w, f), sh.split_axes(w, d))
           != (eaxes, faxes, daxes) for w, f, d in ((w3, 2, 1), (w2, 1, 2))):
        raise ValueError("expert weights laid out apart: "
                         f"{w1.placements}, {w3.placements}, {w2.placements}")
    if set(eaxes + faxes) & set(baxes + daxes):
        raise NotImplementedError("experts split over the batch's or the "
                                  "FSDP axes")
    e0, El = sh.piece_span(w1, 0)
    Fl = sh.piece_span(w1, 2)[1]
    rows_g = E * C + 1
    share = tuple(sorted(eaxes + faxes))      # axes of the experts' shares
    flat_g = sh.grad_summed(flat_g, share)
    buf = _dispatch(sh.grad_summed(xg, share), dest,
                    rows_g).view(G, rows_g, D)
    eb = buf[:, e0 * C:(e0 + El) * C].reshape(G, El, C, D)
    # move the tokens' rows or the weights' FSDP pieces, whichever is
    # fewer bytes (result bytes of the collectives each takes)
    isz = eb.element_size()
    weight_bytes = 3 * El * D * Fl * isz
    token_bytes = 2 * G * El * C * D * isz + \
        2 * (n_ranks // span) * G * El * C * Fl * isz
    if daxes == baxes and len(baxes) == 1 and token_bytes < weight_bytes:
        out = _experts_by_tokens(eb, w1, w3, w2, act, baxes[0], span)
    else:
        w1, w3, w2 = (_read_whole(sh.whole_over(w, (d,)), baxes)
                      for w, d in ((w1, 1), (w3, 1), (w2, 2)))
        out = _experts(eb, w1, w3, w2, act, hint=lambda t, axes: t)
    out_flat = torch.zeros((G, rows_g, D), dtype=out.dtype,
                           device=out.device)
    out_flat[:, e0 * C:(e0 + El) * C] = out.reshape(G, El * C, D)
    yl = _combine(out_flat, dest, flat_g, keep, K).reshape(-1, S, D)
    places = tuple(Shard(0) if i in baxes else
                   Partial() if i in eaxes + faxes else Replicate()
                   for i in range(len(x.placements)))
    y = sh.from_pieces(yl, places, (B, S, D))
    if cfg.n_shared_experts:
        y = y + glu_mlp(x, p["shared"], act)
    return y, aux


def _read_whole(w, baxes: tuple) -> torch.Tensor:
    """This rank's piece of the DTensor ``w`` (whole over the data axes
    ``baxes``), read on this rank's own tokens: its gradient is a partial
    sum over those axes."""
    from torch.distributed.tensor import Partial

    return w.to_local(grad_placements=tuple(
        Partial() if i in baxes else p for i, p in enumerate(w.placements)))


def _aux_mesh(probs, idx, E: int, K: int, coef: float, baxes: tuple,
              T: int):
    """:func:`_aux` over the global group from a rank's ``probs`` and
    ``idx`` of its own tokens: its per-expert assignment counts and
    probability sums, summed over the data axes ``baxes`` (one
    all-reduce), over the global token count ``T``.  Every rank along the
    other axes holds the same tokens and the same value: a replicated
    scalar DTensor, so that its gradient comes back as one."""
    from torch.distributed.tensor import Replicate

    from repro_torch.launch import sharding as sh

    counts = F.one_hot(idx, E).float().sum(dim=(0, 1, 2))       # (E,)
    both = torch.stack([counts, probs.sum(dim=(0, 1))])
    if baxes:
        both = sh.sum_ranks(both, baxes)
    frac_tokens = both[0] / T / K
    frac_probs = both[1] / T
    aux = E * torch.sum(frac_tokens * frac_probs) * coef
    return sh.from_pieces(aux, (Replicate(),) * len(sh.process_mesh().shape),
                          ())


def _experts_by_tokens(eb, w1, w3, w2, act: str, axis: int, span: int):
    """The expert FFN of this rank's dispatch rows ``eb`` (G, El, C, D)
    with the expert weights left split over their FSDP axis ``axis`` (the
    batch's data axis, of n positions): the rows move to the weights.

    An all-to-all sends each position its slice of D of every group; a
    group that spans ``span`` ranks is the sum of their slices (each slot
    is filled on one rank only, so the sum adds zeros: exact).  Each
    position takes the partial products over its slice of D, all-reduced
    over the axis, and its slice of the output rows; an all-to-all sends
    each rank its groups' slices back."""
    from repro_torch.launch import sharding as sh

    G, El, C, D = eb.shape
    n = sh.rank_index((axis,))[1]
    w1, w3, w2 = (w.to_local() for w in (w1, w3, w2))
    send = eb.reshape(G, El, C, n, D // n).permute(3, 0, 1, 2, 4)
    got = sh.all_to_all(send.reshape(n * G, El, C, D // n), axis)
    if span > 1:                         # G == 1: one group a span
        got = got.reshape(n // span, span, El, C, D // n).sum(dim=1)
    # each position reads the sums through its own slice of w2: their
    # backward sums the positions' gradients
    h1 = sh.sum_ranks(torch.einsum("gecd,edf->gecf", got, w1), (axis,),
                      partial_grad=True)
    h3 = sh.sum_ranks(torch.einsum("gecd,edf->gecf", got, w3), (axis,),
                      partial_grad=True)
    a = F.silu(h1) if act == "silu" else F.gelu(h1, approximate="tanh")
    out = torch.einsum("gecf,efd->gecd", a * h3, w2)  # (groups, El, C, D/n)
    if span > 1:
        out = out.repeat_interleave(span, dim=0)
    back = sh.all_to_all(out, axis).reshape(n, G, El, C, D // n)
    return back.permute(1, 2, 3, 0, 4).reshape(G, El, C, D)
