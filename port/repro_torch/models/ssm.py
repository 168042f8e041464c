"""State-space + recurrent layers: Mamba (selective SSM, for Hymba's hybrid
heads), and xLSTM's mLSTM / sLSTM cells.

The port of ``repro.models.ssm``, function for function and operation for
operation, in eager PyTorch (no function here is a Pallas kernel in the
reference).  The forms:

* ``_ssm_scan`` is the reference's ``lax.associative_scan``, recursion and
  all: adjacent pairs combined, the half-length scan recursed, the even
  positions fixed up and the halves interleaved.  The products are taken in
  the reference's tree order, and a scan of S steps costs ~2 log2 S levels
  of a few whole-tensor ops, not S.  Cumulative sums are ``torch.cumsum``:
  its order of the float32 sums differs from XLA's, which moves only the
  rounding.
* ``mamba`` above ``MAMBA_CHUNK`` runs chunk by chunk and injects the
  carried state as ``exp(cumsum(dt A)) h_prev``, as the reference does;
  its ``lax.scan`` over chunks is a Python loop.
* mLSTM trains in its parallel form up to ``MLSTM_CHUNK`` tokens and in
  its chunkwise form above; it decodes with the O(1) matrix-memory
  recurrence.  The scale 1/sqrt(hd) enters as the reference's does: the
  parallel scores and the decode's k are divided by f32(sqrt(hd)), the
  chunkwise k is multiplied by f32(1/sqrt(hd)) (a float64 quotient, as
  under the reference's x64).
* sLSTM is sequential: a Python loop over time of ``_slstm_step``.

Decode functions return new cache tensors; ``model.Layer.decode`` writes
them into the caches in place.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.launch.sharding import by_heads, laid_out_as, on_pieces

from .attention import _sqrt_as
from .layers import Spec, rms_norm, shard

__all__ = ["mamba_shapes", "mamba", "mamba_decode",
           "mlstm_shapes", "mlstm", "mlstm_decode",
           "slstm_shapes", "slstm", "slstm_decode",
           "MAMBA_CHUNK", "MLSTM_CHUNK"]


def _softplus(x):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): no linear threshold."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _log_sigmoid(x):
    """``jax.nn.log_sigmoid`` (``-softplus(-x)``), of ops whose backward
    DTensor lays out (it has no strategy for ``log_sigmoid_backward``)."""
    return -_softplus(-x)


@functools.lru_cache(maxsize=None)
def _inv_sqrt_f64_as_f32(hd: int) -> float:
    """``1 / sqrt(hd)`` divided in float64, rounded to float32."""
    return float(np.float32(1.0 / math.sqrt(hd)))


# ---------------------------------------------------------------------- mamba

def _dt_rank(cfg):
    return cfg.dt_rank or max(1, cfg.d_model // 16)


def mamba_shapes(cfg, dtype):
    D = cfg.d_model
    Di = cfg.ssm_expand * D
    N = cfg.ssm_state
    R = _dt_rank(cfg)
    K = cfg.ssm_conv
    return {
        "in_proj": Spec((D, 2 * Di), dtype, ("embed", "mlp")),
        "conv_w": Spec((K, Di), dtype, ("conv", "mlp")),
        "conv_b": Spec((Di,), dtype, ("mlp",)),
        "x_proj": Spec((Di, R + 2 * N), dtype, ("mlp", "lora")),
        "dt_proj": Spec((R, Di), dtype, ("lora", "mlp")),
        "dt_bias": Spec((Di,), torch.float32, ("mlp",)),
        "A_log": Spec((Di, N), torch.float32, ("mlp", "state")),
        "Dskip": Spec((Di,), torch.float32, ("mlp",)),
        "out_proj": Spec((Di, D), dtype, ("mlp", "embed")),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B,S,Di); w (K,Di).  The K shifted products
    are added in Python ``sum`` order, as in the reference.  The K - 1
    zeros ahead of x are concatenated, not ``F.pad``ded: torch 2.11's
    DTensor fails to lay out the pad's decomposition (an IndexError)."""
    K = w.shape[0]
    pad = torch.cat([torch.zeros_like(x[:, :1])] * (K - 1) + [x], dim=1)
    # w[i] of a reshape, not of w: on a DTensor, a view of a layer's row
    # of a stacked parameter (made outside inference mode) raises in it
    w = w.reshape(K, 1, 1, w.shape[1])
    out = sum(pad[:, i: i + x.shape[1], :] * w[i] for i in range(K))
    return out + b


def _interleave(a, b):
    """a at the even positions of axis 1, b at the odd ones (a has as many
    positions as b, or one more).  Stacked pairwise, not written into a
    new tensor: on a ``DTensor`` that would be whole (replicated), and
    each write would gather its pieces."""
    n = b.shape[1]
    out = torch.stack([a[:, :n], b], dim=2).flatten(1, 2)
    return torch.cat([out, a[:, n:]], dim=1) if a.shape[1] > n else out


def _ssm_scan(dA, dBx):
    """Associative scan of h_t = dA_t * h_{t-1} + dBx_t along axis 1, in the
    tree order of ``lax.associative_scan``.  dA, dBx: (B, S, Di, N) f32."""
    def combine(a, b):
        a1, b1 = a
        a2, b2 = b
        return a1 * a2, a2 * b1 + b2

    def scan(elems):
        n = elems[0].shape[1]
        if n < 2:
            return elems
        odd = scan(combine([e[:, 0:-1:2] for e in elems],
                           [e[:, 1::2] for e in elems]))
        if n % 2 == 0:
            even = combine([e[:, :-1] for e in odd],
                           [e[:, 2::2] for e in elems])
        else:
            even = combine(odd, [e[:, 2::2] for e in elems])
        even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
        return [_interleave(e, o) for e, o in zip(even, odd)]

    return scan([dA, dBx])[1]


MAMBA_CHUNK = 512   # seq chunk bounding the (B,chunk,Di,N) working set


def mamba(x, p, cfg):
    """x (B,S,D) -> (B,S,D).  Long sequences run chunked: the (S,Di,N)
    transition tensor is only ever materialized one chunk at a time, with
    the hidden state carried across chunks."""
    B, S, D = x.shape
    N = cfg.ssm_state
    xz = shard(x @ p["in_proj"], ("batch", "seq", "mlp"))
    xi, z = torch.chunk(xz, 2, dim=-1)
    xi = F.silu(_causal_conv(xi, p["conv_w"], p["conv_b"]))
    xi = shard(xi, ("batch", "seq", "mlp"))
    R = _dt_rank(cfg)
    proj = shard(xi @ p["x_proj"], ("batch", "seq", "lora"))
    dt = _softplus(proj[..., :R] @ p["dt_proj"] + p["dt_bias"])   # (B,S,Di)
    Bm = proj[..., R: R + N].float()                               # (B,S,N)
    Cm = proj[..., R + N:].float()
    A = -torch.exp(p["A_log"])                                     # (Di,N)
    dtf = dt.float()
    xif = xi.float()

    if S <= MAMBA_CHUNK:
        dA = torch.exp(dtf[..., None] * A)                  # (B,S,Di,N)
        dBx = (dtf * xif)[..., None] * Bm[:, :, None, :]
        h = _ssm_scan(dA, dBx)                              # (B,S,Di,N)
        y = torch.einsum("bsdn,bsn->bsd", h, Cm)
    else:
        ck = MAMBA_CHUNK
        if S % ck:
            raise ValueError(f"S={S} is not a multiple of the chunk {ck}")
        Di = dtf.shape[-1]
        h_prev = torch.zeros((B, Di, N), dtype=torch.float32,
                             device=x.device)
        ys = []
        for c0 in range(0, S, ck):
            dtc, xic = dtf[:, c0:c0 + ck], xif[:, c0:c0 + ck]
            Bc, Cc = Bm[:, c0:c0 + ck], Cm[:, c0:c0 + ck]
            dA = torch.exp(dtc[..., None] * A)              # (B,ck,Di,N)
            dBx = (dtc * xic)[..., None] * Bc[:, :, None, :]
            h_loc = _ssm_scan(dA, dBx)
            # inject carried state: h_t += (prod_{j<=t} dA_j) h_prev
            P = torch.exp(torch.cumsum(dtc[..., None] * A, 1))
            h = h_loc + P * h_prev[:, None]
            ys.append(torch.einsum("bsdn,bsn->bsd", h, Cc))
            h_prev = h[:, -1]
        y = torch.cat(ys, dim=1)
    y = y + p["Dskip"] * xif
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"]


def mamba_decode(x, p, cfg, cache):
    """One step. cache: h (B,Di,N) f32, conv (B,K-1,Di).  The new conv
    cache is a view of a fresh tensor (``hist``), never of ``cache``."""
    N = cfg.ssm_state
    xz = shard(x @ p["in_proj"], ("batch", "seq", "mlp"))   # (B,1,2Di)
    xi, z = torch.chunk(xz[:, 0], 2, dim=-1)   # (B,Di)
    hist = torch.cat([cache["conv"], xi[:, None, :]], dim=1)   # (B,K,Di)
    xi = F.silu(torch.einsum("bkd,kd->bd", hist, p["conv_w"]) + p["conv_b"])
    R = _dt_rank(cfg)
    proj = shard(xi @ p["x_proj"], ("batch", "lora"))
    dt = _softplus(proj[..., :R] @ p["dt_proj"] + p["dt_bias"])
    Bm = proj[..., R: R + N].float()
    Cm = proj[..., R + N:].float()
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[..., None].float() * A)                  # (B,Di,N)
    h = dA * cache["h"] + (dt * xi.float())[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, Cm) + p["Dskip"] * xi.float()
    y = (y.to(x.dtype) * F.silu(z))[:, None, :]
    out = y @ p["out_proj"]
    return out, {"h": h, "conv": hist[:, 1:, :]}


# ---------------------------------------------------------------------- mLSTM

def mlstm_shapes(cfg, dtype):
    D = cfg.d_model
    Di = cfg.mlstm_pf * D
    H = cfg.n_heads
    return {
        "up": Spec((D, 2 * Di), dtype, ("embed", "mlp")),
        "wq": Spec((Di, Di), dtype, ("mlp", "heads")),
        "wk": Spec((Di, Di), dtype, ("mlp", "heads")),
        "wv": Spec((Di, Di), dtype, ("mlp", "heads")),
        "wi": Spec((Di, H), dtype, ("mlp", "heads")),
        "wf": Spec((Di, H), dtype, ("mlp", "heads")),
        "out_norm": Spec((Di,), torch.float32, ("mlp",)),
        "down": Spec((Di, D), dtype, ("mlp", "embed")),
    }


def _mlstm_parallel(q, k, v, logi, logf):
    """Stabilized parallel mLSTM.  q,k,v (B,H,S,hd); logi/logf (B,H,S) f32."""
    B, H, S, hd = q.shape
    Fc = torch.cumsum(logf, -1)                         # (B,H,S)
    # D[t,s] = F_t - F_s + i_s  for s<=t
    Dmat = Fc[..., :, None] - Fc[..., None, :] + logi[..., None, :]
    tri = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
    Dmat = torch.where(tri, Dmat, -math.inf)
    m = torch.amax(Dmat, dim=-1, keepdim=True)          # (B,H,S,1)
    w = torch.exp(Dmat - m)
    scores = torch.einsum("bhsd,bhtd->bhst", q, k).float() \
        / _sqrt_as(hd, torch.float32)
    Cw = scores * w
    n = torch.maximum(torch.abs(torch.sum(Cw, dim=-1, keepdim=True)),
                      torch.exp(-m))
    return torch.einsum("bhst,bhtd->bhsd", (Cw / n).to(v.dtype), v)


MLSTM_CHUNK = 256   # chunkwise form above this sequence length


def _mlstm_chunkwise(q, k, v, logi, logf, ck: int):
    """Chunkwise-recurrent mLSTM: within-chunk parallel (ck x ck), matrix
    state (C, n, m) carried across chunks — O(S*ck) memory, matches the
    parallel form and the O(1) decode recurrence.
    q,k,v (B,H,S,hd); logi/logf (B,H,S) f32."""
    B, H, S, hd = q.shape
    if S % ck:
        raise ValueError(f"S={S} is not a multiple of the chunk {ck}")
    dev = q.device
    qf = q.float()
    kf = k.float() * _inv_sqrt_f64_as_f32(hd)
    vf = v.float()
    tri = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=dev))

    C_p = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=dev)
    n_p = torch.zeros((B, H, hd), dtype=torch.float32, device=dev)
    m_p = torch.zeros((B, H), dtype=torch.float32, device=dev)
    hs = []
    for c0 in range(0, S, ck):
        sl = slice(c0, c0 + ck)
        qc, kc, vc, ic, fc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], \
            logi[..., sl], logf[..., sl]
        b = torch.cumsum(fc, -1)                      # (B,H,ck)
        g = b[..., -1:]                               # total chunk forget
        # intra weights D[t,s] = b_t - b_s + i_s (s<=t)
        Dm = b[..., :, None] - b[..., None, :] + ic[..., None, :]
        Dm = torch.where(tri, Dm, -math.inf)
        m_intra = torch.amax(Dm, dim=-1)              # (B,H,ck)
        m_inter = b + m_p[..., None]
        m_t = torch.maximum(m_intra, m_inter)
        w = torch.exp(Dm - m_t[..., None])
        s_qk = torch.einsum("bhtd,bhsd->bhts", qc, kc)
        num = torch.einsum("bhts,bhsd->bhtd", s_qk * w, vc)
        den = torch.sum(s_qk * w, dim=-1)
        inter_w = torch.exp(b + m_p[..., None] - m_t)  # (B,H,ck)
        num = num + inter_w[..., None] * torch.einsum("bhtd,bhdv->bhtv",
                                                      qc, C_p)
        den = den + inter_w * torch.einsum("bhtd,bhd->bht", qc, n_p)
        hs.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        # state update
        m_n = torch.maximum((g + m_p[..., None])[..., 0],
                            torch.amax(g - b + ic, dim=-1))
        sw = torch.exp(g - b + ic - m_n[..., None])   # (B,H,ck)
        decay = torch.exp(g[..., 0] + m_p - m_n)
        C_p = decay[..., None, None] * C_p + \
            torch.einsum("bhs,bhsd,bhsv->bhdv", sw, kc, vc)
        n_p = decay[..., None] * n_p + torch.einsum("bhs,bhsd->bhd", sw, kc)
        m_p = m_n
    return torch.cat(hs, dim=2).to(v.dtype)


def _by_heads(t, H=None):
    """``t`` (B, [S,] H*hd) laid out by heads and cut into its ``H``
    heads, or (B, [S,] H) laid out by heads (``H`` None).  A layout hint:
    on a process mesh the products with the "mlp"-split rows of ``wq``,
    ``wk``, ``wv``, ``wi`` and ``wf`` are partial sums over "model",
    reduced here once and split by heads, so that the cell runs head by
    head on each rank with no collective (``sharding.by_heads`` gathers a
    split that does not fall on head boundaries, xlstm's 4 heads on a
    "model" axis of 16)."""
    t = shard(t, ("batch",) + ("seq",) * (t.ndim - 2) + ("heads",))
    if H is None:
        return t
    return by_heads(t, tuple(t.shape[:-1]) + (H, t.shape[-1] // H))


def _mlstm_cell(q, k, v, logi, logf):
    """The parallel form up to ``MLSTM_CHUNK`` tokens, the chunkwise form
    above."""
    if q.shape[2] > MLSTM_CHUNK:
        return _mlstm_chunkwise(q, k, v, logi, logf, MLSTM_CHUNK)
    return _mlstm_parallel(q, k, v, logi, logf)


def mlstm(x, p, cfg):
    B, S, D = x.shape
    H = cfg.n_heads
    Di = cfg.mlstm_pf * D
    hd = Di // H
    up = shard(x @ p["up"], ("batch", "seq", "mlp"))
    hin, z = torch.chunk(up, 2, dim=-1)                 # (B,S,Di)
    q = _by_heads(hin @ p["wq"], H).transpose(1, 2)     # (B,H,S,hd)
    k = _by_heads(hin @ p["wk"], H).transpose(1, 2)
    v = _by_heads(hin @ p["wv"], H).transpose(1, 2)
    logi = _by_heads(hin @ p["wi"]).transpose(1, 2).float()   # (B,H,S)
    logf = _log_sigmoid(_by_heads(hin @ p["wf"]).transpose(1, 2).float())
    # in training on a process mesh, on each rank's batch rows and heads
    # (its einsums take (B, H) as batch dimensions, a flatten torch 2.11
    # refuses on two split dimensions)
    split = on_pieces(q, (k, v, logi, logf), (0, 1))
    if split is None:
        hout = _mlstm_cell(q, k, v, logi, logf)
    else:
        pieces, wrap = split
        hout = wrap(_mlstm_cell(*pieces), tuple(v.shape))
    hout = by_heads(hout.transpose(1, 2), (B, S, Di))
    hout = rms_norm(hout, p["out_norm"], cfg.norm_eps)
    y = hout * F.silu(z)
    return y @ p["down"]


def mlstm_decode(x, p, cfg, cache):
    """O(1) recurrent step.  cache: C (B,H,hd,hd) f32, n (B,H,hd) f32,
    m (B,H) f32."""
    B = x.shape[0]
    H = cfg.n_heads
    Di = cfg.mlstm_pf * cfg.d_model
    hd = Di // H
    up = shard(x[:, 0] @ p["up"], ("batch", "mlp"))
    hin, z = torch.chunk(up, 2, dim=-1)                 # (B,Di)
    # laid out as the state they meet (layout hints): q and k as ``n``,
    # split on hd where the cache rule splits the state there (hd = T),
    # v and the gates whole over "model"; the products with the
    # "mlp"-split rows are partial sums, reduced here once
    q = laid_out_as((hin @ p["wq"]).reshape(B, H, hd), cache["n"])
    k = laid_out_as((hin @ p["wk"]).reshape(B, H, hd), cache["n"])
    v = shard((hin @ p["wv"]).reshape(B, H, hd), ("batch", None, None))
    logi = shard(hin @ p["wi"], ("batch", None)).float()      # (B,H)
    logf = _log_sigmoid(shard(hin @ p["wf"], ("batch", None)).float())
    m_new = torch.maximum(logf + cache["m"], logi)
    fs = torch.exp(logf + cache["m"] - m_new)[..., None]
    is_ = torch.exp(logi - m_new)[..., None]
    kf = k.float() / _sqrt_as(hd, torch.float32)
    C = fs[..., None] * cache["C"] + is_[..., None] * \
        (kf[..., :, None] * v.float()[..., None, :])
    n = fs * cache["n"] + is_ * kf
    qf = q.float()
    num = torch.einsum("bhd,bhdv->bhv", qf, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qf, n)),
                        torch.exp(-m_new))[..., None]
    hout = (num / den).reshape(B, Di)
    hout = rms_norm(hout, p["out_norm"], cfg.norm_eps)
    y = (hout * F.silu(z))[:, None, :].to(x.dtype)
    return y @ p["down"], {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------- sLSTM

def slstm_shapes(cfg, dtype):
    D = cfg.d_model
    H = cfg.slstm_heads
    dh = D // H
    return {
        "W": Spec((D, 4 * D), dtype, ("embed", "mlp")),
        "R": Spec((H, dh, 4 * dh), dtype, ("heads", "qk", "v")),
        "bias": Spec((4 * D,), torch.float32, ("mlp",)),
        "out_norm": Spec((D,), torch.float32, ("embed",)),
        "down": Spec((D, D), dtype, ("embed", "embed")),
    }


def _slstm_step(R, bias, carry, wx):
    """carry: (c, n, h, m) each (B,H,dh) / m (B,H).  wx: (B,H,4dh)
    precomputed; R (H,dh,4dh), bias (H,4dh)."""
    c, n, h, m = carry
    rec = torch.einsum("bhd,hdk->bhk", h.to(R.dtype), R)  # (B,H,4dh)
    gates = wx + rec + bias
    gi, gf, gz, go = torch.chunk(gates.float(), 4, dim=-1)
    # per-head scalar-ish gating (keep per-unit gates; stabilizer per unit)
    logf = _log_sigmoid(gf)
    # m[..., None] as a reshape: on a DTensor, a view of the cache's row
    # (made outside inference mode) raises in it
    m = m.reshape(m.shape + (1,))
    m_new = torch.maximum(logf + m, gi)
    i_ = torch.exp(gi - m_new)
    f_ = torch.exp(logf + m - m_new)
    c_new = f_ * c + i_ * torch.tanh(gz)
    n_new = f_ * n + i_
    h_new = torch.sigmoid(go) * c_new / torch.clamp_min(n_new, 1e-6)
    m_out = torch.amax(m_new, dim=-1)   # collapse stabilizer per head
    return (c_new, n_new, h_new, m_out), h_new


def _slstm_loop(wx, R, bias):
    """wx (B,S,H,4dh) -> the hidden states (B,S,H,dh) f32, step by step
    from zero states."""
    B, S, H, k4 = wx.shape
    zeros = torch.zeros((B, H, k4 // 4), dtype=torch.float32,
                        device=wx.device)
    carry = (zeros, zeros, zeros,
             torch.zeros((B, H), dtype=torch.float32, device=wx.device))
    hs = []
    for t in range(S):
        carry, h = _slstm_step(R, bias, carry, wx[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1)


def slstm(x, p, cfg):
    """x (B,S,D): sequential loop over time (inherent to sLSTM)."""
    B, S, D = x.shape
    H = cfg.slstm_heads
    dh = D // H
    # laid out as "mlp" once, then by heads (layout hints: DTensor may
    # contract the product split over "data", and the loop would then
    # reduce each step's slice of the partial sum, a collective a token)
    wx = shard(x @ p["W"], ("batch", "seq", "mlp"))      # (B,S,4D)
    wx = shard(by_heads(wx, (B, S, H, 4 * dh)), ("batch", "seq", "heads",
                                                 None))
    bias = by_heads(p["bias"], (H, 4 * dh))
    # in training on a process mesh, the loop runs on each rank's batch
    # rows and heads (plain tensors: no collective and no DTensor dispatch
    # a token); the gradients of R and the bias come back partial sums
    # over the batch's axes
    split = on_pieces(wx, (), (0, 2), ((p["R"], {2: 0}), (bias, {2: 0})))
    if split is None:
        hs = _slstm_loop(wx, p["R"], bias)
    else:
        pieces, wrap = split
        hs = wrap(_slstm_loop(*pieces), (B, S, H, dh))
    hs = by_heads(hs, (B, S, D)).to(x.dtype)
    hs = rms_norm(hs, p["out_norm"], cfg.norm_eps)
    return hs @ p["down"]


def slstm_decode(x, p, cfg, cache):
    B = x.shape[0]
    H = cfg.slstm_heads
    D = cfg.d_model
    wx = shard(x[:, 0] @ p["W"], ("batch", "mlp"))
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    (c, n, hh, m), h = _slstm_step(
        p["R"], p["bias"].reshape(H, 4 * D // H), carry,
        wx.reshape(B, H, 4 * D // H))
    hs = rms_norm(h.reshape(B, D).to(x.dtype), p["out_norm"], cfg.norm_eps)
    out = (hs @ p["down"])[:, None, :]
    return out, {"c": c, "n": n, "h": hh, "m": m}
