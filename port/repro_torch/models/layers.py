"""Shared layers: norms, rotary embeddings, GLU MLPs, logical sharding axes.

Every parameter is described by a :class:`Spec`: its shape, dtype and
*logical* axis names (a tuple parallel to the shape), as in the reference's
``repro.models.layers``.  The axes are kept for the launcher's sharding
rules (``launch/sharding``, a later slice of the port); on one card with no
mesh, :func:`shard` is the identity.

Numerics follow the reference operation by operation: norms compute in f32
with an f32 scale and cast back, rotary embeddings rotate split halves in
f32 with numpy-f32 frequencies, and the residual stream stays in the
config's dtype.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Spec", "tree_leaves", "tree_paths", "tree_map", "tree_unflatten",
           "rms_norm", "layer_norm", "apply_norm", "rope", "glu_mlp",
           "mlp_shapes", "norm_shapes", "shard", "cross_entropy"]


@dataclasses.dataclass(frozen=True)
class Spec:
    """A parameter's shape, dtype and logical axis names."""

    shape: tuple
    dtype: torch.dtype
    axes: tuple

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} do not match shape "
                             f"{self.shape}")


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in sorted key order (the order in which
    JAX flattens the reference's trees)."""
    if not isinstance(tree, dict):
        return [tree]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


def tree_paths(tree, prefix=()) -> list:
    """(dotted name, leaf) of a nested dict, in sorted key order: the
    reference's checkpoint names, e.g. ``stages.s0_attn_mlp.attn.wq``."""
    if not isinstance(tree, dict):
        return [(".".join(prefix), tree)]
    return [x for k in sorted(tree)
            for x in tree_paths(tree[k], prefix + (str(k),))]


def tree_map(fn, *trees) -> dict:
    """``fn`` over the leaves of nested dicts of one structure, in sorted
    key order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def tree_unflatten(tree, leaves) -> dict:
    """``leaves`` (in sorted key order) in the structure of ``tree``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def shard(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """Logical sharding constraint on activations.  The identity: the port
    runs on one card with no mesh; the launcher's sharding slice
    (``launch/sharding``) gives the axes their meaning."""
    del axes
    return x


# ---------------------------------------------------------------------- norms

def rms_norm(x, scale, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x, scale, eps):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def apply_norm(x, p, cfg):
    if cfg.norm_type == "ln":
        return layer_norm(x, p, cfg.norm_eps)
    return rms_norm(x, p, cfg.norm_eps)


def norm_shapes(cfg, dtype):
    return Spec((cfg.d_model,), dtype, ("embed",))


# ----------------------------------------------------------------------- rope

@functools.lru_cache(maxsize=32)
def _rope_freqs(theta: float, rd: int, device: torch.device) -> torch.Tensor:
    """The reference's numpy-f32 frequencies, copied to ``device`` once."""
    half = rd // 2
    freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) * 2.0 / rd))
    t = torch.from_numpy(np.ascontiguousarray(freqs, np.float32))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def rope(x, positions, theta: float, rotary_dim: int | None = None):
    """x: (..., S, H, hd); positions: (..., S) int32."""
    hd = x.shape[-1]
    rd = rotary_dim or hd
    half = rd // 2
    freqs = _rope_freqs(float(theta), rd, x.device)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].float()
    x2 = x[..., half:rd].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    out = torch.cat([r1, r2], dim=-1).to(x.dtype)
    if rd < hd:
        out = torch.cat([out, x[..., rd:]], dim=-1)
    return out


# ------------------------------------------------------------------------ mlp

def glu_mlp(x, p, act: str):
    """Gated MLP w2(act(x@w1) * (x@w3)), or plain w2(act(x@w1)) when the
    config has no gate branch (musicgen).  GELU is the tanh form, as
    ``jax.nn.gelu`` is by default."""
    h = x @ p["w1"]
    a = F.silu(h) if act == "silu" else F.gelu(h, approximate="tanh")
    h = a * (x @ p["w3"]) if "w3" in p else a
    h = shard(h, ("batch", "seq", "mlp"))
    return h @ p["w2"]


def mlp_shapes(cfg, d_ff: int, dtype):
    D, F_ = cfg.d_model, d_ff
    p = {
        "w1": Spec((D, F_), dtype, ("embed", "mlp")),
        "w2": Spec((F_, D), dtype, ("mlp", "embed")),
    }
    if cfg.glu:
        p["w3"] = Spec((D, F_), dtype, ("embed", "mlp"))
    return p


# ----------------------------------------------------------------------- loss

def cross_entropy(logits, labels, softcap: float = 0.0):
    """Mean token NLL in f32.  logits (B, S, V); labels (B, S) int."""
    lg = logits.float()
    if softcap:
        lg = torch.tanh(lg / softcap) * softcap
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)
