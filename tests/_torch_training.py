"""Helpers shared by the port's training tests
(``tests/test_torch_train.py``, ``test_torch_train_step.py``): a
reference tree as numpy, trees flattened by dotted name in sorted key
order, a smoke config's parameters on both sides, a batch drawn from a
numpy seed, and the per-leaf difference over the leaf's largest
magnitude."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402


def np_tree(t):
    """A JAX tree as numpy: float leaves as float32 (bf16 exactly), other
    leaves as they are."""
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    a = jnp.asarray(t)
    if jnp.issubdtype(a.dtype, jnp.floating):
        a = a.astype(jnp.float32)
    return np.asarray(a)


def flat(tree, path=()):
    """{dotted name: leaf}, keys in sorted order."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], path + (k,)))
        return out
    return {".".join(path): tree}


def as_np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else t


def rel_err(got, want) -> float:
    """max |got - want| over max |want| (0 when both are all zero)."""
    got, want = as_np(got), np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    return err / scale if scale else err


def pair(arch, **replace):
    """(port cfg, reference cfg, reference params, port model).  Every
    gate leaf (zero at init, which makes its layer the identity) is set to
    0.5 on both sides."""
    jcfg = dataclasses.replace(jget_smoke(arch), **replace)
    cfg = dataclasses.replace(get_smoke_config(arch), **replace)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.full_like(a, 0.5)
        if "gate" in jax.tree_util.keystr(path) else a, jp)
    return cfg, jcfg, jp, params_from_numpy(np_tree(jp), cfg, "cpu")


def make_batch(cfg, B, S, seed):
    """A numpy batch: labels, tokens or embeds, and image embeddings when
    the config has image tokens."""
    rng = np.random.default_rng(seed)
    b = {"labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.inputs_embeds:
        b["embeds"] = rng.standard_normal((B, S, cfg.d_model)
                                          ).astype(np.float32)
    else:
        b["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    if cfg.n_image_tokens:
        b["image_embed"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return b


def grads_of(model, cfg, batch, remat):
    """(loss, aux metrics, {dotted name: gradient or None}) of the port's
    ``loss_fn``."""
    from repro_torch.models import loss_fn
    tree = flat(model.tree())
    loss, aux = loss_fn(model, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(tree.values()), allow_unused=True)
    return loss, aux, dict(zip(tree, grads))


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}
