"""The port's MoE FFN, MLA attention and gated cross-attention against the
JAX package's on the same inputs.

Parameters and activations are drawn from a seed with numpy and handed to
both packages; in float32 the port is held to the reference within 1e-5
(absolute), as test_torch_models.py holds the stacks.  ``moe_ffn`` runs at
the forward capacity (1.25) and the decode capacity (2.0), with and without
shared experts, with SiLU and GELU, with one group's expert forced to
overflow, over two dispatch groups, and with a zero router, whose equal
probabilities the reference's top-k breaks towards the lower expert.
MLA runs through the dense and the chunked attention paths, and its decode
over the compressed cache past ``max_seq``.  The serving engine is held
in ``test_torch_moe_mla_serving.py``, the serve launcher in
``test_torch_moe_mla_launcher.py``."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import attention as patt  # noqa: E402
from repro_torch.models import moe as pmoe  # noqa: E402
from repro_torch.models.layers import tree_leaves  # noqa: E402

TOL = 1e-5
DS = "deepseek-v2-lite-16b"


def cfgs(arch=DS, **replace):
    """(port cfg, reference cfg) of ``arch``'s smoke config."""
    return (dataclasses.replace(get_smoke_config(arch), **replace),
            dataclasses.replace(jget_smoke(arch), **replace))


def draw(specs, seed, scale=0.1):
    """A numpy tree of the port's ``Spec`` tree: N(0, scale) float32, norms
    and gates 0.5 + U(0, 1)."""
    r = np.random.default_rng(seed)

    def one(name, s):
        if "norm" in name or "gate" in name:
            return (0.5 + r.random(s.shape)).astype(np.float32)
        return (r.standard_normal(s.shape) * scale).astype(np.float32)

    def walk(t, name=""):
        if isinstance(t, dict):
            return {k: walk(t[k], k) for k in sorted(t)}
        return one(name, t)
    return walk(specs)


def both(tree):
    """(torch tree, jax tree) of a numpy tree."""
    def m(t, f):
        return {k: m(v, f) for k, v in t.items()} if isinstance(t, dict) \
            else f(t)
    return m(tree, torch.from_numpy), m(tree, jnp.asarray)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(a.float().numpy(),
                               np.asarray(jnp.asarray(b, jnp.float32)),
                               rtol=0, atol=tol)


# ------------------------------------------------------------------ moe_ffn

def _moe(cfg, jcfg, x, p, act, cf):
    pp, jp = both(p)
    y, aux = pmoe.moe_ffn(torch.from_numpy(x), pp, cfg, act,
                          capacity_factor=cf)
    jy, jaux = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg, act,
                            capacity_factor=cf)
    close(y, jy)
    close(aux, jaux)
    # the decode path skips the aux loss and nothing else
    y2, none = pmoe.moe_ffn(torch.from_numpy(x), pp, cfg, act,
                            capacity_factor=cf, with_aux=False)
    assert none is None and torch.equal(y, y2)
    return pp


@pytest.mark.parametrize("cf", [1.25, 2.0])
@pytest.mark.parametrize("shared,act", [(1, "silu"), (0, "gelu"),
                                        (2, "gelu"), (0, "silu")])
def test_moe_ffn_matches_reference(cf, shared, act):
    cfg, jcfg = cfgs(n_shared_experts=shared, d_model=32, moe_d_ff=48)
    x = np.random.default_rng(1).standard_normal((4, 24, 32)).astype(
        np.float32)
    _moe(cfg, jcfg, x, draw(pmoe.moe_shapes(cfg, torch.float32), 2),
         act, cf)


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_moe_ffn_overflow_matches_reference(cf):
    """Expert 0 outranks every other for every token, in two dispatch
    groups of 1024: each group keeps C of its 1024 assignments to it and
    sends the rest to the sink."""
    cfg, jcfg = cfgs(d_model=16, moe_d_ff=24)
    r = np.random.default_rng(3)
    x = (r.standard_normal((4, 512, 16)) + 3.0).astype(np.float32)
    p = draw(pmoe.moe_shapes(cfg, torch.float32), 4)
    p["router"][:, 0] += 1.0
    pp = _moe(cfg, jcfg, x, p, "silu", cf)
    C = pmoe.capacity(1024, cfg.top_k, cfg.n_experts, cf)
    _, idx, _, keep, dest = pmoe.route(torch.from_numpy(x).reshape(2, 1024,
                                                                   16),
                                       pp["router"], cfg.top_k, C)
    assert (idx[..., 0] == 0).all()
    first = keep.reshape(2, 1024, cfg.top_k)[..., 0]
    assert first.sum(dim=1).tolist() == [C, C]
    assert first[:, :C].all() and not first[:, C:].any()
    assert (dest[~keep] == cfg.n_experts * C).all()


def test_moe_ffn_zero_router_breaks_ties_to_the_lower_expert():
    """All probabilities equal: the reference's top-k picks experts
    0..K-1 for every token, and the port's must too (then both overflow
    those experts' capacity alike)."""
    cfg, jcfg = cfgs(d_model=16, moe_d_ff=24)
    x = np.random.default_rng(5).standard_normal((2, 40, 16)).astype(
        np.float32)
    p = draw(pmoe.moe_shapes(cfg, torch.float32), 6)
    p["router"][:] = 0.0
    pp = _moe(cfg, jcfg, x, p, "silu", 1.25)
    _, jidx = jax.lax.top_k(jnp.full((80, cfg.n_experts),
                                     1.0 / cfg.n_experts), cfg.top_k)
    assert np.array_equal(np.asarray(jidx)[0], np.arange(cfg.top_k))
    C = pmoe.capacity(80, cfg.top_k, cfg.n_experts, 1.25)
    _, idx, gates, keep, _ = pmoe.route(torch.from_numpy(x).reshape(1, 80,
                                                                    16),
                                        pp["router"], cfg.top_k, C)
    assert (idx == torch.arange(cfg.top_k)).all()
    assert torch.equal(gates, torch.full_like(gates, 1.0 / cfg.top_k))
    assert keep.sum().item() == C * cfg.top_k


def test_moe_capacity_is_the_reference_arithmetic():
    """The decode capacity of deepseek-v2-lite at B = 256 is 48; forward's
    1024-token groups at 1.25 give 120."""
    assert pmoe.capacity(256, 6, 64, 2.0) == 48
    assert pmoe.capacity(1024, 6, 64, 1.25) == 120
    assert pmoe.capacity(4, 2, 8, 2.0) == 8
    assert pmoe.GROUP_TOKENS == jmoe.GROUP_TOKENS
    cfg, _ = cfgs()
    with pytest.raises(RuntimeError):      # T not a multiple of the group
        pmoe.moe_ffn(torch.zeros(3, 700, cfg.d_model),
                     {k: torch.from_numpy(v) for k, v in draw(
                         pmoe.moe_shapes(cfg, torch.float32), 0).items()
                      if k != "shared"},
                     dataclasses.replace(cfg, n_shared_experts=0), "silu")


# ---------------------------------------------------------------------- MLA

def _mla_params(cfg, seed=7):
    return draw(patt.mla_shapes(cfg, torch.float32), seed)


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_mla_attention_matches_reference(path, monkeypatch):
    """S = 48: the dense path, and the chunked one with the threshold
    patched to 8 in both packages (chunks of 16: three of them)."""
    cfg, jcfg = cfgs()
    calls = []
    if path == "chunked":
        for mod in (patt, jatt):
            monkeypatch.setattr(mod, "FLASH_THRESHOLD", 8)
            monkeypatch.setattr(mod, "FLASH_KV_CHUNK", 16)
        real = patt._sdpa_chunked
        monkeypatch.setattr(patt, "_sdpa_chunked",
                            lambda *a: calls.append(1) or real(*a))
    pp, jp = both(_mla_params(cfg))
    x = np.random.default_rng(8).standard_normal((2, 48, cfg.d_model)
                                                 ).astype(np.float32)
    got = patt.mla_attention(torch.from_numpy(x), pp, cfg)
    close(got, jatt.mla_attention(jnp.asarray(x), jp, jcfg))
    assert len(calls) == (path == "chunked")


def test_mla_decode_past_max_seq_matches_reference():
    """7 steps over a 4-token compressed cache: from step 4 every write
    lands in slot 3, as the reference clamps it."""
    cfg, jcfg = cfgs()
    pp, jp = both(_mla_params(cfg, 9))
    B, T = 3, 4
    r = np.random.default_rng(10)
    pc = {"c_kv": torch.zeros(B, T, cfg.kv_lora_rank),
          "k_rope": torch.zeros(B, T, cfg.qk_rope_dim),
          "pos": torch.zeros((), dtype=torch.int32)}
    jc = {k: jnp.asarray(v.numpy()) for k, v in pc.items()}
    c_kv = pc["c_kv"]
    for _ in range(7):
        x = r.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        out, pc = patt.mla_decode(torch.from_numpy(x), pp, cfg, pc)
        jout, jc = jatt.mla_decode(jnp.asarray(x), jp, jcfg, jc)
        close(out, jout)
        for k in ("c_kv", "k_rope"):
            close(pc[k], jc[k])
    assert pc["c_kv"] is c_kv                 # written in place
    assert pc["pos"].item() == int(jc["pos"]) == 7


def test_mla_decode_reproduces_mla_attention():
    """The port's own invariant: the absorbed decode over the compressed
    cache equals the explicit attention over the same tokens."""
    cfg, _ = cfgs()
    pp, _ = both(_mla_params(cfg, 11))
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (2, 10, cfg.d_model)).astype(np.float32))
    full = patt.mla_attention(x, pp, cfg)
    c = {"c_kv": torch.zeros(2, 10, cfg.kv_lora_rank),
         "k_rope": torch.zeros(2, 10, cfg.qk_rope_dim),
         "pos": torch.zeros((), dtype=torch.int32)}
    steps = []
    for i in range(10):
        out, c = patt.mla_decode(x[:, i:i + 1], pp, cfg, c)
        steps.append(out)
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(),
                               rtol=0, atol=TOL)


def test_mla_scale_is_the_reference_f32_scale():
    """1 / f32(sqrt(192)) divided in f32: what the reference's x64
    ``1.0 / jnp.sqrt(192).astype(f32)`` gives."""
    for hd in (24, 192, 64, 80):
        want = np.asarray(1.0 / jnp.sqrt(hd).astype(jnp.float32))
        assert patt._inv_sqrt_f32(hd) == float(want)


# --------------------------------------------------------------- cross-attn

@pytest.mark.parametrize("gate", [0.0, 0.5, -1.5])
def test_cross_attention_matches_reference(gate):
    cfg, jcfg = cfgs("llama-3.2-vision-11b")
    p = draw(patt.cross_attn_shapes(cfg, torch.float32), 13)
    p["gate"][:] = gate
    pp, jp = both(p)
    r = np.random.default_rng(14)
    x = r.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    img = r.standard_normal((2, cfg.n_image_tokens, cfg.d_model)).astype(
        np.float32)
    got = patt.cross_attention(torch.from_numpy(x), torch.from_numpy(img),
                               pp, cfg)
    close(got, jatt.cross_attention(jnp.asarray(x), jnp.asarray(img), jp,
                                    jcfg))
    assert (got.abs().max().item() == 0.0) == (gate == 0.0)


def test_new_shapes_match_reference():
    cfg, jcfg = cfgs()
    xcfg, jxcfg = cfgs("llama-3.2-vision-11b")
    for pf, jf, c, jc in ((pmoe.moe_shapes, jmoe.moe_shapes, cfg, jcfg),
                          (patt.mla_shapes, jatt.mla_shapes, cfg, jcfg),
                          (patt.cross_attn_shapes, jatt.cross_attn_shapes,
                           xcfg, jxcfg)):
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                        (torch.float32, jnp.float32)):
            got = tree_leaves(pf(c, dt))
            want = jax.tree.leaves(jf(jc, jdt))
            assert [(s.shape, s.axes, str(s.dtype).split(".")[-1])
                    for s in got] == \
                [(tuple(s.shape), s.axes, np.dtype(s.dtype).name)
                 for s in want]
