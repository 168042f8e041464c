"""The port's model stack against the JAX package's on the same inputs.

Parameters come from the reference's ``init_params`` and cross to the port
through ``convert.params_from_numpy``; tokens and activations are drawn
from a seed with numpy.  In float32 the port is held to the reference
within 1e-5 (absolute) on logits, caches and layer outputs: the two run
the same operations in the same order, and what differs is the order of
the float32 sums inside a matmul or a mean (a few ulps at these widths).
The bfloat16 cases are held within BF16_TOL of the logits' scale (see
there).  The smoke configs are the four whose stack is ``attn_mlp``
(ARCHS), and the three of the MoE, MLA and cross-attention blocks
(BLOCK_ARCHS: mixtral, deepseek, llama-3.2-vision, whose cross-attention
and MLP gates are set to 0.5 on both sides: at init they are 0 and the
layer is the identity).  A MoE stack is held to the reference's forward
and to its decode separately, never decode to forward: the two bucket
different token groups at different capacities, so a dropped assignment
makes them differ in the reference too."""

import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.models import attention as jatt  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import (decode_step, forward, init_caches,  # noqa: E402
                                init_params, param_shapes)
from repro_torch.models import attention as patt  # noqa: E402
from repro_torch.models import layers as players  # noqa: E402
from repro_torch.models.blocks import BLOCKS  # noqa: E402
from repro_torch.models.layers import spec_leaves  # noqa: E402

ARCHS = ("qwen2-0.5b", "qwen2.5-14b", "glm4-9b", "command-r-plus-104b")
BLOCK_ARCHS = ("mixtral-8x22b", "deepseek-v2-lite-16b",
               "llama-3.2-vision-11b")
TOL = 1e-5
# bf16 keeps 8 significant bits: one rounding is within 2^-9 of a value.
# A smoke forward rounds the residual stream, the norms' outputs and every
# matmul's output to bf16 a few dozen times, and the two packages may round
# a different side of a tie or sum in another order; 8 bf16 ulps of the
# logits' largest magnitude (2^-5 of it) bounds a few such flips per layer
BF16_TOL = 2.0 ** -5
B = 2


def np_tree(t):
    """A JAX tree as numpy, bf16 leaves as float32 (exact)."""
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    a = jnp.asarray(t)
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def pair(arch, **replace):
    """(port cfg, reference cfg, reference params, port params).  Every
    gate leaf (zero at init) is set to 0.5 on both sides."""
    jcfg = dataclasses.replace(jget_smoke(arch), **replace)
    cfg = dataclasses.replace(get_smoke_config(arch), **replace)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.full_like(a, 0.5)
        if "gate" in jax.tree_util.keystr(path) else a, jp)
    return cfg, jcfg, jp, params_from_numpy(np_tree(jp), cfg, "cpu")


def image_aux(cfg, B, seed=3):
    """(reference aux, port aux): image embeddings when the config has
    image tokens."""
    if not cfg.n_image_tokens:
        return {}, {}
    img = np.random.default_rng(seed).standard_normal(
        (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return {"image_embed": jnp.asarray(img)}, \
        {"image_embed": torch.from_numpy(img)}


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape
                                                ).astype(np.int32)


def close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(jnp.asarray(b, jnp.float32)),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    cfg, jcfg, jp, pp = pair(arch)
    toks = tokens(cfg, (B, 12))
    jl, jaux = jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks), remat=None)
    pl, paux = forward(pp, cfg, tokens=torch.from_numpy(toks), remat=None)
    assert pl.shape == (B, 12, cfg.vocab) and pl.dtype == torch.float32
    close(pl, jl)
    close(paux, jaux)
    assert torch.equal(pp(torch.from_numpy(toks))[0], pl)   # nn.Module call
    jl1, _ = jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks), remat=None,
                            last_only=True)
    close(forward(pp, cfg, tokens=torch.from_numpy(toks),
                  last_only=True)[0], jl1)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(arch):
    """8 decode steps: each step's logits, then the caches' k, v and pos."""
    cfg, jcfg, jp, pp = pair(arch)
    toks = tokens(cfg, (B, 8))
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, jcfg, c, tokens=t))
    jc = jmodel.init_caches(jcfg, B, 12)
    pc = init_caches(cfg, B, 12, device="cpu")
    for i in range(8):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        pl, pc = decode_step(pp, cfg, pc, tokens=torch.from_numpy(
            toks[:, i:i + 1]))
        close(pl, jl)
    for key, c in jc.items():
        for name in ("k", "v"):
            close(pc[key][name], c[name])
        assert np.array_equal(pc[key]["pos"].numpy(), np.asarray(c["pos"]))
        assert pc[key]["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_block_forward_matches_reference(arch):
    """The MoE, MLA and cross-attention stacks: logits, the MoE aux loss
    (forward capacity 1.25) and the last-only projection."""
    cfg, jcfg, jp, pp = pair(arch)
    toks = tokens(cfg, (B, 12))
    jaux, paux = image_aux(cfg, B)
    jl, ja = jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks), aux=jaux,
                            remat=None)
    pl, pa = forward(pp, cfg, tokens=torch.from_numpy(toks), aux=paux)
    close(pl, jl)
    close(pa, ja)
    assert (float(pa) > 0) == bool(cfg.n_experts)
    jl1, _ = jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks), aux=jaux,
                            remat=None, last_only=True)
    close(forward(pp, cfg, tokens=torch.from_numpy(toks), aux=paux,
                  last_only=True)[0], jl1)


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_block_decode_matches_reference(arch):
    """8 decode steps (MoE at the decode capacity 2.0): each step's
    logits, then every cache leaf — mixtral's window ring, deepseek's
    compressed ``c_kv``/``k_rope``, the cross-attention layers' position
    that never advances."""
    cfg, jcfg, jp, pp = pair(arch)
    toks = tokens(cfg, (B, 8))
    jaux, paux = image_aux(cfg, B)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, jcfg, c, tokens=t,
                                                       aux=jaux))
    jc = jmodel.init_caches(jcfg, B, 12)
    pc = init_caches(cfg, B, 12, device="cpu")
    for i in range(8):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        pl, pc = decode_step(pp, cfg, pc, tokens=torch.from_numpy(
            toks[:, i:i + 1]), aux=paux)
        close(pl, jl)
    assert set(pc) == set(jc)
    for key, c in jc.items():
        assert set(pc[key]) == set(c)
        for name, a in c.items():
            close(pc[key][name], a)
        assert pc[key]["pos"].dtype == torch.int32
    if cfg.n_image_tokens:
        assert pc["s1_cross_attn_mlp"]["pos"].tolist() == [0, 0]


def test_gqa_decode_window_ring_matches_reference():
    """A sliding window of 4 over a 16-token context: the cache is a ring
    of 4, and 11 steps wrap it twice."""
    cfg, jcfg, jp, pp = pair("qwen2.5-14b", window=4)
    toks = tokens(cfg, (B, 11), seed=5)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, jcfg, c, tokens=t))
    jc = jmodel.init_caches(jcfg, B, 16)
    pc = init_caches(cfg, B, 16, device="cpu")
    assert pc["s0_attn_mlp"]["k"].shape[2] == 4
    for i in range(11):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        pl, pc = decode_step(pp, cfg, pc, tokens=torch.from_numpy(
            toks[:, i:i + 1]))
        close(pl, jl)
    for name in ("k", "v"):
        close(pc["s0_attn_mlp"][name], jc["s0_attn_mlp"][name])
    # the windowed forward, too
    close(forward(pp, cfg, tokens=torch.from_numpy(toks))[0],
          jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks), remat=None)[0])


def test_decode_past_max_seq_writes_the_last_slot():
    """The shared cache position runs past T: every later write lands in
    slot T-1, as in the reference."""
    cfg, jcfg, jp, pp = pair("qwen2-0.5b")
    toks = tokens(cfg, (B, 7), seed=9)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, jcfg, c, tokens=t))
    jc = jmodel.init_caches(jcfg, B, 4)
    pc = init_caches(cfg, B, 4, device="cpu")
    for i in range(7):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        pl, pc = decode_step(pp, cfg, pc, tokens=torch.from_numpy(
            toks[:, i:i + 1]))
        close(pl, jl)
    assert pc["s0_attn_mlp"]["pos"].tolist() == [7, 7]
    close(pc["s0_attn_mlp"]["k"], jc["s0_attn_mlp"]["k"])


@pytest.mark.parametrize("window", [None, 100])
def test_sdpa_chunked_matches_reference(window):
    """The online-softmax loop at S = T = 1024 (two KV chunks of 512)."""
    r = np.random.default_rng(3)
    q = r.standard_normal((1, 1024, 4, 8), np.float32)
    k = r.standard_normal((1, 1024, 2, 8), np.float32)
    v = r.standard_normal((1, 1024, 2, 8), np.float32)
    want = jatt._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              window)
    got = patt._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), window)
    close(got, want)
    # and the dense path it replaces agrees with it
    dense = patt._sdpa_dense(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             patt.causal_mask(1024, 1024, window))
    close(got, dense.numpy(), tol=1e-4)


@pytest.mark.parametrize("window", [None, 3])
def test_causal_mask_matches_reference(window):
    for S, T in ((5, 5), (1, 7), (3, 9)):
        assert np.array_equal(patt.causal_mask(S, T, window).numpy(),
                              np.asarray(jatt.causal_mask(S, T, window)))


def test_rope_and_norms_match_reference():
    r = np.random.default_rng(4)
    x = r.standard_normal((2, 5, 3, 16), np.float32)
    pos = r.integers(0, 4000, (2, 5)).astype(np.int32)
    for theta in (1e4, 1e6):
        for rd in (None, 8):
            close(players.rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta, rd),
                  jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta, rd))
    h = r.standard_normal((3, 4, 64), np.float32)
    s = r.standard_normal(64).astype(np.float32)
    for pf, jf in ((players.rms_norm, jlayers.rms_norm),
                   (players.layer_norm, jlayers.layer_norm)):
        close(pf(torch.from_numpy(h), torch.from_numpy(s), 1e-5),
              jf(jnp.asarray(h), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("act,glu", [("silu", True), ("gelu", True),
                                     ("gelu", False)])
def test_glu_mlp_matches_reference(act, glu):
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 3, 32), np.float32)
    p = {"w1": r.standard_normal((32, 48), np.float32) * 0.1,
         "w2": r.standard_normal((48, 32), np.float32) * 0.1}
    if glu:
        p["w3"] = r.standard_normal((32, 48), np.float32) * 0.1
    close(players.glu_mlp(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in p.items()}, act),
          jlayers.glu_mlp(jnp.asarray(x),
                          {k: jnp.asarray(v) for k, v in p.items()}, act))


def test_cross_entropy_matches_reference():
    r = np.random.default_rng(7)
    lg = r.standard_normal((2, 5, 40), np.float32) * 3
    lab = r.integers(0, 40, (2, 5)).astype(np.int32)
    for cap in (0.0, 2.5):
        close(players.cross_entropy(torch.from_numpy(lg),
                                    torch.from_numpy(lab), cap),
              jlayers.cross_entropy(jnp.asarray(lg), jnp.asarray(lab), cap))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own invariant: token-by-token decode reproduces the
    parallel forward (the KV cache holds what attention needs)."""
    cfg = get_smoke_config(arch)
    pp = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(tokens(cfg, (B, 10), seed=2))
    full, _ = forward(pp, cfg, tokens=toks)
    caches = init_caches(cfg, B, 10, device="cpu")
    outs = []
    for i in range(10):
        lg, caches = decode_step(pp, cfg, caches, tokens=toks[:, i:i + 1])
        outs.append(lg)
    close(torch.cat(outs, dim=1), full.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_and_shapes_match_reference(arch):
    for get, jget in ((get_smoke_config, jget_smoke),
                      (get_config, jget_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert cfg.param_count() == jcfg.param_count()
        specs = spec_leaves(param_shapes(cfg))
        jspecs = jax.tree.leaves(jmodel.param_shapes(jcfg))
        assert [s.shape for s in specs] == [tuple(s.shape) for s in jspecs]
        assert [s.axes for s in specs] == [s.axes for s in jspecs]
        assert [str(s.dtype).split(".")[-1] for s in specs] == \
            [str(s.dtype) for s in jspecs]
    assert get_config("qwen2-0.5b").param_count() == 494_032_768


@pytest.mark.parametrize("arch", BLOCK_ARCHS)
def test_block_param_counts_and_shapes_match_reference(arch):
    """param_shapes, param_count and active_param_count of the smoke and
    the full configs."""
    for get, jget in ((get_smoke_config, jget_smoke),
                      (get_config, jget_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        specs = spec_leaves(param_shapes(cfg))
        jspecs = jax.tree.leaves(jmodel.param_shapes(jcfg))
        assert [(s.shape, s.axes, str(s.dtype).split(".")[-1])
                for s in specs] == \
            [(tuple(s.shape), s.axes, str(s.dtype)) for s in jspecs]
    ds = get_config("deepseek-v2-lite-16b")
    assert (ds.param_count(), ds.active_param_count(), ds.n_layers) == \
        (15_706_484_224, 2_661_150_208, 27)


def test_init_params_rules_and_determinism():
    cfg = get_smoke_config("glm4-9b")
    a = init_params(cfg, torch.Generator().manual_seed(11), device="cpu")
    b = init_params(cfg, torch.Generator().manual_seed(11), device="cpu")
    c = init_params(cfg, torch.Generator().manual_seed(12), device="cpu")
    ta, tb, tc = a.tree(), b.tree(), c.tree()
    st = ta["stages"]["s0_attn_mlp"]
    assert torch.equal(ta["final_norm"], torch.ones(cfg.d_model))
    assert torch.equal(st["ln1"], torch.ones(cfg.n_units, cfg.d_model))
    assert torch.equal(st["ln2"], torch.ones(cfg.n_units, cfg.d_model))
    w = st["attn"]["wq"]
    assert w.dtype == torch.float32 and abs(w.std().item() - 0.02) < 2e-3
    # stacked biases are (L, n) matrices, drawn like every matrix
    assert st["attn"]["bq"].shape == (cfg.n_units, cfg.n_heads * cfg.hd)
    assert st["attn"]["bq"].abs().sum() > 0
    for x, y, z in zip(spec_leaves_t(ta), spec_leaves_t(tb),
                       spec_leaves_t(tc)):
        assert torch.equal(x, y)
        if x.dim() >= 2 and x.std() > 0.01:
            assert not torch.equal(x, z)
    assert all(not p.requires_grad for p in a.parameters())
    bf = init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                     torch.Generator().manual_seed(11), device="cpu").tree()
    assert bf["embed"].dtype == torch.bfloat16
    assert bf["final_norm"].dtype == torch.float32
    # drawn in f32, then cast: the same draws as the f32 model
    assert torch.equal(bf["embed"], ta["embed"].to(torch.bfloat16))


def spec_leaves_t(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves_t(tree[k])]
    return [tree]


def test_bf16_smoke_matches_reference():
    """qwen2-0.5b's smoke config in bf16: forward and 4 decode steps."""
    cfg, jcfg, jp, pp = pair("qwen2-0.5b", dtype="bfloat16")
    assert pp.tree()["embed"].dtype == torch.bfloat16
    toks = tokens(cfg, (B, 8))
    jl, _ = jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks), remat=None)
    pl, _ = forward(pp, cfg, tokens=torch.from_numpy(toks))
    assert pl.dtype == torch.bfloat16
    scale = float(jnp.abs(jl.astype(jnp.float32)).max())
    close(pl, jl, tol=BF16_TOL * scale)
    jc = jmodel.init_caches(jcfg, B, 8)
    pc = init_caches(cfg, B, 8, device="cpu")
    for i in range(4):
        jl, jc = jmodel.decode_step(jp, jcfg, jc,
                                    tokens=jnp.asarray(toks[:, i:i + 1]))
        pl, pc = decode_step(pp, cfg, pc, tokens=torch.from_numpy(
            toks[:, i:i + 1]))
        close(pl, jl, tol=BF16_TOL * scale)


def test_bf16_deepseek_smoke_matches_reference():
    """deepseek-v2-lite's smoke config in bf16 (MLA, MoE with f32 router
    and kv_norm): forward and 4 decode steps."""
    cfg, jcfg, jp, pp = pair("deepseek-v2-lite-16b", dtype="bfloat16")
    tree = pp.tree()["stages"]["s0_mla_moe"]
    assert tree["moe"]["w1"].dtype == torch.bfloat16
    assert tree["moe"]["router"].dtype == torch.float32
    assert tree["attn"]["kv_norm"].dtype == torch.float32
    toks = tokens(cfg, (B, 8))
    jl, _ = jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks), remat=None)
    pl, _ = forward(pp, cfg, tokens=torch.from_numpy(toks))
    assert pl.dtype == torch.bfloat16
    scale = float(jnp.abs(jl.astype(jnp.float32)).max())
    close(pl, jl, tol=BF16_TOL * scale)
    jc = jmodel.init_caches(jcfg, B, 8)
    pc = init_caches(cfg, B, 8, device="cpu")
    for i in range(4):
        jl, jc = jmodel.decode_step(jp, jcfg, jc,
                                    tokens=jnp.asarray(toks[:, i:i + 1]))
        pl, pc = decode_step(pp, cfg, pc, tokens=torch.from_numpy(
            toks[:, i:i + 1]))
        close(pl, jl, tol=BF16_TOL * scale)


def test_unported_blocks_and_bad_trees_raise():
    with pytest.raises(KeyError, match="'hybrid'.*7d"):
        BLOCKS["hybrid"]
    for block in ("mlstm", "slstm"):
        with pytest.raises(KeyError, match=f"'{block}'.*7d"):
            BLOCKS[block]
    with pytest.raises(KeyError, match="unknown block 'nope'"):
        BLOCKS["nope"]
    with pytest.raises(KeyError, match="7d"):
        param_shapes(get_config("hymba-1.5b"))
    cfg, _, jp, _ = pair("glm4-9b")
    tree = np_tree(jp)
    tree["final_norm"] = tree["final_norm"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_numpy(tree, cfg, "cpu")
    del tree["final_norm"]
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy(tree, cfg, "cpu")
