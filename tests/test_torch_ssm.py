"""The port's recurrent layers and blocks against the JAX package's on the
same inputs: ``models/ssm.py`` function by function (Mamba's causal
conv, associative scan, chunked forward and decode; mLSTM's parallel,
chunkwise and recurrent forms; sLSTM's step, scan and decode), the
``hybrid``, ``mlstm`` and ``slstm`` blocks, and the hymba-1.5b and
xlstm-1.3b smoke configs whole, through ``forward``, ``decode_step`` and
the serving engine.

Parameters and activations are drawn from a seed with numpy (Mamba's
``A_log`` is the reference's ``log(1..N)`` and ``Dskip`` ones, as
``init_params`` sets them) and handed to both packages; whole models take
the reference's ``init_params`` across through ``convert.params_from_numpy``.
In float32 the port is held to the reference within 1e-5 (absolute) on
outputs, logits and every cache leaf: the two run the same operations in
the same order (the scan in ``lax.associative_scan``'s tree order), and
what differs is the order of the float32 sums inside a matmul, a mean or
a cumulative sum, and an ulp of an ``exp`` or ``log1p``.  Both sides of
``MAMBA_CHUNK`` (512) and ``MLSTM_CHUNK`` (256) run.  The bf16 case is held
within test_torch_models.py's BF16_TOL of the logits' scale.

mLSTM's normalizer ``max(|sum_s C w|, exp(-m))`` cancels where the weighted
scores have mixed signs, and there an output carries the rounding of the
sum magnified.  Its 1e-5 cases draw the cell at scale 0.05 and q, k, v at
0.3, where the outputs are of order one; the stress cases (cell weights
at 0.1, q, k, v at 1, outputs up to tens) are held within STRESS_TOL of
the largest output, chip_smoke.py's card-against-CPU bound, since an
absolute 1e-5 is below the float32 rounding of outputs that large."""

import dataclasses
import math
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
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.serving import engine as jeng  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import (decode_step, forward, init_caches,  # noqa: E402
                                init_params, param_shapes)
from repro_torch.models import ssm as pssm  # noqa: E402
from repro_torch.models.blocks import BLOCKS  # noqa: E402
from repro_torch.models.layers import Spec, tree_leaves  # noqa: E402
from repro_torch.serving import engine as peng  # noqa: E402

TOL = 1e-5
BF16_TOL = 2.0 ** -5     # test_torch_models.py's: 8 bf16 ulps of the scale
STRESS_TOL = 2.0 ** -15  # of the largest output (chip_smoke.I_F32_TOL)
HYMBA, XLSTM = "hymba-1.5b", "xlstm-1.3b"
SSM_ARCHS = (HYMBA, XLSTM)
B = 2


# -------------------------------------------------------------------- helpers

def draw(specs, seed, scale=0.1):
    """A numpy tree of the port's ``Spec`` tree: ``A_log`` log(1..N),
    ``Dskip`` ones, norms 0.5 + U(0, 1), the rest N(0, scale), float32."""
    r = np.random.default_rng(seed)

    def one(name, s):
        if name == "A_log":
            return np.broadcast_to(np.log(np.arange(
                1, s.shape[-1] + 1, dtype=np.float32)), s.shape).copy()
        if name == "Dskip":
            return np.ones(s.shape, np.float32)
        if "norm" in name:
            return (0.5 + r.random(s.shape)).astype(np.float32)
        return (r.standard_normal(s.shape) * scale).astype(np.float32)

    def walk(t, name=""):
        if isinstance(t, Spec):
            return one(name, t)
        return {k: walk(t[k], k) for k in sorted(t)}
    return walk(specs)


def both(tree):
    """(torch tree, jax tree) of a numpy tree."""
    def m(t, f):
        return {k: m(v, f) for k, v in t.items()} if isinstance(t, dict) \
            else f(t)
    return m(tree, torch.from_numpy), m(tree, jnp.asarray)


def np_tree(t):
    """A JAX tree as numpy, bf16 leaves as float32 (exact)."""
    if isinstance(t, dict):
        return {k: np_tree(v) for k, v in t.items()}
    a = jnp.asarray(t)
    if a.dtype == jnp.bfloat16:
        a = a.astype(jnp.float32)
    return np.asarray(a)


def close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else a
    np.testing.assert_allclose(a, np.asarray(jnp.asarray(b, jnp.float32)),
                               rtol=0, atol=tol)


def close_tree(pt, jt, tol=TOL):
    """Every leaf of the reference tree ``jt`` against the port's, keys
    equal at every level."""
    if isinstance(jt, dict):
        assert set(pt) == set(jt)
        for k in jt:
            close_tree(pt[k], jt[k], tol)
        return
    close(pt, jt, tol)


def act(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    return torch.from_numpy(x), jnp.asarray(x)


def cfgs(arch, **replace):
    """(port smoke cfg, reference smoke cfg)."""
    return (dataclasses.replace(get_smoke_config(arch), **replace),
            dataclasses.replace(jget_smoke(arch), **replace))


def pair(arch, **replace):
    """(port cfg, reference cfg, reference params, port params) from the
    reference's ``init_params``."""
    cfg, jcfg = cfgs(arch, **replace)
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    return cfg, jcfg, jp, params_from_numpy(np_tree(jp), cfg, "cpu")


def tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape
                                                ).astype(np.int32)


# ---------------------------------------------------------------- the shapes

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cell_shapes_and_dt_rank_match_reference(arch):
    for get, jget in ((get_smoke_config, jget_smoke),
                      (get_config, jget_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert pssm._dt_rank(cfg) == jssm._dt_rank(jcfg)
        for name in ("mamba_shapes", "mlstm_shapes", "slstm_shapes"):
            got = getattr(pssm, name)(cfg, torch.bfloat16)
            want = getattr(jssm, name)(jcfg, jnp.bfloat16)
            assert sorted(got) == sorted(want)
            for k in want:
                assert (got[k].shape, got[k].axes,
                        str(got[k].dtype).split(".")[-1]) == \
                    (tuple(want[k].shape), want[k].axes,
                     str(jnp.dtype(want[k].dtype)))
    assert pssm._dt_rank(dataclasses.replace(get_config(HYMBA),
                                             dt_rank=7)) == 7


# ---------------------------------------------------------------------- mamba

def mamba_pair(seed=0, **replace):
    cfg, jcfg = cfgs(HYMBA, **replace)
    p = draw(pssm.mamba_shapes(cfg, torch.float32), seed)
    return cfg, jcfg, *both(p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_reference(dtype):
    """The K shifted products in Python ``sum`` order, then the bias; in
    bf16 the same roundings (equal to the last bit)."""
    x, jx = act((B, 12, 40), 1)
    w, jw = act((4, 40), 2)
    b, jb = act((40,), 3)
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    got = pssm._causal_conv(x.to(tdt), w.to(tdt), b.to(tdt))
    want = jssm._causal_conv(jx.astype(jdt), jw.astype(jdt), jb.astype(jdt))
    assert got.dtype == tdt
    if dtype == "float32":
        close(got, want)
    else:
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("S", [1, 2, 5, 8, 33, 64])
def test_ssm_scan_matches_reference_and_the_recurrence(S):
    """The associative scan at odd and even lengths: the reference's, and
    the sequential recurrence h_t = dA_t h_{t-1} + dBx_t."""
    r = np.random.default_rng(S)
    dA = r.uniform(0.2, 1.0, (B, S, 6, 4)).astype(np.float32)
    dBx = r.standard_normal((B, S, 6, 4)).astype(np.float32)
    got = pssm._ssm_scan(torch.from_numpy(dA), torch.from_numpy(dBx))
    close(got, jssm._ssm_scan(jnp.asarray(dA), jnp.asarray(dBx)))
    h = np.zeros((B, 6, 4), np.float32)
    for t in range(S):
        h = dA[:, t] * h + dBx[:, t]
        np.testing.assert_allclose(got[:, t].numpy(), h, rtol=0, atol=TOL)


@pytest.mark.parametrize("S", [8, 512, 1024])
def test_mamba_matches_reference(S):
    """Up to MAMBA_CHUNK in one scan; at 1024 two chunks, the carried
    state injected as exp(cumsum(dt A)) h_prev."""
    cfg, jcfg, pp, jp = mamba_pair()
    x, jx = act((B, S, cfg.d_model), 4)
    got = pssm.mamba(x, pp, cfg)
    assert got.shape == (B, S, cfg.d_model)
    close(got, jssm.mamba(jx, jp, jcfg))


def test_mamba_rejects_a_ragged_chunk():
    cfg, _, pp, _ = mamba_pair()
    x, _ = act((1, pssm.MAMBA_CHUNK + 8, cfg.d_model), 4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        pssm.mamba(x, pp, cfg)


def test_mamba_decode_matches_reference_and_forward():
    """8 steps: each step's output and the caches (h, conv) against the
    reference's, and the outputs against ``mamba`` over the same 8
    inputs."""
    cfg, jcfg, pp, jp = mamba_pair()
    x, jx = act((B, 8, cfg.d_model), 5)
    Di = cfg.ssm_expand * cfg.d_model
    c = {"h": torch.zeros(B, Di, cfg.ssm_state),
         "conv": torch.zeros(B, cfg.ssm_conv - 1, Di)}
    jc = {"h": jnp.zeros((B, Di, cfg.ssm_state)),
          "conv": jnp.zeros((B, cfg.ssm_conv - 1, Di))}
    outs = []
    for t in range(8):
        y, c = pssm.mamba_decode(x[:, t:t + 1], pp, cfg, c)
        jy, jc = jssm.mamba_decode(jx[:, t:t + 1], jp, jcfg, jc)
        close(y, jy)
        close_tree(c, jc)
        outs.append(y)
    close(torch.cat(outs, dim=1), pssm.mamba(x, pp, cfg).numpy())


# ---------------------------------------------------------------------- mLSTM

def mlstm_pair(seed=0, scale=0.05):
    cfg, jcfg = cfgs(XLSTM)
    p = draw(pssm.mlstm_shapes(cfg, torch.float32), seed, scale)
    return cfg, jcfg, *both(p)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("S", [8, 256, 512])
def test_mlstm_matches_reference(S, seed):
    """The parallel form up to MLSTM_CHUNK, the chunkwise form above, on
    two draws of the cell and its input."""
    cfg, jcfg, pp, jp = mlstm_pair(seed)
    x, jx = act((B, S, cfg.d_model), 6 + seed)
    got = pssm.mlstm(x, pp, cfg)
    assert got.shape == (B, S, cfg.d_model)
    close(got, jssm.mlstm(jx, jp, jcfg))


@pytest.mark.parametrize("S", [256, 512])
def test_mlstm_stress_matches_reference(S):
    """Cell weights at 0.1: within STRESS_TOL of the largest output."""
    cfg, jcfg, pp, jp = mlstm_pair(scale=0.1)
    x, jx = act((B, S, cfg.d_model), 6)
    want = jssm.mlstm(jx, jp, jcfg)
    close(pssm.mlstm(x, pp, cfg), want,
          tol=STRESS_TOL * float(jnp.abs(want).max()))


def _qkv_gates(S, hd=16, H=4, seed=7, scale=0.3):
    r = np.random.default_rng(seed)
    q, k, v = ((r.standard_normal((B, H, S, hd)) * scale).astype(np.float32)
               for _ in range(3))
    logi = r.standard_normal((B, H, S)).astype(np.float32)
    logf = np.log(r.uniform(0.8, 1.0, (B, H, S))).astype(np.float32)
    arrs = (q, k, v, logi, logf)
    return [torch.from_numpy(a) for a in arrs], [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("hd", [16, 24])
def test_mlstm_chunkwise_matches_parallel_and_reference(hd):
    """At S = 512: the chunkwise form against the parallel one (the same
    function), and each against the reference's; at hd = 24 the
    chunkwise scale f32(1/sqrt(hd)) is not 1/f32(sqrt(hd))."""
    pt, jt = _qkv_gates(512, hd=hd)
    par = pssm._mlstm_parallel(*pt)
    chk = pssm._mlstm_chunkwise(*pt, pssm.MLSTM_CHUNK)
    close(par, jssm._mlstm_parallel(*jt))
    close(chk, jssm._mlstm_chunkwise(*jt, jssm.MLSTM_CHUNK))
    np.testing.assert_allclose(chk.numpy(), par.numpy(), rtol=0, atol=TOL)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        pssm._mlstm_chunkwise(*[t[..., :100, :] if t.dim() == 4
                                else t[..., :100] for t in pt], 64)


def test_mlstm_chunkwise_stress_matches_reference():
    """q, k, v at unit scale: within STRESS_TOL of the largest output."""
    pt, jt = _qkv_gates(512, scale=1.0)
    for got, want in ((pssm._mlstm_parallel(*pt),
                       jssm._mlstm_parallel(*jt)),
                      (pssm._mlstm_chunkwise(*pt, pssm.MLSTM_CHUNK),
                       jssm._mlstm_chunkwise(*jt, jssm.MLSTM_CHUNK))):
        close(got, want, tol=STRESS_TOL * float(jnp.abs(want).max()))


def test_mlstm_scale_is_the_reference_f32_of_the_f64_quotient():
    """The reference runs with x64: its chunkwise scale ``1.0 / sqrt(hd)``
    is a weak-typed float64, which enters the f32 product rounded to f32;
    the parallel form and decode divide by f32(sqrt(hd))."""
    for hd in (6, 16, 24, 32, 1024):
        want = np.float32(np.asarray(1.0 / jnp.sqrt(hd)))
        assert pssm._inv_sqrt_f64_as_f32(hd) == float(want)
    # at hd = 6 and 24 the two roundings differ (at 16, 32 and 1024 not)
    for hd in (6, 24):
        assert pssm._inv_sqrt_f64_as_f32(hd) != float(
            np.float32(1) / np.float32(math.sqrt(hd)))


def test_mlstm_decode_matches_reference_and_forward():
    """8 recurrent steps: outputs and the (C, n, m) state against the
    reference's; outputs against ``mlstm`` over the same inputs."""
    cfg, jcfg, pp, jp = mlstm_pair()
    x, jx = act((B, 8, cfg.d_model), 8)
    cache = BLOCKS["mlstm"].init_cache(cfg, B, 8, torch.float32, "cpu")
    jc = jblocks.MLstm.init_cache(jcfg, B, 8, jnp.float32)
    outs = []
    for t in range(8):
        y, cache = pssm.mlstm_decode(x[:, t:t + 1], pp, cfg, cache)
        jy, jc = jssm.mlstm_decode(jx[:, t:t + 1], jp, jcfg, jc)
        close(y, jy)
        close_tree(cache, jc)
        outs.append(y)
    close(torch.cat(outs, dim=1), pssm.mlstm(x, pp, cfg).numpy())


# ---------------------------------------------------------------------- sLSTM

def slstm_pair(seed=0):
    cfg, jcfg = cfgs(XLSTM)
    p = draw(pssm.slstm_shapes(cfg, torch.float32), seed, scale=0.3)
    return cfg, jcfg, *both(p)


def test_slstm_step_matches_reference():
    """One step from a non-zero carry: the gates, the stabilizer collapsed
    per head with max, n floored at 1e-6 (an n of zero reaches it)."""
    cfg, jcfg, pp, jp = slstm_pair()
    H, dh = cfg.slstm_heads, cfg.d_model // cfg.slstm_heads
    r = np.random.default_rng(9)
    carry = [r.standard_normal((B, H, dh)).astype(np.float32)
             for _ in range(3)] + [r.standard_normal((B, H)).astype(
                 np.float32)]
    carry[1][0] = 0.0
    carry[1] = np.abs(carry[1])
    wx = r.standard_normal((B, 4 * cfg.d_model)).astype(np.float32)
    got, h = pssm._slstm_step(pp, cfg, tuple(torch.from_numpy(c)
                                             for c in carry),
                              torch.from_numpy(wx))
    want, jh = jssm._slstm_step(jp, jcfg, tuple(jnp.asarray(c)
                                                for c in carry),
                                jnp.asarray(wx))
    close(h, jh)
    for g, w in zip(got, want):
        close(g, w)
    assert got[3].shape == (B, H)


@pytest.mark.parametrize("S", [8, 40])
def test_slstm_matches_reference(S):
    cfg, jcfg, pp, jp = slstm_pair()
    x, jx = act((B, S, cfg.d_model), 10)
    close(pssm.slstm(x, pp, cfg), jssm.slstm(jx, jp, jcfg))


def test_slstm_decode_matches_reference_and_forward():
    cfg, jcfg, pp, jp = slstm_pair()
    x, jx = act((B, 8, cfg.d_model), 11)
    cache = BLOCKS["slstm"].init_cache(cfg, B, 8, torch.float32, "cpu")
    jc = jblocks.SLstm.init_cache(jcfg, B, 8, jnp.float32)
    outs = []
    for t in range(8):
        y, cache = pssm.slstm_decode(x[:, t:t + 1], pp, cfg, cache)
        jy, jc = jssm.slstm_decode(jx[:, t:t + 1], jp, jcfg, jc)
        close(y, jy)
        close_tree(cache, jc)
        outs.append(y)
    close(torch.cat(outs, dim=1), pssm.slstm(x, pp, cfg).numpy())


# --------------------------------------------------------------------- blocks

BLOCK_ARCH = {"hybrid": HYMBA, "mlstm": XLSTM, "slstm": XLSTM}
JBLOCK = {"hybrid": jblocks.Hybrid, "mlstm": jblocks.MLstm,
          "slstm": jblocks.SLstm}


@pytest.mark.parametrize("block", sorted(BLOCK_ARCH))
def test_block_forward_and_decode_match_reference(block):
    """One layer of each recurrent block: ``forward`` over 12 tokens, then
    8 ``decode`` steps, each step's output and every leaf of the (for
    ``hybrid``, nested) cache against the reference's."""
    cfg, jcfg = cfgs(BLOCK_ARCH[block])
    p = draw(BLOCKS[block].shapes(cfg, torch.float32), 12)
    pp, jp = both(p)
    x, jx = act((B, 12, cfg.d_model), 13)
    y, aux = BLOCKS[block].forward(x, pp, cfg, {})
    jy, jaux = JBLOCK[block].forward(jx, jp, jcfg, {})
    close(y, jy)
    assert aux == jaux == 0.0
    cache = BLOCKS[block].init_cache(cfg, B, 16, torch.float32, "cpu")
    jc = JBLOCK[block].init_cache(jcfg, B, 16, jnp.float32)
    close_tree(cache, jc)
    for t in range(8):
        y, cache = BLOCKS[block].decode(x[:, t:t + 1], pp, cfg, cache, {})
        jy, jc = JBLOCK[block].decode(jx[:, t:t + 1], jp, jcfg, jc, {})
        close(y, jy)
        close_tree(cache, jc)


# ------------------------------------------------------------- whole models

@pytest.mark.parametrize("arch,S", [(HYMBA, 12), (HYMBA, 1024),
                                    (XLSTM, 12), (XLSTM, 512)])
def test_forward_matches_reference(arch, S):
    """The smoke config through ``forward``; hymba at 1024 runs its mamba
    heads chunked (and its attention through the chunked softmax), xlstm
    at 512 its mLSTM chunkwise."""
    cfg, jcfg, jp, pp = pair(arch)
    toks = tokens(cfg, (B, S))
    jl, jaux = jmodel.forward(jp, jcfg, tokens=jnp.asarray(toks), remat=None)
    pl, paux = forward(pp, cfg, tokens=torch.from_numpy(toks))
    assert pl.shape == (B, S, cfg.vocab) and pl.dtype == torch.float32
    close(pl, jl)
    close(paux, jaux)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_matches_reference(arch):
    """8 decode steps with caches: each step's logits, then every leaf of
    the stacked caches (hymba's nested ``attn``/``mamba`` trees: the
    write-back of ``Layer.decode`` at every depth), each cache tensor
    written in place (the same storage before and after)."""
    cfg, jcfg, jp, pp = pair(arch)
    toks = tokens(cfg, (B, 8))
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, jcfg, c, tokens=t))
    jc = jmodel.init_caches(jcfg, B, 12)
    pc = init_caches(cfg, B, 12, device="cpu")
    ptrs = [t.data_ptr() for t in _leaves(pc)]
    for i in range(8):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, i:i + 1]))
        pl, pc = decode_step(pp, cfg, pc, tokens=torch.from_numpy(
            toks[:, i:i + 1]))
        close(pl, jl)
    close_tree(dict(pc), jc)
    assert [t.data_ptr() for t in _leaves(pc)] == ptrs
    if arch == HYMBA:
        assert float(jnp.abs(jc["s0_hybrid"]["mamba"]["h"]).max()) > 0
        assert int(pc["s0_hybrid"]["attn"]["pos"][0]) == 8


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_param_count_and_shapes_match_reference(arch):
    for get, jget in ((get_smoke_config, jget_smoke),
                      (get_config, jget_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert cfg.param_count() == jcfg.param_count()
        assert cfg.active_param_count() == jcfg.active_param_count()
        specs = tree_leaves(param_shapes(cfg))
        jspecs = jax.tree.leaves(jmodel.param_shapes(jcfg))
        assert [(s.shape, s.axes, str(s.dtype).split(".")[-1])
                for s in specs] == \
            [(tuple(s.shape), s.axes, str(s.dtype)) for s in jspecs]
    assert get_config(HYMBA).n_layers == 32
    assert get_config(XLSTM).n_layers == 48


def test_bf16_hymba_smoke_matches_reference():
    """hymba's smoke config in bf16 (f32 dt_bias, A_log, Dskip and norms):
    forward and 4 decode steps within BF16_TOL of the logits' scale."""
    cfg, jcfg, jp, pp = pair(HYMBA, dtype="bfloat16")
    tree = pp.tree()["stages"]["s0_hybrid"]["mamba"]
    assert tree["in_proj"].dtype == torch.bfloat16
    for name in ("dt_bias", "A_log", "Dskip"):
        assert tree[name].dtype == torch.float32
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


def test_params_from_numpy_carries_the_f32_leaves_of_a_bf16_config():
    """Inside a bf16 config the Mamba leaves dt_bias, A_log and Dskip and
    the cells' out_norm stay float32, carried bit for bit."""
    for arch in SSM_ARCHS:
        cfg, jcfg = cfgs(arch, dtype="bfloat16")
        jp = jmodel.init_params(jcfg, jax.random.key(1))
        want = np_tree(jp)
        got = params_from_numpy(want, cfg, "cpu").tree()

        def walk(g, w, jt, path=()):
            if isinstance(w, dict):
                for k in w:
                    walk(g[k], w[k], jt[k], path + (k,))
                return
            assert str(g.dtype).split(".")[-1] == str(jt.dtype), path
            assert np.array_equal(g.float().numpy(), w), path
        walk(got, want, jp)
        f32 = [s for s in tree_leaves(param_shapes(cfg))
               if s.dtype == torch.float32]
        assert len(f32) >= (4 if arch == HYMBA else 3)


# ------------------------------------------------------- the init_params rules

def test_init_params_sets_a_log_and_dskip_as_the_reference():
    """hymba's smoke config: A_log is the reference's (log(1..N) along the
    state axis), every Dskip is 1, and every other leaf follows the rule
    it followed before: norms ones, gates and unstacked biases zeros, the
    rest drawn N(0, 0.02) in sorted path order, the generator advancing
    once a drawn leaf only."""
    cfg = get_smoke_config(HYMBA)
    jcfg = jget_smoke(HYMBA)
    got = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    tree = got.tree()
    jt = jmodel.init_params(jcfg, jax.random.key(0))
    a_log = tree["stages"]["s0_hybrid"]["mamba"]["A_log"]
    assert a_log.shape == (cfg.n_units, 2 * cfg.d_model, cfg.ssm_state)
    assert torch.equal(a_log, torch.from_numpy(np.array(
        jt["stages"]["s0_hybrid"]["mamba"]["A_log"])))
    assert torch.equal(a_log[1, 7], torch.from_numpy(np.log(np.arange(
        1, cfg.ssm_state + 1, dtype=np.float32))))
    assert torch.equal(tree["stages"]["s0_hybrid"]["mamba"]["Dskip"],
                       torch.ones(cfg.n_units, 2 * cfg.d_model))
    g = torch.Generator().manual_seed(3)

    def expect(path, s):
        nm = "/".join(path).lower()
        if any(t in nm for t in ("norm", "ln1", "ln2", "/na", "/nm")):
            return torch.ones(s.shape)
        if "a_log" in nm or "dskip" in nm:
            return None
        if len(s.shape) >= 2:
            return torch.randn(s.shape, generator=g).mul_(0.02)
        return torch.zeros(s.shape)

    def walk(specs, t, path=()):
        if isinstance(specs, Spec):
            want = expect(path, specs)
            if want is not None:
                assert torch.equal(t, want), path
            return
        for k in sorted(specs):
            walk(specs[k], t[k], path + (k,))
    walk(param_shapes(cfg), tree)


# ------------------------------------------- test_archs_smoke.py's cases

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_archs_smoke_forward_and_shapes(arch):
    """test_archs_smoke.py::test_forward_and_shapes on the port: B = 2,
    S = 32 from ``init_params``; finite logits of the vocabulary's width."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(tokens(cfg, (B, 32)))
    logits, aux = forward(params, cfg, tokens=toks, remat=None)
    assert logits.shape == (B, 32, cfg.vocab)
    assert torch.isfinite(logits).all() and torch.isfinite(aux)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_archs_smoke_decode_step(arch):
    """test_archs_smoke.py::test_decode_step on the port: one step over a
    64-token cache."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    caches = init_caches(cfg, B, 64, device="cpu")
    logits, _ = decode_step(params, cfg, caches,
                            tokens=torch.from_numpy(tokens(cfg, (B, 1))))
    assert logits.shape == (B, 1, cfg.vocab)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_matches_forward_ssm(arch):
    """test_archs_smoke.py::test_decode_matches_forward_ssm on the port,
    for both recurrent archs, held within 1e-5 rather than its 2e-2: the
    recurrent decode reproduces the parallel forward."""
    cfg = get_smoke_config(arch)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.from_numpy(tokens(cfg, (B, 8)))
    full, _ = forward(params, cfg, tokens=toks, remat=None)
    caches = init_caches(cfg, B, 8, device="cpu")
    outs = [decode_step(params, cfg, caches, tokens=toks[:, i:i + 1])[0]
            for i in range(8)]
    close(torch.cat(outs, dim=1), full.numpy())


# -------------------------------------------------------------------- serving

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serving_engine_matches_reference(arch):
    """The serve launcher's workload (12 requests of 3-9 tokens, 8 new,
    ``max_batch=4``) on the smoke config: the reference's tokens, steps,
    page pool, session stats and every cache leaf.  The whole-batch
    prefill drives every slot's recurrent state in both packages."""
    cfg, jcfg, jp, pp = pair(arch)
    ecfg = {"max_batch": 4, "max_seq": 64}
    je = jeng.ServingEngine(jcfg, jp, jeng.EngineConfig(**ecfg),
                            session_policy="always")
    pe = peng.ServingEngine(cfg, pp, peng.EngineConfig(**ecfg),
                            session_policy="always", device="cpu")
    reqs = []
    for eng, Request in ((je, jeng.Request), (pe, peng.Request)):
        rng = np.random.default_rng(0)
        rs = [Request(rid=1000 + i, prompt=rng.integers(
            0, cfg.vocab, size=rng.integers(3, 10)).astype(np.int32),
            max_new=8) for i in range(12)]
        for r in rs:
            eng.submit(r)
        eng.run_until_drained()
        reqs.append(rs)
    assert [(r.rid, r.done, r.generated) for r in reqs[0]] == \
        [(r.rid, r.done, r.generated) for r in reqs[1]]
    assert pe.steps == je.steps and pe.pool.free == je.pool.free
    assert pe.sessions.stats() == je.sessions.stats()
    close_tree(dict(pe.caches), je.caches)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_launcher_serves_the_recurrent_archs(arch, capsys,
                                                   monkeypatch):
    """``launch/serve.py --arch ... --device cpu`` prints the reference
    launcher's line."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as pserve

    monkeypatch.setattr(sys, "argv", ["serve", "--arch", arch])
    jserve.main()
    want = capsys.readouterr().out
    pserve.main(["--arch", arch, "--device", "cpu"])
    got = capsys.readouterr().out
    assert want.startswith("served 12 requests in ") and got == want
