"""The filter plane in the port: the plain version of the stack-probe
kernel (``ops.bloom_probe_stack`` on CPU tensors) against repro's
``bloom_probe_stack_ref`` and its Pallas kernel in interpret mode, exactly,
on level-shaped stacks and on the card tests' edge stacks;
then the engine's device filter probe (``LookupEngine.filter_probe``, and
``lookup_async`` with ``fstate`` and no host mask) against the host-screen
mask path and repro's engine with ``filter_impl="ref"``."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core import filters as jfilters  # noqa: E402
from repro.core.bloom import bloom_probe_np  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import engine as peng  # noqa: E402
from repro_torch.core import filters as pfilters  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_engine import (B_LIVE, N_LEVELS, _filter_inputs,  # noqa: E402
                               _probes, _trees)

import test_torch_kernels_cuda as cuda_cases  # noqa: E402  (no JAX there)


def _stack(rng, n_levels=3, n_keys=2000, bpk=10, k=7):
    """A padded (L, W) filter stack and the per-level key sets (the shapes
    of tests/test_filters.py)."""
    key_sets, filters = [], []
    for li in range(n_levels):
        ks = np.unique(rng.integers(0, 1 << 40, n_keys * (li + 1)))
        key_sets.append(ks)
        filters.append(pfilters.build_level_filter(ks, bpk, k))
    W = max(64, 1 << (max(f.n_words for f in filters) - 1).bit_length())
    bits = np.zeros((n_levels, W), np.uint64)
    nw = np.zeros(n_levels, np.int32)
    for li, f in enumerate(filters):
        bits[li, : f.n_words] = f.bits
        nw[li] = f.n_words
    return key_sets, filters, bits, nw


def _port_probe(bits, nw, probes, k):
    return ops.bloom_probe_stack(torch.from_numpy(bits.view(np.int64)),
                                 torch.from_numpy(nw),
                                 torch.from_numpy(probes), k).numpy()


@pytest.mark.parametrize("B", [64, 100, 257])
@pytest.mark.parametrize("k", [4, 7])
def test_bloom_probe_stack_matches_reference(B, k):
    """Plain version == repro's jnp oracle == its Pallas kernel (interpret
    mode) == the per-level host probe, on ragged batches, with zero false
    negatives for every level's own keys."""
    rng = np.random.default_rng(B + k)
    key_sets, filters, bits, nw = _stack(rng, k=k)
    probes = np.concatenate([key_sets[0][:B // 2],
                             rng.integers(0, 1 << 40, B - B // 2)])
    got = _port_probe(bits, nw, probes, k)
    want = np.stack([bloom_probe_np(f.bits, probes, k, n_words=f.n_words)
                     for f in filters])
    ref = np.asarray(jref.bloom_probe_stack_ref(
        jnp.asarray(bits), jnp.asarray(nw), jnp.asarray(probes), k))
    pal = np.asarray(jops.bloom_probe_stack(
        jnp.asarray(bits), jnp.asarray(nw), jnp.asarray(probes),
        k_hashes=k, impl="pallas_interpret"))
    assert got.shape == (3, B) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    for li, ks in enumerate(key_sets):         # no false negatives
        p = ks[:B]
        assert _port_probe(bits, nw, p, k)[li].all()


@pytest.mark.parametrize("L", [1, 7])
@pytest.mark.parametrize("k", [1, 8, 12])
def test_bloom_probe_stack_edge_stacks_match_reference(k, L):
    """The card tests' edge stacks (``stack_edge_table``: filterless rows
    first, in the middle and last, a one-word filter, rows whose nw is
    below the padded W; 0, -1, int64 min and max and the pad probe among
    4096 + 37 probes): plain version == repro's jnp oracle == its Pallas
    kernel in interpret mode, exactly."""
    tb = cuda_cases.stack_edge_table(L, k)
    got = ops.bloom_probe_stack(torch.from_numpy(tb["bits"]),
                                torch.from_numpy(tb["nw"]),
                                torch.from_numpy(tb["probes"]), k).numpy()
    bits = jnp.asarray(tb["bits"].view(np.uint64))
    nw, probes = jnp.asarray(tb["nw"]), jnp.asarray(tb["probes"])
    want = np.asarray(jref.bloom_probe_stack_ref(bits, nw, probes, k))
    pal = np.asarray(jops.bloom_probe_stack(bits, nw, probes, k_hashes=k,
                                            impl="pallas_interpret"))
    assert got.shape == (L, tb["probes"].shape[0]) and got.dtype == bool
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pal)
    assert got[tb["nw"] == 0].all()
    assert got[tb["nw"] > 0].any() and not got[tb["nw"] > 0].all()


def test_bloom_probe_stack_filterless_row_is_all_maybe():
    """nw == 0 marks a level without a filter: its row is all True (pruning
    on it would drop real keys), in the port as in the reference."""
    rng = np.random.default_rng(0)
    _, _, bits, nw = _stack(rng, n_levels=3)
    nw[1] = 0
    bits[1] = 0
    probes = rng.integers(0, 1 << 40, 128)
    got = _port_probe(bits, nw, probes, 7)
    assert got[1].all()
    for impl in ("ref", "pallas_interpret"):
        want = np.asarray(jops.bloom_probe_stack(
            jnp.asarray(bits), jnp.asarray(nw), jnp.asarray(probes),
            k_hashes=7, impl=impl))
        np.testing.assert_array_equal(got, want)


def test_bloom_probe_stack_wrapper_checks_inputs():
    rng = np.random.default_rng(1)
    _, _, bits, nw = _stack(rng, n_levels=2, n_keys=100)
    b = torch.from_numpy(bits.view(np.int64))
    p = torch.arange(10, dtype=torch.int64)
    with pytest.raises(TypeError):
        ops.bloom_probe_stack(b, torch.from_numpy(nw).long(), p, 7)
    with pytest.raises(ValueError):
        ops.bloom_probe_stack(b, torch.from_numpy(nw[:1]), p, 7)
    with pytest.raises(TypeError):
        ops.bloom_probe_stack(b, torch.from_numpy(nw), p.int(), 7)
    before = dict(ops.launches)
    assert ops.bloom_probe_stack(b, torch.from_numpy(nw), p[:0], 7).shape \
        == (2, 0)
    assert ops.launches == before           # the plain version never counts


@pytest.mark.parametrize("mode,learn", [("model", "half"),
                                        ("model_pure", "all")])
def test_engine_device_filter_probe_matches_host_mask_and_reference(mode,
                                                                    learn):
    (jt, pt), keys = _trees(learn)
    probes = _probes(keys)
    je = jeng.LookupEngine(jeng.EngineConfig(filter_impl="ref"))
    pe = peng.LookupEngine(peng.EngineConfig(device="cpu"))
    je.record_probe_split = pe.record_probe_split = True
    jfilt, _, hint = _filter_inputs(jt, jfilters, probes)
    pfilt, pmask, _ = _filter_inputs(pt, pfilters, probes)
    jfs = je.build_filter_state(jfilt)
    pfs = pe.build_filter_state(pfilt)
    # the (L, B) device mask equals the reference's and, on the live
    # probes of the live levels, the host screen's
    pm = pe.filter_probe(pfs, torch.from_numpy(probes)).numpy()
    jm = np.asarray(je.filter_probe(jfs, jnp.asarray(probes)))
    np.testing.assert_array_equal(pm, jm)
    live = [li for li in range(N_LEVELS) if pt.levels[li]]
    np.testing.assert_array_equal(pm[live, :B_LIVE], pmask[live, :B_LIVE])
    # the lookup with the device mask == with the host mask == reference
    outs = []
    for eng, tree, fs, mask in ((pe, pt, pfs, None), (pe, pt, pfs, pmask),
                                (je, jt, jfs, None)):
        eng.probe_split_acc = eng.filter_stats_acc = None
        res = eng.lookup_async(eng.build_state(tree), probes, mode,
                               l0_live=len(tree.levels[0]), fstate=fs,
                               fmaybe_host=mask, level_maybe=hint).resolve()
        outs.append((res, eng.probe_split_np(), eng.filter_stats_np()))
    (dev, dsplit, dfst) = outs[0]
    for res, split, fst in outs[1:]:
        np.testing.assert_array_equal(dev.found, res.found)
        np.testing.assert_array_equal(dev.vptr, res.vptr)
        np.testing.assert_array_equal(dev.served_level, res.served_level)
        for li in range(N_LEVELS):
            np.testing.assert_array_equal(dev.pos_counts[li],
                                          res.pos_counts[li])
            np.testing.assert_array_equal(dev.neg_counts[li],
                                          res.neg_counts[li])
        np.testing.assert_array_equal(dsplit, split)
        np.testing.assert_array_equal(dfst, fst)
    assert dfst[:, 0].sum() > 0             # the device mask pruned
    assert dev.found[:B_LIVE].any()
