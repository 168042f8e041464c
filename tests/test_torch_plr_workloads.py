"""The port's leftovers of the in-memory slice, held to the reference on
the CPU: ``core/workloads.py`` yields the reference's request streams for
the same seed; ``greedy_plr_torch`` (the tensor loop of
``greedy_plr_jax``) fits the segments of ``greedy_plr_np`` as
tests/test_plr.py holds the JAX version, and those of ``greedy_plr_jax``
bit for bit, duplicates and the ``cap`` clamp included; and the plain
bloom probes, whose split unsigned modulus is exact only below 2**31,
refuse a larger filter instead of returning wrong bits."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import greedy_plr_jax  # noqa: E402
from repro.core import workloads as rwl  # noqa: E402
from repro_torch.core import (greedy_plr_np, greedy_plr_torch,  # noqa: E402
                              make_dataset, plr_predict_np)
from repro_torch.core import workloads as pwl  # noqa: E402
from repro_torch.core.bloom import bloom_probe_ref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402


@pytest.mark.parametrize("dist", ["uniform", "zipfian", "sequential",
                                  "hotspot", "exponential", "latest"])
def test_request_indices_match_reference(dist):
    for step in (0, 3):
        a = rwl.request_indices(dist, np.random.default_rng(4), 5000, 777,
                                step)
        b = pwl.request_indices(dist, np.random.default_rng(4), 5000, 777,
                                step)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("mix", sorted(rwl.YCSB_MIXES))
def test_ycsb_workload_streams_match_reference(mix):
    assert pwl.YCSB_MIXES == rwl.YCSB_MIXES
    keys = np.sort(make_dataset("osm", 4096, seed=2))
    ra = list(rwl.iter_workload(rwl.WorkloadSpec.ycsb(mix, 9000, 512, 7),
                                keys))
    pa = list(pwl.iter_workload(pwl.WorkloadSpec.ycsb(mix, 9000, 512, 7),
                                keys))
    assert [op for op, _ in pa] == [op for op, _ in ra]
    for (_, a), (_, b) in zip(ra, pa):
        np.testing.assert_array_equal(b, a)
    assert pwl.WorkloadSpec.ycsb(mix, 10) == pwl.WorkloadSpec(
        **vars(rwl.WorkloadSpec.ycsb(mix, 10)))


def test_greedy_plr_torch_matches_numpy():
    keys = make_dataset("normal", 2048, seed=5)
    m_np = greedy_plr_np(keys, delta=8, pad_to=1024)
    m_pt = greedy_plr_torch(torch.from_numpy(keys), delta=8, cap=1024,
                            device="cpu")
    assert int(m_np.n_segments) == int(m_pt.n_segments)
    n = int(m_np.n_segments)
    np.testing.assert_allclose(m_pt.starts[:n], m_np.starts[:n])
    np.testing.assert_allclose(m_pt.slopes[:n], m_np.slopes[:n], rtol=1e-12)
    pred = plr_predict_np(m_pt, keys)
    assert np.abs(pred - np.arange(keys.shape[0])).max() <= 8 + 1e-6


def test_greedy_plr_torch_runs_on_the_card_unless_asked():
    """Like every entry point of the port, the fit defaults to the card and
    refuses, rather than falling back to the CPU, where there is none."""
    keys = make_dataset("normal", 64, seed=7)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            greedy_plr_torch(keys)
        return
    m_np = greedy_plr_np(keys, delta=8, pad_to=1024)
    m_pt = greedy_plr_torch(keys)
    assert m_pt.n_segments == m_np.n_segments


@pytest.mark.parametrize("case", ["normal", "duplicates", "cap_clamp",
                                  "one_key"])
def test_greedy_plr_torch_bit_equal_to_jax(case):
    keys = make_dataset("normal", 1024, seed=6)
    delta, cap = 8, 256
    if case == "duplicates":
        keys = np.sort(np.concatenate([keys, keys[:100], keys[500:520]]))
    elif case == "cap_clamp":
        delta, cap = 1, 8          # more segments than cap: the last clamps
    elif case == "one_key":
        keys = keys[:1]
    m_jx = greedy_plr_jax(np.asarray(keys), delta=delta, cap=cap)
    m_pt = greedy_plr_torch(keys, delta=delta, cap=cap, device="cpu")
    assert m_pt.n_segments == int(m_jx.n_segments)
    if case == "cap_clamp":
        assert m_pt.n_segments > cap
    for a, b in ((m_jx.starts, m_pt.starts), (m_jx.slopes, m_pt.slopes),
                 (m_jx.intercepts, m_pt.intercepts)):
        np.testing.assert_array_equal(b, np.asarray(a))


@pytest.mark.parametrize("probe", ["rows", "stack", "filter"])
def test_plain_bloom_probes_refuse_moduli_past_2_31(probe):
    """A filter of 2**25 words has 2**31 bits: past the split modulus's
    range, so each plain version raises before reading a word (the
    one-word ``bits`` stand for the filter, only ``nw`` is read)."""
    bits = torch.zeros((1, 1), dtype=torch.int64)
    probes = torch.arange(1, 65, dtype=torch.int64)
    big = torch.tensor([1 << 25], dtype=torch.int32)
    with pytest.raises(ValueError, match="too large"):
        if probe == "rows":
            rows = torch.zeros(64, dtype=torch.int32)
            ops.bloom_probe(bits, big, rows, probes, 7)
        elif probe == "stack":
            ops.bloom_probe_stack(bits, big, probes, 7)
        else:
            bloom_probe_ref(bits[0], probes, 7, n_words=1 << 25)
    # one word less is inside the range and answers
    ok = torch.tensor([(1 << 25) - 1], dtype=torch.int32)
    out = ref.bloom_probe_rows_ref(bits, ok, torch.zeros(64, dtype=torch.int32),
                                   probes, 7)
    assert out.shape == (64,) and not out.any()
