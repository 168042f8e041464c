"""The port's mesh GET on the CPU against the reference's ``shard_map``
program: ``core.mesh``, ``core.distributed``'s ``build_dist_get``,
``dist_state_specs`` and ``place_dist_state``, ``ShardedStore`` over a
mesh, and ``port/examples/distributed_get.py``.

A mesh of ``cpu`` repeated stands in for the reference's forced host
devices.  The reference's four-device mesh needs
``--xla_force_host_platform_device_count=4`` before JAX starts, so that
half runs in a subprocess (this file run as a script) and hands back
numpy arrays; the one-device cases run in this process.  found and vptr
must be equal exactly, with filters on and off, for both ``combine``
values and both ``seg_search`` values, and for an empty shard probed with
KEY_SENTINEL.  The mesh store is held to the reference's ``mesh=None``
store (the same answers by construction): values, tombstones, flush and
the epoch refresh, kill and reopen, and the pipelined server at I/O pool
sizes 0 and 2."""

import gc
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.core.distributed as RD  # noqa: E402
from repro.core.jaxcompat import make_mesh as r_make_mesh  # noqa: E402
from repro.core.jaxcompat import set_mesh  # noqa: E402
import repro_torch.core.distributed as PD  # noqa: E402
from repro_torch.core.datasets import make_dataset  # noqa: E402
from repro_torch.core.filters import build_level_filter  # noqa: E402
from repro_torch.core.mesh import Mesh, make_mesh  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
import _torch_serving as common  # noqa: E402
from test_torch_storage import sync_file_ids  # noqa: E402

PAD_PROBE = -(1 << 62)
K_HASHES = 7
COMBINES = ("reduce_scatter", "allreduce")
SEG_SEARCHES = ("bisect", "compare")
# the four-device cases the reference runs in its subprocess:
# (filters, combine, seg_search), and the empty-shard case per combine
FOUR_DEVICE_CASES = ([(f, c, "bisect") for f in (False, True)
                      for c in COMBINES]
                     + [(True, "reduce_scatter", "compare")])


def cpu_mesh(n: int) -> Mesh:
    return make_mesh((n,), ("shard",), ["cpu"] * n)


def dist_case(n_shards: int, filters: bool, seed: int = 5):
    """(stacked numpy state, probes, cfg): 4096 "ar" keys over
    ``n_shards`` equal-count shards; 512 probes (present keys, absent
    neighbours, KEY_SENTINEL, the pad probe and extremes).  With
    ``filters``, each shard's bloom row rides in ``fbits``/``fnw``."""
    keys = make_dataset("ar", 4096, seed=seed)
    vptrs = np.arange(keys.shape[0], dtype=np.int64) * 3 + 1
    cfg = RD.DistStoreConfig(n_keys=keys.shape[0], probe_batch=512)
    if filters:
        per = -(-keys.shape[0] // n_shards)
        snaps = [(keys[s * per: (s + 1) * per], vptrs[s * per: (s + 1) * per])
                 for s in range(n_shards)]
        state = PD.build_dist_state_from_shards(
            snaps, cfg.delta,
            filters=[build_level_filter(k, 10, K_HASHES) for k, _ in snaps])
    else:
        state = PD.build_dist_state(keys, vptrs, n_shards, cfg)
    rng = np.random.default_rng(seed + 1)
    special = np.array([PD.KEY_SENTINEL, PD.KEY_SENTINEL - 1, PAD_PROBE, 0,
                        -1, int(keys[0]), int(keys[-1]), int(keys[-1]) + 1],
                       np.int64)
    probes = np.concatenate([rng.choice(keys, 256), rng.choice(keys, 120) + 1,
                             special,
                             rng.integers(int(keys[0]), int(keys[-1]), 128,
                                          dtype=np.int64)])
    return state, probes, cfg


def empty_shard_case():
    """The reference's ``test_empty_shard_masked_from_sentinel_probe``:
    five keys over four shards, the last empty (lo = hi = KEY_SENTINEL),
    probed with KEY_SENTINEL."""
    keys = np.array([10, 20, 30, 40, 50], dtype=np.int64)
    cfg = RD.DistStoreConfig(n_keys=5, probe_batch=8)
    state = PD.build_dist_state(keys, np.arange(5, dtype=np.int64), 4, cfg)
    probes = np.array([PD.KEY_SENTINEL, 10, PD.KEY_SENTINEL - 1, 50,
                       PAD_PROBE, 30, 31, PD.KEY_SENTINEL], np.int64)
    return state, probes, cfg


def ref_dist_get(state, probes, cfg, n_dev, combine, seg_search):
    """The reference's mesh GET on an ``n_dev``-device mesh (the process
    must have that many JAX devices) -> numpy (found, vptr)."""
    mesh = r_make_mesh((n_dev,), ("data",), axis_type="Explicit")
    fn = RD.build_dist_get(mesh, cfg, seg_search, combine,
                           state_keys=tuple(state), k_hashes=K_HASHES)
    with set_mesh(mesh):
        f, v = fn({k: jnp.asarray(v) for k, v in state.items()},
                  jnp.asarray(probes))
    return np.asarray(f), np.asarray(v)


def port_dist_get(state, probes, cfg, mesh, combine, seg_search):
    """The port's mesh GET -> numpy (found, vptr) of the whole batch, the
    pieces checked against the combine's layout first."""
    fn = PD.build_dist_get(mesh, cfg, seg_search, combine,
                           state_keys=tuple(state), k_hashes=K_HASHES)
    f, v = fn(PD.place_dist_state(state, mesh), torch.from_numpy(probes))
    assert len(f) == len(v) == mesh.size
    for x, dev in zip(f + v, mesh.devices * 2):
        assert x.device == dev
    if combine == "allreduce":
        for x, y in zip(f[1:] + v[1:], f[:1] * (mesh.size - 1)
                        + v[:1] * (mesh.size - 1)):
            assert torch.equal(x, y)
        return f[0].numpy(), v[0].numpy()
    assert {x.shape[0] for x in f} == {probes.shape[0] // mesh.size}
    return torch.cat(f).numpy(), torch.cat(v).numpy()


def four_device_reference() -> dict:
    """Every four-device case on the reference (run in a process that JAX
    started with four host devices): arrays by case name, and the state
    specs of a four-device mesh."""
    out = {}
    for f, c, s in FOUR_DEVICE_CASES:
        state, probes, cfg = dist_case(4, f)
        out[f"{f}-{c}-{s}-found"], out[f"{f}-{c}-{s}-vptr"] = ref_dist_get(
            state, probes, cfg, 4, c, s)
    for c in COMBINES:
        state, probes, cfg = empty_shard_case()
        out[f"empty-{c}-found"], out[f"empty-{c}-vptr"] = ref_dist_get(
            state, probes, cfg, 4, c, "bisect")
    mesh = r_make_mesh((4,), ("data",), axis_type="Explicit")
    specs = RD.dist_state_specs(mesh, RD.DistStoreConfig(n_keys=5000,
                                                         probe_batch=64))
    out["specs"] = np.array([f"{k}:{tuple(v.shape)}:{np.dtype(v.dtype)}"
                             for k, v in specs.items()])
    return out


@pytest.fixture(scope="module")
def four_ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh_ref") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [os.path.join(REPO, "src"), os.path.join(REPO, "port")]))
    subprocess.run([sys.executable, os.path.abspath(__file__), out],
                   env=env, check=True, timeout=120, cwd=REPO)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _specs(specs: dict) -> list:
    return [f"{k}:{tuple(v.shape)}:{str(v.dtype).replace('torch.', '')}"
            for k, v in specs.items()]


# ------------------------------------------------------------ the mesh GET

@pytest.mark.parametrize("filters", [False, True], ids=["nofilter", "filter"])
@pytest.mark.parametrize("seg_search", SEG_SEARCHES)
@pytest.mark.parametrize("combine", COMBINES)
def test_dist_get_one_device_matches_reference(combine, seg_search, filters):
    state, probes, cfg = dist_case(1, filters)
    want = ref_dist_get(state, probes, cfg, 1, combine, seg_search)
    got = port_dist_get(state, probes, cfg, cpu_mesh(1), combine, seg_search)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert want[0][:256].all() and not want[0][-136:-128][:5].any()


@pytest.mark.parametrize("case", FOUR_DEVICE_CASES,
                         ids=["-".join(map(str, c))
                              for c in FOUR_DEVICE_CASES])
def test_dist_get_four_devices_matches_reference(four_ref, case):
    filters, combine, seg_search = case
    state, probes, cfg = dist_case(4, filters)
    ops.reset_launches()
    got = port_dist_get(state, probes, cfg, cpu_mesh(4), combine, seg_search)
    name = "-".join(map(str, case))
    np.testing.assert_array_equal(got[0], four_ref[f"{name}-found"])
    np.testing.assert_array_equal(got[1], four_ref[f"{name}-vptr"])
    assert got[0][:256].all()
    assert sum(ops.launches.values()) == 0     # the CPU runs plain versions


@pytest.mark.parametrize("combine", COMBINES)
def test_empty_shard_sentinel_probe_matches_reference(four_ref, combine):
    state, probes, cfg = empty_shard_case()
    assert state["n"][3] == 0
    got = port_dist_get(state, probes, cfg, cpu_mesh(4), combine, "bisect")
    np.testing.assert_array_equal(got[0], four_ref[f"empty-{combine}-found"])
    np.testing.assert_array_equal(got[1], four_ref[f"empty-{combine}-vptr"])
    np.testing.assert_array_equal(got[0], [0, 1, 0, 1, 0, 1, 0, 0])


def test_dist_state_specs_match_reference(four_ref):
    cfg = RD.DistStoreConfig(n_keys=5000, probe_batch=64)
    r1 = RD.dist_state_specs(r_make_mesh((1,), ("data",),
                                         axis_type="Explicit"), cfg)
    p1 = PD.dist_state_specs(cpu_mesh(1), cfg)
    assert _specs(p1) == [f"{k}:{tuple(v.shape)}:{np.dtype(v.dtype)}"
                          for k, v in r1.items()]
    p4 = PD.dist_state_specs(cpu_mesh(4), cfg)
    assert _specs(p4) == list(four_ref["specs"])
    assert all(v.device.type == "meta" for v in p4.values())
    assert list(p4) == list(PD.STATE_KEYS)


def test_mesh_layout_and_argument_checks():
    m = make_mesh((2, 2), ("a", "b"), ["cpu"] * 4)
    assert m.size == 4 and m.shape == (2, 2) and m.axis_names == ("a", "b")
    assert m.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="needs 4 devices"):
        Mesh(("cpu",) * 3, ("a", "b"), (2, 2))
    with pytest.raises(ValueError, match="axes"):
        make_mesh((4,), ("a", "b"), ["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh((2,), ("shard",))
    # a 2x2 mesh is read flattened in row-major order, as one of 4
    state, probes, cfg = dist_case(4, True)
    want = port_dist_get(state, probes, cfg, cpu_mesh(4), "reduce_scatter",
                         "bisect")
    got = port_dist_get(state, probes, cfg, m, "reduce_scatter", "bisect")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    fn = PD.build_dist_get(cpu_mesh(4), cfg, state_keys=tuple(state))
    with pytest.raises(ValueError, match="split"):
        fn(PD.place_dist_state(state, cpu_mesh(4)),
           torch.from_numpy(probes[:-1]))
    with pytest.raises(ValueError, match="rows"):
        PD.place_dist_state(state, cpu_mesh(2))
    with pytest.raises(ValueError, match="seg_search"):
        PD.build_dist_get(m, cfg, seg_search="scan")
    with pytest.raises(ValueError, match="leaves"):
        fn(PD.place_dist_state(state, cpu_mesh(4))[:3],
           torch.from_numpy(probes))


# ------------------------------------------------------- the store on a mesh

def _open(pkg, path, keys, n_shards, mesh, **kw):
    """A fresh sharded store of ``pkg`` (tests/_torch_serving.py's shard
    config) split at the keys' quantiles, opened with ``mesh``."""
    M = common.PKGS[pkg]
    bounds = tuple(int(b) for b in
                   np.quantile(keys, np.arange(1, n_shards) / n_shards))
    extra = {"device": "cpu"} if pkg == "repro_torch" else {}
    return M["sharded"].ShardedStore.open(
        str(path), M["sharded"].ShardedConfig(n_shards=n_shards,
                                              boundaries=bounds),
        common.store_cfg(pkg, **kw), mesh=mesh, **extra)


def _stats(st) -> dict:
    """``stats()`` less its wall-clock value-fetch totals."""
    return {k: v for k, v in st.stats().items() if k != "value_fetch"}


def _stage_counts(snap) -> dict:
    """How many times each read stage was timed (the histograms' counts;
    their sums are wall clock)."""
    return {dict(x["labels"])["stage"]: x["value"]["count"]
            for x in snap.get("server_stage_us", {"samples": []})["samples"]}


def _get_same(rs, ps, probes):
    """The same GET on both stores, vptrs then values; returns (found,
    values)."""
    for wv in (False, True):
        a = rs.get_batch(probes, with_values=wv)
        b = ps.get_batch(probes, with_values=wv)
        np.testing.assert_array_equal(b[0], a[0])
        np.testing.assert_array_equal(b[1], a[1])
    return a


def test_one_shard_auto_mesh_matches_reference(tmp_path):
    """With ``mesh="auto"`` a one-shard store on one device builds a
    one-device mesh in both packages (the reference's rule, ``len(devices)
    >= n_shards``), so both take the mesh GET: equal answers, values,
    ``stats()`` and obs counts — the mesh path times no ``filter_probe``
    stage, in either package."""
    keys = common.keys_of(6000, seed=30)
    sync_file_ids()
    rs = _open("repro", tmp_path / "r", keys, 1, "auto")
    ps = _open("repro_torch", tmp_path / "p", keys, 1, "auto")
    assert rs.uses_shard_map and ps.uses_shard_map
    ro = common.RO.Obs(common.RO.ObsConfig(sample_every=1))
    po = common.PO.Obs(common.PO.ObsConfig(sample_every=1))
    rs.attach_obs(ro)
    ps.attach_obs(po)
    for o in (ro, po):          # time every read stage from here on
        o.tracer.begin_tick()
    probes = np.concatenate([keys[:3000], keys[:500] + 1])
    for st in (rs, ps):
        for off in range(0, keys.shape[0], 2000):
            ks = keys[off: off + 2000]
            st.put_batch(ks, common.values_of(ks))
        st.delete_batch(keys[:300])
    found = _get_same(rs, ps, probes)[0]           # memtables and snapshot
    for st in (rs, ps):
        st.flush_all()
        st.put_batch(keys[300:400], common.values_of(keys[300:400], 2))
    found2, vals2 = _get_same(rs, ps, probes)      # after the epoch refresh
    assert not found[:300].any() and found[300:3000].all()
    assert (vals2[300:400, 1] == 2).all() and not found2[:300].any()
    assert ps.state_epoch == rs.state_epoch >= 2
    assert _stats(ps) == _stats(rs)
    rsnap, psnap = ro.snapshot(), po.snapshot()
    common.assert_snapshots_equal(rsnap, psnap)
    assert _stage_counts(psnap) == _stage_counts(rsnap)
    assert _stage_counts(psnap).get("filter_probe", 0) == 0
    assert _stage_counts(psnap)["value_fetch"] > 0
    rs.close()
    ps.close()


def test_mesh_store_matches_reference(tmp_path):
    """A four-shard store on a four-``cpu`` mesh against the reference's
    ``mesh=None`` store: values and tombstones through the memtables and
    the snapshot, flush and the epoch refresh (every row re-placed), and
    kill and reopen from the directories onto the mesh."""
    keys = common.keys_of(12000, seed=31, stride=3)
    mesh = cpu_mesh(4)
    sync_file_ids()
    rs = _open("repro", tmp_path / "r", keys, 4, None)
    ps = _open("repro_torch", tmp_path / "p", keys, 4, mesh)
    assert ps.uses_shard_map and not rs.uses_shard_map
    for st in (rs, ps):
        for off in range(0, 10000, 2500):
            ks = keys[off: off + 2500]
            st.put_batch(ks, common.values_of(ks))
        st.put_batch(keys[:1000], common.values_of(keys[:1000], 1))
        st.delete_batch(keys[1000:2000])
    probes = np.concatenate([keys, keys[:700] + 1])
    found, vals = _get_same(rs, ps, probes)
    assert (vals[:1000, 1] == 1).all() and not found[1000:2000].any()
    assert found[2000:10000].all() and not found[10000:12000].any()
    e0 = ps.state_epoch
    state0 = ps.device_state()
    assert len(state0) == 4 and all(r["keys"].shape[0] == 1 for r in state0)
    for st in (rs, ps):
        st.put_batch(keys[10000:], common.values_of(keys[10000:], 2))
        st.flush_all()
    found, vals = _get_same(rs, ps, probes)
    assert found[10000:12000].all() and (vals[10000:12000, 1] == 2).all()
    assert ps.state_epoch == rs.state_epoch > e0
    assert all(a["keys"] is not b["keys"]
               for a, b in zip(state0, ps.device_state()))
    for st in (rs, ps):
        st.learn_all()
        st.put_batch(keys[:64], common.values_of(keys[:64], 3))  # WAL only
    del rs, ps, st                                   # KILL: no close
    gc.collect()
    rs = common.rsh.ShardedStore.open(str(tmp_path / "r"), mesh=None)
    ps = common.psh.ShardedStore.open(str(tmp_path / "p"), mesh=mesh,
                                      device="cpu")
    assert ps.uses_shard_map
    sr, sp = _stats(rs), _stats(ps)
    assert sp["files_learned"] == 0 and sp["level_models_recovered"] > 0
    sr.pop("uses_shard_map")
    sp.pop("uses_shard_map")
    assert sp == sr
    found, vals = _get_same(rs, ps, probes)
    assert (vals[:64, 1] == 3).all() and not found[1000:2000].any()
    rs.close()
    ps.close()


def test_wrong_mesh_size_raises_and_auto_needs_devices(tmp_path):
    keys = common.keys_of(2000, seed=32)
    with pytest.raises(ValueError, match="one device a shard"):
        _open("repro_torch", tmp_path / "a", keys, 4, cpu_mesh(2))
    with pytest.raises(ValueError, match="one device a shard"):
        _open("repro_torch", tmp_path / "a", keys, 4, cpu_mesh(8))
    st = _open("repro_torch", tmp_path / "a", keys, 4, "auto")
    assert not st.uses_shard_map          # the CPU offers one device
    st.close()
    st = common.psh.ShardedStore.open(str(tmp_path / "a"), mesh=cpu_mesh(4),
                                      device="cpu")
    assert st.uses_shard_map and st.stats()["uses_shard_map"]
    st.close()


def _serve(pkg, root, keys, streams, io_workers, mesh):
    S = common.PKGS[pkg]["server"]
    st = _open(pkg, root, keys, 4, mesh, fetch_values=True)
    srv = S.PipelinedServer(st, S.PipelineConfig(
        max_batch_keys=1024, max_wait_ticks=0, queue_capacity=128,
        max_batches_per_tick=8, max_inflight=8, carry=1,
        io_workers=io_workers,
        coordinator=S.CoordinatorConfig(budget_us_per_tick=2048.0)))
    try:
        common.load_through(srv, S, keys)
        reqs = common.closed_loop(srv, S, streams)
    finally:
        srv.shutdown()
    stats = common.stats_less_wall_time(srv.stats())
    stats["store"] = {k: v for k, v in stats["store"].items()
                      if k != "uses_shard_map"}
    out = ([common.request_record(r) + (r.epochs_served,) for r in reqs],
           stats)
    st.close()
    return out


def test_pipelined_server_over_the_mesh_matches_reference(tmp_path):
    """``PipelinedServer`` over the four-``cpu`` mesh store, with I/O pools
    of 0 and 2 workers: every request's answer, values, completion tick
    and served epochs equal the reference server's over its ``mesh=None``
    store, and no epoch violation."""
    from test_torch_pipeline import _mixed_streams
    keys = common.keys_of(4000, seed=50)
    streams = _mixed_streams(keys, 51)
    sync_file_ids()
    ref = _serve("repro", tmp_path / "r", keys, streams, 0, None)
    for w in (0, 2):
        sync_file_ids()
        port = _serve("repro_torch", tmp_path / f"p{w}", keys, streams, w,
                      cpu_mesh(4))
        assert port[0] == ref[0], w
        p = port[1]["pipeline"]
        assert p["epoch_violations"] == 0 and p["max_depth_seen"] > 1
        assert p["write_barriers"] > 0
        if w == 0:
            assert port[1] == ref[1]
        else:
            assert port[1]["store"]["n_gets"] == ref[1]["store"]["n_gets"]
            assert port[1]["io"]["submitted"] > 0


def test_example_distributed_get_on_the_cpu(capsys):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "port_distributed_get",
        os.path.join(REPO, "port", "examples", "distributed_get.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    res = mod.main(["--device", "cpu", "--shards", "4"])
    out = capsys.readouterr().out
    assert "devices=4" in out and "hit_rate=1.000" in out
    assert res["hit_rate"] == 1.0


if __name__ == "__main__":      # the reference's four-device half
    np.savez(sys.argv[1], **four_device_reference())
