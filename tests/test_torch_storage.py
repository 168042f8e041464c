"""Durable storage in the port: the same put/delete/flush/learn/GC stream
into a repro and a repro_torch durable store writes byte-identical files,
name for name (sstables, MANIFEST, CURRENT, WAL, value-log segments,
level-model and filter sidecars), and a directory written by either
package opens in the other with identical answers.  Each store is closed
before the other package opens its directory: ``LOCK`` is flock'd."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import sstable as rsst  # noqa: E402
from repro_torch.core import sstable as psst  # noqa: E402

LSM = dict(memtable_cap=1 << 10, file_cap=1 << 11, l1_cap_records=1 << 13)


def _cfg(M, **kw):
    defaults = dict(policy="always", value_size=16, fetch_values=True,
                    lsm=M.LSMConfig(**LSM))
    defaults.update(kw)
    if M is P:
        defaults["device"] = "cpu"
    return M.StoreConfig(**defaults)


def _values_for(keys, version):
    v = np.zeros((keys.shape[0], 16), np.uint8)
    v[:, 0] = (keys % 251).astype(np.uint8)
    v[:, 1] = version % 251
    return v


def _stream(st, keys, rng, gc_log: bool):
    """Puts, GETs (which build and persist the level filters), overwrites,
    deletes, learning and, for file granularity, value-log GC."""
    for off in range(0, 12288, 4096):
        ks = keys[off: off + 4096]
        st.put_batch(ks, _values_for(ks, 0))
    st.flush_all()
    st.get_batch(np.concatenate([keys[:300], keys[:100] + 1]))
    st.learn_all()
    st.put_batch(keys[:2000], _values_for(keys[:2000], 1))
    st.delete_batch(keys[2000:2600])
    st.flush_all()
    st.get_batch(rng.choice(keys[:12288], 700))
    if gc_log:
        st.gc_value_log(min_dead_ratio=0.2)
    st.put_batch(keys[12288:12800], _values_for(keys[12288:12800], 0))


def sync_file_ids():
    """Both packages number sstables from a process-wide counter, which
    earlier tests in the same process may have moved apart; start the next
    files of both at the same id so their names and MANIFEST edits can be
    compared byte for byte."""
    n = max(rsst._next_file_id, psst._next_file_id)
    rsst.advance_file_ids(n)
    psst.advance_file_ids(n)


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        if name != "LOCK":
            with open(os.path.join(d, name), "rb") as f:
                out[name] = f.read()
    return out


def _probes(keys):
    return np.concatenate([keys[:3000], keys[12288:12800],
                           keys[:500] + 1])


def _answers(st, probes):
    f, v = st.get_batch(probes)
    return f.copy(), v.copy()


@pytest.mark.parametrize("granularity", ["file", "level"])
def test_durable_stores_write_identical_bytes_and_cross_open(tmp_path,
                                                             granularity):
    keys = np.random.default_rng(3).permutation(
        np.arange(1, 20001, dtype=np.int64) * 5)
    dirs = {}
    sync_file_ids()
    for M in (R, P):
        d = str(tmp_path / M.__name__)
        st = M.BourbonStore.open(d, _cfg(M, granularity=granularity))
        _stream(st, keys, np.random.default_rng(4),
                gc_log=granularity == "file")
        st.close()
        dirs[M] = d
    rf, pf = _files(dirs[R]), _files(dirs[P])
    assert list(pf) == list(rf)
    for name in rf:
        assert pf[name] == rf[name], name
    kinds = {n.split("-")[0] if "-" in n else n.split(".")[-1] for n in rf}
    want = {"sst", "MANIFEST", "CURRENT", "wal", "vlog", "flt"}
    if granularity == "level":
        want.add("lm")
    assert want <= kinds
    # each package opens the other's directory; both answer identically,
    # and the persisted models and filters serve without relearning
    probes = _probes(keys)
    got = {}
    for M, d in ((P, dirs[R]), (R, dirs[P])):
        st = M.BourbonStore.open(d, _cfg(M, granularity=granularity))
        assert st.stats()["files_learned"] == 0
        if granularity == "level":
            assert st.stats()["level_models_recovered"] > 0
        got[M] = _answers(st, probes)
        assert st.filters_built == 0
        st.put_batch(keys[12800:13000], _values_for(keys[12800:13000], 2))
        st.close()
    np.testing.assert_array_equal(got[P][0], got[R][0])
    np.testing.assert_array_equal(got[P][1], got[R][1])
    assert got[P][0][:2000].all() and (got[P][1][:2000, 1] == 1).all()
    assert not got[P][0][2000:2600].any()
    # ... and the writes each made in the other's directory read back
    # through the original package
    for M in (R, P):
        st = M.BourbonStore.open(dirs[M], _cfg(M, granularity=granularity))
        f, v = st.get_batch(keys[12800:13000])
        assert f.all() and (v[:, 1] == 2).all()
        st.close()
