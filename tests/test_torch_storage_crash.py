"""The crash cases of tests/test_storage_engine.py in the port — kill
without close, torn WAL tail, torn MANIFEST frame, flipped sstable byte —
recover exactly as in repro: the port kills a store, the damaged directory
is copied, and each package opens one copy; answers, clock, relearning and
the replayed memtable agree.  ``LOCK`` is flock'd, so each store is
dropped or closed before the next open."""

import gc
import os
import shutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from test_torch_storage import _answers, _cfg, _values_for  # noqa: E402


def _crashed_dir(tmp_path):
    """A port store killed without close: flushed, learned tables plus a
    WAL-only tail (two batches since the last flush)."""
    d = str(tmp_path / "db")
    st = P.BourbonStore.open(d, _cfg(P))
    keys = np.random.default_rng(7).permutation(
        np.arange(1, 8001, dtype=np.int64) * 3)
    for off in range(0, 6144, 2048):
        st.put_batch(keys[off: off + 2048], _values_for(keys[off: off + 2048],
                                                         0))
    st.flush_all()
    st.learn_all()
    st.put_batch(keys[6144:6400], _values_for(keys[6144:6400], 0))
    st.put_batch(keys[6400:6600], _values_for(keys[6400:6600], 1))
    del st                                   # KILL: no close
    gc.collect()
    return d, keys


def _tear(d, prefix, nbytes):
    name = [n for n in os.listdir(d) if n.startswith(prefix)][0]
    path = os.path.join(d, name)
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) - nbytes)


@pytest.mark.parametrize("case", ["kill", "torn_wal", "torn_manifest",
                                  "flipped_sst"])
def test_crash_cases_recover_as_in_reference(tmp_path, case):
    d, keys = _crashed_dir(tmp_path)
    if case == "torn_wal":
        _tear(d, "wal-", 7)                  # the last batch is lost
    elif case == "torn_manifest":
        name = [n for n in os.listdir(d) if n.startswith("MANIFEST-")][0]
        with open(os.path.join(d, name), "ab") as f:   # a torn frame
            f.write(b"\x13\x37torn-frame-garbage")
    elif case == "flipped_sst":
        name = sorted(n for n in os.listdir(d) if n.endswith(".sst"))[0]
        path = os.path.join(d, name)
        with open(path, "r+b") as f:
            f.seek(200)
            b = f.read(1)
            f.seek(200)
            f.write(bytes([b[0] ^ 0xFF]))
    d2 = str(tmp_path / "db_ref")
    shutil.copytree(d, d2)
    if case == "flipped_sst":
        for M, dd in ((P, d), (R, d2)):
            with pytest.raises(ValueError, match="checksum"):
                M.BourbonStore.open(dd, _cfg(M))
        return
    probes = np.concatenate([keys[:6600], keys[:400] + 1])
    got = {}
    for M, dd in ((P, d), (R, d2)):
        st = M.BourbonStore.open(dd, _cfg(M))
        got[M] = (_answers(st, probes), st.clock.now,
                  st.stats()["files_learned"], len(st.memtable))
        st.close()
    (pa, pclock, plearned, pmt), (ra, rclock, rlearned, rmt) = \
        got[P], got[R]
    np.testing.assert_array_equal(pa[0], ra[0])
    np.testing.assert_array_equal(pa[1], ra[1])
    assert (pclock, plearned, pmt) == (rclock, rlearned, rmt)
    assert pa[0][:6144].all()
    assert not pa[0][6600:][~np.isin(keys[:400] + 1, keys)].any()
    tail = pa[0][6400:6600]
    if case == "torn_wal":
        assert not tail.any() and pa[0][6144:6400].all()
    else:
        assert tail.all() and (pa[1][6400:6600, 1] == 1).all()
    if case == "torn_manifest":
        # a session that writes through the repaired manifest, then a
        # third that must see both sessions' data
        more = np.arange(10_001, 13_001, dtype=np.int64) * 3 + 1
        st = P.BourbonStore.open(d, _cfg(P))
        st.put_batch(more, _values_for(more, 4))
        st.flush_all()
        st.close()
        st = P.BourbonStore.open(d, _cfg(P))
        assert _answers(st, np.concatenate([keys[:6600], more]))[0].all()
        st.close()
