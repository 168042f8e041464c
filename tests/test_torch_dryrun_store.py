"""The store cell's state (``launch/dryrun.store_row``) on the CPU: each
row a PLR model of many segments that misplaces its keys by up to delta,
checked through the kernels' plain versions at three sizes (the slowest
part of the dry run's checks, kept apart from ``test_torch_dryrun.py``,
whose constants it shares)."""

import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(REPO, "port"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import distributed as PD  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from test_torch_dryrun import STORE_KEYS, STORE_PROBES  # noqa: E402


@pytest.mark.parametrize("n_keys,n_rows,nseg", [
    (STORE_KEYS, 4, 64), (1 << 20, 16, 512), (1_000_003, 7, 511)])
def test_store_rows_are_piecewise_models_off_by_up_to_delta(n_keys, n_rows,
                                                           nseg):
    """Each row of the store state is a PLR model of many segments whose
    keys it misplaces by up to delta either way, with every key in its
    window and every key + 1 absent; keys rise through the rows."""
    cfg = PD.DistStoreConfig(n_keys=n_keys, probe_batch=STORE_PROBES)
    total, last, errs = 0, -1, set()
    for s in range(n_rows):
        r = dryrun.store_row(s, n_rows, cfg, torch.device("cpu"))
        n = int(r["n"][0])
        k = r["keys"][0, :n]
        assert bool((k[1:] > k[:-1]).all()) and int(k[0]) > last
        assert (int(r["lo"][0]), int(r["hi"][0])) == (int(k[0]), int(k[-1]))
        assert s or int(r["nseg"][0]) == nseg
        last, total = int(k[-1]), total + n
        rows = torch.zeros(n, dtype=torch.int32)
        tables = [r[x] for x in ("starts", "slopes", "icepts", "nseg", "n")]
        pos = kref.plr_lookup_rows_ref(*tables, rows, k)
        errs |= set((pos.long() - torch.arange(n)).tolist())
        idx, found = kref.bounded_search_rows_ref(r["keys"], r["n"], rows,
                                                 pos, k, cfg.delta)
        assert bool(found.all()) and bool((idx.long() ==
                                           torch.arange(n)).all())
        pos = kref.plr_lookup_rows_ref(*tables, rows, k + 1)
        assert not kref.bounded_search_rows_ref(r["keys"], r["n"], rows, pos,
                                               k + 1, cfg.delta)[1].any()
    assert total == n_keys
    assert errs == set(range(-cfg.delta, cfg.delta + 1))
