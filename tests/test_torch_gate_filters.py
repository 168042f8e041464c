"""The port's filter-plane gate (``port/scripts/check_filter_zero_fn.py``)
against the reference's (``scripts/check_filter_zero_fn.py``, loaded from
its file and run unedited), both on the CPU on the same seeds: every
request's found and value bytes in each arm equal, the same keys screened
ahead of dispatch (1,081 on this workload), no filter rebuilt when either
durable store reopens, the same printed lines and exit status; and the
gate's mutation case: one present key's maybe bit cleared in the host
screen makes the port's gate fail, naming a false negative."""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GATE = "check_filter_zero_fn.py"
ARMS = ("filters-off", "filters-on", "filters-on-reopened")


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    """The reference gate's run: its exit status, its printed lines and,
    arm by arm, each request's bytes and the store's filter counters."""
    mod = _load(os.path.join(REPO, "scripts", GATE), "ref_gate_filters")
    arms = []
    orig = mod._run

    def recorded(st, reqs):
        built = st.filters_built
        out = orig(st, reqs)
        arms.append({"answers": out, "filters_built": built,
                     "filter_screened": st.filter_screened})
        return out
    mod._run = recorded
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main()
    return {"rc": rc, "lines": buf.getvalue().splitlines(),
            "arms": dict(zip(ARMS, arms))}


@pytest.fixture(scope="module")
def port():
    mod = _load(os.path.join(REPO, "port", "scripts", GATE),
                "port_gate_filters")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, rec = mod.gate("cpu")
    return {"rc": rc, "rec": rec, "lines": buf.getvalue().splitlines(),
            "mod": mod}


def test_gate_answers_equal_the_reference(ref, port):
    assert ref["rc"] == 0 and port["rc"] == 0
    for arm in ARMS:
        want = ref["arms"][arm]["answers"]
        got = port["rec"]["answers"][arm]
        assert len(got) == len(want) == port["rec"]["requests"] == 10
        for i, ((f0, v0), (f1, v1)) in enumerate(zip(want, got)):
            assert f1 == f0, (arm, i)
            assert v1 == v0, (arm, i)


def test_gate_screens_as_the_reference(ref, port):
    rec = port["rec"]
    assert rec["filter_screened"] == \
        ref["arms"]["filters-on"]["filter_screened"] == 1081
    assert rec["probes"] == 3328
    assert 0 < rec["filter_host_answered"] < rec["probes"]
    assert rec["filters_built"] > 0
    assert set(rec["levels_pruned"]) == set(ARMS)


def test_gate_reopen_rebuilds_no_filter(ref, port):
    assert ref["arms"]["filters-on-reopened"]["filters_built"] == 0
    assert port["rec"]["filters_rebuilt_on_reopen"] == 0


def test_gate_prints_the_reference_lines(ref, port):
    mine = [ln for ln in port["lines"] if not ln.startswith("readings: ")]
    assert mine == ref["lines"]
    assert ref["lines"][-1] == \
        "OK: filter plane zero-false-negative across 3328 probes"


def test_gate_cli_on_the_cpu(ref):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "port", "scripts", GATE),
         "--device", "cpu"], capture_output=True, text=True, env=env,
        timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = [ln for ln in out.stdout.splitlines()
             if not ln.startswith("readings: ")]
    assert lines == ref["lines"]


def test_gate_fails_on_a_cleared_maybe_bit(port, monkeypatch, capsys):
    """One present key's maybe bits cleared in the host screen (the call
    in ``BourbonStore.dispatch_get``) is a false negative: exit 1."""
    import repro_torch.core.store as store

    mod = port["mod"]
    keys = np.random.default_rng(3).permutation(
        np.arange(1, mod.N_KEYS + 1, dtype=np.int64) * 4)
    present = set(keys.tolist()) - set(keys[::16].tolist())
    orig = store.filter_maybe_np
    cleared = []

    def screen(filters, probes):
        maybe = orig(filters, probes)
        if not cleared:
            for i, k in enumerate(probes.tolist()):
                if k in present:
                    maybe[:, i] = False
                    cleared.append(k)
                    break
        return maybe
    monkeypatch.setattr(store, "filter_maybe_np", screen)
    assert mod.main(["--device", "cpu"]) == 1
    assert len(cleared) == 1
    out = capsys.readouterr().out
    assert "false negative" in out and "OK:" not in out
