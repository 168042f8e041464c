"""The port's I/O-pool determinism gate
(``port/scripts/check_io_determinism.py``) against the reference's
(``scripts/check_io_determinism.py``, loaded from its file and run
unedited), both on the CPU on the same seeds: at ``io_workers`` 0 and 4
every request's ``(rid, found, result, epochs_served)`` equal to the
reference's with no epoch violation; the gate's ``main`` passing; and its
mutation case: one GET's found flag flipped only when a pool serves makes
the gate fail, naming the pool size."""

import importlib.util
import os

import numpy as np
import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GATE = "check_io_determinism.py"


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gates():
    ref = _load(os.path.join(REPO, "scripts", GATE), "ref_gate_iodet")
    port = _load(os.path.join(REPO, "port", "scripts", GATE),
                 "port_gate_iodet")
    keys = np.random.default_rng(3).permutation(
        np.arange(1, ref.N_KEYS + 1, dtype=np.int64) * 5)
    return ref, port, keys, ref._streams(keys)


def test_gate_streams_equal_the_reference(gates):
    ref, port, keys, streams = gates
    mine = port._streams(keys)
    assert len(mine) == len(streams) == port.CLIENTS
    for a, b in zip(streams, mine):
        assert [(op, ks.tobytes()) for op, ks in a] == \
            [(op, ks.tobytes()) for op, ks in b]


@pytest.mark.parametrize("io_workers", [0, 4])
def test_gate_requests_equal_the_reference(gates, io_workers):
    ref, port, keys, streams = gates
    want, v_ref = ref._run(io_workers, keys, streams)
    got, v_port, secs = port._run(io_workers, keys, streams, "cpu")
    assert v_ref == v_port == 0
    assert len(got) == len(want) == port.CLIENTS * port.ROUNDS
    assert sum(r[1] == b"put" for r in got) == 2
    for a, b in zip(want, got):
        assert b == a, a[0]
    assert secs["load"] > 0 and secs["serve"] > 0


def test_gate_main_passes_on_the_cpu(gates, capsys):
    _, port, _, _ = gates
    assert port.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines == [f"io_workers={w}: 48 requests served, "
                     "epoch_violations=0" for w in (0, 1, 4)] + [
        "OK: io_workers (0, 1, 4) byte-identical across 48 requests"]


def test_gate_fails_when_a_pool_flips_a_found_flag(gates, monkeypatch,
                                                   capsys):
    """One GET's first found flag flipped, only on servers with a pool:
    the gate exits 1 and names the first pool size it ran."""
    from repro_torch.server.pipeline import PipelinedServer

    _, port, _, _ = gates
    orig = PipelinedServer._finish_retire
    flipped = []

    def finish(self, fl):
        out = orig(self, fl)
        if self.io is not None and not flipped:
            r = next(r for r in out if r.op == "get")
            r.found[0] = not r.found[0]
            flipped.append(r.rid)
        return out
    monkeypatch.setattr(PipelinedServer, "_finish_retire", finish)
    assert port.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert flipped
    assert (f"FAIL: io_workers=1 diverges from inline at request "
            f"{flipped[0]}") in out
    assert "OK:" not in out
