"""The port's examples on the CPU (``port/examples/``), each against the
facts the reference's example prints: ``quickstart.py`` prints the
reference's lines exactly (its store, data and seeds are the same), with
hit rate 1.000 and every lookup on the model path;
``serve_kv_cache.py`` serves every one of its 16 requests in the
reference's number of engine steps (the lengths of its prompts and
outputs fix them; its random weights differ); ``train_lm.py`` trains a
narrow, shallow model on the CPU and its loss falls (the reference's
example at its defaults, ~100M parameters for 200 steps, is for the
card: ``chip_smoke.py`` runs the port's there)."""

import importlib.util
import os
import runpy

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"port_example_{name}", os.path.join(REPO, "port", "examples",
                                             f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_lines(name, capsys):
    runpy.run_path(os.path.join(REPO, "examples", f"{name}.py"),
                   run_name="__main__")
    return capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_reference_lines(capsys):
    want = _reference_lines("quickstart", capsys)
    res = _example("quickstart").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert got[1].startswith("hit rate 1.000")
    assert got[3].endswith("model_path=100.0%")
    assert res["hit_rate"] == 1.0 and res["learned"] > 0


def test_serve_kv_cache_serves_every_request(capsys):
    want = _reference_lines("serve_kv_cache", capsys)
    res = _example("serve_kv_cache").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got[0] == want[0]
    assert got[0].startswith("served 16 requests in ")
    assert res["served"] == 16
    assert got[1].startswith("session store: 0 live records")


def test_train_lm_loss_falls_on_the_cpu(capsys):
    losses = _example("train_lm").main([
        "--device", "cpu", "--d-model", "64", "--layers", "2",
        "--steps", "21"])
    out = capsys.readouterr().out.splitlines()
    assert [s for s, _ in losses] == [0, 20]
    assert losses[-1][1] < losses[0][1]
    assert out[-1].startswith("loss ") and out[-1].endswith(
        "over 21 steps")


@pytest.mark.parametrize("name", ["quickstart", "serve_kv_cache",
                                  "train_lm"])
def test_examples_take_the_card_unless_asked(name, monkeypatch):
    """The default device is the card: without one, the example stops
    before it serves, stores or trains anything."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = _example(name)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
