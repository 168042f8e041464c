"""Port cases of ``tests/test_substrates.py`` for the training substrate:
the data pipeline (equal to the reference's, step for step and host for
host), checkpoints (round trip, commit protocol, bf16 and the dtype
check that the reference lacks, a checkpoint the reference wrote), the
fault-tolerant restart as a real process on the CPU, the launcher, and
int8 gradient compression."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_training import flat, np_tree
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.configs import get_smoke_config as jget_smoke  # noqa: E402
from repro.core.jaxcompat import make_mesh as jmake_mesh  # noqa: E402
from repro.core.jaxcompat import shard_map  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import grad_compress as jgc  # noqa: E402
from repro_torch.checkpoint.ckpt import (AsyncSaver, latest_step,  # noqa: E402
                                         restore, save)
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.convert import (opt_state_from_numpy,  # noqa: E402
                                 params_from_numpy)
from repro_torch.core.mesh import make_mesh  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, HostDataLoader,  # noqa: E402
                                       TokenDataset, synthetic_tokens)
from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                               compressed_psum, dequantize_int8,
                               quantize_int8)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


# ------------------------------------------------------------------- data

def test_data_equals_the_reference_step_for_step_and_host_for_host():
    assert np.array_equal(synthetic_tokens(50_000, 997, seed=3),
                          jpipe.synthetic_tokens(50_000, 997, seed=3))
    toks = synthetic_tokens(60_000, 500)
    ds = TokenDataset(toks, DataConfig(seq_len=32, global_batch=8, seed=5))
    jds = jpipe.TokenDataset(toks, jpipe.DataConfig(seq_len=32,
                                                    global_batch=8, seed=5))
    for step in (0, 1, 7, 250, 400):        # 400 wraps into epoch 1
        for n_hosts in (1, 2, 4, 8):
            for host in range(n_hosts):
                got = ds.batch_for_step(step, host, n_hosts)
                want = jds.batch_for_step(step, host, n_hosts)
                assert all(np.array_equal(a, b) for a, b in zip(got, want))
    loader = HostDataLoader(ds, host=1, n_hosts=2, start_step=3)
    try:
        for step in range(3, 7):
            s, (t, lab) = next(loader)
            assert s == step
            assert np.array_equal(t, jds.batch_for_step(step, 1, 2)[0])
            assert np.array_equal(lab, jds.batch_for_step(step, 1, 2)[1])
    finally:
        loader.close()


def test_data_deterministic_and_host_sharded():
    ds = TokenDataset(synthetic_tokens(100_000, 1000),
                      DataConfig(seq_len=64, global_batch=8))
    a1, l1 = ds.batch_for_step(7, host=0, n_hosts=4)
    a2, _ = ds.batch_for_step(7, host=0, n_hosts=4)
    np.testing.assert_array_equal(a1, a2)
    assert a1.shape == (2, 64)
    np.testing.assert_array_equal(a1[:, 1:], l1[:, :-1])
    rows = [ds.batch_for_step(7, h, 4)[0] for h in range(4)]
    assert np.concatenate(rows).shape == (8, 64)
    t_all = np.concatenate([ds.batch_for_step(3, h, 4)[0] for h in range(4)])
    t_again = np.concatenate([ds.batch_for_step(3, h, 8)[0]
                              for h in range(8)])
    np.testing.assert_array_equal(t_all, t_again)


# --------------------------------------------------------------- checkpoint

def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)},
            "s": torch.tensor(3, dtype=torch.int32)}
    save(tree, tmp_path, 3)
    like = {"a": torch.zeros(3, 4), "b": {"c": torch.zeros(5,
                                                           dtype=torch.int32)},
            "s": torch.tensor(0, dtype=torch.int32)}
    got, step = restore(like, tmp_path, None)
    assert step == 3
    for name, t in flat(tree).items():
        assert torch.equal(flat(got)[name], t)
    man = json.loads((tmp_path / "step_00000003" / "manifest.json"
                      ).read_text())
    assert man["leaves"]["b.c"] == {"file": "b.c__full.npy", "shape": [5],
                                    "dtype": "int32"}


def test_async_checkpoint_and_commit_protocol(tmp_path):
    saver = AsyncSaver()
    w = torch.ones(100, 100)
    saver.save_async({"w": w}, tmp_path, 1)
    w.add_(1.0)                  # after the snapshot: not in the checkpoint
    saver.wait()
    assert latest_step(tmp_path) == 1
    got, _ = restore({"w": torch.zeros(100, 100)}, tmp_path)
    assert bool((got["w"] == 1).all())
    d = tmp_path / "step_00000005"
    d.mkdir()
    (d / "w__full.npy").write_bytes(b"junk")
    assert latest_step(tmp_path) == 1   # no manifest -> not committed
    assert latest_step(tmp_path / "absent") is None
    with pytest.raises(FileNotFoundError):
        restore({"w": w}, tmp_path / "absent")


def test_bf16_tree_saves_and_restores_bit_for_bit(tmp_path):
    """The reference writes bf16 as ``|V2`` and cannot read it back; the
    port writes the 16-bit pattern and records "bfloat16"."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(37, 19, generator=g).to(torch.bfloat16)
    w[0, :4] = torch.tensor([float("inf"), float("-inf"), -0.0, 1e-40])
    tree = {"p": {"w": w}, "o": {"m": torch.randn(37, 19, generator=g),
                                 "step": torch.tensor(9, dtype=torch.int32)}}
    save(tree, tmp_path, 9)
    man = json.loads((tmp_path / "step_00000009" / "manifest.json"
                      ).read_text())
    assert man["leaves"]["p.w"]["dtype"] == "bfloat16"
    like = {"p": {"w": torch.zeros(37, 19, dtype=torch.bfloat16)},
            "o": {"m": torch.zeros(37, 19),
                  "step": torch.tensor(0, dtype=torch.int32)}}
    got, _ = restore(like, tmp_path, 9)
    assert got["p"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["p"]["w"].view(torch.int16), w.view(torch.int16))
    assert torch.equal(got["o"]["m"], tree["o"]["m"])


def test_dtype_or_shape_mismatch_raises(tmp_path):
    save({"w": torch.ones(4, 4, dtype=torch.bfloat16)}, tmp_path, 1)
    with pytest.raises(ValueError, match="dtype bfloat16"):
        restore({"w": torch.zeros(4, 4)}, tmp_path, 1)
    with pytest.raises(ValueError, match="shape"):
        restore({"w": torch.zeros(4, 5, dtype=torch.bfloat16)}, tmp_path, 1)
    with pytest.raises(ValueError, match="not in the checkpoint"):
        restore({"v": torch.zeros(4, 4, dtype=torch.bfloat16)}, tmp_path, 1)


def test_restores_what_the_reference_wrote(tmp_path):
    """A trainer's tree saved by the reference (f32, the smoke config, and
    a bf16 leaf in the reference's ``|V2`` form) restores into the port's
    tree of the same names, every leaf equal."""
    jcfg = jget_smoke("qwen2-0.5b")
    cfg = get_smoke_config("qwen2-0.5b")
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    jo = jadamw_init(jp, JAdamWConfig())
    jo["step"] = jnp.asarray(4, jnp.int32)
    jckpt.save({"p": jp, "o": jo}, tmp_path, 4)
    params = params_from_numpy(np_tree(jax.tree.map(jnp.zeros_like, jp)),
                               cfg, "cpu")
    opt = adamw_init(params, AdamWConfig())
    got, step = restore({"p": params.tree(), "o": opt}, tmp_path)
    assert step == 4 and int(got["o"]["step"]) == 4
    want = flat(np_tree({"p": jp, "o": jo}))
    for name, t in flat(got).items():
        assert np.array_equal(t.numpy(), want[name]), name
    bf = jnp.arange(-6, 6, dtype=jnp.bfloat16).reshape(3, 4) / 3
    jckpt.save({"w": bf}, tmp_path / "bf", 1)
    got, _ = restore({"w": torch.zeros(3, 4, dtype=torch.bfloat16)},
                     tmp_path / "bf", 1)
    assert np.array_equal(got["w"].float().numpy(),
                          np.asarray(bf.astype(jnp.float32)))


def test_opt_state_from_numpy_checks_its_tree():
    jcfg = jget_smoke("qwen2-0.5b")
    cfg = get_smoke_config("qwen2-0.5b")
    jp = jmodel.init_params(jcfg, jax.random.key(0))
    jo = np_tree(jadamw_init(jp, JAdamWConfig()))
    st = opt_state_from_numpy(jo, cfg, "cpu")
    assert st["step"].dtype == torch.int32 and set(st) == set(jo)
    jo["m"]["embed"] = jo["m"]["embed"][:, :3]
    with pytest.raises(ValueError, match="m/embed"):
        opt_state_from_numpy(jo, cfg, "cpu")
    with pytest.raises(ValueError, match="optimizer state keys"):
        opt_state_from_numpy({"m": {}}, cfg, "cpu")


# -------------------------------------------------------- fault tolerance

TRAIN = textwrap.dedent("""
    import sys
    sys.path.insert(0, {port!r})
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import (DataConfig, TokenDataset,
                                           synthetic_tokens)
    from repro_torch.train.trainer import Trainer, TrainerConfig
    from repro_torch.launch.steps import TrainConfig
    cfg = get_smoke_config("qwen2-0.5b")
    ds = TokenDataset(synthetic_tokens(200_000, cfg.vocab),
                      DataConfig(seq_len=32, global_batch=4, vocab=cfg.vocab))
    tc = TrainerConfig(steps=16, ckpt_every=4, ckpt_dir={ckpt!r},
                       fail_at_step={fail}, log_every=4,
                       train=TrainConfig(remat="none"))
    out = Trainer(cfg, tc, ds, device="cpu").run()
    print("FINAL", out["losses"][-1][0], out["losses"][0][0])
""")


def test_fault_tolerant_restart(tmp_path):
    """Kill a real training process mid-run; the restart resumes from the
    last committed checkpoint and finishes."""
    ckpt = str(tmp_path / "ck")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}

    def run(fail):
        code = TRAIN.format(port=os.path.join(REPO, "port"), ckpt=ckpt,
                            fail=fail)
        return subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, cwd=REPO,
                              env=env, timeout=600)

    r1 = run(10)
    assert r1.returncode != 0 and "injected failure at step 10" in r1.stderr
    assert latest_step(ckpt) == 8        # step 4's and 8's committed
    r2 = run(None)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "FINAL 15 12" in r2.stdout    # resumed at 9, logged 12 and 15
    assert latest_step(ckpt) == 15


def test_train_launcher_runs_and_resumes(tmp_path, capsys):
    from repro_torch.launch import train
    argv = ["--smoke", "--device", "cpu", "--steps", "6", "--seq", "16",
            "--batch", "2", "--ckpt-dir", str(tmp_path)]
    out = train.main(argv)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("step 0: loss ") and "step 5: loss" in line
    assert latest_step(tmp_path) == 5 and out["losses"][-1][0] == 5
    out = train.main(argv + ["--steps", "8", "--resume"])
    assert [s for s, _ in out["losses"]] == [7]
    assert latest_step(tmp_path) == 7


def test_trainer_takes_the_card_unless_asked(monkeypatch, tmp_path):
    from repro_torch.train.trainer import Trainer, TrainerConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ds = TokenDataset(synthetic_tokens(1000, 512),
                      DataConfig(seq_len=8, global_batch=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(get_smoke_config("qwen2-0.5b"),
                TrainerConfig(ckpt_dir=str(tmp_path)), ds)
    from repro_torch.launch import train
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--ckpt-dir", str(tmp_path)])


# -------------------------------------------------------------- compression

def test_int8_quantization_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(10_240) * 3.0
                          ).astype(np.float32))
    q, s = quantize_int8(x)
    y = dequantize_int8(q, s, x.shape, x.dtype)
    blockmax = np.abs(x.numpy()).reshape(-1, 256).max(axis=1)
    tol = (blockmax / 127.0 * 0.51 + 1e-6).repeat(256)
    assert (np.abs(y.numpy() - x.numpy()) <= tol).all()


@pytest.mark.parametrize("n", [10_240, 1000, 3])
def test_round_to_nearest_equals_the_reference(n):
    """generator=None rounds half to even, as jnp.round: q and scale equal
    the reference's bit for bit, padding and ties included."""
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 2.0).astype(np.float32)
    x[: min(n, 8)] = np.float32(0.5) * np.arange(min(n, 8))
    jq, js = jgc.quantize_int8(jnp.asarray(x))
    q, s = quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    y = dequantize_int8(q, s, (n,), torch.float32)
    assert np.array_equal(y.numpy(), np.asarray(jgc.dequantize_int8(
        jq, js, (n,), jnp.float32)))


def test_stochastic_rounding_unbiased():
    x = torch.full((256,), 0.3)
    g = torch.Generator().manual_seed(0)
    outs = [dequantize_int8(*quantize_int8(x, generator=g), x.shape,
                            x.dtype).numpy() for _ in range(200)]
    est = np.mean(outs)
    assert abs(est - 0.3) < 0.005, est
    x = torch.linspace(-1.0, 1.0, 256)
    a, b = (quantize_int8(x, generator=g)[0] for _ in range(2))
    assert not torch.equal(a, b)          # each call draws anew


def test_compressed_psum_on_one_piece_matches_the_reference():
    from jax.sharding import PartitionSpec as P
    x = np.random.default_rng(1).standard_normal((4, 256)).astype(np.float32)
    jmesh = jmake_mesh((1,), ("pod",), axis_type="Explicit")
    want = shard_map(lambda xs: jgc.compressed_psum(xs, "pod"), mesh=jmesh,
                     in_specs=P("pod"), out_specs=P("pod"))(jnp.asarray(x))
    mesh = make_mesh((1,), ("pod",), devices=["cpu"])
    (got,) = compressed_psum([torch.from_numpy(x)], mesh, "pod")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.abs(got.numpy() - x).max() < np.abs(x).max() / 127 + 1e-5


def test_compressed_psum_over_four_pieces_is_the_int8_formula():
    """Four CPU devices on the axis (a (2, 4) mesh summed over its second
    axis): each device gets dequant(clip(sum q_i, ±127·4), mean s_i) of its
    row's four pieces."""
    rng = np.random.default_rng(2)
    xs = [rng.standard_normal((3, 200)).astype(np.float32) * (i + 1)
          for i in range(8)]           # scales differ piece to piece
    mesh = make_mesh((2, 4), ("data", "pod"), devices=["cpu"] * 8)
    out = compressed_psum([torch.from_numpy(x) for x in xs], mesh, "pod")
    assert len(out) == 8
    for row in range(2):
        group = xs[row * 4: (row + 1) * 4]
        qs, ss = zip(*(quantize_int8(torch.from_numpy(x)) for x in group))
        qsum = sum(q.numpy().astype(np.int32) for q in qs)
        scale = sum(s.numpy() for s in ss) / 4
        want = (np.clip(qsum, -508, 508).astype(np.float32) * scale
                ).reshape(-1)[:600].reshape(3, 200)
        for i in range(row * 4, (row + 1) * 4):
            assert out[i].shape == (3, 200) and out[i].dtype == torch.float32
            np.testing.assert_allclose(out[i].numpy(), want, rtol=1e-6,
                                       atol=1e-6)
    with pytest.raises(ValueError, match="no axis"):
        compressed_psum(xs, mesh, "model")
