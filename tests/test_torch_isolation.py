"""The port stands alone: importing every module of ``repro_torch`` loads
neither ``jax`` nor ``repro``; no source under ``port/`` (nor
``chip_smoke.py``) imports them; and the default store and value logs,
which run on the card, refuse to start without one instead of falling back
to the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "port"))

import pytest  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import BourbonStore, StoreConfig  # noqa: E402
from repro_torch.core.engine import EngineConfig, LookupEngine  # noqa: E402
from repro_torch.core.valuelog import ValueLog  # noqa: E402
from repro_torch.storage import DurableValueLog  # noqa: E402

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = os.path.join(REPO, "port")
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _port_modules():
    mods = []
    for dirpath, _, files in os.walk(os.path.join(PORT, "repro_torch")):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), PORT)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[: -len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return mods


def test_importing_every_module_loads_no_jax_or_repro():
    mods = _port_modules()
    assert "repro_torch.core.engine" in mods and len(mods) >= 18
    assert {"repro_torch.obs", "repro_torch.obs.registry",
            "repro_torch.obs.tracer", "repro_torch.obs.trace",
            "repro_torch.obs.export", "repro_torch.server",
            "repro_torch.server.admission", "repro_torch.server.cache",
            "repro_torch.server.coordinator", "repro_torch.server.frontend",
            "repro_torch.server.pipeline",
            "repro_torch.core.workloads", "repro_torch.core.mesh",
            "repro_torch.core.distributed", "repro_torch.analysis",
            "repro_torch.analysis.core", "repro_torch.analysis.hotsync",
            "repro_torch.analysis.durorder", "repro_torch.analysis.pairing",
            "repro_torch.analysis.obsdrift",
            "repro_torch.analysis.deadmod", "repro_torch.serving",
            "repro_torch.serving.session_store", "repro_torch.serving.engine",
            "repro_torch.models", "repro_torch.models.config",
            "repro_torch.models.layers", "repro_torch.models.attention",
            "repro_torch.models.moe", "repro_torch.models.ssm",
            "repro_torch.models.blocks", "repro_torch.models.model",
            "repro_torch.configs", "repro_torch.configs.base",
            "repro_torch.configs.qwen2_0_5b", "repro_torch.launch",
            "repro_torch.launch.serve", "repro_torch.launch.steps",
            "repro_torch.launch.train", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding", "repro_torch.launch.inputs",
            "repro_torch.launch.elastic", "repro_torch.launch.plan",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.launch.spmd",
            "repro_torch.optim",
            "repro_torch.optim.adamw", "repro_torch.optim.schedule",
            "repro_torch.optim.grad_compress", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.checkpoint",
            "repro_torch.checkpoint.ckpt", "repro_torch.train",
            "repro_torch.train.trainer"} <= set(mods)
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.path.insert(0, {PORT!r})
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in {sorted(FORBIDDEN)!r})
        print(",".join(bad))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


def test_no_source_imports_jax_or_repro():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, dirs, files in os.walk(PORT):
        if dirpath == PORT and "build" in dirs:
            dirs.remove("build")           # build output, not source
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    assert len(paths) > 10
    assert os.path.join(PORT, "examples", "distributed_get.py") in paths
    assert os.path.join(PORT, "scripts", "lint.py") in paths
    for p in paths:
        bad = FORBIDDEN.intersection(_imports(p))
        assert not bad, f"{p} imports {bad}"


def test_sharded_serve_ranks_import_no_jax_or_repro():
    """The ranks of ``test_torch_sharded_serve.py`` import that module
    (for its rank body) and the port's process launcher: no JAX may load
    in them, so the module imports it only inside its reference side."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.join(REPO, "tests")!r})
        import test_torch_sharded_serve
        from repro_torch.launch import spmd
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in {sorted(FORBIDDEN)!r})
        print(",".join(bad))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_sharded_moe_ranks_import_no_jax_or_repro():
    """The same for ``test_torch_sharded_moe.py``'s ranks, which import
    that module and, through it, ``test_torch_sharded_serve``."""
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {os.path.join(REPO, "tests")!r})
        import test_torch_sharded_moe
        from repro_torch.launch import spmd
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in {sorted(FORBIDDEN)!r})
        print(",".join(bad))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_default_store_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BourbonStore(StoreConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        LookupEngine(EngineConfig())
    assert StoreConfig().engine.device == "cuda"
    assert BourbonStore(StoreConfig(device="cpu")).engine.device.type == "cpu"


def test_value_logs_need_a_card(monkeypatch, tmp_path):
    """The value logs take the card by default, as every other entry point
    of the port does, and refuse without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ValueLog()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DurableValueLog(8, str(tmp_path))
    assert ValueLog(device="cpu").device.type == "cpu"


def test_gates_import_no_jax_or_repro():
    """The port's correctness gates (``port/scripts/check_*.py``) load
    neither JAX nor the reference when imported, as ``chip_smoke.py``
    imports them on the card."""
    gates = sorted(f for f in os.listdir(os.path.join(PORT, "scripts"))
                   if f.startswith("check_") and f.endswith(".py"))
    assert gates == ["check_filter_zero_fn.py", "check_io_determinism.py"]
    code = textwrap.dedent(f"""
        import importlib.util, os, sys
        for f in {gates!r}:
            path = os.path.join({os.path.join(PORT, "scripts")!r}, f)
            spec = importlib.util.spec_from_file_location(f[:-3], path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            assert callable(mod.main) and callable(mod.gate)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in {sorted(FORBIDDEN)!r})
        print(",".join(bad))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_ci_script_parses_and_names_existing_paths():
    """``bash -n port/ci.sh`` passes, and every repo path the script names
    (its commands' and its comments') exists."""
    import glob
    import re

    ci = os.path.join(PORT, "ci.sh")
    subprocess.run(["bash", "-n", ci], check=True, timeout=30)
    text = open(ci).read()
    paths = set(re.findall(r"\b((?:port|tests|scripts|src|benchmarks)/"
                           r"[\w./*-]*[\w*/])", text))
    assert {"port/scripts/lint.py", "port/mypy.ini",
            "port/scripts/check_io_determinism.py",
            "port/scripts/check_filter_zero_fn.py",
            "tests/test_torch_kernels_cuda.py",
            "tests/test_torch_*.py"} <= paths
    for p in sorted(paths):
        assert glob.glob(os.path.join(REPO, p)), p
