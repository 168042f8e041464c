"""The port's bourbonlint (``repro_torch.analysis``) against its fixtures
and against the reference's rules.

Port cases of test_analysis.py with torch snippets: HOTSYNC fires on each
torch sink and stays quiet on host numpy, ``torch.from_numpy``, the
designated sync points and the host scalars beside device tensors; the
reference's three JITDISC cases become HOTSYNC truthiness cases inside
``_lookup_impl``.  Parity: on the reference's own fixture snippets,
placed under the matching ``repro_torch/`` scope, DURORDER, PAIRING and
OBSDRIFT give the same (rule, line, col, message, symbol) as
``repro.analysis``, and suppressions and the baseline round-trip give the
same counts.  Repo level: ``port/repro_torch`` lints clean against the
empty port baseline, its dead-module report is empty, DURORDER visits the
port's storage files and OBSDRIFT reads the port's own declarations."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

HERE = os.path.dirname(__file__)
sys.path.insert(0, os.path.join(HERE, "..", "port"))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

import repro.analysis as ref_analysis  # noqa: E402
import repro_torch.analysis as port_analysis  # noqa: E402
from repro.analysis.durorder import DurabilityOrderRule as RefDurOrder  # noqa: E402
from repro.analysis.hotsync import HotSyncRule as RefHotSync  # noqa: E402
from repro.analysis.obsdrift import ObsDriftRule as RefObsDrift  # noqa: E402
from repro.analysis.pairing import PairingRule as RefPairing  # noqa: E402
from repro_torch.analysis import (ALL_RULES, SUPPRESS, apply_baseline,  # noqa: E402
                                  dead_module_report, default_rules,
                                  load_baseline, make_baseline, run_lint,
                                  save_baseline)
from repro_torch.analysis.core import SourceFile  # noqa: E402
from repro_torch.analysis.durorder import DurabilityOrderRule  # noqa: E402
from repro_torch.analysis.hotsync import HotSyncRule  # noqa: E402
from repro_torch.analysis.obsdrift import (ObsDriftRule,  # noqa: E402
                                          _tables_from_readme)
from repro_torch.analysis.pairing import PairingRule  # noqa: E402

import test_analysis as ref_fixtures  # noqa: E402

REPO = os.path.abspath(os.path.join(HERE, ".."))
PORT_BASELINE = os.path.join(REPO, "port", ".bourbonlint-baseline.json")


def lint_snippet(tmp_path, code, rules, name="snip.py", subdir="",
                 runner=run_lint):
    d = tmp_path / subdir if subdir else tmp_path
    d.mkdir(parents=True, exist_ok=True)
    p = d / name
    p.write_text(textwrap.dedent(code))
    return runner([str(p)], rules, root=str(tmp_path))


def _hot(fs):
    return [f for f in fs if f.rule == "HOTSYNC"]


# ------------------------------------------------------------------ HOTSYNC

# one snippet per torch sink, each inside a registered hot function; the
# expected message fragment
HOTSYNC_SINKS = {
    "item": ("n = dev.sum().item()", ".item()"),
    "cpu": ("host = dev.cpu()", ".cpu()"),
    "numpy": ("host = dev.numpy()", ".numpy()"),
    "tolist": ("xs = dev.tolist()", ".tolist()"),
    "nonzero": ("idx = dev.nonzero()", ".nonzero()"),
    "torch_nonzero": ("idx = torch.nonzero(dev)", "torch.nonzero()"),
    "np_asarray": ("host = np.asarray(dev)", "np.asarray()"),
    "np_array": ("host = np.array(dev)", "np.array()"),
    "int": ("n = int(dev.sum())", "int()"),
    "float": ("x = float(dev.max())", "float()"),
    "bool": ("b = bool(dev.any())", "bool()"),
    "if": ("if dev.any():\n                return 1", "if/while test"),
    "while": ("while (dev > 0).all():\n                dev = dev - 1",
              "if/while test"),
    "ifexp": ("x = 1 if dev.sum() > 0 else 2", "conditional expression"),
    "cuda_synchronize": ("torch.cuda.synchronize()",
                         "torch.cuda.synchronize()"),
    "event_synchronize": ("ev = torch.cuda.Event()\n            ev.record()"
                          "\n            ev.synchronize()",
                          ".synchronize()"),
    "stream_synchronize": ("torch.cuda.current_stream().synchronize()",
                           ".synchronize()"),
    "to_device": ("host = int(torch.from_numpy(a).to(self.device, "
                  "non_blocking=True)[0])", "int()"),
    "to_cpu": ("host = dev.to('cpu')", ".to('cpu')"),
    "pageable_to": ("up = torch.from_numpy(a).to(self.device)",
                    ".to() of a host tensor"),
    "pageable_cuda": ("up = torch.from_numpy(a).cuda()",
                      ".cuda() of a host tensor"),
    "tensor_upload": ("up = torch.tensor([1, 2], device='cuda')",
                      "torch.tensor(..., device=)"),
    "as_tensor_upload": ("up = torch.as_tensor(a, device=self.device)",
                         "torch.as_tensor(..., device=)"),
    "ops_wrapper": ("pos = ops.plr_lookup(*t)\n            n = int(pos[0])",
                    "int()"),
    "producer": ("pb = self.engine.lookup_async(s, p, 'model')\n"
                 "            n = int(pb.found.sum())", "int()"),
}


def _sink_snippet(sink: str) -> str:
    return f"""
    import numpy as np, torch
    from repro_torch.kernels import ops

    class PipeServer:
        def tick(self, a, t, s, p):
            dev = torch.zeros((8,), device="cuda")
            {HOTSYNC_SINKS[sink][0]}
    """


@pytest.mark.parametrize("sink", list(HOTSYNC_SINKS))
def test_hotsync_fires_on_each_torch_sink(tmp_path, sink):
    fragment = HOTSYNC_SINKS[sink][1]
    hot = _hot(lint_snippet(tmp_path, _sink_snippet(sink), [HotSyncRule()]))
    assert len(hot) == 1, [f.render() for f in hot]
    assert fragment in hot[0].message
    assert hot[0].symbol == "PipeServer.tick"


def test_reference_hotsync_is_blind_to_torch_sinks(tmp_path):
    """Why the rule is retargeted: the reference's HOTSYNC, whose sinks
    and device values are JAX's, sees none of torch's blocking calls."""
    for sink in ("cpu", "tolist", "nonzero", "bool", "if", "while", "int",
                 "cuda_synchronize", "event_synchronize"):
        assert lint_snippet(tmp_path, _sink_snippet(sink), [RefHotSync()],
                            name=f"{sink}.py",
                            runner=ref_analysis.run_lint) == [], sink


HOTSYNC_QUIET = {
    "host_numpy": """
    import numpy as np, torch

    class PipeServer:
        def tick(self, batch):
            keys = np.asarray(batch.keys)     # host numpy: fine
            n = int(keys.sum())               # host coercion: fine
            if keys.any():                    # host truthiness: fine
                keys = keys.tolist()
            return self.store.resolve_get(self.store.dispatch_get(keys))
    """,
    "from_numpy": """
    import numpy as np, torch

    class PipeServer:
        def tick(self, batch):
            t = torch.from_numpy(np.zeros(4, np.int64))   # a host tensor
            n = int(t.sum()) + int(t.to(torch.int32)[0])
            if t.is_pinned() or t.shape[0] > 2 or t.device.type == "cpu":
                n += 1
            return n
    """,
    "async_upload": """
    import numpy as np, torch

    def upload(a, device):
        # pinned + non_blocking, a dtype cast, a copy between cards and a
        # host constructor on the CPU: none waits for the stream
        t = torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
        c = torch.from_numpy(a).cuda(non_blocking=True)
        u = t.to(torch.int32).to(torch.device("cuda", 1))
        return t, c, u, torch.tensor([1], device="cpu")
    """,
    "resolve_closure": """
    import numpy as np

    class ShardedStore:
        def resolve_get_async(self, pb):
            found, vptr = pb.found, pb.vptr

            def task():
                # the designated sync point may transfer its pending arg,
                # through method chains and names bound from it
                if isinstance(pb.v_dev, tuple):
                    v2 = np.concatenate([v.cpu().numpy() for v in pb.v_dev])
                    vptr[pb.miss] = v2
                elif pb.f_dev is not None:
                    f2 = pb.f_dev.cpu().numpy()[:pb.n_miss]
                    found[pb.miss] = f2
                    vptr[pb.miss] = np.asarray(pb.v_dev)[:pb.n_miss]
            return task
    """,
    "pending_resolve": """
    class PendingLookup:
        def resolve(self):
            # the pending lookup's own tensors are the payload
            return (self.found.cpu().numpy(), self.vptr.cpu().numpy(),
                    None if self.values is None
                    else self.values.cpu().numpy())
    """,
    "host_scalars": """
    import torch

    class LookupEngine:
        def _lookup_impl(self, state, probes, mode: str, live: tuple):
            for li in range(len(state.levels)):
                lv = state.levels[li]
                for s in range(lv.n_files):     # host int beside tensors
                    probes = probes + s
                lm = state.level_models[li]
                if mode == "level" and lm.n_seg > 0:   # host copy of nseg
                    probes = probes + 1
            return probes

        def _probe_split(self, state, mode: str, pos_counts, neg_counts):
            tot = pos_counts[0].sum()
            return tot if state.level_models[1].n_seg > 0 else \\
                torch.zeros_like(tot)
    """,
}


@pytest.mark.parametrize("case", list(HOTSYNC_QUIET))
def test_hotsync_quiet(tmp_path, case):
    fs = lint_snippet(tmp_path, HOTSYNC_QUIET[case], [HotSyncRule()])
    assert _hot(fs) == [], [f.render() for f in fs]


def test_hotsync_host_attrs_are_what_keeps_n_seg_quiet(tmp_path):
    """Without ``n_seg``/``n_files`` in the host attributes the same
    snippet fires three times: the lines are quiet because the rule knows
    them, not because it is blind to them."""
    rule = HotSyncRule()
    rule.host_attrs = ("shape", "ndim", "dtype", "device")
    fs = _hot(lint_snippet(tmp_path, HOTSYNC_QUIET["host_scalars"], [rule]))
    assert len(fs) == 3
    for fragment in ("range()", "an if/while test",
                     "a conditional expression"):
        assert any(fragment in f.message for f in fs), fragment


def test_hotsync_sync_points_need_their_designation(tmp_path):
    """Without the designations the sync points fire: the resolve closure
    on each ``.cpu()`` and ``np.asarray``, PendingLookup.resolve on each
    ``.cpu()``."""
    rule = HotSyncRule()
    rule.sync_arg_ok = rule.self_sync = ()
    fs = _hot(lint_snippet(tmp_path, HOTSYNC_QUIET["resolve_closure"],
                           [rule]))
    assert len(fs) == 3
    fs = _hot(lint_snippet(tmp_path, HOTSYNC_QUIET["pending_resolve"],
                           [rule], name="snip2.py"))
    assert len(fs) == 3


def test_hotsync_off_the_hot_path_quiet(tmp_path):
    code = """
    import numpy as np, torch

    class Fleet:
        def snapshot(self):
            dev = torch.zeros((4,), device="cuda")
            return np.asarray(dev), dev.cpu(), int(dev.sum())
    """
    assert _hot(lint_snippet(tmp_path, code, [HotSyncRule()])) == []


# the reference's JITDISC cases, as HOTSYNC truthiness in _lookup_impl: in
# eager PyTorch a branch on a device tensor is a sync, not a retrace

TRUTH_POS = """
    class LookupEngine:
        def _lookup_impl(self, state, probes, mode: str, live: tuple):
            x = probes.sum()
            if x > 0:                           # device truthiness
                return x
            return -x
"""

TRUTH_NEG = """
    class LookupEngine:
        def _lookup_impl(self, state, probes, mode: str, live: tuple,
                         fmaybe=None):
            S = probes.shape[-1]
            use_filters = fmaybe is not None
            if mode == "model":                 # host: annotated arg
                return probes
            if S <= 1024 and use_filters:       # host: shape, identity
                return probes * 2
            if not live[0]:                     # host: annotated tuple
                return probes
            for i in range(3):                  # host loop
                probes = probes + i
            return -probes
"""

TRUTH_EXTRA = """
    class LookupEngine:
        def _lookup_impl(self, state, probes, mode: str):
            if probes:                          # a device tensor's bool
                return state
            return probes
"""


def test_hotsync_truthiness_fires_in_lookup_impl(tmp_path):
    fs = _hot(lint_snippet(tmp_path, TRUTH_POS, [HotSyncRule()]))
    assert len(fs) == 1 and "truth value" in fs[0].message
    assert fs[0].symbol == "LookupEngine._lookup_impl"


def test_hotsync_truthiness_quiet_on_host_values(tmp_path):
    assert _hot(lint_snippet(tmp_path, TRUTH_NEG, [HotSyncRule()])) == []


def test_hotsync_truthiness_of_a_parameter(tmp_path):
    fs = _hot(lint_snippet(tmp_path, TRUTH_EXTRA, [HotSyncRule()]))
    assert len(fs) == 1 and "truth value" in fs[0].message


# ------------------------------------------------------------- suppressions

def test_suppression_honored(tmp_path):
    code = """
    import numpy as np, torch

    class PipeServer:
        def tick(self):
            dev = torch.zeros((4,), device="cuda")
            # bourbonlint: allow[HOTSYNC] -- stats snapshot, off hot path
            return np.asarray(dev)
    """
    fs = lint_snippet(tmp_path, code, [HotSyncRule()])
    hot = _hot(fs)
    assert len(hot) == 1 and hot[0].suppressed
    assert not [f for f in fs if f.rule == SUPPRESS]


def test_suppression_without_justification_rejected(tmp_path):
    code = """
    import torch

    class PipeServer:
        def tick(self):
            dev = torch.zeros((4,), device="cuda")
            return dev.cpu()  # bourbonlint: allow[HOTSYNC]
    """
    fs = lint_snippet(tmp_path, code, [HotSyncRule()])
    hot = _hot(fs)
    assert len(hot) == 1 and not hot[0].suppressed    # NOT suppressed
    supp = [f for f in fs if f.rule == SUPPRESS]
    assert len(supp) == 1 and "justification" in supp[0].message


def test_suppress_finding_not_suppressible(tmp_path):
    code = """
    # bourbonlint: allow[SUPPRESS] -- should not work
    # bourbonlint: allow[HOTSYNC]
    x = 1
    """
    fs = lint_snippet(tmp_path, code, [HotSyncRule()])
    supp = [f for f in fs if f.rule == SUPPRESS]
    assert len(supp) == 1 and not supp[0].suppressed


# ----------------------------------------------------------------- baseline

HOTSYNC_POS = """
    import numpy as np, torch

    class PipeServer:
        def tick(self):
            dev = torch.zeros((8,), device="cuda")
            host = np.asarray(dev)            # blocking transfer
            n = int(dev.sum())                # device coercion
            torch.cuda.synchronize()
            if dev.any():
                n += 1
            return host, n
"""


def test_baseline_add_expire_roundtrip(tmp_path):
    bl_path = str(tmp_path / "bl.json")
    rules = [HotSyncRule()]

    fs = lint_snippet(tmp_path, HOTSYNC_POS, rules)
    assert len(fs) == 4 and not any(f.baselined for f in fs)

    save_baseline(bl_path, make_baseline(fs))
    fs2 = lint_snippet(tmp_path, HOTSYNC_POS, rules)
    expired = apply_baseline(fs2, load_baseline(bl_path))
    assert all(f.baselined for f in fs2) and expired == []

    extra = HOTSYNC_POS + """
        def dispatch_more(self):
            return torch.ones(2, device="cuda").cpu()
    """
    fs3 = lint_snippet(tmp_path, extra, rules)
    apply_baseline(fs3, load_baseline(bl_path))
    new = [f for f in fs3 if not f.baselined]
    assert len(new) == 1 and "dispatch_more" in new[0].symbol

    fs4 = lint_snippet(tmp_path, HOTSYNC_QUIET["host_numpy"], rules)
    expired = apply_baseline(fs4, load_baseline(bl_path))
    assert len(expired) == 4
    save_baseline(bl_path, make_baseline(fs4))
    assert load_baseline(bl_path)["findings"] == []


def test_parse_error_reported(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def broken(:\n")
    fs = run_lint([str(p)], [HotSyncRule()], root=str(tmp_path))
    assert len(fs) == 1 and fs[0].rule == "PARSE"


# ------------------------------------------------- parity with the reference

def _tuples(fs):
    return [(f.rule, f.line, f.col, f.message, f.symbol, f.suppressed)
            for f in fs]


def _both(tmp_path, code, port_rules, ref_rules, sub):
    """The same snippet linted by the port's rules at repro_torch/<sub>
    and by the reference's at repro/<sub>; paths differ by the package."""
    port = lint_snippet(tmp_path / "p", code, port_rules,
                        subdir=f"repro_torch/{sub}")
    ref = lint_snippet(tmp_path / "r", code, ref_rules, subdir=f"repro/{sub}",
                       runner=ref_analysis.run_lint)
    assert [f.path.replace("repro_torch/", "repro/") for f in port] \
        == [f.path for f in ref]
    return port, ref


DURORDER_CASES = {
    "fires": (ref_fixtures.DURORDER_POS, "storage", 2),
    "quiet": (ref_fixtures.DURORDER_NEG, "storage", 0),
    "create_nosync": ("""
    import os

    def recover(path, fsync=True):
        with open(path, "ab") as f:          # new dir entry, never synced
            f.write(b"x")
    """, "distributed", 1),
    "out_of_scope": (ref_fixtures.DURORDER_POS, "server", 0),
}


@pytest.mark.parametrize("case", list(DURORDER_CASES))
def test_durorder_matches_reference(tmp_path, case):
    code, sub, n = DURORDER_CASES[case]
    port, ref = _both(tmp_path, code, [DurabilityOrderRule()],
                      [RefDurOrder()], sub)
    assert _tuples(port) == _tuples(ref)
    assert len([f for f in port if f.rule == "DURORDER"]) == n


@pytest.mark.parametrize("case", ["fires", "quiet"])
def test_pairing_matches_reference(tmp_path, case):
    code = (ref_fixtures.PAIRING_POS if case == "fires"
            else ref_fixtures.PAIRING_NEG)
    port, ref = _both(tmp_path, code, [PairingRule()], [RefPairing()],
                      "server")
    assert _tuples(port) == _tuples(ref)
    msgs = [f.message for f in port]
    if case == "fires":
        assert any("discarded" in m for m in msgs)
        assert any("every following path" in m for m in msgs)
        assert any("epoch stamp" in m for m in msgs)
    else:
        assert msgs == []


@pytest.mark.parametrize("case", ["fires", "quiet"])
@pytest.mark.parametrize("decl", ["fallback", "live"])
def test_obsdrift_matches_reference(tmp_path, case, decl):
    """The fallback tables, and each package's live declarations (the
    port's README and tuples against the reference's): same findings."""
    code = (ref_fixtures.OBSDRIFT_POS if case == "fires"
            else ref_fixtures.OBSDRIFT_NEG)
    if decl == "live":
        port_rule, ref_rule = (ObsDriftRule.from_root(REPO),
                               RefObsDrift.from_root(REPO))
    else:
        port_rule, ref_rule = ObsDriftRule(), RefObsDrift()
    port, ref = _both(tmp_path, code, [port_rule], [ref_rule], "server")
    assert _tuples(port) == _tuples(ref)
    assert (len(port) >= 8) == (case == "fires")


def test_suppression_and_baseline_counts_match_reference(tmp_path):
    """A PAIRING finding allowed with a justification, one allowed without
    (a SUPPRESS finding, not suppressed), then the baseline round-trip:
    both packages give the same counts at every step."""
    code = ref_fixtures.PAIRING_POS.replace(
        "self.store.dispatch_get(keys)          # dropped handle",
        "self.store.dispatch_get(keys)  # bourbonlint: allow[PAIRING] -- "
        "fire and forget in a fixture").replace(
        "self.cache.fill(keys, vals)            # no epoch stamp",
        "self.cache.fill(keys, vals)  # bourbonlint: allow[PAIRING]")
    counts = []
    for pkg, rule, sub in (("port", PairingRule(), "repro_torch/server"),
                           ("ref", RefPairing(), "repro/server")):
        lib = ref_analysis if pkg == "ref" else port_analysis
        fs = lint_snippet(tmp_path / pkg, code, [rule], subdir=sub,
                          runner=lib.run_lint)
        bl = lib.make_baseline(fs)
        path = str(tmp_path / f"{pkg}.json")
        lib.save_baseline(path, bl)
        fs2 = lint_snippet(tmp_path / pkg, code, [rule], subdir=sub,
                           runner=lib.run_lint)
        expired = lib.apply_baseline(fs2, lib.load_baseline(path))
        fs3 = lint_snippet(tmp_path / pkg, ref_fixtures.PAIRING_NEG, [rule],
                           subdir=sub, runner=lib.run_lint)
        gone = lib.apply_baseline(fs3, lib.load_baseline(path))
        counts.append((
            sum(f.suppressed for f in fs),
            sum(f.rule == SUPPRESS for f in fs),
            len(fs), len(bl["findings"]), bl["version"],
            sum(f.baselined for f in fs2), len(expired),
            sum(e["count"] for e in gone)))
    assert counts[0] == counts[1]
    assert counts[0][:3] == (1, 1, 4)


# --------------------------------------------------------------- repo-level

def test_port_lints_clean():
    """The production gate: zero unbaselined findings on port/repro_torch
    against the checked-in (empty) port baseline."""
    fs = run_lint([os.path.join(REPO, "port", "repro_torch")],
                  default_rules(REPO), root=REPO)
    apply_baseline(fs, load_baseline(PORT_BASELINE))
    new = [f for f in fs if not f.suppressed and not f.baselined]
    assert new == [], "\n" + "\n".join(f.render() for f in new)
    assert [r.id for r in default_rules(REPO)] == list(ALL_RULES)
    assert "JITDISC" not in ALL_RULES


def test_port_baseline_is_empty():
    with open(PORT_BASELINE) as f:
        data = json.load(f)
    assert data == {"findings": [], "version": 1}


def test_dead_module_report():
    rep = dead_module_report(REPO)
    assert rep["dead"] == [], rep["dead"]
    assert rep["quarantined"] == []
    assert rep["reachable"] == rep["total"] > 40
    assert rep["roots"] > 15


def test_dead_module_report_finds_an_orphan(tmp_path):
    """A module nothing imports is reported: the graph is over
    repro_torch, not over repro."""
    port = tmp_path / "port" / "repro_torch"
    shutil.copytree(os.path.join(REPO, "port", "repro_torch"), port,
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    (port / "core" / "orphan.py").write_text("X = 1\n")
    for sub in ("tests", "port/examples", "port/scripts"):
        shutil.copytree(os.path.join(REPO, sub), tmp_path / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    rep = dead_module_report(str(tmp_path))
    assert rep["dead"] == ["repro_torch.core.orphan"]


def test_durorder_visits_the_port_storage():
    """The scope trap: with the reference's scopes the rule would check
    no file of repro_torch/storage.  The port's scopes cover it, and a
    publish without flush+fsync there fires."""
    rule = DurabilityOrderRule()
    files = []
    for sub in ("storage", "distributed"):
        d = os.path.join(REPO, "port", "repro_torch", sub)
        files += [SourceFile.load(os.path.join(d, f), REPO)
                  for f in sorted(os.listdir(d)) if f.endswith(".py")]
    checked = [sf.relpath for sf in files
               if any(s in sf.relpath for s in rule.scopes)]
    storage = [p for p in checked if "repro_torch/storage/" in p]
    assert len(storage) >= 5 and len(checked) == len(files)
    assert not any(any(s in p for s in RefDurOrder().scopes)
                   for p in checked)


def test_durorder_fires_under_port_storage(tmp_path):
    fs = lint_snippet(tmp_path, ref_fixtures.DURORDER_POS,
                      [DurabilityOrderRule()],
                      subdir="port/repro_torch/storage")
    assert any("flush+os.fsync" in f.message for f in fs)
    assert any("rename itself" in f.message for f in fs)


def test_obsdrift_reads_port_declarations():
    from repro_torch.obs import READ_STAGES
    from repro_torch.obs.trace import CRITICAL_STAGES, SPAN_NAMES
    rule = ObsDriftRule.from_root(REPO)
    assert rule._obs_init.endswith(os.path.join("port", "repro_torch",
                                                "obs", "__init__.py"))
    assert rule.stages == READ_STAGES       # parsed from the port's obs
    assert rule.spans == SPAN_NAMES and rule.critical == CRITICAL_STAGES
    assert "fleet" in rule.prefixes and "io" in rule.prefixes
    assert "index" in rule.labels
    assert rule._stage_drift is None and rule._trace_drift == []
    # the README's stage table is read (it follows its heading after a
    # blank line, which the reference's pattern misses)
    readme = os.path.join(REPO, "port", "repro_torch", "obs", "README.md")
    assert _tables_from_readme(readme)[2] == READ_STAGES


def test_obsdrift_readme_code_disagreement_fires(tmp_path):
    """The port's README with one stage row dropped and one span row
    renamed: OBSDRIFT reports both against the port's sources."""
    obs = tmp_path / "port" / "repro_torch" / "obs"
    shutil.copytree(os.path.join(REPO, "port", "repro_torch", "obs"), obs,
                    ignore=shutil.ignore_patterns("__pycache__"))
    readme = (obs / "README.md").read_text()
    assert "| `cache_probe` |" in readme and "| `io_task`        |" in readme
    (obs / "README.md").write_text(
        readme.replace("| `cache_probe` |", "| cache probe |")
        .replace("| `io_task`        |", "| `io_job`         |"))
    rule = ObsDriftRule.from_root(str(tmp_path))
    fs = run_lint([str(obs)], [rule], root=str(tmp_path))
    msgs = {(f.path, f.message.split(" in code")[0]) for f in fs}
    assert msgs == {("port/repro_torch/obs/__init__.py", "READ_STAGES"),
                    ("port/repro_torch/obs/trace.py", "SPAN_NAMES")}


@pytest.mark.parametrize("args", [[], ["--report", "dead-modules"],
                                  ["--json", "--rules", "HOTSYNC,DURORDER"]])
def test_lint_cli_exits_clean(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "port", "scripts", "lint.py"),
         *args], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    if "--json" in args:
        assert json.loads(out.stdout)["new"] == 0
