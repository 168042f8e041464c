"""Dead-module report: import-graph reachability over ``repro_torch``.

The port's counterpart of ``repro.analysis.deadmod``.  A module of
``port/repro_torch`` that nothing imports from the roots — the package's
``__init__``, the port's tests (``tests/test_torch_*.py`` and their
shared ``tests/_torch_serving.py``), ``chip_smoke.py``, the examples in
``port/examples`` and the scripts in ``port/scripts`` — is dead weight.
This pass parses the imports of every ``.py`` file (AST only, nothing is
executed), resolves ``repro_torch.*`` absolute and relative imports to
files, and BFSes from the roots.  Unreached modules are reported; a
module kept on purpose goes in an explicit allowlist with its reason
(quarantined: reported, not failing), so a *new* module going dark is
always a hard finding.
"""

from __future__ import annotations

import ast
import glob
import os

# Modules of the port that are knowingly unreferenced, as path prefixes
# ("repro_torch/<pkg>/<module>"), each with its reason.  Empty: every
# module of the port is reached from a root.
DEAD_MODULE_ALLOWLIST: tuple = ()

PACKAGE = "repro_torch"

# root files, as globs under the repository root
ROOT_GLOBS = ("tests/test_torch_*.py", "tests/_torch_serving.py",
              "chip_smoke.py", "port/examples/*.py", "port/scripts/*.py")


def _module_name(relpath: str) -> str:
    """repro_torch/a/b.py -> repro_torch.a.b ; packages use their
    __init__."""
    p = relpath.replace(os.sep, "/")
    if p.endswith("/__init__.py"):
        p = p[: -len("/__init__.py")]
    elif p.endswith(".py"):
        p = p[:-3]
    return p.replace("/", ".")


def _iter_py(base: str):
    if not os.path.isdir(base):
        return
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames
                             if not d.startswith(".") and d != "__pycache__")
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def _imports_of(path: str, modname: str):
    """Absolute module names this file imports (relative imports
    resolved, and `from pkg import name` where name may be a module)."""
    try:
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
    except (OSError, SyntaxError):
        return []
    out = []
    pkg_parts = modname.split(".")
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                out.append(alias.name)
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # containing package, then (level-1) more hops up
                pkg = pkg_parts if path.endswith("__init__.py") \
                    else pkg_parts[:-1]
                base = pkg[: len(pkg) - (node.level - 1)]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            if mod:
                out.append(mod)
                for alias in node.names:
                    out.append(f"{mod}.{alias.name}")
    return out


def dead_module_report(root: str, allowlist=DEAD_MODULE_ALLOWLIST) -> dict:
    """Compute reachability from the repository root ``root``.  Returns
    ``{"dead": [...], "quarantined": [...], "reachable": int, "total":
    int, "roots": int}`` with module names relative to ``port`` (e.g.
    ``repro_torch.core.engine``)."""
    port = os.path.join(root, "port")
    modules: dict[str, str] = {}      # module name -> file path
    for path in _iter_py(os.path.join(port, PACKAGE)):
        modules[_module_name(os.path.relpath(path, port))] = path
    roots = [p for pattern in ROOT_GLOBS
             for p in sorted(glob.glob(os.path.join(root, pattern)))]

    reached: set = set()
    queue: list = []

    def reach(mod: str):
        """Mark mod and its package __init__ chain reached."""
        parts = mod.split(".")
        for i in range(1, len(parts) + 1):
            name = ".".join(parts[:i])
            if name in modules and name not in reached:
                reached.add(name)
                queue.append(name)

    reach(PACKAGE)
    for path in roots:
        modname = "__root__." + _module_name(os.path.relpath(path, root))
        for imp in _imports_of(path, modname):
            if imp.split(".")[0] == PACKAGE:
                reach(imp)

    while queue:
        mod = queue.pop()
        for imp in _imports_of(modules[mod], mod):
            if imp.split(".")[0] == PACKAGE:
                reach(imp)

    dead, quarantined = [], []
    for mod in sorted(modules):
        if mod in reached:
            continue
        slashed = mod.replace(".", "/")
        if any(slashed == al or slashed.startswith(al + "/")
               for al in allowlist):
            quarantined.append(mod)
        else:
            dead.append(mod)
    return {"dead": dead, "quarantined": quarantined,
            "reachable": len(reached), "total": len(modules),
            "roots": len(roots)}
