"""HOTSYNC — no blocking device-to-host transfer on registered hot paths.

The port's counterpart of ``repro.analysis.hotsync``, retargeted to
PyTorch.  The reference split lookup into dispatch and resolve halves so
that the only blocking sync is the one inside ``resolve_get``; the port
keeps the split (``PendingLookup``, ``dispatch_get``/``resolve_get_async``)
and this rule pins the same property.  PyTorch blocks through other calls
than JAX: ``.cpu()``, ``.numpy()``, ``.tolist()``, ``.item()``,
``.nonzero()``, ``int()``/``float()``/``bool()`` of a CUDA tensor, the
truth value of one in an ``if`` or ``while`` test, and
``torch.cuda.synchronize()``/``Event.synchronize()``/``Stream.synchronize()``.

Model: a per-function taint pass, flow-insensitive (a name is a device
value if any assignment in the function makes it one).  Device values
come from ``torch.*`` calls (except the host constructors
``torch.from_numpy``, ``torch.device``, ``torch.Size``, ``torch.finfo``,
``torch.iinfo`` and the ``torch.cuda`` queries), the kernel wrappers
``ops.*``, configured producer calls (``lookup_async``, ``_upload``,
``device_state``, ...), configured device attributes (``.f_dev``,
``._pos_dev``, ...), ``.to(device)``/``.cuda()``, and, in the eager
descent functions that take device tensors (``_lookup_impl``,
``dist_get_local``, ...), every parameter not annotated as a host type.
Taint flows through assignments, tuple unpacking, ``for`` and
comprehension targets, operators, comparisons (not ``is``/``in``),
subscripts and methods; ``.cpu()``, ``.numpy()``, ``.tolist()`` and
``.item()`` give host values, and so do the host attributes
(``.shape``, ``.device``, ``.dtype``, and the host scalars that sit
beside device tensors: ``n_seg``, ``n_files``).  Inside a registered hot
function,

* ``torch.cuda.synchronize()``, ``.synchronize()`` and ``.cpu()`` are
  flagged on any receiver (``.cpu()`` is torch's device-to-host copy);
* ``.item()``, ``.numpy()``, ``.tolist()``, ``.nonzero()``,
  ``torch.nonzero``, ``np.asarray``/``np.array``,
  ``int()``/``float()``/``bool()``/``range()``, ``.to("cpu")`` and an
  ``if``/``while``/``assert``/conditional-expression test are flagged
  when they apply to a device value — host numpy on the hot path is fine
  and common;
* an upload that waits for the stream is flagged: ``.to(device)`` or
  ``.cuda()`` of a host value without ``non_blocking=True`` (torch
  synchronizes the stream after a blocking host copy), and
  ``torch.tensor``/``torch.as_tensor`` with a ``device=`` other than the
  CPU.

The hot functions include the restack a dispatch half runs after a
structure change (``build_state`` and the stacking under it,
``device_state``, ``place_dist_state``, ``device_view``, ``upload``) and
the kernel wrappers, so that its uploads are held to the same rule.

Designated sync points may transfer their payload: a ``resolve_*``
function its first non-self parameter, ``PendingLookup.resolve`` its
``self``, also through method chains (``pb.f_dev.cpu().numpy()``),
names derived from the payload (``for v in pb.v_dev``) and nested
closures.  The reference's JITDISC rule has no counterpart here (the
port has no ``jit``); its tracer-truthiness check is this rule's
truthiness sink over the descent functions.
"""

from __future__ import annotations

import ast
import fnmatch

from .core import Finding, Rule, SourceFile, dotted, match_hot, walk_functions

# (class_glob, func_glob) pairs — the reference's registered hot paths
# (engine dispatch, store/sharded dispatch+resolve, server tick, tracer
# handles, cache probe/fill, the host I/O plane), then the eager functions
# the port runs inside a dispatch half: the engine's descent, the sharded
# dispatch, the shard descent and the mesh GET's per-device body, and the
# pending lookup's resolve
DEFAULT_HOT_FUNCTIONS = (
    ("LookupEngine", "lookup_async"),
    ("LookupEngine", "filter_probe"),
    ("*", "dispatch_*"),
    ("*", "resolve_*"),
    ("*Server", "tick"),
    ("StageHandle", "begin"),
    ("StageHandle", "end"),
    ("HotKeyCache", "lookup"),
    ("HotKeyCache", "fill"),
    ("IOPool", "submit"),
    ("GroupCommitWAL", "append"),
    ("GroupCommitWAL", "sync"),
    ("ValueFetch", "wait"),
    ("*", "wal_sync"),
    ("LookupEngine", "_upload"),
    ("LookupEngine", "_lookup_impl"),
    ("LookupEngine", "_probe_file"),
    ("LookupEngine", "_probe_level_via_model"),
    ("LookupEngine", "_find_file"),
    ("LookupEngine", "_probe_split"),
    ("ShardedStore", "_dist_dispatch"),
    ("", "dist_get_local"),
    ("", "dist_get"),
    ("PendingLookup", "resolve"),
    # the restack a dispatch half runs after a structure change (host
    # stacking and its uploads), and the kernel wrappers it launches
    ("LookupEngine", "build_state"),
    ("LookupEngine", "build_filter_state"),
    ("LookupEngine", "_build_level"),
    ("LookupEngine", "_build_level_model"),
    ("LookupEngine", "_stack_models"),
    ("ShardedStore", "device_state"),
    ("ValueLog", "device_view"),
    ("", "place_dist_state"),
    ("", "upload"),
    ("", "_to"),
    ("", "_sum_on"),
    ("", "plr_lookup"),
    ("", "bounded_search"),
    ("", "bloom_probe"),
    ("", "sstable_search"),
    ("", "bloom_probe_stack"),
    ("", "_launch"),
)

# functions whose parameters are device tensors (unless annotated with a
# host type): the descent the dispatch halves run eagerly
DEFAULT_DEVICE_PARAM_FUNCTIONS = (
    ("LookupEngine", "_lookup_impl"),
    ("LookupEngine", "_probe_file"),
    ("LookupEngine", "_probe_level_via_model"),
    ("LookupEngine", "_find_file"),
    ("LookupEngine", "_probe_split"),
    ("", "dist_get_local"),
    ("", "dist_get"),
)

# calls whose result lives on the device (by the last name of the callee);
# _get_fn is the mesh GET that build_dist_get returns
DEFAULT_DEVICE_PRODUCERS = (
    "lookup_async", "device_view", "device_state", "_dist_dispatch",
    "filter_probe", "_upload", "upload", "dist_get_local", "_get_fn",
    "_lookup_impl", "_probe_file", "_probe_level_via_model", "_find_file",
    "_probe_split",
)

# attribute names that hold device tensors in the port
DEFAULT_DEVICE_ATTRS = (
    "f_dev", "v_dev", "probe_split_acc", "filter_stats_acc",
    "_pos_dev", "_neg_dev",
)

# attribute names that hold host values beside device tensors: tensor
# metadata, and the host scalars kept so that reading them never syncs
DEFAULT_HOST_ATTRS = (
    "shape", "ndim", "dtype", "device", "is_cuda", "n_seg", "n_files",
)

# (class_glob, func_glob) of sync points whose payload is ``self``
DEFAULT_SELF_SYNC = (("PendingLookup", "resolve"),)

# torch calls that build host objects
_HOST_TORCH = {"torch.from_numpy", "torch.device", "torch.Size",
               "torch.finfo", "torch.iinfo", "torch.is_tensor",
               "torch.get_default_dtype"}
# methods whose result is a host value (the sink, if any, is the call)
_HOST_METHODS = {"cpu", "numpy", "tolist", "item", "size", "dim", "numel",
                 "is_pinned", "is_contiguous", "data_ptr", "element_size",
                 "stride", "pin_memory"}
# methods that block when their receiver is a device tensor
_TAINT_METHOD_SINKS = {"item", "numpy", "tolist", "nonzero"}
# calls that block when their first argument is a device tensor
_TAINT_CALL_SINKS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
                     "int", "float", "bool", "range", "torch.nonzero"}
# calls that block whatever they are given
_ALWAYS_SINKS = {"torch.cuda.synchronize"}
# torch constructors that copy host data to their ``device=`` synchronously
_UPLOAD_CALLS = {"torch.tensor", "torch.as_tensor"}
# host annotations: a parameter so annotated is not a device tensor
_HOST_TYPES = {"str", "int", "bool", "float", "tuple", "list", "dict",
               "bytes", "None"}


def _static_annotation(ann) -> bool:
    """True when every name in the annotation is a host type
    (``mode: str``, ``live: tuple``, ``delta: int | None``)."""
    if ann is None:
        return False
    names = [dotted(n) for n in ast.walk(ann)
             if isinstance(n, (ast.Name, ast.Attribute))]
    consts = [n for n in ast.walk(ann) if isinstance(n, ast.Constant)]
    return bool(names or consts) and all(n in _HOST_TYPES for n in names) \
        and all(c.value is None or c.value in _HOST_TYPES for c in consts)


def _to_target(node: ast.Call):
    """The device or dtype a ``.to(...)`` call names, or None."""
    if node.args:
        return node.args[0]
    return next((kw.value for kw in node.keywords if kw.arg == "device"),
                None)


def _kw_true(node: ast.Call, name: str) -> bool:
    return any(kw.arg == name and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in node.keywords)


def _cpu_const(node) -> bool:
    return isinstance(node, ast.Constant) and isinstance(node.value, str) \
        and node.value.startswith("cpu")


def _targets(node):
    """Names bound by an assignment target (tuples unpacked)."""
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for el in node.elts:
            yield from _targets(el)


def _bindings(fn):
    """(target names, value expression) of every binding in ``fn``:
    assignments, and ``for`` and comprehension targets (bound to the
    iterable)."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                yield list(_targets(tgt)), node.value
        elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                and node.value is not None:
            yield list(_targets(node.target)), node.value
        elif isinstance(node, (ast.For, ast.comprehension)):
            yield list(_targets(node.target)), node.iter


class HotSyncRule(Rule):
    id = "HOTSYNC"
    description = ("blocking device-to-host transfer inside a registered "
                   "hot-path function")

    hot_functions = DEFAULT_HOT_FUNCTIONS
    device_producers = DEFAULT_DEVICE_PRODUCERS
    device_attrs = DEFAULT_DEVICE_ATTRS
    host_attrs = DEFAULT_HOST_ATTRS
    # func_globs whose first non-self parameter is the designated sync
    # payload (transfers of it are the point of the function)
    sync_arg_ok = ("resolve_*",)
    # (class_glob, func_glob) whose payload is self
    self_sync = DEFAULT_SELF_SYNC

    def check(self, sf: SourceFile) -> list:
        findings: list[Finding] = []
        seen: set = set()
        for qual, classname, fn in walk_functions(sf.tree):
            if not match_hot(self.hot_functions, classname, fn.name):
                continue
            for f in self._check_fn(sf, qual, classname, fn):
                # a hot function nested in a hot function is walked twice
                if (f.line, f.col, f.message) not in seen:
                    seen.add((f.line, f.col, f.message))
                    findings.append(f)
        return findings

    # ------------------------------------------------------------- taint

    def _is_device_expr(self, node, tainted: set) -> bool:
        if isinstance(node, ast.Name):
            return node.id in tainted
        if isinstance(node, ast.Attribute):
            if node.attr in self.host_attrs:
                return False
            if node.attr in self.device_attrs:
                return True
            return self._is_device_expr(node.value, tainted)
        if isinstance(node, ast.Subscript):
            return self._is_device_expr(node.value, tainted)
        if isinstance(node, ast.Call):
            return self._is_device_call(node, tainted)
        if isinstance(node, ast.BinOp):
            return (self._is_device_expr(node.left, tainted)
                    or self._is_device_expr(node.right, tainted))
        if isinstance(node, ast.UnaryOp):
            if isinstance(node.op, ast.Not):
                return False        # `not t` is the sink; its result is host
            return self._is_device_expr(node.operand, tainted)
        if isinstance(node, ast.Compare):
            if any(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return any(self._is_device_expr(x, tainted)
                       for x in [node.left, *node.comparators])
        if isinstance(node, ast.IfExp):
            return (self._is_device_expr(node.body, tainted)
                    or self._is_device_expr(node.orelse, tainted))
        return False

    def _is_device_call(self, node: ast.Call, tainted: set) -> bool:
        name = dotted(node.func)
        last = name.rsplit(".", 1)[-1]
        if name.startswith("torch."):
            return not (name in _HOST_TORCH
                        or name.startswith(("torch.cuda.", "torch.backends.")))
        if name.startswith("ops."):
            return True
        if last in self.device_producers:
            return True
        if not isinstance(node.func, ast.Attribute):
            return False
        attr = node.func.attr
        recv = node.func.value
        if attr in _HOST_METHODS:
            return False
        if attr == "cuda":
            return True
        if attr == "to":
            target = _to_target(node)
            if isinstance(target, ast.Constant) \
                    and isinstance(target.value, str):
                return not target.value.startswith("cpu")
            if target is None or dotted(target).startswith("torch."):
                # a dtype cast keeps the receiver where it is
                return self._is_device_expr(recv, tainted)
            return True
        # a method on a device value stays on the device (x.sum(), x.long())
        return self._is_device_expr(recv, tainted)

    def _taint(self, fn, params) -> set:
        """Device names of ``fn``: the fixpoint of its bindings."""
        tainted = set(params)
        binds = list(_bindings(fn))
        changed = True
        while changed:
            changed = False
            for names, value in binds:
                if names and not set(names) <= tainted \
                        and self._is_device_expr(value, tainted):
                    tainted.update(names)
                    changed = True
        return tainted

    def _sync_names(self, fn, payload) -> set:
        """The payload's name and the names bound from it (``v`` in ``for
        v in pb.v_dev``, ``x = pb.f_dev``), to a fixpoint."""
        if payload is None:
            return set()
        names = {payload}
        binds = list(_bindings(fn))
        changed = True
        while changed:
            changed = False
            for targets, value in binds:
                if targets and not set(targets) <= names \
                        and self._rooted(value, names):
                    names.update(targets)
                    changed = True
        return names

    @staticmethod
    def _rooted(node, names: set) -> bool:
        """True when ``node`` is one of ``names`` or an attribute,
        subscript or method-call chain rooted at one (``pb``,
        ``pb.f_dev``, ``pb.x[:n]``, ``pb.f_dev.cpu()``)."""
        while True:
            if isinstance(node, (ast.Attribute, ast.Subscript)):
                node = node.value
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute):
                node = node.func.value
            else:
                break
        return isinstance(node, ast.Name) and node.id in names

    def _device_params(self, classname, fn) -> list:
        if not match_hot(DEFAULT_DEVICE_PARAM_FUNCTIONS, classname, fn.name):
            return []
        args = fn.args
        out = []
        for a in [*args.posonlyargs, *args.args, *args.kwonlyargs]:
            if a.arg in ("self", "cls") or _static_annotation(a.annotation):
                continue
            out.append(a.arg)
        return out

    def _sync_upload(self, node: ast.Call, tainted: set) -> bool:
        """A ``.to(device)``/``.cuda()`` of a host value without
        ``non_blocking=True``: torch waits for the stream after such a
        copy.  Dtype casts, copies to the CPU and copies between devices
        are not uploads."""
        if _kw_true(node, "non_blocking") \
                or self._is_device_expr(node.func.value, tainted):
            return False
        if node.func.attr == "cuda":
            return True
        target = _to_target(node)
        return not (target is None or _cpu_const(target)
                    or dotted(target).startswith("torch."))

    def _payload(self, classname, fn):
        if match_hot(self.self_sync, classname, fn.name):
            return "self"
        if any(fnmatch.fnmatch(fn.name, g) for g in self.sync_arg_ok):
            params = [a.arg for a in fn.args.args
                      if a.arg not in ("self", "cls")]
            if params:
                return params[0]
        return None

    def _check_fn(self, sf, qual, classname, fn):
        findings: list[Finding] = []
        tainted = self._taint(fn, self._device_params(classname, fn))
        sync = self._sync_names(fn, self._payload(classname, fn))

        def note(node, msg):
            findings.append(Finding(self.id, sf.relpath, node.lineno,
                                    node.col_offset, msg, symbol=qual))

        def blocks(node) -> bool:
            return self._is_device_expr(node, tainted) \
                and not self._rooted(node, sync)

        def test(node, where):
            # each operand of `a and b` / `not a` is a truth value
            if isinstance(node, ast.BoolOp):
                for v in node.values:
                    test(v, where)
            elif isinstance(node, ast.UnaryOp) and isinstance(node.op,
                                                              ast.Not):
                test(node.operand, where)
            elif blocks(node):
                note(node, f"the truth value of a device tensor in {where} "
                           f"is a blocking device-to-host transfer")

        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While)):
                test(node.test, "an if/while test")
            elif isinstance(node, ast.IfExp):
                test(node.test, "a conditional expression")
            elif isinstance(node, ast.Assert):
                test(node.test, "an assert")
            elif isinstance(node, ast.comprehension):
                for cond in node.ifs:
                    test(cond, "a comprehension filter")
            elif isinstance(node, ast.Call):
                self._check_call(node, note, blocks, tainted, sync)
        return findings

    def _check_call(self, node, note, blocks, tainted, sync) -> None:
        name = dotted(node.func)
        if name in _ALWAYS_SINKS:
            note(node, f"{name}() blocks until the device queue drains; "
                       f"hot paths must stay async")
            return
        if name in _UPLOAD_CALLS:
            dev = next((kw.value for kw in node.keywords
                        if kw.arg == "device"), None)
            if dev is not None and not _cpu_const(dev):
                note(node, f"{name}(..., device=) copies host data "
                           f"synchronously: it waits for the stream")
            return
        if isinstance(node.func, ast.Attribute):
            attr, recv = node.func.attr, node.func.value
            if attr in ("to", "cuda") and self._sync_upload(node, tainted):
                note(node, f".{attr}() of a host tensor without "
                           f"non_blocking=True is a pageable copy: it waits "
                           f"for the stream")
                return
            if attr == "to" and _cpu_const(_to_target(node)) \
                    and blocks(recv):
                note(node, ".to('cpu') on the hot path is a blocking "
                           "device-to-host copy")
                return
            if attr == "synchronize" and not self._rooted(recv, sync):
                note(node, ".synchronize() on the hot path waits for the "
                           "device")
                return
            if attr == "cpu" and not self._rooted(recv, sync):
                note(node, ".cpu() on the hot path is a blocking "
                           "device-to-host copy")
                return
            if attr in _TAINT_METHOD_SINKS and blocks(recv):
                note(node, f".{attr}() on a device value is a blocking "
                           f"transfer")
                return
        if name in _TAINT_CALL_SINKS and node.args and blocks(node.args[0]):
            note(node, f"{name}() on a device value is a blocking "
                       f"device-to-host transfer")
