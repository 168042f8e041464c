"""Dry run of every (architecture x input-shape) cell on the production mesh
(the port of ``repro.launch.dryrun``), and the distributed store's GET at
the paper's scale.

  PYTHONPATH=port python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape train_4k [--multi-pod] [--units N] [--remat full] ...
  PYTHONPATH=port python -m repro_torch.launch.dryrun --all   # full sweep
  PYTHONPATH=port python -m repro_torch.launch.dryrun --store [--devices D]

The reference lowers and compiles each cell for 256 (or 512) forced host
devices and reads XLA's memory and cost analyses and the compiled HLO's
collectives.  PyTorch has no compiler that lowers a sharded program, so a
model cell is a plan instead: the step runs once, eagerly, on ``meta``
tensors (shapes, no memory) built from ``param_shapes``, at one mesh
position's share of the batch, under the sharding rules on a mesh of
``meta`` positions (``launch/plan`` holds the meters).  The record keeps
the reference's keys; what each means here is in ``launch/README.md``:

- ``memory``: ``argument_bytes``, ``output_bytes`` and ``alias_bytes`` are
  exact per-position sums of the shard shapes (params, optimizer state,
  batch, caches; training donates params and optimizer state, decode the
  caches); ``temp_bytes`` is the run's peak of live intermediates with
  the model axis unsplit (``temp_scope``);
- ``cost``: ``flops`` (``torch.utils.flop_counter``) and ``bytes
  accessed`` (operand and result bytes an aten op) of the whole job,
  divided evenly over the positions (``cost_split``);
- ``collectives``: the parameter and gradient traffic the specs imply
  (``collectives_scope``); for a decode or prefill cell, and a train cell
  on a mesh of two axes (:func:`mesh_trains`), every collective of the
  step run sharded on ``DTensor``s at one position of a fake process
  group (:func:`sharded_plan`), which also gives its ``temp_bytes``.

The store cell (``--store``) runs: the range-partitioned state of the
paper's workload (2^30 keys, one GET of 2^20 probes) built on the
production mesh, one shard row a position, every position the card unless
``devices`` says otherwise, and ``build_dist_get`` run STORE_GETS times,
every answer checked against the state's closed form.  ``devices="meta"``
gives its plan alone.

Results are cached as JSON under experiments/dryrun/.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

import repro_torch.configs.base as cbase
import repro_torch.models.attention as att
from repro_torch.configs.base import ShapeSpec, get_config, shape_applicable
from repro_torch.convert import shard_params
from repro_torch.core.distributed import (KEY_SENTINEL, DistStoreConfig,
                                          build_dist_get, dist_state_specs)
from repro_torch.core.mesh import Mesh
from repro_torch.kernels import ops
from repro_torch.models import Model, init_caches
from repro_torch.models.layers import tree_map
from repro_torch.models.model import _dtype

from .inputs import _bspec, input_specs, shard_caches
from .mesh import make_process_mesh, make_production_mesh
from .plan import (ShardMeter, StepMeter, fake_process_group,
                   param_collectives, tree_bytes)
from .sharding import (DEFAULT_RULES, Sharded, ShardingRules, _axes_of,
                       distribute, logical_to_spec)
from .steps import (TrainConfig, build_prefill_step, build_serve_step,
                    build_train_step, opt_state_specs)

__all__ = ["run_cell", "plan_cell", "sharded_plan", "mesh_trains",
           "run_store_cell", "sweep", "main", "store_row",
           "store_keys", "store_probes", "STORE_GETS"]

STORE_GETS = 3            # timed GETs of the store cell
STORE_SEED = 0
# the store cell's value pointers, by global index i: VPTR_STEP * i +
# VPTR_BASE
_VPTR_STEP, _VPTR_BASE = 4, 1
# its keys: each shard row is cut into segments of equal length (at least
# _SEG_MIN keys, at most seg_cap a row); a segment's keys are evenly spaced
# by an even gap of 2 to 2 * _GAPS, drawn from the segment's index (so key
# + 1 is absent)
_SEG_MIN, _GAPS = 64, 8
# bytes a probe occupies at once on a position during the GET: the
# gathered probe (8), its row (4), position (4), window index (4), found
# and hit (1 + 1), vptr (8), and the int8/int64 pair it keeps for the
# combine (1 + 8)
_STORE_TEMP_PER_PROBE = 39
_PORT = str(pathlib.Path(__file__).resolve().parents[2])
# the step's arguments by kind, in ``args`` order (``argument_parts``)
_ARG_NAMES = {"train": ("params", "optimizer", "batch"),
              "prefill": ("params", "batch"),
              "decode": ("params", "caches", "batch")}


def _mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape)


def _meta_tree(tree):
    """``meta`` tensors of a :class:`Sharded` tree's global shapes."""
    if isinstance(tree, dict):
        return {k: _meta_tree(v) for k, v in tree.items()}
    return tree.meta()


def _meta_batch(specs: dict, b: int) -> dict:
    """The batch stand-ins at ``b`` rows, on ``meta``."""
    return {k: torch.empty((b,) + s.shape[1:], dtype=s.dtype, device="meta")
            for k, s in specs.items()}


def _scalar_bytes(metrics: dict) -> int:
    """Bytes of a step's metrics, each a replicated scalar (a Python
    number rides as f32, as ``jit`` returns it)."""
    return sum(v.numel() * v.element_size() if isinstance(v, torch.Tensor)
               else 4 for v in metrics.values())


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             units: int | None = None, remat: str = "full",
             microbatch: int = 0, rule_overrides: dict | None = None,
             flash_kv_chunk: int | None = None,
             metering: bool = False, scan_param_fsdp: bool = False,
             grad_accum_dtype: str = "float32") -> dict:
    """The plan of one cell (see the module docstring)."""
    cfg = get_config(arch)
    shape = cbase.SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    res = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "units": units, "remat": remat, "microbatch": microbatch}
    if not ok:
        res["skipped"] = why
        return res
    if units is not None:
        cfg = cfg.scaled(units)
    return plan_cell(cfg, shape, make_production_mesh(multi_pod=multi_pod,
                                                      devices="meta"),
                     res=res, remat=remat, microbatch=microbatch,
                     rule_overrides=rule_overrides,
                     flash_kv_chunk=flash_kv_chunk, metering=metering,
                     scan_param_fsdp=scan_param_fsdp,
                     grad_accum_dtype=grad_accum_dtype)


def plan_cell(cfg, shape: ShapeSpec, mesh: Mesh, *, res: dict | None = None,
              remat: str = "full", microbatch: int = 0,
              rule_overrides: dict | None = None,
              flash_kv_chunk: int | None = None, metering: bool = False,
              scan_param_fsdp: bool = False,
              grad_accum_dtype: str = "float32") -> dict:
    """The plan of ``cfg`` at ``shape`` on ``mesh`` (of ``meta``
    positions), added to ``res``: :func:`run_cell` after it has resolved
    the cell's names and the production mesh."""
    res = {"mesh": _mesh_tag(mesh), "remat": remat,
           "microbatch": microbatch} if res is None else res
    if metering:
        # the reference's metering build unrolls its loops so that
        # cost_analysis counts every layer; the eager plan always does
        microbatch = 1
        res["metering"] = True

    t0 = time.time()
    rules = ShardingRules(DEFAULT_RULES)
    if rule_overrides:
        rules.update(rule_overrides)
    res["rules"] = dict(rules)
    if microbatch == 0:  # auto: one sequence per data shard per microstep
        sizes = mesh.axis_sizes
        data_shards = sizes.get("data", 1) * sizes.get("pod", 1)
        microbatch = max(1, shape.global_batch // data_shards) \
            if (shape.kind == "train" and cfg.d_model >= 2048) else 1
        res["microbatch"] = microbatch
    tcfg = TrainConfig(remat=remat, microbatch=microbatch, unroll=metering,
                       scan_param_fsdp=scan_param_fsdp,
                       grad_accum_dtype=grad_accum_dtype)
    res["scan_param_fsdp"] = scan_param_fsdp
    res["grad_accum_dtype"] = grad_accum_dtype

    GB, T = shape.global_batch, shape.seq_len
    bspec = _bspec(mesh, GB)
    batch_axes = tuple(_axes_of(bspec[0])) if len(bspec) else ()
    b_dev = GB // math.prod(mesh.axis_sizes[a] for a in batch_axes)
    specs = input_specs(cfg, shape, mesh, rules)
    pspec = specs[0]
    model = Model(cfg, _meta_tree(pspec))
    batch = _meta_batch(specs[-1], b_dev)
    logits = (GB, 1, cfg.vocab)       # the last position's logits
    logits_bytes = Sharded(logits, _dtype(cfg), logical_to_spec(
        rules, ("batch", "seq", "vocab"), param=False, shape=logits,
        mesh=mesh), mesh).shard_bytes()

    if shape.kind == "train":
        ospec = opt_state_specs(cfg, mesh, rules, tcfg)
        args = (pspec, ospec, specs[1])
        donated = tree_bytes(pspec) + tree_bytes(ospec)
        opt = _meta_tree(ospec)
        step = build_train_step(cfg, tcfg, rules, mesh)

        def run() -> int:
            return donated + _scalar_bytes(step(model, opt, batch)[2])
    elif shape.kind == "prefill":
        args, donated = specs, 0
        step = build_prefill_step(cfg, rules, mesh, unroll=metering)

        def run() -> int:
            step(model, batch)
            return logits_bytes
    else:  # decode
        args, donated = specs, tree_bytes(specs[1])
        caches = init_caches(cfg, b_dev, T, device="meta")
        step = build_serve_step(cfg, rules, mesh, unroll=metering)

        def run() -> int:
            step(model, caches, batch)
            return logits_bytes + donated

    res["lower_s"] = round(time.time() - t0, 2)
    t1 = time.time()
    old_chunk = att.FLASH_KV_CHUNK
    if flash_kv_chunk is not None:
        att.FLASH_KV_CHUNK = flash_kv_chunk
    sharded = None
    try:
        with StepMeter() as meter, FlopCounterMode(display=False) as fc:
            outputs = run()
        if shape.kind != "train" or mesh_trains(mesh):
            sharded = sharded_plan(cfg, shape, mesh, rules, tcfg)
    finally:
        att.FLASH_KV_CHUNK = old_chunk
    res["compile_s"] = round(time.time() - t1, 2)

    arg_bytes = sum(tree_bytes(a) for a in args)
    res["memory"] = {
        "argument_bytes": arg_bytes,
        "output_bytes": outputs,
        "temp_bytes": meter.peak,
        "alias_bytes": donated,
        "peak_bytes": arg_bytes + meter.peak + outputs - donated,
    }
    res["temp_scope"] = "model axis unsplit (upper bound)"
    res["argument_parts"] = dict(zip(_ARG_NAMES[shape.kind],
                                     (tree_bytes(a) for a in args)))
    job = GB / b_dev / mesh.size
    res["cost"] = {"flops": float(fc.get_total_flops()) * job,
                   "bytes accessed": float(meter.accessed) * job}
    res["cost_split"] = "even"
    res["hlo_chars"] = None
    res["collectives"] = param_collectives(pspec, batch_axes, shape.kind,
                                           microbatch)
    res["collectives_scope"] = "parameters and gradients"
    if sharded is not None:
        mem = res["memory"]
        mem["temp_bytes"] = sharded["temp_bytes"]
        mem["peak_bytes"] = arg_bytes + mem["temp_bytes"] + outputs - donated
        res["temp_scope"] = "one position's shard (DTensor placements)"
        res["collectives"] = sharded["collectives"]
        res["collective_counts"] = sharded["counts"]
        res["collectives_scope"] = "all (DTensor placements)"
    res["per_position_batch"] = b_dev
    res["n_devices"] = mesh.size
    return res


def mesh_trains(mesh) -> bool:
    """Whether a train cell on ``mesh`` is planned on DTensor placements:
    the mesh has two axes.  On the (2, 16, 16) mesh DTensor's
    redistribution planner (torch 2.13) spends over ten minutes of CPU on
    the train step's three-axis layouts (mixtral-8x22b, one unit), so
    those cells keep the parameters' and gradients' count."""
    return len(mesh.shape) == 2


def sharded_plan(cfg, shape: ShapeSpec, mesh: Mesh,
                 rules: ShardingRules, tcfg: TrainConfig | None = None) -> dict:
    """Position 0's run of the train, prefill or decode step of ``shape``
    sharded as on a process mesh of ``mesh``'s shape: a
    ``fake_process_group`` of ``mesh.size`` ranks in this process, every
    parameter, optimizer leaf, cache and input a ``DTensor`` of ``meta``
    pieces laid out by its spec, the step (``tcfg``'s train step for a
    train cell) run once under :class:`~repro_torch.launch.plan.ShardMeter`.
    Returns the peak bytes of its local temporaries (``temp_bytes``) and
    the result bytes (``collectives``) and number (``counts``) of every
    collective DTensor issued, by kind: in a train step, the backward's
    and, under remat, the recomputed forward's too."""
    with fake_process_group(mesh.size):
        pm = make_process_mesh(mesh.shape, mesh.axis_names, "meta")
        specs = input_specs(cfg, shape, mesh, rules)
        params = shard_params(Model(cfg, _meta_tree(specs[0])), pm, rules)
        def piece(s: Sharded):
            return distribute(s.meta(), s.spec, pm, local=torch.empty(
                s.shard_shape(), dtype=s.dtype, device="meta"))

        batch = {k: piece(s) for k, s in specs[-1].items()
                 if k != "labels" or shape.kind == "train"}
        if shape.kind == "train":
            ospec = opt_state_specs(cfg, mesh, rules, tcfg)
            opt = {k: torch.zeros((), dtype=torch.int32, device="meta")
                   if k == "step" else tree_map(piece, v)
                   for k, v in ospec.items()}
            step = build_train_step(cfg, tcfg, rules, pm)

            def run():
                step(params, opt, batch)
        elif shape.kind == "decode":
            caches = shard_caches(cfg, shape.global_batch, shape.seq_len, pm,
                                  rules)
            step = build_serve_step(cfg, rules, pm)

            def run():
                step(params, caches, batch)
        else:
            step = build_prefill_step(cfg, rules, pm)

            def run():
                step(params, batch)
        with ShardMeter() as meter:
            run()
    return {"temp_bytes": meter.peak, "collectives": meter.collectives,
            "counts": meter.counts}


# ---------------------------------------------------------------- the store

def _store_segments(n_rows: int, cfg, dev) -> dict:
    """The store cell's segments, all rows at once, as (n_rows, m) tensors
    on ``dev`` (m the segments a full row has): each one's first key
    ``k0``, key gap ``gap``, key count ``len`` (0 past a row's keys) and
    the sign ``sign`` of its model's error; and the row length ``per`` and
    segment length ``L``.

    Segment ``g`` of row ``s`` holds the global indices ``s * per + g * L +
    t``, t < len, at keys ``k0 + gap * t``; the next segment starts ``gap``
    after its last key, so keys rise through every row and row."""
    per = -(-cfg.n_keys // n_rows)
    L = max(_SEG_MIN, -(-per // cfg.seg_cap))
    m = -(-per // L)
    s = torch.arange(n_rows, dtype=torch.int64, device=dev)[:, None]
    g = torch.arange(m, dtype=torch.int64, device=dev)[None, :]
    cnt = (cfg.n_keys - s * per).clamp(0, per)
    n = (cnt - g * L).clamp(0, L)
    gid = s * m + g
    h = (gid * 2654435761) % (1 << 32)       # Knuth's multiplicative hash
    gap = 2 * (1 + (h >> 16) % _GAPS)
    run = gap * n
    k0 = torch.cumsum(run.flatten(), 0).view(run.shape) - run
    sign = 1 - 2 * ((h >> 8) & 1)
    return {"k0": k0, "gap": gap, "len": n, "sign": sign, "per": per,
            "L": L}


def store_keys(seg: dict, i: torch.Tensor) -> torch.Tensor:
    """The keys of global indices ``i`` under :func:`_store_segments`."""
    s, j = i // seg["per"], i % seg["per"]
    g, t = j // seg["L"], j % seg["L"]
    return seg["k0"][s, g] + seg["gap"][s, g] * t


def store_row(s: int, n_rows: int, cfg, dev) -> dict:
    """Row ``s`` of ``n_rows`` of the store cell's stacked state, on
    ``dev``, in ``core.distributed``'s layout, with no host fit: the
    equal-count key range of ``build_dist_state`` at the keys of
    :func:`_store_segments`, value pointers ``4i + 1`` for the global
    indices ``i``, and a PLR model with one line for each of the row's
    segments (up to ``cfg.seg_cap``).  A segment's model misplaces its keys by an
    error that runs linearly from ``-sign * delta`` at its first key to
    ``sign * delta`` at its last, the most ``bounded_search``'s window
    allows, so the search has real windows to read."""
    seg = _store_segments(n_rows, cfg, dev)
    per, L = seg["per"], seg["L"]
    k0, gap, n, sign = (seg[k][s] for k in ("k0", "gap", "len", "sign"))
    cnt = int(n.sum())
    nseg = int((n > 0).sum())
    cap = cfg.shard_cap(n_rows)
    i = torch.arange(s * per, s * per + cnt, dtype=torch.int64, device=dev)
    keys = torch.full((1, cap), KEY_SENTINEL, dtype=torch.int64, device=dev)
    vptrs = torch.full((1, cap), -1, dtype=torch.int64, device=dev)
    keys[0, :cnt] = store_keys(seg, i)
    vptrs[0, :cnt] = i * _VPTR_STEP + _VPTR_BASE
    lo = int(keys[0, 0]) if cnt else KEY_SENTINEL
    hi = int(keys[0, cnt - 1]) if cnt else KEY_SENTINEL
    # pos(p) = g L + t + err(t), t = (p - k0) / gap, err(t) = sign delta
    # (2 t / (len - 1) - 1): linear in p, so slope and intercept are exact
    k0, gap, n, sign = (x[:nseg].to(torch.float64)
                        for x in (k0, gap, n, sign))
    err = torch.where(n > 1, sign * cfg.delta, 0.0)
    slope = (1 + 2 * err / (n - 1).clamp(min=1)) / gap
    g = torch.arange(nseg, dtype=torch.float64, device=dev)
    icept = g * L - err - slope * k0

    def pad(v, fill):
        out = torch.full((1, cfg.seg_cap), fill, dtype=torch.float64,
                         device=dev)
        out[0, :nseg] = v
        return out

    def one(v, dtype):
        return torch.tensor([v], dtype=dtype, device=dev)

    return {"keys": keys, "vptrs": vptrs, "n": one(cnt, torch.int32),
            "lo": one(lo, torch.int64), "hi": one(hi, torch.int64),
            "starts": pad(k0, float("inf")), "slopes": pad(slope, 0.0),
            "icepts": pad(icept, 0.0), "nseg": one(nseg, torch.int32)}


def store_probes(cfg, g: int, dev, n_rows: int) -> tuple:
    """GET ``g``'s ``cfg.probe_batch`` probes on ``dev`` over the state of
    ``n_rows`` rows, and their answers (found, vptr): uniform global
    indices from a generator seeded STORE_SEED + g, every odd probe moved
    to the absent key after its index's."""
    gen = torch.Generator(device=dev).manual_seed(STORE_SEED + g)
    i = torch.randint(0, cfg.n_keys, (cfg.probe_batch,), generator=gen,
                      dtype=torch.int64, device=dev)
    absent = torch.arange(cfg.probe_batch, device=dev) % 2 == 1
    probes = store_keys(_store_segments(n_rows, cfg, dev), i) \
        + absent.to(torch.int64)
    vptr = torch.where(absent, -1, i * _VPTR_STEP + _VPTR_BASE)
    return probes, ~absent, vptr


def _store_mesh(devices, multi_pod: bool):
    """The production mesh over ``devices`` (None: the card repeated; one
    name: that device repeated), or, for a list of another length n, a
    ("data", "model") mesh of (n // m, m), m the largest power of two with
    m * m <= n."""
    size = 512 if multi_pod else 256
    if devices is None or isinstance(devices, (str, torch.device)) \
            or len(devices) == size:
        return make_production_mesh(multi_pod=multi_pod, devices=devices)
    n = len(devices)
    m = 1 << ((n.bit_length() - 1) // 2)
    return Mesh(tuple(devices), ("data", "model"), (n // m, m))


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_answers(found, vptr, want_f, want_v, combine: str, g: int):
    """Every piece of the GET's answer against the closed form; raises on
    the first wrong one."""
    pieces = [(torch.cat([f.to(want_f.device) for f in found]),
               torch.cat([v.to(want_v.device) for v in vptr]))] \
        if combine == "reduce_scatter" else \
        [(f.to(want_f.device), v.to(want_v.device))
         for f, v in zip(found, vptr)]
    for f, v in pieces:
        bad_f = int((f != want_f).sum())
        bad_v = int((v != want_v).sum())
        if bad_f or bad_v:
            raise RuntimeError(f"store GET {g}: {bad_f} found and {bad_v} "
                               f"vptr answers of {want_f.shape[0]} wrong")


def _run_store(mesh, cfg, seg_search: str, combine: str) -> dict:
    """Build the state on ``mesh``, run the GET STORE_GETS times, check
    every answer; the measurements."""
    dev = mesh.devices[0]
    cuda = dev.type == "cuda"
    _sync(dev)
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state = [store_row(s, mesh.size, cfg, d)
             for s, d in enumerate(mesh.devices)]
    fn = build_dist_get(mesh, cfg, seg_search=seg_search, combine=combine)
    _sync(dev)
    build_s = time.perf_counter() - t0
    ops.reset_launches()
    times = []
    for g in range(STORE_GETS):
        probes, want_f, want_v = store_probes(cfg, g, dev, mesh.size)
        _sync(dev)
        t = time.perf_counter()
        found, vptr = fn(state, probes)
        _sync(dev)
        times.append((time.perf_counter() - t) * 1e3)
        _check_answers(found, vptr, want_f, want_v, combine, g)
    out = {"device": torch.cuda.get_device_name(dev) if cuda else dev.type,
           "gets": STORE_GETS, "answers_checked": STORE_GETS * cfg.probe_batch,
           "get_ms": times, "median_get_ms": statistics.median(times),
           "launches_per_get": {k: v / STORE_GETS
                                for k, v in ops.launches.items()},
           "state_bytes": sum(t.numel() * t.element_size()
                              for row in state for t in row.values()),
           "build_s": build_s,
           "peak_device_bytes": (torch.cuda.max_memory_allocated(dev)
                                 if cuda else None)}
    if cuda:
        out["card"] = _card()
    return out


def run_store_cell(*, multi_pod: bool = False, n_keys: int = 1 << 30,
                   probe_batch: int = 1 << 20, seg_search: str = "bisect",
                   combine: str = "reduce_scatter", devices=None) -> dict:
    """The distributed Bourbon store (the paper's own workload):
    range-partitioned state over every mesh position, one batched GET.
    The plan's bytes come from ``dist_state_specs``; unless ``devices`` is
    ``"meta"``, the state is then built and the GET run and checked
    (``measured``)."""
    mesh = _store_mesh(devices, multi_pod)
    cfg = DistStoreConfig(n_keys=n_keys, probe_batch=probe_batch)
    S, B = mesh.size, probe_batch
    res = {"arch": "bourbon_kv", "shape": f"get_{probe_batch}",
           "mesh": _mesh_tag(mesh), "n_keys": n_keys,
           "probe_batch": probe_batch, "seg_search": seg_search,
           "combine": combine}
    t0 = time.time()
    specs = dist_state_specs(mesh, cfg)
    row = sum(t.numel() * t.element_size() for t in specs.values()) // S
    gathered = 1 if combine == "reduce_scatter" else S
    arg = row + B // S * 8
    out = B // S * gathered * (1 + 8)
    temp = B * _STORE_TEMP_PER_PROBE
    res["memory"] = {"argument_bytes": arg, "output_bytes": out,
                     "temp_bytes": temp, "alias_bytes": 0,
                     "peak_bytes": arg + temp + out}
    res["temp_scope"] = "one position's GET buffers (count)"
    window = 2 * cfg.delta + 3
    steps = math.ceil(math.log2(cfg.seg_cap + 1))
    # per position, every probe: the probe, its row, ModelLookup's bisect
    # over the starts, its segment's slope and intercept, the position,
    # the window's keys, the index, found and vptr, and the combine's
    # int8/int64 pair
    res["cost"] = {"flops": 2.0 * B,
                   "bytes accessed": float(B * (8 + 4 + 8 * steps + 16 + 4
                                                + 8 * window + 4 + 1 + 8
                                                + 9))}
    res["cost_split"] = "per position"
    res["collectives"] = {
        "all-gather": B * 8,
        "all-reduce": B * 9 if combine == "allreduce" else 0,
        "reduce-scatter": B // S * 9 if combine == "reduce_scatter" else 0,
        "all-to-all": 0, "collective-permute": 0}
    res["collectives_scope"] = "probes and answers"
    res["lower_s"] = round(time.time() - t0, 2)
    res["compile_s"] = None
    res["n_devices"] = S
    if mesh.devices[0].type != "meta":
        res["measured"] = _run_store(mesh, cfg, seg_search, combine)
    return res


# ------------------------------------------------------------------ the CLI

def _cache_path(out_dir, arch, shape, mesh_tag, suffix=""):
    return pathlib.Path(out_dir) / f"{arch}__{shape}__{mesh_tag}{suffix}.json"


def sweep(out_dir: str, multi_pod: bool, with_depth_variants: bool,
          jobs: list | None = None):
    """Run every cell in a subprocess (isolates each plan), cache JSON."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    mesh_tag = "multi" if multi_pod else "single"
    todo = jobs or [(a, s) for a in cbase.ARCHS for s in cbase.SHAPES]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_PORT, os.environ.get("PYTHONPATH")) if p))
    for arch, shape in todo:
        variants = [("", None)]
        if with_depth_variants:
            variants += [("__u1", 1), ("__u2", 2)]
        for suffix, units in variants:
            path = _cache_path(out, arch, shape, mesh_tag, suffix)
            if path.exists():
                print(f"[cached] {path.name}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--out", str(path)]
            if multi_pod:
                cmd.append("--multi-pod")
            if units is not None:
                cmd += ["--units", str(units), "--metering"]
            print(f"[run] {' '.join(cmd[3:])}", flush=True)
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=3600, env=env)
            if r.returncode != 0:
                err = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                       "units": units, "error": r.stderr[-4000:]}
                path.write_text(json.dumps(err, indent=1))
                print(f"  FAILED ({time.time()-t0:.0f}s): "
                      f"{r.stderr.strip().splitlines()[-1] if r.stderr else '?'}")
            else:
                print(f"  ok ({time.time()-t0:.0f}s)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--units", type=int, default=None)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="0 = auto (one seq per data shard for >=2B trains)")
    ap.add_argument("--rule", action="append", default=[],
                    help="logical=mesh_axis override, e.g. seq=model")
    ap.add_argument("--flash-kv-chunk", type=int, default=None)
    ap.add_argument("--metering", action="store_true")
    ap.add_argument("--scan-param-fsdp", action="store_true")
    ap.add_argument("--grad-accum-dtype", default="float32")
    ap.add_argument("--out", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--store", action="store_true",
                    help="run the distributed bourbon_kv store cell")
    ap.add_argument("--store-seg-search", default="bisect")
    ap.add_argument("--store-combine", default="reduce_scatter")
    ap.add_argument("--devices", default=None,
                    help="the store cell's device, repeated over the mesh "
                         "(default: the card; 'cpu'; 'meta' for the plan "
                         "alone)")
    ap.add_argument("--depth-variants", action="store_true")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    args = ap.parse_args(argv)

    if args.store:
        res = run_store_cell(multi_pod=args.multi_pod,
                             seg_search=args.store_seg_search,
                             combine=args.store_combine,
                             devices=args.devices)
    elif args.all:
        sweep(args.out_dir, args.multi_pod, args.depth_variants)
        return
    else:
        overrides = {}
        for r in args.rule:
            k, _, v = r.partition("=")
            overrides[k] = None if v in ("", "none", "None") else (
                tuple(v.split("+")) if "+" in v else v)
        res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       units=args.units, remat=args.remat,
                       microbatch=args.microbatch,
                       rule_overrides=overrides or None,
                       flash_kv_chunk=args.flash_kv_chunk,
                       metering=args.metering,
                       scan_param_fsdp=args.scan_param_fsdp,
                       grad_accum_dtype=args.grad_accum_dtype)
    js = json.dumps(res, indent=1, default=str)
    print(js)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(js)


if __name__ == "__main__":
    main()
