#!/usr/bin/env python
"""Phase M1's, N1's, O1's or O3's logit comparison, or phase P1's, P2's,
P3's, Q1's, Q2's or Q3's train-step comparison, for the sound port and
for controls that carry a deliberate fault in the sharded run: the
readings that chip_smoke.py's M_TOL["M1"], N_TOL["N1"], O_TOL["O1"],
O_TOL["O3"] and P_TOL, P_AUX_TOL are set between.

    python port/scripts/shard_tol_control.py
        [--tag M1|N1|O1|O3|P1|P2|P3|Q1|Q2|Q3] [--seeds 0 1 2] [--ulp]

Needs a CUDA card.  For each of SEEDS it runs the phase as
``chip_smoke.py`` does (M1: command-r-plus-104b at full width, 4 units;
N1: deepseek-v2-lite-16b at full width, its dense layer and 3 MoE units;
both bf16; O1: hymba-1.5b at full width, 2 layers, bf16; O3: xlstm-1.3b
at full width, one unit, f32; on a (data 2, model 2) mesh of four
processes under DEFAULT_RULES) and the same unsharded, and reads the
largest gap of each step's logits over the unsharded logits' largest
magnitude, and, for N1, the (layer, token) positions whose top-k experts
differ and the assignments each side dropped.  Each control patches one
fault into the sharded run's processes only, on seed 0:

  norm_bf16       (M1) LayerNorm computed in bf16, not in f32
  slot_late       each decode step's cache row (k and v; MLA's c_kv and
                  k_rope) written one slot late (the slot an offset error
                  in the split cache write would pick)
  no_offset       (N1) the MoE dispatch ranks each data rank's slots from
                  0, without the earlier data ranks' counts: the second
                  data rank keeps assignments the reference drops
  shared_dropped  (N1) the second of deepseek's two shared experts left
                  out (its rows of the shared w2 zeroed)
  h_kept          (O1) each decode step's new Mamba state h not written
                  back: the cache keeps the state the decode began from
  conv_late       (O1) the conv history kept one slot late: the K-1
                  oldest of the K inputs, not the newest
  slstm_stale     (O3, Q2) the sLSTM carry one step stale: each step hands
                  on the carry the step before it made, so every step
                  (and the decode's cache) starts from the state one step
                  behind (in training each time loop starts anew)
  conv_own_rows   (Q1) Mamba's conv_w gradient taken from each rank's own
                  rows: its partial sum over "data" left unreduced
  gate_partial    (Q3) the cross-attention block's gates' gradients left
                  partial over "data": the gated products on each rank's
                  rows, each rank updating by its own rows' share
  grads_unreduced (P, Q) the second data rank's gradients not reduced over
                  "data": it takes its own tokens' partial sum, as
                  autograd hands it back, for the gradient, wherever
                  the step reduces it after (every rank runs the same
                  collectives)
  local_norm      (P, Q) the clip's global norm over each rank's own pieces
                  (no all-reduce), so each rank clips by its own scale
  aux_local       (P3) the MoE aux loss over each rank's own tokens: its
                  counts and probability sums not summed over "data"

With ``--ulp`` (P1-P3, Q1-Q3) it runs no fault and no mesh: for each
seed, the run unsharded twice on the card, the second's parameters each
moved one ulp up on a random half of their entries, and it reads the same
gaps between the two runs: how far a run's own rounding moves it.

For P1-P3 and Q1-Q3 it runs ``chip_smoke.drive_sharded_train``'s steps
(rank 0's unsharded run, kept for the seed's later spawns, then the
ranks; P1 writes no checkpoint) and reads
the loss and grad-norm gap (relative), the largest gap of m and v after
the first step and of the parameters, master, m and v after the last
step (of each leaf's largest magnitude) and, for P3, the aux loss's gap
(relative) and the tokens whose experts differ, step by step.

Prints one JSON line a reading, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO_ROOT)
sys.path.insert(0, os.path.join(REPO_ROOT, "port"))

import chip_smoke  # noqa: E402
import numpy as np  # noqa: E402
from repro_torch.launch import spmd  # noqa: E402

SEEDS = (0, 1, 2)
FAULTS = {"M1": ("norm_bf16", "slot_late"),
          "N1": ("no_offset", "shared_dropped", "slot_late"),
          "O1": ("h_kept", "conv_late"),
          "O3": ("slstm_stale",),
          "P1": ("grads_unreduced", "local_norm"),
          "P2": ("grads_unreduced", "local_norm"),
          "P3": ("grads_unreduced", "local_norm", "aux_local"),
          "Q1": ("grads_unreduced", "local_norm", "conv_own_rows"),
          "Q2": ("grads_unreduced", "local_norm", "slstm_stale"),
          "Q3": ("grads_unreduced", "local_norm", "gate_partial")}


def _layer_norm_bf16(x, scale, eps):
    import torch
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale.to(x.dtype)


def _patch(fault) -> None:
    """``fault`` patched into this process's model code."""
    from repro_torch.models import attention, layers, moe, ssm

    if fault == "norm_bf16":
        layers.layer_norm = _layer_norm_bf16
    elif fault == "slot_late":
        write = attention.index_copy_
        attention.index_copy_ = (
            lambda dst, dim, index, src: write(dst, dim, index + 1, src))
    elif fault == "no_offset":
        route = moe.route
        moe.route = (lambda xg, router, K, C, before=None:
                     route(xg, router, K, C, None))
    elif fault == "shared_dropped":
        import torch
        glu = moe.glu_mlp

        def one_shared(x, p, act):
            n = p["w2"].shape[0]
            keep = (torch.arange(n, device=x.device) < n // 2)[:, None]
            return glu(x, {**p, "w2": p["w2"] * keep.to(p["w2"].dtype)},
                       act)
        moe.glu_mlp = one_shared
    elif fault in ("h_kept", "conv_late"):
        import torch
        import repro_torch.models.blocks as blocks
        step, pending = ssm.mamba_decode, {}

        def faulty_decode(x, p, cfg, cache):
            out, new = step(x, p, cfg, cache)
            if fault == "h_kept":
                return out, {**new, "h": cache["h"]}
            # the history stored without the newest input, which is held
            # back a step: a layer's window always one slot behind
            key = id(cache["conv"])
            late = pending.get(key)
            pending[key] = new["conv"][:, -1:]
            return out, {**new, "conv": cache["conv"] if late is None else
                         torch.cat([cache["conv"], late], dim=1)[:, 1:]}
        ssm.mamba_decode = blocks.mamba_decode = faulty_decode
    elif fault == "slstm_stale":
        step, loop, held = ssm._slstm_step, ssm._slstm_loop, {}

        def stale(R, bias, carry, wx):
            new, h = step(R, bias, carry, wx)
            out = held.get("carry", carry)
            held["carry"] = new
            return out, h

        def fresh(wx, R, bias):          # a training loop starts anew
            held.clear()
            return loop(wx, R, bias)
        ssm._slstm_step, ssm._slstm_loop = stale, fresh
    elif fault == "conv_own_rows":
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.launch import steps
        update = steps.adamw_update

        def own(path, g):
            # the rank's own rows' partial sum over "data" taken as the
            # gradient, unreduced
            if not (isinstance(g, DTensor) and path[-1] == "conv_w"):
                return g
            d = g.device_mesh.mesh_dim_names.index("data")
            if not g.placements[d].is_partial():
                raise ValueError(f"{'.'.join(path)}'s gradient laid out "
                                 f"as {g.placements}")
            places = [Replicate() if i == d else pl
                      for i, pl in enumerate(g.placements)]
            return DTensor.from_local(g.to_local(), g.device_mesh, places,
                                      run_check=False, shape=g.shape,
                                      stride=g.stride())

        def own_rows(params, grads, state, cfg, lr_scale=1.0):
            return update(params, _map_paths(own, grads), state, cfg,
                          lr_scale)
        steps.adamw_update = own_rows
    elif fault == "gate_partial":
        import torch
        import repro_torch.models.blocks as blocks
        from torch.distributed.tensor import DTensor, Replicate
        from repro_torch.launch import sharding
        from repro_torch.models import attention
        from repro_torch.models.layers import shard

        def own_gate(y, gate):
            # the product on each rank's rows, the gate's piece declared
            # whole: its gradient is the rank's own rows' share, never
            # summed over "data"
            if not isinstance(y, DTensor):
                return y * torch.tanh(gate).to(y.dtype)
            y = shard(y, ("batch", "seq", None))
            g = gate.to_local(grad_placements=tuple(
                Replicate() for _ in gate.placements))
            return sharding.from_pieces(
                y.to_local() * torch.tanh(g).to(y.dtype),
                tuple(y.placements), tuple(y.shape))
        attention.gated = blocks.gated = own_gate
    elif fault == "grads_unreduced":
        import torch
        from torch.distributed.tensor import DTensor, Replicate
        grad = torch.autograd.grad

        def unreduced(g):
            if not isinstance(g, DTensor):
                return g
            mesh = g.device_mesh
            d = mesh.mesh_dim_names.index("data")
            if not g.placements[d].is_partial():
                return g
            places = [Replicate() if i == d else pl
                      for i, pl in enumerate(g.placements)]
            right = g.redistribute(mesh, places)
            own = DTensor.from_local(g.to_local(), mesh, places,
                                     run_check=False, shape=g.shape,
                                     stride=g.stride())
            return own if mesh.get_coordinate()[d] == 1 else right

        def own_grads(outputs, inputs, *args, **kwargs):
            return tuple(unreduced(g) for g in
                         grad(outputs, inputs, *args, **kwargs))
        torch.autograd.grad = own_grads
    elif fault == "local_norm":
        import torch
        from repro_torch.models.layers import tree_leaves
        from repro_torch.optim import adamw

        def local_norm(tree):
            total = 0
            for g in tree_leaves(adamw._tree(tree)):
                total = total + torch.sum(torch.square(
                    adamw._local(g).to(torch.float32)))
            return torch.sqrt(total)
        adamw.global_norm = local_norm
    elif fault == "aux_local":
        from repro_torch.launch import sharding
        aux = moe._aux_mesh

        def own_tokens(probs, idx, E, K, coef, baxes, T):
            n = sharding.rank_index(baxes)[1] if baxes else 1
            return aux(probs, idx, E, K, coef, (), T // n)
        moe._aux_mesh = own_tokens
    elif fault is not None:
        raise ValueError(fault)


def _map_paths(fn, tree: dict, path: tuple = ()) -> dict:
    """``fn(path, leaf)`` over a nested dict, ``path`` its keys."""
    return {k: _map_paths(fn, v, path + (k,)) if isinstance(v, dict)
            else fn(path + (k,), v) for k, v in tree.items()}


def faulty_rank(rank, device, fault, tag, seed):
    """``chip_smoke.m_rank`` of run ``tag`` with ``fault`` patched into
    this process."""
    _patch(fault)
    return chip_smoke.m_rank(rank, device, (tag,), seed)[tag]


def faulty_p_rank(rank, device, fault, tag, seed, ref_root):
    """``chip_smoke.p_rank`` of run ``tag`` (no checkpoint; the unsharded
    reference kept in ``ref_root`` for the next spawn) with ``fault``
    patched into this process after rank 0's unsharded run."""
    return chip_smoke.p_rank(rank, device, (tag,), seed, ref_root, None,
                             patch=functools.partial(_patch, fault),
                             keep=True)[tag]


def train_readings(tag: str, devices, backend, seeds=SEEDS) -> None:
    """Phase P's or Q's run ``tag`` for each seed, sound and (seed 0) with
    each fault, one JSON line each."""
    import shutil
    import tempfile

    for seed in seeds:
        tmp = tempfile.mkdtemp(prefix="shard_tol_p_")
        try:
            for fault in (None,) + (FAULTS[tag] if seed == 0 else ()):
                ranks = spmd.run(faulty_p_rank, devices, backend,
                                 (fault, tag, seed, tmp))
                r = chip_smoke.p_readings(tag, ranks, ranks[0]["one"])
                rec = {"tag": tag, "seed": seed, "fault": fault,
                       "backend": backend,
                       **{k: r[k] for k in (
                           "gap_metrics", "gap_loss", "gap_grad_norm",
                           "gap_step1", "gap_step1_max",
                           "gap_leaves", "gap_leaves_max", "routing",
                           "sharded_step_ms", "unsharded_step_ms",
                           "sharded_s", "slstm_loop") if k in r}}
                if "gap_aux" in r:
                    rec.update(gap_aux=r["gap_aux"],
                               aux_sharded=r["aux_sharded"],
                               aux_unsharded=r["aux_unsharded"])
                print(json.dumps(rec), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def _ulp_leaves(real):
    """``chip_smoke.m_leaves`` with each leaf moved one ulp up on a
    random half of its entries (a draw of its own, seeded 1)."""
    def leaves(cfg, gen, device):
        import torch
        flip = torch.Generator(device=device).manual_seed(1)
        for name, t in real(cfg, gen, device):
            up = torch.rand(t.shape, generator=flip, device=t.device) < 0.5
            yield name, torch.where(
                up, torch.nextafter(t, torch.full_like(t, float("inf"))), t)
    return leaves


def _dir_gaps(got_dir: str, want_dir: str, step: int, kinds: tuple) -> dict:
    """The largest gap of each of ``kinds`` of leaf between two unsharded
    runs' states after ``step``, as a share of each leaf's largest
    magnitude (``chip_smoke._p_gaps``' reading), and the three leaves
    with the largest."""
    import pathlib

    import torch
    from repro_torch.checkpoint.ckpt import _load

    def leaves(root):
        d = pathlib.Path(root) / f"step_{step:08d}"
        with open(d / "manifest.json") as f:
            return d, json.load(f)["leaves"]
    (gd, got), (wd, want) = leaves(got_dir), leaves(want_dir)
    out, worst = {k: 0.0 for k in kinds}, []
    for kind in kinds:
        prefix = "p." if kind == "params" else f"o.{kind}."
        for name, meta in want.items():
            if not name.startswith(prefix):
                continue
            w = _load(wd / meta["file"], meta["dtype"]).cuda().float()
            g = _load(gd / got[name]["file"], meta["dtype"]).cuda().float()
            scale = float(w.abs().max())
            err = float((g - w).abs().max())
            share = err / scale if scale else err
            out[kind] = max(out[kind], share)
            worst.append((share, name))
    return out, [[n, s] for s, n in sorted(worst, reverse=True)[:3]]


def ulp_readings(tag: str, seeds=SEEDS) -> None:
    """Run ``tag`` unsharded twice for each seed, the second's parameters
    moved one ulp (``_ulp_leaves``); one JSON line a seed with the gaps
    between the two runs, read as ``chip_smoke.p_readings`` reads the
    sharded run's."""
    import shutil
    import tempfile

    import torch

    kinds = tuple(k for k in chip_smoke.P_LEAF_KINDS
                  if k != "master" or chip_smoke.p_config(tag).dtype
                  != "float32")        # a float32 run writes no master
    real = chip_smoke.m_leaves
    for seed in seeds:
        tmp = tempfile.mkdtemp(prefix="shard_tol_ulp_")
        try:
            runs = {}
            for which, leaves in (("base", real),
                                  ("ulp", _ulp_leaves(real))):
                chip_smoke.m_leaves = leaves
                try:
                    runs[which] = chip_smoke.p_unsharded(
                        tag, seed, os.path.join(tmp, which))
                finally:
                    chip_smoke.m_leaves = real
                torch.cuda.empty_cache()
            a, b = runs["ulp"], runs["base"]
            rel = {k: max(abs(x - y) / abs(y) for x, y in zip(a[k], b[k]))
                   for k in ("loss", "grad_norm")}
            step1, worst1 = _dir_gaps(os.path.join(tmp, "ulp"),
                                      os.path.join(tmp, "base"), 1,
                                      chip_smoke.P_STEP1_KINDS)
            last, worst = _dir_gaps(os.path.join(tmp, "ulp"),
                                    os.path.join(tmp, "base"),
                                    chip_smoke.P_STEPS, kinds)
            print(json.dumps({
                "tag": tag, "seed": seed, "fault": "ulp_unsharded",
                "gap_metrics": max(rel.values()), "gap_loss": rel["loss"],
                "gap_grad_norm": rel["grad_norm"],
                "grad_norm": [a["grad_norm"], b["grad_norm"]],
                "gap_step1": step1, "gap_step1_max": max(step1.values()),
                "worst_step1": worst1, "gap_leaves": last,
                "gap_leaves_max": max(last.values()), "worst_leaves": worst,
                "unsharded_step_ms": [a["step_ms"], b["step_ms"]]}),
                flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def gap(got: list, want: list) -> float:
    return max(float(np.abs(g - w).max() / np.abs(w).max())
               for g, w in zip(got, want))


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", choices=sorted(FAULTS), default="M1")
    ap.add_argument("--seeds", type=int, nargs="+", default=list(SEEDS),
                    help="the seeds to run (the faults run on seed 0)")
    ap.add_argument("--ulp", action="store_true",
                    help="P/Q tags: the run unsharded against itself with "
                         "its parameters moved one ulp, no mesh")
    args = ap.parse_args()
    tag, seeds = args.tag, tuple(args.seeds)
    if not torch.cuda.is_available():
        print("shard_tol_control: no CUDA device", file=sys.stderr)
        return 1
    if args.ulp:
        if tag not in chip_smoke.P_RUNS:
            ap.error("--ulp reads a train run (P1-P3, Q1-Q3)")
        ulp_readings(tag, seeds)
        print(chip_smoke.card_line())
        return 0
    backend, devices = spmd.card_layout(chip_smoke.M_PROCS)
    if tag in chip_smoke.P_RUNS:
        train_readings(tag, devices, backend, seeds)
        print(chip_smoke.card_line())
        return 0
    n_moe = chip_smoke.moe_layers(chip_smoke.m_config(tag))
    for seed in seeds:
        one = chip_smoke.m_unsharded(tag, seed)
        torch.cuda.empty_cache()
        for fault in (None,) + (FAULTS[tag] if seed == 0 else ()):
            ranks = spmd.run(faulty_rank, devices, backend,
                             (fault, tag, seed))
            rec = {"tag": tag, "seed": seed, "fault": fault,
                   "err_frac": gap(ranks[0]["logits"], one["logits"]),
                   "backend": backend}
            if one["routes"]:
                rec["moe"] = chip_smoke.m_routing(ranks, one, n_moe)
            print(json.dumps(rec), flush=True)
    print(chip_smoke.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
