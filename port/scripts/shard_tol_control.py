#!/usr/bin/env python
"""Phase M1's, N1's, O1's or O3's logit comparison, or phase P1's, P2's
or P3's train-step comparison, for the sound port and for controls that
carry a deliberate fault in the sharded run: the readings that
chip_smoke.py's M_TOL["M1"], N_TOL["N1"], O_TOL["O1"], O_TOL["O3"] and
P_TOL, P_AUX_TOL are set between.

    python port/scripts/shard_tol_control.py [--tag M1|N1|O1|O3|P1|P2|P3]
        [--seeds 0 1 2]

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
  slstm_stale     (O3) the sLSTM carry one step stale: each step hands
                  on the carry the step before it made, so every step
                  (and the decode's cache) starts from the state one step
                  behind
  grads_unreduced (P) the second data rank's gradients not reduced over
                  "data": it takes its own tokens' partial sum, as
                  autograd hands it back, for the gradient, wherever
                  the step reduces it after (every rank runs the same
                  collectives)
  local_norm      (P) the clip's global norm over each rank's own pieces
                  (no all-reduce), so each rank clips by its own scale
  aux_local       (P3) the MoE aux loss over each rank's own tokens: its
                  counts and probability sums not summed over "data"

For P1, P2 and P3 it runs ``chip_smoke.drive_sharded_train``'s steps
(the unsharded run, then the ranks; P1 writes no checkpoint) and reads
the loss and grad-norm gap (relative), the largest gap of m and v after
the first step and of the parameters, master, m and v after the last
step (of each leaf's largest magnitude) and, for P3, the aux loss's gap
(relative) and the tokens whose experts differ, step by step.

Prints one JSON line a reading, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
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
          "P3": ("grads_unreduced", "local_norm", "aux_local")}


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
        step, held = ssm._slstm_step, {}

        def stale(p, cfg, carry, wx):
            new, h = step(p, cfg, carry, wx)
            out = held.get("carry", carry)
            held["carry"] = new
            return out, h
        ssm._slstm_step = stale
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


def faulty_rank(rank, device, fault, tag, seed):
    """``chip_smoke.m_rank`` of run ``tag`` with ``fault`` patched into
    this process."""
    _patch(fault)
    return chip_smoke.m_rank(rank, device, (tag,), seed)[tag]


def faulty_p_rank(rank, device, fault, tag, seed, refs):
    """``chip_smoke.p_rank`` of run ``tag`` (no checkpoint) with ``fault``
    patched into this process."""
    _patch(fault)
    return chip_smoke.p_rank(rank, device, (tag,), seed, refs, None)[tag]


def train_readings(tag: str, devices, backend, seeds=SEEDS) -> None:
    """Phase P's run ``tag`` for each seed, sound and (seed 0) with each
    fault, one JSON line each."""
    import shutil
    import tempfile
    import torch

    for seed in seeds:
        tmp = tempfile.mkdtemp(prefix="shard_tol_p_")
        try:
            refs = {tag: os.path.join(tmp, tag)}
            one = chip_smoke.p_unsharded(tag, seed, refs[tag])
            one["s"] = 0.0
            torch.cuda.empty_cache()
            for fault in (None,) + (FAULTS[tag] if seed == 0 else ()):
                ranks = spmd.run(faulty_p_rank, devices, backend,
                                 (fault, tag, seed, refs))
                r = chip_smoke.p_readings(tag, ranks, one)
                rec = {"tag": tag, "seed": seed, "fault": fault,
                       "backend": backend,
                       **{k: r[k] for k in (
                           "gap_metrics", "gap_loss", "gap_grad_norm",
                           "gap_step1", "gap_step1_max",
                           "gap_leaves", "gap_leaves_max", "routing",
                           "sharded_step_ms", "unsharded_step_ms",
                           "sharded_s") if k in r}}
                if "gap_aux" in r:
                    rec.update(gap_aux=r["gap_aux"],
                               aux_sharded=r["aux_sharded"],
                               aux_unsharded=r["aux_unsharded"])
                print(json.dumps(rec), flush=True)
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
    args = ap.parse_args()
    tag, seeds = args.tag, tuple(args.seeds)
    if not torch.cuda.is_available():
        print("shard_tol_control: no CUDA device", file=sys.stderr)
        return 1
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
