"""Roofline analysis over dry-run records (the port of
``repro.launch.roofline``), with the H100 figures of ``launch.mesh.HW``.

Three terms per (arch x shape x mesh), all in seconds:

  compute    = flops_per_device / peak_bf16
  memory     = bytes_per_device / hbm_bw
  collective = collective_bytes_per_device / link_bw   (NVLink; IB for "pod")

The port's plan runs every layer and chunk eagerly, so its counts are the
whole step's and ``analyze_cell`` takes them as they are (``metered`` is
true).  The reference compiles a scanned layer stack, counts one layer,
and corrects the count from ``--units 1`` and ``--units 2`` records:

  total(U) = cost(u2) + (U - 2) * (cost(u2) - cost(u1))

``_extrapolated`` keeps that formula, equal to the reference's, as a
check: over the port's plans it reproduces the full count when each unit
costs the same.

Also reports MODEL_FLOPS (6*N*D train / 2*N*D prefill / 2*N_active*B decode)
and the useful-compute ratio MODEL_FLOPS / plan FLOPs.
"""

from __future__ import annotations

import json
import pathlib

from .mesh import HW, hbm_bytes

__all__ = ["analyze_cell", "load_cells", "report", "model_flops"]


def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs per step for the whole job."""
    from repro_torch.configs.base import SHAPES, get_config
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence; attention reads the cache too but the
    # parameter term is the canonical model-flops convention
    return 2.0 * n_active * shape.global_batch


def _extrapolated(full: dict, u1: dict | None, u2: dict | None, key: str,
                  n_units: int) -> float:
    """Depth-delta extrapolation for a cost metric."""
    base = full.get("cost", {}).get(key)
    if u1 is None or u2 is None or "cost" not in u1 or "cost" not in u2:
        return float(base) if base is not None else 0.0
    c1 = float(u1["cost"].get(key, 0.0))
    c2 = float(u2["cost"].get(key, 0.0))
    per_unit = c2 - c1
    return c2 + (n_units - 2) * per_unit


def analyze_cell(full: dict):
    """Returns the roofline record for one cell, from its plan's own
    counts."""
    if "skipped" in full:
        return {"arch": full["arch"], "shape": full["shape"],
                "mesh": full.get("mesh"), "skipped": full["skipped"]}
    if "error" in full:
        return {"arch": full["arch"], "shape": full["shape"],
                "mesh": full.get("mesh"), "error": full["error"][-300:]}
    arch, shape = full["arch"], full["shape"]
    flops_dev = float(full["cost"]["flops"])
    bytes_dev = float(full["cost"]["bytes accessed"])
    coll = full.get("collectives", {})
    coll_bytes_dev = float(sum(coll.values()))
    multi = full.get("mesh") == "2x16x16"
    link_bw = HW.IB_BW if multi else HW.NVLINK_BW

    t_compute = flops_dev / HW.PEAK_BF16_FLOPS
    t_memory = bytes_dev / HW.HBM_BW
    t_coll = coll_bytes_dev / link_bw

    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    n_dev = full.get("n_devices", 256)
    mf = model_flops(arch, shape) if arch != "bourbon_kv" else 0.0
    mf_dev = mf / n_dev
    t_ideal = mf_dev / HW.PEAK_BF16_FLOPS
    return {
        "arch": arch, "shape": shape, "mesh": full.get("mesh"),
        "flops_per_dev": flops_dev, "bytes_per_dev": bytes_dev,
        "collective_bytes_per_dev": coll_bytes_dev,
        "collective_detail": coll,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_lower_bound_s": bound,
        "model_flops": mf,
        "useful_ratio": (mf_dev / flops_dev) if (flops_dev and mf) else 0.0,
        "roofline_fraction": (t_ideal / bound) if (bound and mf) else 0.0,
        "memory_peak_gib": full["memory"]["peak_bytes"] / 2**30,
        "fits_hbm": full["memory"]["peak_bytes"] <= hbm_bytes(),
        "compile_s": full.get("compile_s"),
        "metered": True,   # the plan counts every layer
    }


def load_cells(out_dir: str = "experiments/dryrun", mesh_tag: str = "single"):
    out = pathlib.Path(out_dir)
    cells = {}
    for p in sorted(out.glob(f"*__{mesh_tag}.json")):
        full = json.loads(p.read_text())
        cells[p.stem.replace(f"__{mesh_tag}", "")] = analyze_cell(full)
    return cells


def report(out_dir: str = "experiments/dryrun", mesh_tag: str = "single"):
    cells = load_cells(out_dir, mesh_tag)
    cols = ["arch", "shape", "dominant", "t_compute_s", "t_memory_s",
            "t_collective_s", "useful_ratio", "roofline_fraction",
            "memory_peak_gib", "fits_hbm"]
    lines = ["\t".join(cols)]
    for key in sorted(cells):
        c = cells[key]
        if "skipped" in c:
            lines.append(f"{c['arch']}\t{c['shape']}\tSKIP: {c['skipped'][:60]}")
            continue
        if "error" in c:
            lines.append(f"{c['arch']}\t{c['shape']}\tERROR")
            continue
        lines.append("\t".join([
            c["arch"], c["shape"], c["dominant"],
            f"{c['t_compute_s']:.4g}", f"{c['t_memory_s']:.4g}",
            f"{c['t_collective_s']:.4g}", f"{c['useful_ratio']:.3f}",
            f"{c['roofline_fraction']:.3f}", f"{c['memory_peak_gib']:.1f}",
            str(c["fits_hbm"]),
        ]))
    return "\n".join(lines)


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    print(report(args.out_dir, args.mesh))
