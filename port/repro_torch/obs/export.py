"""Snapshot exporters: JSON, Prometheus text format, and a parser for
round-trip tests.

Both exporters consume the plain-dict shape :meth:`MetricsRegistry
.snapshot` returns (or a registry, which is snapshotted for you), so a
snapshot taken once can be rendered every way without re-collecting.
"""

from __future__ import annotations

import json

from .registry import Histogram, MetricsRegistry

__all__ = ["to_json", "to_prometheus", "parse_prometheus"]


def _snap(reg_or_snap) -> dict:
    if isinstance(reg_or_snap, MetricsRegistry):
        return reg_or_snap.snapshot()
    return reg_or_snap


def to_json(reg_or_snap) -> str:
    """Machine-readable snapshot; ``json.loads`` round-trips it exactly
    (every value is already a plain float/int/str/list/dict)."""
    return json.dumps(_snap(reg_or_snap), sort_keys=True)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt_value(v: float) -> str:
    return repr(float(v))


def to_prometheus(reg_or_snap) -> str:
    """Prometheus text exposition format.  Histograms expand into
    ``_bucket`` (cumulative, ``le`` label), ``_sum``, ``_count``, and a
    non-standard ``_max`` gauge."""
    snap = _snap(reg_or_snap)
    lines: list[str] = []
    for name in sorted(snap):
        fam = snap[name]
        kind = fam["kind"]
        lines.append(f"# TYPE {name} {kind}")
        for s in fam["samples"]:
            labels = s["labels"]
            if kind == "histogram":
                v = s["value"]
                cum = 0
                for bound, n in zip(Histogram.BOUNDS, v["buckets"]):
                    cum += n
                    lb = _fmt_labels({**labels, "le": repr(float(bound))})
                    lines.append(f"{name}_bucket{lb} {cum}")
                cum += v["buckets"][-1]
                lb = _fmt_labels({**labels, "le": "+Inf"})
                lines.append(f"{name}_bucket{lb} {cum}")
                lines.append(
                    f"{name}_sum{_fmt_labels(labels)} {_fmt_value(v['sum'])}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {v['count']}")
                lines.append(
                    f"{name}_max{_fmt_labels(labels)} {_fmt_value(v['max'])}")
            else:
                lines.append(f"{name}{_fmt_labels(labels)} "
                             f"{_fmt_value(s['value'])}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> dict:
    """Parse exposition text back to ``{(name, ((k, v), ...)): value}``
    — the inverse used by the round-trip tests.  Histogram series come
    back under their expanded names (``_sum``/``_count``/``_bucket``)."""
    out: dict = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        # name{label="v",...} value   |   name value
        if "{" in line:
            name, rest = line.split("{", 1)
            label_str, value_str = rest.rsplit("}", 1)
            labels = []
            # split on commas not inside quotes (values are escaped)
            depth_q = False
            cur = ""
            parts = []
            for ch in label_str:
                if ch == '"':
                    depth_q = not depth_q
                if ch == "," and not depth_q:
                    parts.append(cur)
                    cur = ""
                else:
                    cur += ch
            if cur:
                parts.append(cur)
            for p in parts:
                k, v = p.split("=", 1)
                v = v.strip()[1:-1]
                v = v.replace(r"\n", "\n").replace(r"\"", '"') \
                    .replace(r"\\", "\\")
                labels.append((k.strip(), v))
            key = (name.strip(), tuple(sorted(labels)))
        else:
            name, value_str = line.rsplit(None, 1)
            key = (name.strip(), ())
        out[key] = float(value_str)
    return out
