"""Dry-run report (twin of the JAX package's ``benchmarks/dryrun_report.py``):
one row per (arch × shape × mesh) record of ``launch/dryrun.py``.

    python -m repro_torch.launch.dryrun_report [results/dryrun]

Shows whether each cell traced on the 16×16 pod and the 2×16×16 two-pod
mesh (or its error's first line), its FLOPs and bytes per device, the
collectives DTensor issued (op counts and wire bytes), and the dominant
term and roofline fraction of ``launch/roofline.py`` on its H100
constants. "trace s" is the host's time to trace the step on fake
tensors, not a device time.
"""
from __future__ import annotations

import glob
import json
import os

from .roofline import analyze_record

_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
          "collective-permute")


def rows(dirname: str = "results/dryrun") -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        ma = r.get("memory_analysis")
        temp = (ma.get("temp_size_in_bytes", 0) if isinstance(ma, dict)
                else float("nan"))
        coll = r.get("collectives", {})
        counts = coll.get("counts", {})
        wire = sum(coll.get("wire_bytes", {}).values())
        ca = r.get("cost_analysis")
        roof = analyze_record(r) or {}
        out.append({
            "arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
            "ok": r.get("ok", False),
            "gflop": (ca.get("flops", 0) / 1e9 if isinstance(ca, dict)
                      else float("nan")),
            "dominant": roof.get("dominant", ""),
            "fraction": roof.get("roofline_fraction", float("nan")),
            "trace_s": r.get("trace_s", float("nan")),
            "arg_gb": r.get("arg_bytes_per_device", 0) / 1e9,
            "temp_gb": temp / 1e9,
            "wire_gb": wire / 1e9,
            "n_coll": sum(counts.values()),
            "counts": counts,
            "error": r.get("error", ""),
        })
    return out


def markdown(dirname: str = "results/dryrun") -> str:
    hdr = ("| arch | shape | mesh | ok | trace s | GFLOP/dev | args GB/dev | "
           "temp GB/dev | collectives (AR/AG/RS/A2A/CP) | wire GB/dev | "
           "dominant | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows(dirname):
        if not r["ok"]:
            err = r["error"].splitlines()[0][:100] if r["error"] else ""
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                         f"| ✗ {err} | | | | | | | | |")
            continue
        c = r["counts"]
        cs = "/".join(str(c.get(k, 0)) for k in _KINDS)
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| ✓ | {r['trace_s']:.1f} | {r['gflop']:.1f} "
            f"| {r['arg_gb']:.2f} | {r['temp_gb']:.1f} | {cs} "
            f"| {r['wire_gb']:.2f} | {r['dominant']} | {r['fraction']:.3f} |")
    return hdr + "\n".join(lines)


if __name__ == "__main__":
    import sys
    print(markdown(sys.argv[1] if len(sys.argv) > 1 else "results/dryrun"))
