"""Roofline analysis over dry-run records (twin of the JAX package's
``benchmarks/roofline.py``), on H100 constants.

    python -m repro_torch.launch.roofline --probe-dir results/dryrun \\
        --deploy-dir results/dryrun

Hardware model (NVIDIA H100 SXM per device; every constant is a
parameter of ``analyze_record``):
    peak dense bf16 compute : 989 TFLOP/s
    HBM bandwidth           : 3.35 TB/s, 80 GB
    link bandwidth          : 50 GB/s, one 400 Gb/s NDR NIC a GPU. Every
        16-member group of the 16×16 mesh spans more than one 8-GPU node,
        so the slowest link sets the ring; within a node NVLink gives
        450 GB/s a direction.

Records come from ``launch/dryrun.py``. The reference's XLA
``cost_analysis`` counts a while-loop body once, so its scanned graphs
need the ``--probe`` sweep (layers unrolled, one microbatch) for their
FLOPs; the port's trace walks every layer and microbatch, so its
deployment records count them all and can serve as their own probes.
A probe's terms are scaled back up by ``accum_scale`` (with the
optimizer's one-off bytes removed before scaling and re-added: ~24
B/param/device = bf16 param r/w + fp32 m,v r/w + fp32 grad read).

Terms per (arch × shape) cell, seconds:

    compute    = probe_flops_per_device · accum / peak
    memory     = modelled bytes per device / hbm_bw (``_memory_model_bytes``;
                 the traced "bytes accessed" of unfused ops is memory_hlo_s)
    collective = probe_collective_wire_bytes_per_device · accum / link_bw

plus MODEL_FLOPS/HLO_FLOPS (useful-compute ratio) and the roofline fraction
= ideal / dominant, ideal = max(model-FLOPs term, min-arg-bytes term).
"""
from __future__ import annotations

import glob
import json
import os

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_GB = 80.0
LINK_BW = 50e9
NVLINK_BW = 450e9            # within an 8-GPU node, a direction (not used
                             # by the terms: the rings cross nodes)
OPT_BYTES_PER_PARAM = 24.0   # bf16 p r/w + f32 m,v r/w + f32 grad read


# --------------------------------------------------------------------------
# Analytic fused-memory model (the reference's, term for term): what a
# fused executable moves, where the traced bytes of unfused ops overstate
# the device's traffic.
#
#   train    1.5·args  +  C_ACT·L·B_dev·S·d·2B   (residual-stream passes,
#            C_ACT = 12: ~4 fwd + 4 remat + 4 bwd)
#            + 6 passes over attention scores (fp32) when not flash/chunked
#            + MoE dispatch (k·cf blow-up, 3 passes)
#            + SSD intra-chunk decay tensors (3 passes, fp32)
#   prefill  args + 4 passes·L·B_dev·S·d·2B + 2 passes over scores + cache
#   decode   args (params + cache read once) + written cache slots
# --------------------------------------------------------------------------
def _memory_model_bytes(rec: dict, cfg, sh) -> float:
    n_data = 16                        # batch shards on the 16×16 pod
    n_model = 16
    b_dev = max(sh.batch // n_data, 1)
    args = rec.get("arg_bytes_per_device", 0.0)
    d = cfg.d_model
    L = cfg.num_layers if cfg.encdec is None else (
        cfg.encdec.enc_layers + cfg.encdec.dec_layers)
    heads_dev = max(cfg.num_heads // n_model, 1)
    s = sh.seq if cfg.encdec is None else min(sh.seq, 4096)

    def scores(sq, sk, passes):
        if cfg.attn_impl in ("chunked", "flash"):
            return 0.0   # online-softmax: scores never round-trip HBM
        total = 0.0
        for i in range(cfg.num_layers if cfg.encdec is None else 0):
            if not cfg.layer_is_attn(i):
                continue
            w = cfg.layer_window(i)
            eff = min(sk, w) if w else sk
            total += passes * heads_dev * b_dev * sq * eff * 4.0
        if cfg.encdec is not None:
            total += passes * heads_dev * b_dev * sq * sk * 4.0 * L
        return total

    moe = 0.0
    if cfg.moe is not None:
        n_moe = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
        moe = 3.0 * n_moe * cfg.moe.top_k * cfg.moe.capacity_factor \
            * b_dev * s * d * 2.0
    ssd = 0.0
    if cfg.ssm is not None:
        n_ssm = sum(not cfg.layer_is_attn(i) for i in range(cfg.num_layers))
        d_in = cfg.ssm.expand * d
        hh = d_in // cfg.ssm.head_dim
        ssd = 3.0 * n_ssm * b_dev * (s // max(cfg.ssm.chunk, 1) + 1) \
            * cfg.ssm.chunk ** 2 * hh * 4.0

    if sh.kind == "train":
        act = 12.0 * L * b_dev * s * d * 2.0
        return 1.5 * args + act + scores(s, s, 6) + 2 * moe + 2 * ssd
    if sh.kind == "prefill":
        act = 4.0 * L * b_dev * s * d * 2.0
        return args + act + scores(s, s, 2) + moe + ssd
    # decode: params + cache read once; tiny activations
    return args + 4.0 * L * b_dev * d * 2.0


def analyze_record(rec: dict, deploy: dict | None = None, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW, hbm_gb: float = HBM_GB
                   ) -> dict | None:
    """One record's roofline row (None for a failed record or one with no
    FLOPs); the memory-fit column is ``fits_hbm<hbm_gb>``."""
    if not rec.get("ok"):
        return None
    ca = rec.get("cost_analysis")
    if not isinstance(ca, dict) or "flops" not in ca:
        return None
    n = rec["n_devices"]
    accum = rec.get("accum_scale", 1) or 1
    flops_dev = ca["flops"] * accum
    bytes_dev = ca.get("bytes accessed", 0.0)
    if accum > 1:
        # optimizer traffic happens once per step, not per microbatch
        opt_bytes = OPT_BYTES_PER_PARAM * rec.get("param_count", 0) / n
        bytes_dev = max(bytes_dev - opt_bytes, 0.0) * accum + opt_bytes
    coll = rec.get("collectives", {})
    wire_dev = sum(coll.get("wire_bytes", {}).values()) * accum
    operand_dev = sum(coll.get("operand_bytes", {}).values()) * accum

    compute_s = flops_dev / peak_flops
    memory_hlo_s = bytes_dev / hbm_bw
    try:
        import dataclasses

        from .. import configs
        from . import shapes
        cfg = configs.get(rec["arch"])
        ov = {k: v for k, v in (rec.get("overrides") or {}).items()
              if k not in ("unroll", "grad_accum")}
        if ov:
            cfg = dataclasses.replace(cfg, **ov)
        sh = shapes.SHAPES[rec["shape"]]
        memory_s = _memory_model_bytes(rec, cfg, sh) / hbm_bw
    except Exception:
        memory_s = memory_hlo_s
    collective_s = wire_dev / link_bw
    dominant = max(
        [("compute", compute_s), ("memory", memory_s),
         ("collective", collective_s)], key=lambda kv: kv[1])

    model_flops = rec.get("model_flops_global", 0.0)
    useful_ratio = model_flops / (flops_dev * n) if flops_dev else 0.0

    ideal_compute = model_flops / (n * peak_flops)
    src = deploy or rec
    min_bytes_dev = src.get("arg_bytes_per_device", 0.0)
    ideal = max(ideal_compute, min_bytes_dev / hbm_bw)
    fraction = ideal / dominant[1] if dominant[1] > 0 else 0.0

    ma = (deploy or {}).get("memory_analysis") or rec.get("memory_analysis")
    temp_gb = (ma.get("temp_size_in_bytes", 0) / 1e9
               if isinstance(ma, dict) else float("nan"))
    arg_gb = src.get("arg_bytes_per_device", 0) / 1e9
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "tag": rec.get("tag", ""),
        "compute_s": compute_s, "memory_s": memory_s,
        "memory_hlo_s": memory_hlo_s,
        "collective_s": collective_s,
        "collective_operand_s": operand_dev / link_bw,
        "dominant": dominant[0],
        "useful_flops_ratio": useful_ratio,
        "roofline_fraction": fraction,
        "ideal_s": ideal,
        "temp_gb_per_device": temp_gb,
        "arg_gb_per_device": arg_gb,
        f"fits_hbm{hbm_gb:g}": (temp_gb + arg_gb) <= hbm_gb,
    }


def load_records(dirname: str) -> dict:
    out = {}
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        out[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    return out


def load_all(probe_dir: str = "results/probe",
             deploy_dir: str = "results/dryrun") -> list[dict]:
    probes = load_records(probe_dir)
    deploys = load_records(deploy_dir)
    rows = []
    for key, rec in sorted(probes.items()):
        row = analyze_record(rec, deploy=deploys.get(key))
        if row:
            rows.append(row)
    return rows


def markdown_table(rows: list[dict]) -> str:
    hdr = ("| arch | shape | compute s | memory s (model) | memory s (traced) "
           "| collective s | dominant | useful FLOPs | roofline frac "
           "| temp+arg GB/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['memory_hlo_s']:.3e} "
            f"| {r['collective_s']:.3e} | **{r['dominant']}** "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} "
            f"| {r['temp_gb_per_device'] + r['arg_gb_per_device']:.1f} |")
    return hdr + "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe-dir", default="results/probe")
    ap.add_argument("--deploy-dir", default="results/dryrun")
    ap.add_argument("--csv", action="store_true")
    args = ap.parse_args(argv)
    rows = load_all(args.probe_dir, args.deploy_dir)
    if args.csv:
        for r in rows:
            print(f"roofline_{r['arch']}_{r['shape']}"
                  f"{('_' + r['tag']) if r['tag'] and r['tag'] != 'probe' else ''},"
                  f"{r['compute_s']*1e6:.1f},"
                  f"dominant={r['dominant']};frac={r['roofline_fraction']:.3f};"
                  f"mem_us={r['memory_s']*1e6:.1f};"
                  f"coll_us={r['collective_s']*1e6:.1f}")
    else:
        print(markdown_table(rows))


if __name__ == "__main__":
    main()
