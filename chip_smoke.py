#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root; needs one card

Phases (any failure exits non-zero; none is caught and passed over):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every CUDA kernel from the repo's sources (one nvcc per source,
     all at once) and print the build seconds and ptxas's report;
  3. hold each kernel against its plain PyTorch version on the card, at
     the test shapes and at the serving paths' shapes; time the kernel, the
     plain version and, where one exists, one PyTorch library call
     computing the same function (a yardstick the port never calls), each
     with a cold L2; for flash also print the achieved TFLOP/s, the share
     of its bound and the ratio to the library's time; for RMSNorm also the
     wrapper's host µs per call beside the library call's;
  4. serve internlm2-1.8b at full published width (batch 4, prompt 512,
     32 generated tokens) through ``repro_torch.launch.serve.run`` with
     random weights from a seeded generator on the card; count the kernel
     launches of that run (every flash launch on the bf16 tensor-core
     kernel); hold its logits against the same prompts run through the
     plain path (every kernel replaced by its plain version);
  4b. the same for mamba2-130m (the ssm family: the SSD chunk kernel in
     prefill, every launch on its bf16 tensor-core kernel, RMSNorm in every
     forward), with its own counts and plain path;
  5. print one ``{"kernels": [...]}`` line, then the result line
     ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX and nothing of the JAX package ``src/repro``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# published peaks by model (NVIDIA data sheets; dense, no sparsity):
# (device memory bytes/s, bf16 tensor-core flop/s, fp32 non-tensor flop/s)
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12),
         "H100": (3.35e12, 989e12, 67e12)}          # SXM (80GB HBM3)
ARCH, BATCH, PROMPT, GEN, SEED = "internlm2-1.8b", 4, 512, 32, 0
SSM_ARCH = "mamba2-130m"
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RMSNORM_TOL = 2e-2
# The SSD kernels compute in fp32 (the bf16 tensor-core kernel through
# products split into bf16 halves, ~2^-18 of each term); the reference's
# own tolerance (tests/test_kernels.py), relative to max |y| and to
# max(max |h|, 1), holds both kernels for both input types.
SSD_TOL = 1e-4
# The serving run vs the plain path, max |diff| / max |logit|: 24 layers
# with a bf16 residual stream (48 bf16 adds) turn one-ulp rounding
# differences into ~3% on the logits; two plain paths that differ only in
# rounding (chunked vs reference attention) are printed as that noise
# floor. A wiring, masking or offset fault moves the logits by far more.
LOGITS_REL_TOL = 6e-2


def card_peaks(name: str) -> tuple[float, float, float]:
    for key, peaks in PEAKS.items():
        if key in name:
            return peaks
    raise SystemExit(f"chip_smoke: no published peaks for card {name!r}")


class ColdTimer:
    """Mean device ms of ``fn`` over ``n`` launches, each after reading a
    buffer larger than the 50 MB L2 (a read leaves no dirty lines for the
    timed launch to write back), with CUDA events around the launch only.
    After the flush the card spins (``torch.cuda._sleep``, ~0.1 ms) while
    the host queues the start event, ``fn`` and the end event behind it, so
    at launch-sized shapes the event pair reads device time, not the
    host's dispatch of ``fn``. The first ``warmup`` rounds are not counted:
    they bring the card's clocks up after a pause."""

    SPIN_CYCLES = 200_000

    def __init__(self, dev: torch.device):
        self.flush = torch.ones(32 << 20, dtype=torch.float32, device=dev)

    def __call__(self, fn, n: int = 20, warmup: int = 5) -> float:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(warmup + n)]
        for start, end in pairs:
            self.flush.sum()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs[warmup:]) / n


def require(ok: bool, what) -> None:
    """A check that ``python -O`` keeps: fail the run with ``what``."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def rel_err(ref: torch.Tensor, out: torch.Tensor) -> float:
    ref, out = ref.float(), out.float()
    return float((ref - out).abs().max() / (ref.abs().max() + 1e-9))


# ------------------------------------------------------------------ phase 3
def check_rmsnorm(dev, timer, peaks):
    from repro_torch.kernels.rmsnorm import ops, ref
    g = torch.Generator(device=dev).manual_seed(1)
    rows = {}
    # test shapes, then what each serving path gives the kernel: internlm2
    # (D 2048), mamba2's ln1/final norm (D 768) and its gated norm (D 1536)
    shapes = [(8, 128), (3, 5, 64), (257, 96), (1, 8),
              (BATCH * PROMPT, 2048), (BATCH, 1, 2048),
              (BATCH * PROMPT, 768), (BATCH, 1, 768),
              (BATCH * PROMPT, 1536), (BATCH, 1, 1536)]
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            w = torch.randn(shape[-1:], generator=g, device=dev)
            err = max_err(ops.rmsnorm(x, w), ref.rmsnorm_ref(x, w))
            torch.cuda.synchronize()
            print(f"rmsnorm {shape} {dtype}: max_abs_err {err:.3g}")
            require(err <= RMSNORM_TOL, (shape, dtype, err))
            if dtype == torch.bfloat16 and shape[-1] == 2048:
                rows[shape] = (x, w, err)
    out = None
    for shape, (x, w, err) in rows.items():
        d = x.shape[-1]
        w_lib = w.to(x.dtype)
        nbytes = 2 * x.numel() * x.element_size() + d * 4
        flops = 4 * x.numel()            # square+sum, scale, weight (fp32)
        t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[2] * 1e3
        r = {"ms": timer(lambda: ops.rmsnorm(x, w)),
             "plain_ms": timer(lambda: ref.rmsnorm_ref(x, w)),
             # the fused library kernel wants the weight in x's dtype
             "library_ms": timer(lambda: F.rms_norm(x, (d,), w_lib, 1e-5)),
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "max_abs_err": err}
        print(f"rmsnorm {shape} bf16: " + json.dumps(r)
              + f" ({r['ms'] / r['library_ms']:.2f}x the library's time)")
        if shape == (BATCH * PROMPT, 2048):
            out = r
    # the wrapper's own host cost at the decode shape, beside the library's
    from repro_torch.launch.rmsnorm_layouts import host_us
    x, w, _ = rows[(BATCH, 1, 2048)]
    w_lib = w.to(x.dtype)
    host = {"rmsnorm_us": host_us(lambda: ops.rmsnorm(x, w)),
            "library_us": host_us(lambda: F.rms_norm(x, (2048,), w_lib, 1e-5))}
    print(f"rmsnorm {(BATCH, 1, 2048)} bf16 host µs per call: "
          + json.dumps(host))
    return out


def check_flash(dev, timer, peaks):
    from repro_torch.kernels.flash_attention import ops, ref
    g = torch.Generator(device=dev).manual_seed(2)
    cases = [  # B, Sq, Sk, H, KV, D, causal, window, qoff
        (2, 128, 128, 4, 2, 64, True, 0, 0),
        (1, 256, 256, 8, 8, 32, True, 0, 0),
        (2, 128, 128, 4, 4, 64, True, 16, 0),
        (1, 64, 128, 4, 2, 64, True, 0, 64),
        (2, 128, 128, 2, 1, 128, False, 0, 0),
        (1, 512, 512, 2, 2, 64, True, 128, 0),
        (1, 15, 15, 2, 2, 64, True, 0, 0),
        (2, 32, 96, 4, 2, 64, True, 24, 0),            # + per-row offsets
        # the bf16 kernel's 64 x 64 tiles: ragged edges past one and two
        # tiles, GQA group 8, windows inside one kv tile and across two
        (2, 65, 129, 8, 1, 128, True, 0, 64),
        (1, 127, 127, 4, 1, 32, True, 40, 0),
        (2, 200, 260, 4, 2, 128, True, 100, 30),
        (BATCH, PROMPT, PROMPT + GEN, 16, 8, 128, True, 0, 0),  # prefill
    ]
    for i, (b, sq, sk, h, kvh, d, causal, window, qoff) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, sk, kvh, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, sk, kvh, d, generator=g, device=dev).to(dtype)
            off = qoff + torch.arange(b, dtype=torch.int32, device=dev) * (
                50 if i == 7 else 0)
            kw = dict(causal=causal, window=window)
            err = max_err(ops.flash_attention(q, k, v, off, **kw),
                          ref.attention_ref(q, k, v, off, **kw))
            torch.cuda.synchronize()
            print(f"flash {(b, sq, sk, h, kvh, d, causal, window, qoff)} "
                  f"{dtype}: max_abs_err {err:.3g}")
            require(err <= FLASH_TOL[dtype], (i, dtype, err))
    # the prefill shape, bf16, timed
    b, sq, sk, h, kvh, d = cases[-1][:6]
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, sk, kvh, d, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    off = torch.zeros(b, dtype=torch.int32, device=dev)
    kw = dict(causal=True, window=0)
    err = max_err(ops.flash_attention(q, k, v, off, **kw),
                  ref.attention_ref(q, k, v, off, **kw))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_err = max_err(lib().transpose(1, 2), ref.attention_ref(q, k, v, off, **kw))
    # the work this data needs: each query row against its unmasked keys
    pairs = b * h * sum(min(i + 1, sk) for i in range(sq))
    flops = 4 * d * pairs                   # q·k and p·v, 2 flops per MAC
    nbytes = 2 * q.numel() * 2 + 2 * k.numel() * 2 + off.numel() * 4
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    before_tc = ops.flash_attention.launches_tc
    out = {"ms": timer(lambda: ops.flash_attention(q, k, v, off, **kw)),
           "plain_ms": timer(lambda: ref.attention_ref(q, k, v, off, **kw)),
           "library_ms": timer(lib),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err}
    require(ops.flash_attention.launches_tc > before_tc,
            "the bf16 flash call did not run the tensor-core kernel")
    print(f"flash {tuple(q.shape)} x {tuple(k.shape)} bf16 causal: "
          + json.dumps(out) + f" (library vs plain max_abs_err {lib_err:.3g})")
    print(f"flash bf16 at the prefill shape: {flops / out['ms'] / 1e9:.1f} "
          f"TFLOP/s achieved, {out['bound_ms'] / out['ms']:.1%} of its bound, "
          f"{out['ms'] / out['library_ms']:.2f}x the library's time "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return out


def check_ssd(dev, timer, peaks):
    from repro_torch.kernels.ssd import ops, ref
    g = torch.Generator(device=dev).manual_seed(3)

    def inputs(b, s, h, p, n):
        """As the model makes them: dt = softplus(N(0, 0.55²)) and a = -e
        (the init's a_log = 1), so a 128-long chunk decays to cs ~ -240 and
        exp(cs_i - cs_j) overflows fp32 for j > i."""
        x = torch.randn(b, s, h, p, generator=g, device=dev)
        dt = F.softplus(0.55 * torch.randn(b, s, h, generator=g, device=dev))
        a = torch.full((h,), -2.718281828, device=dev)
        bm, cm = (0.5 * torch.randn(b, s, n, generator=g, device=dev)
                  for _ in range(2))
        return x, dt, a, bm, cm

    def cumsum(dt, a, chunk):
        b, s, h = dt.shape
        return torch.cumsum((dt * a).reshape(b, s // chunk, chunk, h),
                            2).reshape(b, s, h)

    def close(got, want):
        (y, h), (y_exp, h_exp) = got, want
        ey, eh = max_err(y, y_exp), max_err(h, h_exp)
        ok = (ey <= SSD_TOL * float(y_exp.abs().max())
              and eh <= SSD_TOL * max(float(h_exp.abs().max()), 1.0))
        return ok, ey, eh

    serving = (BATCH, PROMPT, 24, 64, 128, 128)
    cases = [  # b, S, H, P, N, chunk
        (2, 64, 3, 16, 32, 16), (1, 128, 4, 32, 16, 32),
        (2, 48, 2, 16, 8, 16), (1, 96, 8, 8, 8, 32),     # tests/test_kernels.py
        (2, 16, 16, 16, 16, 8),                          # reduced mamba2
        (1, 256, 4, 64, 16, 128),                        # jamba's SSMCfg
        serving,
    ]
    for case in cases:
        b, s, h, p, n, chunk = case
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, a, bm, cm = inputs(b, s, h, p, n)
            x, bm, cm = x.to(dtype), bm.to(dtype), cm.to(dtype)
            cs = cumsum(dt, a, chunk)
            ok, ey, eh = close(ops.ssd_chunk(x, dt, cs, bm, cm, chunk=chunk),
                               ref.ssd_chunk_ref(x, dt, cs, bm, cm, chunk=chunk))
            torch.cuda.synchronize()
            print(f"ssd_chunk {case} {dtype}: max_abs_err y {ey:.3g}, "
                  f"states {eh:.3g}")
            require(ok, (case, dtype, ey, eh))
    # the whole wrapper (pad, cumsum, kernel, inter-chunk scan) vs the
    # sequential oracle: a ragged S at the serving widths, from zero and
    # from a non-zero initial state
    for with_h0 in (False, True):
        x, dt, a, bm, cm = inputs(BATCH, 500, 24, 64, 128)
        x, bm, cm = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
        h0 = (torch.randn(BATCH, 24, 64, 128, generator=g, device=dev)
              if with_h0 else None)
        ok, ey, eh = close(ops.ssd(x, dt, a, bm, cm, chunk=128, h0=h0),
                           ref.ssd_ref(x, dt, a, bm, cm, h0=h0))
        torch.cuda.synchronize()
        print(f"ssd S=500 h0={'random' if with_h0 else 'zero'} vs ssd_ref: "
              f"max_abs_err y {ey:.3g}, h {eh:.3g}")
        require(ok, ("ssd vs ssd_ref", with_h0, ey, eh))

    # the serving shape, bf16, timed
    b, s, h, p, n, chunk = serving
    x, dt, a, bm, cm = inputs(b, s, h, p, n)
    x, bm, cm = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    cs = cumsum(dt, a, chunk)
    before_tc = ops.ssd.launches_tc
    y, st = ops.ssd_chunk(x, dt, cs, bm, cm, chunk=chunk)
    require(ops.ssd.launches_tc == before_tc + 1,
            "the bf16 serving-shape ssd_chunk did not run the tensor-core kernel")
    err = max_err(y, ref.ssd_chunk_ref(x, dt, cs, bm, cm, chunk=chunk)[0])
    nc = s // chunk
    # least work: the causal half (j <= i) of C Bᵀ and of W X, and B^T X
    tri = chunk * (chunk + 1) // 2
    flops = 2 * b * nc * h * (tri * n + tri * p + chunk * n * p)
    nbytes = (x.numel() * 2 + 2 * dt.numel() * 4 + 2 * bm.numel() * 2
              + y.numel() * 4 + st.numel() * 4)
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[1] * 1e3
    out = {"ms": timer(lambda: ops.ssd_chunk(x, dt, cs, bm, cm, chunk=chunk)),
           "plain_ms": timer(lambda: ref.ssd_chunk_ref(x, dt, cs, bm, cm,
                                                       chunk=chunk)),
           # no single PyTorch call computes this function
           "library_ms": None,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err}
    print(f"ssd_chunk {serving} bf16: " + json.dumps(out)
          + f" ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
          f"{out['bound_ms'] / out['ms']:.1%} of its bound, "
          f"{out['ms'] / out['bound_ms']:.2f}x it)")
    return out


# ------------------------------------------------------------------ phase 4
def plain_last_logits(cfg, params, tokens, attn_impl="chunked"):
    """The dense forward with every kernel replaced by plain torch:
    ``rmsnorm_ref``, and the ``chunked`` attention (fp32 online softmax, as
    the kernel computes it) or the ``reference`` one; last-position logits."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import layers, lm
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    b, s = tokens.shape
    h = lm.embed_lookup(cfg, params["embed"], tokens)
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    for i in range(cfg.num_layers):
        p = tree_map(lambda t: t[i], params["blocks"])
        x = rmsnorm_ref(h, p["ln1"], cfg.norm_eps)
        h = h + layers.attn_block(cfg, p["attn"], x, pos, window=None)[0]
        x = rmsnorm_ref(h, p["ln2"], cfg.norm_eps)
        h = h + layers.mlp_block(p["mlp"], x)
    h = rmsnorm_ref(h[:, -1], params["final_norm"], cfg.norm_eps)
    return h @ params["lm_head"]


def plain_ssm_last_logits(cfg, params, tokens, scan="chunked"):
    """The mamba2 forward with every kernel replaced by plain torch:
    ``rmsnorm_ref`` for every norm (the gated one inside the mixer too), and
    the reference model's chunked ``ssd_scan_reference`` or the sequential
    oracle ``ssd_ref``; last-position logits through the tied head."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.models import lm, ssd
    from repro_torch.models.params import tree_map
    scfg = cfg.ssm
    h = lm.embed_lookup(cfg, params["embed"], tokens)
    b, s, _ = h.shape
    for i in range(cfg.num_layers):
        p = tree_map(lambda t: t[i], params["blocks"])
        x = rmsnorm_ref(h, p["ln1"], cfg.norm_eps)
        m = p["ssm"]
        z, xbc, dt_raw, d_in, ns, nh = ssd._split_proj(
            scfg, cfg.d_model, x @ m["in_proj"])
        a = -torch.exp(m["a_log"])
        dt = F.softplus(dt_raw.float() + m["dt_bias"])
        conv, _ = ssd._causal_conv(xbc, m["conv_w"], m["conv_b"])
        xs, bm, cm = torch.split(conv, [d_in, ns, ns], dim=-1)
        xh = xs.reshape(b, s, nh, scfg.head_dim)
        if scan == "chunked":
            y, _ = ssd.ssd_scan_reference(xh, dt, a, bm, cm, scfg.chunk)
        else:
            y, _ = ssd_ref(xh, dt, a, bm, cm)
        y = y + (xh.float() * m["d_skip"][None, None, :, None]).to(y.dtype)
        y = rmsnorm_ref(y.reshape(b, s, d_in) * F.silu(z.float()).to(y.dtype),
                        m["norm_w"])
        h = h + (y.to(x.dtype) @ m["out_proj"]).to(x.dtype)
    h = rmsnorm_ref(h[:, -1], params["final_norm"], cfg.norm_eps)
    return h @ params["embed"].T


def launch_counters():
    """{count name: (wrapper, attribute)}; each attribute counts kernel
    launches since it was last set to 0. ``flash_attention_tc`` and
    ``ssd_tc`` count the launches that ran the bf16 tensor-core kernel of
    flash and of the SSD chunk."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"rmsnorm": (rn_ops.rmsnorm, "launches"),
            "flash_attention": (fa_ops.flash_attention, "launches"),
            "flash_attention_tc": (fa_ops.flash_attention, "launches_tc"),
            "ssd": (ssd_ops.ssd, "launches"),
            "ssd_tc": (ssd_ops.ssd, "launches_tc")}


def serve_path(dev, cfg, plain, alt, expect):
    """Serve ``cfg`` at full width through ``serve.run``: a warm-up, then
    the main path with every launch count set to 0 just before it and read
    just after. Requires the counts ``expect``; holds the prefill and last
    decode logits against ``plain(cfg, params, tokens)`` and prints beside
    them the noise floor to ``plain(cfg, params, tokens, alt)``, a plain
    path that differs only in rounding."""
    from repro_torch.data import synth
    from repro_torch.launch import serve
    from repro_torch.models import registry

    t0 = time.perf_counter()
    params = registry.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = synth.lm_tokens(SEED, BATCH * PROMPT + 1, cfg.vocab_size)[
        :BATCH * PROMPT].reshape(BATCH, PROMPT)
    torch.cuda.synchronize()
    print(f"{cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")

    serve.run(cfg, params, prompts, 2)            # warm-up: cuBLAS, libraries
    torch.cuda.reset_peak_memory_stats(dev)
    counters = launch_counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    res = serve.run(cfg, params, prompts, GEN)    # the main path
    launches = {name: getattr(wrapper, attr)
                for name, (wrapper, attr) in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tok_s = BATCH * (GEN - 1) / res.decode_s
    print(f"serve {cfg.name}: prefill {res.prefill_s * 1e3:.2f} ms; decode "
          f"{res.decode_s * 1e3:.2f} ms for {GEN - 1} steps ({tok_s:.1f} tok/s); "
          f"peak memory {peak_gb:.2f} GB; launches {launches}")

    require(launches == expect, (cfg.name, launches, expect))
    require(tuple(res.tokens.shape) == (BATCH, GEN), res.tokens.shape)
    require(0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size,
            "tokens out of the vocabulary")
    for t in (res.prefill_logits, res.last_logits):
        require(t.shape == (BATCH, cfg.vocab_size) and bool(torch.isfinite(t).all()),
                "logits of the wrong shape or not finite")

    with torch.inference_mode():
        tokens = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
        plain_prefill = plain(cfg, params, tokens)
        seq = torch.cat([tokens, res.tokens[:, :-1].to(dev)], 1)
        plain_last = plain(cfg, params, seq)
        floor = {"prefill": rel_err(plain_prefill, plain(cfg, params, tokens, alt)),
                 "last_decode": rel_err(plain_last, plain(cfg, params, seq, alt))}
    errs = {"prefill": rel_err(plain_prefill, res.prefill_logits),
            "last_decode": rel_err(plain_last, res.last_logits)}
    print(f"serve {cfg.name} vs plain path (max |diff| / max |logit|): {errs}; "
          f"noise floor between two plain paths: {floor}; "
          f"first sequence {res.tokens[0][:16].tolist()}")
    require(all(e < LOGITS_REL_TOL for e in errs.values()), errs)
    return launches


def serve_full(dev):
    """internlm2-1.8b: flash in each layer of prefill, every one on the
    bf16 tensor-core kernel; 2 norms a layer and the final norm in every
    forward (one prefill + GEN-1 decodes)."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(ARCH), attn_impl="flash")
    return serve_path(dev, cfg, plain_last_logits, "reference", {
        "rmsnorm": (2 * cfg.num_layers + 1) * GEN,
        "flash_attention": cfg.num_layers,
        "flash_attention_tc": cfg.num_layers, "ssd": 0, "ssd_tc": 0})


def serve_ssm(dev):
    """mamba2-130m: the SSD chunk kernel in each layer of prefill, every one
    on the bf16 tensor-core kernel; ln1 and
    the mixer's gated norm in each layer and the final norm in every
    forward. Decode is the recurrence in plain torch (no kernel there, as
    in the reference)."""
    from repro_torch import configs
    cfg = configs.get(SSM_ARCH)
    return serve_path(dev, cfg, plain_ssm_last_logits, "sequential", {
        "rmsnorm": (2 * cfg.num_layers + 1) * GEN,
        "flash_attention": 0, "flash_attention_tc": 0, "ssd": cfg.num_layers,
        "ssd_tc": cfg.num_layers})


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    peaks = card_peaks(name)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {name}; "
          f"peaks {peaks[0] / 1e12:.2f} TB/s, {peaks[1] / 1e12:.0f} TFLOP/s bf16, "
          f"{peaks[2] / 1e12:.0f} TFLOP/s fp32")

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {len(logs)} of {len(_build.sources())} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, log in logs.items():
        report = [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{os.path.relpath(src, ROOT)}:\n  " + "\n  ".join(report))

    timer = ColdTimer(dev)
    rows = {"rmsnorm": check_rmsnorm(dev, timer, peaks),
            "flash_attention": check_flash(dev, timer, peaks),
            "ssd": check_ssd(dev, timer, peaks)}
    del timer
    by_path = {ARCH: serve_full(dev), SSM_ARCH: serve_ssm(dev)}

    meta = {
        "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/rmsnorm.py:28"),
        "flash_attention": (
            "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention/flash_attention.py:109"),
        "ssd": ("src/repro_torch/kernels/ssd/csrc/ssd.cu",
                "src/repro/kernels/ssd/ssd.py:76"),
    }
    # launches: the sum over the main paths; each path's count beside it,
    # and for flash and ssd how many ran the bf16 tensor-core kernel
    kernels = []
    for k, (source, replaces) in meta.items():
        row = {"name": k, "route": "cuda", "source": source,
               "replaces": replaces,
               "launches": sum(n[k] for n in by_path.values()),
               "launches_by_path": {a: n[k] for a, n in by_path.items()}}
        if f"{k}_tc" in launch_counters():
            row["launches_tensor_core"] = sum(
                n[f"{k}_tc"] for n in by_path.values())
        kernels.append({**row, **rows[k]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
