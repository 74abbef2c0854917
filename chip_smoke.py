#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py          # from the repo root; needs one card

Phases (any failure exits non-zero; none is caught and passed over):
  1. the card's name and power limit, as nvidia-smi reports them;
  2. build every CUDA kernel from the repo's sources (one nvcc per source,
     all at once) and print the build seconds and ptxas's report, one line
     a kernel (registers, spill bytes);
  3. hold each kernel against its plain PyTorch version on the card, at
     the test shapes and at the serving and training paths' shapes (the
     RMSNorm backward at the train shape); time the kernel, the
     plain version and, where one exists, one PyTorch library call
     computing the same function (a yardstick the port never calls), each
     with a cold L2; for flash also print the achieved TFLOP/s, the share
     of its bound and the ratio to the library's time, at internlm2's
     prefill shape, at gemma3's local (window 1024) and global prefill
     shapes (head_dim 256), at granite-moe's (head_dim 64) and
     qwen2-moe's (head_dim 128, one query head a KV head) prefill shapes
     and at qwen2-vl's (a GQA group of 7) and jamba's, with the library's
     backend, then whisper's encoder (non-causal over 1,500 frames) and
     decoder prefill; RMSNorm also timed at widths 1024 (granite-moe), 3584
     (qwen2-vl), 4096 (jamba) and 8192 in fp32 (jamba's gated norm), each
     at its prefill and decode rows, and at whisper's encoder and decoder
     prefill rows (width 1024); SSD also at jamba's prefill shape
     (128 heads, d_state 16); for RMSNorm also the
     wrapper's host µs per call beside the library call's; for the RMSNorm
     backward the device kernels a call runs (one), and the library's
     backward timed as a CUDA-graph replay (its device time);
  4. serve internlm2-1.8b at full published width (batch 4, prompt 512,
     32 generated tokens) through ``repro_torch.launch.serve.run`` with
     random weights from a seeded generator on the card; count the kernel
     launches of that run (every flash launch on the bf16 tensor-core
     kernel); hold its logits against the same prompts run through the
     plain path (every kernel replaced by its plain version);
  4b. the same for mamba2-130m (the ssm family: the SSD chunk kernel in
     prefill, every launch on its bf16 tensor-core kernel, RMSNorm in every
     forward), with its own counts and plain path;
  4c. the same for gemma3-4b (the windowed family: 34 layers, head_dim
     256, ring KV caches for the 29 local layers) with a 1536-token
     prompt, longer than its 1024-key window: flash at head_dim 256 in
     every layer of prefill, all on the tensor-core kernel; logits held
     against the plain no-cache forward (the uniform stack with per-layer
     windows); the ring cache's bytes beside a uniform cache's, and the
     card's busy share of one profiled prefill and one decode step;
  4d. the MoE family at full width and depth: granite-moe-1b-a400m and
     qwen2-moe-a2.7b, as phase 4 serves internlm2 (flash in every layer of
     prefill, RMSNorm in every forward, exact counts). The capacity per
     expert follows the tokens of each call (1 in a decode step of batch
     4), so decode drops assignments and is not the no-cache forward of
     its tokens: the logits are held against a plain cached path (the
     same prefill and teacher-forced decode calls, every kernel replaced
     by its plain version), with the noise floor between two such paths
     and the share of top-k picks and kept slots on which the served and
     plain routings disagree; then a drop-free run (capacity factor = the
     expert count) against the plain no-cache forward; two served runs
     bitwise equal; the dropped share of assignments in prefill and
     decode, the KV cache's bytes, and one profiled prefill and decode
     step;
  4e. qwen2-vl-7b (the vlm family) at full width and depth: each prompt
     opens with a 256-patch vision prefix of seeded random embeddings and
     runs three different M-RoPE streams (Qwen2-VL's layout: t = 0, h =
     row, w = col over a 16 x 16 grid, text from 16 on); flash in every
     layer of prefill (28 query heads over 4 KV heads), exact counts; the
     logits against the plain no-cache forward with the noise floor
     beside; the served prefill with equal streams, and with the vision
     embeddings + 1, must each move the logits beyond that floor; one
     profiled prefill and decode step;
  4f. jamba-v0.1-52b (the hybrid family) at full width, cut to one group
     of 8 layers (its 32 do not fit the card), served as phase 4d serves
     its MoE configs: the SSD chunk kernel in the 7 Mamba-2 layers and
     flash in the attention layer of prefill, exact counts, two served
     runs bitwise equal, the logits on the served picks against the plain
     cached path (rmsnorm_ref, plain attention, the plain SSD scan), the
     routing's agreement and dropped shares, the drop-free run;
  4g. whisper-medium (the audio family) at full width and depth (24
     encoder and 24 decoder layers): 1,500 seeded random frames a row (the
     reference stubs the conv frontend) and a 128-token prompt; flash
     non-causal over every frame in each encoder layer and causal in each
     decoder layer of prefill, all on the tensor-core kernel, exact
     counts; the encoder states and the logits against the plain no-cache
     forward with the noise floor beside; the frames + 1 must move the
     served prefill beyond that floor; two served runs bitwise equal; one
     profiled prefill and decode step, and the share of the decode step's
     device time that the cross-attention K/V projections take;
  5. one Helix session on the card (``repro_torch.core``): a workflow
     params → prompts → prefill → decode serving internlm2-1.8b at full
     width and depth, run under ``Policy.ALWAYS`` (cold, a ``gen_tokens``
     edit, a restart on the same workdir) and under ``Policy.OPT`` (two
     iterations). Each iteration's counts are set to 0 just before it and
     read just after, and must match the states the planner chose (a
     reused prefill launches no flash kernel); its tokens must equal a
     direct prefill + decode on the same weights; every stored entry must
     reload from the disk tier onto the card bitwise equal to what its
     node computed. Prints times, per-tier bytes and seconds, and the
     device → host offload and disk → card load rates beside the host
     link that bounds them (``nvidia-smi``'s PCIe generation and width,
     and the measured rate of a pinned 1 GiB copy each way);
  6. train internlm2-1.8b at full width and depth on the card through
     ``repro_torch.launch.train``'s step loop (random state from a seeded
     generator, batch 4 x 512 from ``TokenBatcher``): 3 steps through the
     kernels (RMSNorm forward and backward in ``RMSNormFn``; the counts
     must be the remat arithmetic, 4L + 1 forwards and 2L + 1 backwards a
     step), the same 3 steps on the plain path, per-step loss and grad
     norm and the first step's norm-weight gradients held against it, the
     noise floor between two plain paths beside them; ms a step, tokens/s,
     peak memory and the card's busy share (one profiled step, its top
     kernels); then the resume check at reduced size: 4 steps with a
     segment at 2, a restart from step 2, bitwise the uninterrupted run;
  7. the LM workflow in a Helix session (``launch.bench_tier`` on the card:
     cold, warm, then an ``LI`` edit of ``peak_lr``), each iteration's
     counts matching the states the planner chose (a reused ``train``
     launches no backward), every stored ``TrainState`` (after the warm
     run and after the edit) reloading from disk onto the card bitwise
     equal to the memory tier's copy of what its node computed;
  8. the paper's four workflows (census, genomics, NLP, MNIST) at their
     default knobs in Helix sessions on the card, as in the paper's Fig. 5:
     ``launch.bench_workflows`` runs 10 iterations of each one's edit
     schedule under NM, AM and OPT (per-iteration wall seconds, cumulative
     seconds and speedup over NM, nodes computed / loaded / pruned, store
     bytes, the cold iteration's C(n) of every node); census, genomics and
     NLP give the same outputs under every policy in every iteration, and
     MNIST recomputes its random-FFT node in every one. Each deterministic
     learner runs twice on the card at its workflow's shapes, bitwise
     equal, and each workflow's values on the card are held against the
     same workflow run on the CPU. Then the daily-retrain census
     (``bench_incremental``: delta == cold, in under half its time). No
     hand-written kernel is on this path: every count must stay 0;
  9. the serving and fleet layer (``repro_torch.serve``, the sweep and
     search drivers) on the card: each workflow run alone first (phase 5's
     serving workflow of internlm2-1.8b at full width for 32 and 48
     tokens, and a 4-arm census grid at 120,000 rows), the grid again
     through ``run_sweep``; then one ``SessionServer`` (prefix schedule,
     2 session slots, the paper's 10 GB budget) on a unix socket, with two
     socket clients each submitting the serving workflow and a third the
     census grid, all at once: served tokens bitwise the isolated runs',
     census outputs equal, no signature blind-computed twice (every node
     computed twice printed with the planner's reason), flash and RMSNorm
     launched under the server, the wire summaries carrying the tokens'
     shape and dtype; each job's queued and running seconds, each serve
     node's C(n) alone beside in the server, the card's busy share over
     the run (``torch.profiler``). Then a fleet of two servers behind a
     hash ``FleetRouter``: the same submissions, then again through a
     fresh router, where every repeat lands on its home shard and
     recomputes nothing its shard holds (no kernel launched). Then
     ``tune`` over the census grid (reuse frontier, successive halving):
     0 wasted recomputes and 0 B ledger drift. Then
     ``launch.bench_fleet``'s six benches at ``FLEET_BENCH_SCALE``, their
     rows after the card's name and power limit;
  10. the engine benches and the examples: ``python -m
     repro_torch.launch.bench_engine`` in a subprocess on the card, BLAS
     pinned to one thread before numpy loads (OEP µs at 50/200/1000 nodes;
     the sequential against the pipelined engine on census and the
     12-tower MNIST, census outputs equal across the engines; the 8-wide
     diamond of 150 ms waits at >= 3x; each census learner's C(n) under
     both engines, and the card's busy share of one cold pipelined census
     iteration: the first card measurement of what one CUDA stream for
     every executor worker costs), then the eight examples of
     ``repro_torch.examples`` on the card at the reference's defaults
     (``serve_lm`` also at mamba2-130m; ``train_lm --small --steps 50``,
     then ``--resume`` after its last checkpoint is removed, bitwise the
     uninterrupted run), each with its exact launch counts (flash and
     RMSNorm under ``serve_lm``, SSD at mamba2, the RMSNorm forward and
     backward under ``train_lm``, none elsewhere) and its reference's bar
     (the PPR edit reruns only the reducer, no signature computed twice,
     0 B of ledger drift);
  11. print one ``{"kernels": [...]}`` line, then the result line
     ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX and nothing of the JAX package ``src/repro``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

# published peaks by model (NVIDIA data sheets; dense, no sparsity):
# (device memory bytes/s, bf16 tensor-core flop/s, fp32 non-tensor flop/s)
PEAKS = {"H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12),
         "H100": (3.35e12, 989e12, 67e12)}          # SXM (80GB HBM3)
ARCH, BATCH, PROMPT, GEN, SEED = "internlm2-1.8b", 4, 512, 32, 0
SSM_ARCH = "mamba2-130m"
# phase 4c: gemma3-4b's prompt is longer than its 1024-key window, so the
# prefill's ring write gathers (S > W), decode wraps the ring and flash
# masks by the window; the other phases keep PROMPT
WINDOWED_ARCH, WINDOWED_PROMPT = "gemma3-4b", 1536
# its flash calls in prefill, (B, Sq, Sk, H, KV, D, causal, window, qoff):
# a local layer attends within the prompt under the window, a global one
# over its full-length cache of prompt + generated tokens
WINDOWED_LOCAL = (BATCH, WINDOWED_PROMPT, WINDOWED_PROMPT, 8, 4, 256, True,
                  1024, 0)
WINDOWED_GLOBAL = (BATCH, WINDOWED_PROMPT, WINDOWED_PROMPT + GEN, 8, 4, 256,
                   True, 0, 0)
# phase 4d: the MoE family, served as phase 4 serves ARCH; their flash
# calls in prefill (B, Sq, Sk, H, KV, D, causal, window, qoff)
MOE_ARCHS = ("granite-moe-1b-a400m", "qwen2-moe-a2.7b")
GRANITE_PREFILL = (BATCH, PROMPT, PROMPT + GEN, 16, 8, 64, True, 0, 0)
QWEN2_MOE_PREFILL = (BATCH, PROMPT, PROMPT + GEN, 16, 16, 128, True, 0, 0)
# phase 4e: qwen2-vl-7b at full width and depth; a vision prefix of
# VLM_GRID x VLM_GRID patches (seeded random embeddings at the embedding
# table's init scale) and three different M-RoPE streams in Qwen2-VL's
# layout; its flash calls in prefill (a GQA group of 7)
VLM_ARCH, VLM_GRID, VLM_VISION_STD = "qwen2-vl-7b", 16, 0.02
QWEN2_VL_PREFILL = (BATCH, PROMPT, PROMPT + GEN, 28, 4, 128, True, 0, 0)
# phase 4f: jamba-v0.1-52b at full width, cut to one group of its 8
# layers (7 Mamba-2, 1 attention; 4 MoE of 16 experts): the 32 layers'
# 51.46 B parameters (103 GB in bf16) do not fit the card's 80 GB, 8
# layers' 13.27 B (26.5 GB) do. Its flash and SSD calls in prefill:
# (B, Sq, Sk, H, KV, D, causal, window, qoff) and (b, S, H, P, N, chunk)
HYBRID_ARCH, HYBRID_LAYERS = "jamba-v0.1-52b", 8
JAMBA_PREFILL = (BATCH, PROMPT, PROMPT + GEN, 32, 8, 128, True, 0, 0)
JAMBA_SSD = (BATCH, PROMPT, 128, 64, 16, 128)
# phase 4g: whisper-medium at full width and depth, 30 s of audio (its
# cross_len of 1,500 frames, seeded random frame embeddings: the reference
# stubs the conv frontend) and a 128-token decoder prompt (whisper takes up
# to 224 in a 448-token context); its flash calls in prefill: the encoder
# non-causal over every frame (no tile divides 1,500), then the decoder's
# causal self-attention over its cache
AUDIO_ARCH, AUDIO_FRAMES, AUDIO_PROMPT = "whisper-medium", 1500, 128
WHISPER_ENCODER = (BATCH, AUDIO_FRAMES, AUDIO_FRAMES, 16, 16, 64, False, 0, 0)
WHISPER_DEC_PREFILL = (BATCH, AUDIO_PROMPT, AUDIO_PROMPT + GEN, 16, 16, 64,
                       True, 0, 0)
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RMSNORM_TOL = 2e-2
# at qwen2-vl's and jamba's widths outputs reach |y| >= 4, where one bf16
# ulp (0.03125) is past RMSNORM_TOL, and the kernel's fp32 sum, in another
# order than the plain version's, rounds some of them the other way: those
# widths are held, as the card tests hold every layout case, at half a
# bf16 ulp (2^-8 relative) of the fp32 result, 1e-5 for fp32
ULP_WIDTHS = (3584, 4096, 8192)
# and so are whisper's rows at width 1024: the encoder's 6,000 x 1024
# outputs are enough for some to reach |y| >= 4 as well
ULP_SHAPES = ((BATCH * AUDIO_FRAMES, 1024), (BATCH * AUDIO_PROMPT, 1024))
# The SSD kernels compute in fp32 (the bf16 tensor-core kernel through
# products split into bf16 halves, ~2^-18 of each term); the reference's
# own tolerance (tests/test_kernels.py), relative to max |y| and to
# max(max |h|, 1), holds both kernels for both input types.
SSD_TOL = 1e-4
# phase 5: the session's KV cache holds the prompt and up to 64 generated
# tokens, so every iteration's prefill and decode see the same shapes
# whatever gen_tokens is; iterations decode 32, then 48 tokens.
SESSION_MAX_LEN = PROMPT + 64
SESSION_GEN = (32, 48)
# the memory tier holds params (3.78 GB) and the rest of the workflow
SESSION_MEM_BUDGET = 8e9
# The serving run vs the plain path, max |diff| / max |logit|: 24 layers
# with a bf16 residual stream (48 bf16 adds) turn one-ulp rounding
# differences into ~3% on the logits; two plain paths that differ only in
# rounding (chunked vs reference attention) are printed as that noise
# floor. A wiring, masking or offset fault moves the logits by far more.
LOGITS_REL_TOL = 6e-2
# phase 4d: routing is discrete. Where two experts nearly tie, a one-ulp
# difference in the bf16 hidden state picks the other and moves that
# token's logits by percents, and the change spreads to later layers and,
# through the capacity, to the other tokens of its expert. Two plain
# paths that differ only in rounding then differ by more than
# LOGITS_REL_TOL at qwen2-moe's 24 layers (PERF.md, section 6). So that bound
# holds the plain path run on the served path's top-k picks, which keeps
# every other step (gates, capacity, dispatch, experts, combine, caches);
# the routing is held by the share of (token, layer) rows on which the
# two paths, each on its own, pick alike: a wiring fault (a wrong router,
# softmax axis or top-k order) disagrees on nearly all of them.
ROUTING_DISAGREE_MAX = 0.5
# phase 6: the train path vs its plain path, per step and for the first
# step's norm-weight gradients (each leaf relative to its max |g|). Both
# run the same bf16 model; they differ only where the kernels round
# (a bf16 dx one ulp apart, dw summed in another order), which 24 layers
# amplify as in serving: held at the serving bound, with the floor between
# two plain paths (chunked vs reference attention) printed beside.
TRAIN_STEPS, TRAIN_LR, TRAIN_TOTAL = 3, 3e-3, 300   # the trainer's defaults
LOSS_REL_TOL = 1e-2
GRAD_REL_TOL = 6e-2


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


def ptxas_report(log: str) -> list[str]:
    """One line a kernel from ``nvcc -Xptxas -v``'s output: its name
    (demangled by ``c++filt`` where the machine has it, argument list
    dropped), registers and spill bytes."""
    rows, name, spill = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            spill = f"spill {m.group(1)} B stored / {m.group(2)} B loaded"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            rows.append((name, f"{m.group(1)} registers, {spill}"))
            name, spill = None, ""
    names = [n for n, _ in rows]
    if names and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(names), check=True,
                             capture_output=True, text=True).stdout
        names = [re.sub(r"\(anonymous namespace\)::", "", n).split("(")[0]
                 for n in out.splitlines()]
    return [f"{n}: {r}" for n, (_, r) in zip(names, rows)]


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
    # (D 2048), mamba2's ln1/final norm (D 768) and its gated norm (D 1536),
    # gemma3 (D 2560 over its longer prompt: blocks of 160 and 320 threads),
    # granite-moe (D 1024; qwen2-moe's D 2048 is internlm2's), qwen2-vl
    # (D 3584), jamba's norms (D 4096) and its gated norm (D 8192, fp32:
    # the SSD output times the gate), whisper's encoder and decoder prefill
    # (D 1024; its decode rows are granite-moe's)
    shapes = [(8, 128), (3, 5, 64), (257, 96), (1, 8),
              (BATCH * PROMPT, 2048), (BATCH, 1, 2048),
              (BATCH * PROMPT, 1024), (BATCH, 1, 1024),
              (BATCH * AUDIO_FRAMES, 1024), (BATCH * AUDIO_PROMPT, 1024),
              (BATCH * PROMPT, 768), (BATCH, 1, 768),
              (BATCH * PROMPT, 1536), (BATCH, 1, 1536),
              (BATCH * WINDOWED_PROMPT, 2560), (BATCH, 1, 2560),
              (BATCH * PROMPT, 3584), (BATCH, 1, 3584),
              (BATCH * PROMPT, 4096), (BATCH, 1, 4096),
              (BATCH * PROMPT, 8192), (BATCH, 1, 8192)]
    # the rows timed: (width, dtype) as the serving paths give them
    timed = {(1024, torch.bfloat16), (2048, torch.bfloat16),
             (2560, torch.bfloat16), (3584, torch.bfloat16),
             (4096, torch.bfloat16), (8192, torch.float32)}
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(shape, generator=g, device=dev).to(dtype)
            w = torch.randn(shape[-1:], generator=g, device=dev)
            y = ops.rmsnorm(x, w)
            err = max_err(y, ref.rmsnorm_ref(x, w))
            torch.cuda.synchronize()
            print(f"rmsnorm {shape} {dtype}: max_abs_err {err:.3g}")
            if shape[-1] in ULP_WIDTHS or shape in ULP_SHAPES:
                exp = ref.rmsnorm_ref(x.float(), w)
                rtol = 2.0 ** -8 + 1e-5 if dtype == torch.bfloat16 else 1e-5
                require(bool(((y.float() - exp).abs()
                               <= 1e-5 + rtol * exp.abs()).all()),
                        (shape, dtype, "past half a bf16 ulp", err))
            else:
                require(err <= RMSNORM_TOL, (shape, dtype, err))
            if (shape[-1], dtype) in timed:
                rows[shape] = [x, w, err, None]
    out = None
    for shape, row in rows.items():
        x, w, err, _ = row
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
        print(f"rmsnorm {shape} {x.dtype}: " + json.dumps(r)
              + f" ({r['ms'] / r['library_ms']:.2f}x the library's time)")
        row[3] = r
        if shape == (BATCH * PROMPT, 2048):
            out = r
    for d, label in ((1024, "d1024"), (3584, "d3584"), (4096, "d4096"),
                     (8192, "d8192_fp32")):
        out[f"{label}_prefill"] = rows[(BATCH * PROMPT, d)][3]
        out[f"{label}_decode"] = rows[(BATCH, 1, d)][3]
    out["d1024_whisper_encoder"] = rows[(BATCH * AUDIO_FRAMES, 1024)][3]
    out["d1024_whisper_decoder_prefill"] = rows[(BATCH * AUDIO_PROMPT, 1024)][3]
    # the wrapper's own host cost at the decode shape, beside the library's
    from repro_torch.launch.rmsnorm_layouts import host_us
    x, w, _, _ = rows[(BATCH, 1, 2048)]
    w_lib = w.to(x.dtype)
    host = {"rmsnorm_us": host_us(lambda: ops.rmsnorm(x, w)),
            "library_us": host_us(lambda: F.rms_norm(x, (2048,), w_lib, 1e-5))}
    print(f"rmsnorm {(BATCH, 1, 2048)} bf16 host µs per call: "
          + json.dumps(host))
    return out


def device_kernels(fn):
    """({kernel name: device µs}, {kernel name: launches}) of one call of
    ``fn`` (after a call that warms it up), from ``torch.profiler``."""
    from repro_torch.launch.profile_serve import _kernel_times
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return _kernel_times(prof)


def check_rmsnorm_bwd(dev, timer, peaks):
    """The backward kernel against ``rmsnorm_bwd_ref``: dx and dw, each
    relative to max(1, its max |ref|) (dw sums one term a row), at 2e-2
    (bf16 dx) and 2e-5 (fp32 dx, and dw for either); the device kernels one
    call runs at the train shapes (one: no fill, no second pass); then
    timed at internlm2's train shape, beside the plain version and the
    library's backward (``torch.autograd.grad`` through ``F.rms_norm``),
    with both's kernel durations from the profiler beside.
    The library's call is captured once in a CUDA graph and its replay
    timed (``library_ms``: its kernels' device time, one host call well
    inside the timer's spin); the eager call, whose autograd dispatch
    outlasts the spin, is kept as ``library_host_ms``."""
    from repro_torch.kernels.rmsnorm import ops, ref
    g = torch.Generator(device=dev).manual_seed(4)
    train = (BATCH * PROMPT, 2048)
    lm = (8 * 64, 128)      # the LM workflow's rows (LMKnobs: 8 x 64, D 128)
    shapes = [(8, 128), (3, 5, 64), (257, 96), (1, 8), (2049, 776), train,
              (BATCH, PROMPT, 2048), (257, 2048), lm, (600, 8192)]
    out = None
    for shape in shapes:
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = (torch.randn(shape, generator=g, device=dev).to(dtype)
                     for _ in range(2))
            w = torch.randn(shape[-1:], generator=g, device=dev)
            dx, dw = ops.rmsnorm_bwd(x, w, dy)
            dx_ref, dw_ref = ref.rmsnorm_bwd_ref(x, w, dy)
            torch.cuda.synchronize()
            scale = lambda t: max(1.0, float(t.abs().max()))  # noqa: E731
            ex, ew = max_err(dx, dx_ref), max_err(dw, dw_ref)
            route = ops.plan_bwd(x.numel() // shape[-1], shape[-1],
                                 x.element_size(), 132).route
            print(f"rmsnorm_bwd {shape} {dtype} ({route}): max_abs_err dx "
                  f"{ex:.3g}, dw {ew:.3g}")
            require(ex <= FLASH_TOL[dtype] * scale(dx_ref)
                    and ew <= FLASH_TOL[torch.float32] * scale(dw_ref),
                    ("rmsnorm_bwd", shape, dtype, ex, ew))
            if shape == train and dtype == torch.bfloat16:
                out = (x, w, dy, max(ex, ew))
            if shape in (train, lm) and dtype == torch.bfloat16:
                times, calls = device_kernels(lambda: ops.rmsnorm_bwd(x, w, dy))
                print(f"rmsnorm_bwd {shape} bf16: {sum(calls.values())} "
                      f"device kernel(s) a call, "
                      f"{sum(times.values()) / 1e3:.5f} ms profiled: "
                      f"{dict(calls)}")
                require(sum(calls.values()) == 1,
                        ("rmsnorm_bwd kernels a call", shape, dict(calls)))
                if shape == train:
                    profiled_ms = sum(times.values()) / 1e3
    x, w, dy, err = out
    again = ops.rmsnorm_bwd(x, w, dy)[1]
    require(torch.equal(again, ops.rmsnorm_bwd(x, w, dy)[1]),
            "rmsnorm_bwd's dw differs between two runs")
    d = x.shape[-1]
    xl = x.detach().requires_grad_()
    wl = w.to(x.dtype).requires_grad_()
    y_lib = F.rms_norm(xl, (d,), wl, 1e-5)
    lib_eager = lambda: torch.autograd.grad(  # noqa: E731
        y_lib, (xl, wl), dy, retain_graph=True)
    # the graph: leaves and forward made on the capture stream, so that
    # the backward's kernels (which run on their forward's stream) are
    # captured there
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        xg = x.detach().clone().requires_grad_()
        wg = w.to(x.dtype).requires_grad_()
        y_side = F.rms_norm(xg, (d,), wg, 1e-5)
        for _ in range(2):
            torch.autograd.grad(y_side, (xg, wg), dy, retain_graph=True)
    torch.cuda.current_stream().wait_stream(side)
    lib_graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(lib_graph, stream=side):
        dx_g, dw_g = torch.autograd.grad(y_side, (xg, wg), dy,
                                         retain_graph=True)
    lib_graph.replay()
    torch.cuda.synchronize()
    dx_e, dw_e = lib_eager()
    require(torch.equal(dx_g, dx_e) and torch.equal(dw_g, dw_e),
            "the library backward's graph replay differs from its eager call")
    lib_times, lib_calls = device_kernels(lib_eager)
    print(f"rmsnorm_bwd {tuple(x.shape)} bf16, library backward's device "
          f"kernels: {sum(lib_times.values()) / 1e3:.5f} ms in "
          f"{sum(lib_calls.values())} kernel(s)")
    for name, us in lib_times.most_common():
        print(f"  {us / 1e3:9.5f} ms {lib_calls[name]:3d}x  {name[:110]}")
    nbytes = 3 * x.numel() * x.element_size() + 2 * d * 4  # x, dy; dx; w; dw
    flops = 12 * x.numel()      # g, x², g·x, dx (4), dw (3), fp32
    t_bytes, t_ops = nbytes / peaks[0] * 1e3, flops / peaks[2] * 1e3
    row = {"ms": timer(lambda: ops.rmsnorm_bwd(x, w, dy)),
           "plain_ms": timer(lambda: ref.rmsnorm_bwd_ref(x, w, dy)),
           "library_ms": timer(lib_graph.replay),
           "library_host_ms": timer(lib_eager),
           # kernel durations alone, from torch.profiler (no launch)
           "profiled_ms": profiled_ms,
           "library_profiled_ms": sum(lib_times.values()) / 1e3,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err}
    print(f"rmsnorm_bwd {tuple(x.shape)} bf16: " + json.dumps(row)
          + f" ({nbytes / 1e6:.1f} MB; {row['bound_ms'] / row['ms']:.1%} of "
          f"its bound, {row['ms'] / row['library_ms']:.2f}x the library's "
          f"device time)")
    del lib_graph
    return row


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
        # head_dim 256 (gemma3's GQA 2): ragged past one and two tiles with
        # an offset, a window across two kv tiles; gemma3's local and
        # global prefill shapes
        (2, 65, 129, 8, 4, 256, True, 0, 64),
        (2, 200, 260, 4, 2, 256, True, 100, 30),
        WINDOWED_LOCAL,
        WINDOWED_GLOBAL,
        GRANITE_PREFILL,
        QWEN2_MOE_PREFILL,
        # qwen2-vl's GQA group of 7, ragged with an offset; its prefill;
        # jamba's
        (2, 65, 129, 7, 1, 128, True, 0, 64),
        QWEN2_VL_PREFILL,
        JAMBA_PREFILL,
        # whisper: non-causal ragged past 23 kv tiles of 64 (1,500 = 23 x 64
        # + 28), its encoder and its decoder prefill
        (1, AUDIO_FRAMES, AUDIO_FRAMES, 2, 2, 64, False, 0, 0),
        WHISPER_ENCODER,
        WHISPER_DEC_PREFILL,
        (BATCH, PROMPT, PROMPT + GEN, 16, 8, 128, True, 0, 0),  # prefill
    ]
    for i, (b, sq, sk, h, kvh, d, causal, window, qoff) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
            k = torch.randn(b, sk, kvh, d, generator=g, device=dev).to(dtype)
            v = torch.randn(b, sk, kvh, d, generator=g, device=dev).to(dtype)
            off = qoff + torch.arange(b, dtype=torch.int32, device=dev) * (
                50 if i in (7, 11, 12, 17) else 0)
            kw = dict(causal=causal, window=window)
            err = max_err(ops.flash_attention(q, k, v, off, **kw),
                          ref.attention_ref(q, k, v, off, **kw))
            torch.cuda.synchronize()
            print(f"flash {(b, sq, sk, h, kvh, d, causal, window, qoff)} "
                  f"{dtype}: max_abs_err {err:.3g}")
            require(err <= FLASH_TOL[dtype], (i, dtype, err))
    # the prefill shapes, bf16, timed: internlm2's (the row's own keys),
    # then gemma3's local and global layers, granite-moe's and qwen2-moe's
    out = time_flash(dev, timer, peaks, g, cases[-1], "internlm2 prefill")
    out["gemma3_local"] = time_flash(dev, timer, peaks, g, WINDOWED_LOCAL,
                                     "gemma3 local prefill")
    out["gemma3_global"] = time_flash(dev, timer, peaks, g, WINDOWED_GLOBAL,
                                      "gemma3 global prefill")
    out["granite_moe_prefill"] = time_flash(dev, timer, peaks, g,
                                            GRANITE_PREFILL,
                                            "granite-moe prefill")
    out["qwen2_moe_prefill"] = time_flash(dev, timer, peaks, g,
                                          QWEN2_MOE_PREFILL,
                                          "qwen2-moe prefill")
    out["qwen2_vl_prefill"] = time_flash(dev, timer, peaks, g,
                                         QWEN2_VL_PREFILL, "qwen2-vl prefill")
    out["jamba_prefill"] = time_flash(dev, timer, peaks, g, JAMBA_PREFILL,
                                      "jamba prefill")
    out["whisper_encoder"] = time_flash(dev, timer, peaks, g, WHISPER_ENCODER,
                                        "whisper encoder")
    out["whisper_decoder_prefill"] = time_flash(
        dev, timer, peaks, g, WHISPER_DEC_PREFILL, "whisper decoder prefill")
    return out


def time_flash(dev, timer, peaks, g, case, label):
    """One prefill shape in bf16: the kernel's, the plain version's and the
    library's cold-L2 ms beside the bound. The library call is
    ``F.scaled_dot_product_attention``: ``is_causal`` for a causal global
    layer (its causal mask is aligned top-left, as q_offset 0 is), an
    explicit boolean mask for a windowed one, no mask for a non-causal
    one; the backend it picks is printed from its kernels' names."""
    from repro_torch.kernels.flash_attention import ops, ref
    b, sq, sk, h, kvh, d, causal, window, qoff = case
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn(b, sk, kvh, d, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    off = torch.full((b,), qoff, dtype=torch.int32, device=dev)
    kw = dict(causal=causal, window=window)
    err = max_err(ops.flash_attention(q, k, v, off, **kw),
                  ref.attention_ref(q, k, v, off, **kw))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    require(qoff == 0 and (causal or not window),
            ("the library call assumes", case))
    if window:
        i = torch.arange(sq, device=dev)[:, None]
        j = torch.arange(sk, device=dev)[None, :]
        mask = (j <= i) & (i - j < window)
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    lib_err = max_err(lib().transpose(1, 2), ref.attention_ref(q, k, v, off, **kw))
    lib_kernels = device_kernels(lib)[0]
    # the work this data needs: each query row against its unmasked keys
    pairs = b * h * sum(min(i + 1 if causal else sk, sk, window or sk)
                        for i in range(sq))
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
    print(f"flash {label} {tuple(q.shape)} x {tuple(k.shape)} bf16 "
          f"{'causal' if causal else 'non-causal'}, window {window}: "
          + json.dumps(out)
          + f" (library vs plain max_abs_err {lib_err:.3g}; the library's "
          f"kernels: {[n[:80] for n, _ in lib_kernels.most_common(3)]})")
    print(f"flash bf16 at the {label} shape: {flops / out['ms'] / 1e9:.1f} "
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
        JAMBA_SSD,                                       # jamba's prefill
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

    # the serving shapes, bf16, timed: mamba2's (the row's own keys), then
    # jamba's (128 heads, in blocks of ``head_group`` heads)
    out = time_ssd(timer, peaks, inputs, cumsum, serving, "mamba2")
    out["jamba_prefill"] = time_ssd(timer, peaks, inputs, cumsum, JAMBA_SSD,
                                    "jamba")
    return out


def time_ssd(timer, peaks, inputs, cumsum, case, label):
    """One serving shape in bf16: the chunk kernel's and the plain
    version's cold-L2 ms beside the bound (no single PyTorch call
    computes this function); the launch must take the tensor-core
    kernel."""
    from repro_torch.kernels.ssd import ops, ref
    b, s, h, p, n, chunk = case
    x, dt, a, bm, cm = inputs(b, s, h, p, n)
    x, bm, cm = x.bfloat16(), bm.bfloat16(), cm.bfloat16()
    cs = cumsum(dt, a, chunk)
    before_tc = ops.ssd.launches_tc
    y, st = ops.ssd_chunk(x, dt, cs, bm, cm, chunk=chunk)
    require(ops.ssd.launches_tc == before_tc + 1,
            f"the bf16 {label} ssd_chunk did not run the tensor-core kernel")
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
           "library_ms": None,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "max_abs_err": err}
    print(f"ssd_chunk {label} {case} bf16: " + json.dumps(out)
          + f" ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP; "
          f"{out['bound_ms'] / out['ms']:.1%} of its bound, "
          f"{out['ms'] / out['bound_ms']:.2f}x it)")
    return out


# ------------------------------------------------------------------ phase 4
def plain_last_logits(cfg, params, tokens, attn_impl="chunked", *,
                      vision_embeds=None, mrope_positions=None):
    """The dense forward with every kernel replaced by plain torch:
    ``rmsnorm_ref``, and the ``chunked`` attention (fp32 online softmax, as
    the kernel computes it) or the ``reference`` one; last-position logits.
    No cache: every layer attends over the tokens under its own window
    (a windowed config's local layers), as the uniform stack does. The vlm
    family's ``vision_embeds`` replace the first embeddings and its
    ``mrope_positions`` (3, B, S) rotate q and k."""
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models import layers, lm
    from repro_torch.models.params import tree_map
    cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    b, s = tokens.shape
    h = lm.embed_lookup(cfg, params["embed"], tokens)
    if vision_embeds is not None:
        h = torch.cat([vision_embeds.to(h.dtype),
                       h[:, vision_embeds.shape[1]:]], 1)
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
    for i in range(cfg.num_layers):
        p = tree_map(lambda t: t[i], params["blocks"])
        x = rmsnorm_ref(h, p["ln1"], cfg.norm_eps)
        h = h + layers.attn_block(cfg, p["attn"], x, pos,
                                  window=cfg.layer_window(i),
                                  mrope_positions=mrope_positions)[0]
        x = rmsnorm_ref(h, p["ln2"], cfg.norm_eps)
        h = h + layers.mlp_block(p["mlp"], x)
    h = rmsnorm_ref(h[:, -1], params["final_norm"], cfg.norm_eps)
    return h @ (params["embed"].T if cfg.tie_embeddings else params["lm_head"])


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
    launches since it was last set to 0 (``rmsnorm_bwd`` counts calls, each
    of which launches its row kernel and its dw sum). ``flash_attention_tc`` and
    ``ssd_tc`` count the launches that ran the bf16 tensor-core kernel of
    flash and of the SSD chunk."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rn_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    return {"rmsnorm": (rn_ops.rmsnorm, "launches"),
            "rmsnorm_bwd": (rn_ops.rmsnorm_bwd, "launches"),
            "flash_attention": (fa_ops.flash_attention, "launches"),
            "flash_attention_tc": (fa_ops.flash_attention, "launches_tc"),
            "ssd": (ssd_ops.ssd, "launches"),
            "ssd_tc": (ssd_ops.ssd, "launches_tc")}


def serve_main(dev, cfg, expect, prompt=PROMPT, inputs=None):
    """Serve ``cfg`` at full width through ``serve.run`` (BATCH prompts of
    ``prompt`` tokens, GEN generated; the prefill inputs ``inputs``: the
    vlm family's vision embeddings and M-RoPE streams, or the audio
    family's frames): a warm-up, then the main path with every launch
    count set to 0 just before it and read just after. Requires the counts
    ``expect``, tokens in the vocabulary and finite logits. Returns the
    result, the launch counts, the parameters and the prompts."""
    from repro_torch.launch import serve
    from repro_torch.models import registry

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = registry.init(cfg, torch.Generator(device=dev).manual_seed(SEED), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    torch.cuda.empty_cache()
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = synth_prompts(cfg, prompt=prompt)
    depth = (cfg.num_layers if cfg.encdec is None else
             f"{cfg.encdec.enc_layers} + {cfg.encdec.dec_layers}")
    print(f"{cfg.name}: {depth} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params, init {init_s:.1f} s (peak "
          f"{init_gb:.2f} GB)")

    inputs = inputs or {}
    serve.run(cfg, params, prompts, 2, **inputs)  # warm-up: cuBLAS, libraries
    torch.cuda.reset_peak_memory_stats(dev)
    counters = launch_counters()
    _reset(counters)
    res = serve.run(cfg, params, prompts, GEN, **inputs)   # the main path
    launches = _read(counters)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    tok_s = BATCH * (GEN - 1) / res.decode_s
    print(f"serve {cfg.name}: prefill {res.prefill_s * 1e3:.2f} ms; decode "
          f"{res.decode_s * 1e3:.2f} ms for {GEN - 1} steps "
          f"({res.decode_s / (GEN - 1) * 1e3:.2f} ms a step, {tok_s:.1f} "
          f"tok/s); peak memory {peak_gb:.2f} GB; launches {launches}")

    require(launches == expect, (cfg.name, launches, expect))
    require(tuple(res.tokens.shape) == (BATCH, GEN), res.tokens.shape)
    require(0 <= int(res.tokens.min()) and int(res.tokens.max()) < cfg.vocab_size,
            "tokens out of the vocabulary")
    for t in (res.prefill_logits, res.last_logits):
        require(t.shape == (BATCH, cfg.vocab_size) and bool(torch.isfinite(t).all()),
                "logits of the wrong shape or not finite")
    return res, launches, params, prompts


def serve_path(dev, cfg, plain, alt, expect, prompt=PROMPT):
    """``serve_main``, then the prefill and last decode logits held against
    ``plain(cfg, params, tokens)``, with the noise floor to ``plain(cfg,
    params, tokens, alt)``, a plain path that differs only in rounding,
    printed beside them. Returns the launch counts, the parameters and the
    prompts."""
    res, launches, params, prompts = serve_main(dev, cfg, expect, prompt)
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
    return launches, params, prompts


def serve_full(dev):
    """internlm2-1.8b: flash in each layer of prefill, every one on the
    bf16 tensor-core kernel; 2 norms a layer and the final norm in every
    forward (one prefill + GEN-1 decodes)."""
    from repro_torch import configs
    cfg = dataclasses.replace(configs.get(ARCH), attn_impl="flash")
    return serve_path(dev, cfg, plain_last_logits, "reference", {
        "rmsnorm": (2 * cfg.num_layers + 1) * GEN, "rmsnorm_bwd": 0,
        "flash_attention": cfg.num_layers,
        "flash_attention_tc": cfg.num_layers, "ssd": 0, "ssd_tc": 0})[0]


def serve_ssm(dev):
    """mamba2-130m: the SSD chunk kernel in each layer of prefill, every one
    on the bf16 tensor-core kernel; ln1 and
    the mixer's gated norm in each layer and the final norm in every
    forward. Decode is the recurrence in plain torch (no kernel there, as
    in the reference)."""
    from repro_torch import configs
    cfg = configs.get(SSM_ARCH)
    return serve_path(dev, cfg, plain_ssm_last_logits, "sequential", {
        "rmsnorm": (2 * cfg.num_layers + 1) * GEN, "rmsnorm_bwd": 0,
        "flash_attention": 0, "flash_attention_tc": 0, "ssd": cfg.num_layers,
        "ssd_tc": cfg.num_layers})[0]


def serve_windowed(dev):
    """gemma3-4b at full width and depth (34 layers: 5 groups of 5 local
    ring layers and a global one, then 4 local tail layers), prompt
    WINDOWED_PROMPT: flash in each layer of prefill (29 local within the
    prompt under the window, 5 global over the full cache), every one on
    the bf16 tensor-core kernel at head_dim 256; 2 norms a layer and the
    final norm in every forward. Decode attends over the ring slots in
    plain torch (no kernel there, as in the reference). Then the ring
    cache's bytes beside a uniform cache's, and one profiled prefill and
    decode step."""
    from repro_torch import configs
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get(WINDOWED_ARCH), attn_impl="flash")
    n = cfg.num_layers
    launches, params, prompts = serve_path(
        dev, cfg, plain_last_logits, "reference", {
            "rmsnorm": (2 * n + 1) * GEN, "rmsnorm_bwd": 0,
            "flash_attention": n, "flash_attention_tc": n, "ssd": 0,
            "ssd_tc": 0}, prompt=WINDOWED_PROMPT)
    windowed_profile(dev, cfg, params, prompts)
    del params
    torch.cuda.empty_cache()
    print(f"serve {cfg.name}: phase 4c {time.perf_counter() - t_phase:.1f} s")
    return launches


def windowed_profile(dev, cfg, params, prompts):
    """The ring cache's bytes beside a uniform cache's at the serving
    max_len, then the card's busy share of one profiled prefill and one
    decode step (``profile_serving``)."""
    max_len = WINDOWED_PROMPT + GEN
    ring = cache_bytes(cfg, max_len)
    uniform = cache_bytes(dataclasses.replace(cfg, window_cache=False),
                          max_len)
    print(f"serve {cfg.name}: ring cache {ring / 1e6:.1f} MB, a uniform "
          f"cache {uniform / 1e6:.1f} MB at max_len {max_len} "
          f"({ring / uniform:.3f}x)")
    profile_serving(dev, cfg, params, prompts, max_len)


def cache_bytes(cfg, max_len) -> int:
    """Bytes of ``cfg``'s serving cache for BATCH rows of ``max_len``."""
    from repro_torch.models import lm
    return sum(t.numel() * t.element_size()
               for t in lm.init_cache(cfg, BATCH, max_len, "meta").values()
               if isinstance(t, torch.Tensor))


def profile_serving(dev, cfg, params, prompts, max_len, inputs=None):
    """The card's busy share (device time over wall) of one profiled
    prefill (with the prefill inputs ``inputs``) and one decode step,
    with their launches and top kernels."""
    from repro_torch.launch.profile_serve import _kernel_times
    from repro_torch.train import steps
    from torch.profiler import ProfilerActivity, profile
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int32,
                                       device=dev), **(inputs or {})}
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode():
        logits, cache = steps.prefill_step(cfg, params, batch,
                                           max_len=max_len)
        token = logits.argmax(-1).to(torch.int32)[:, None]
        logits, cache = steps.decode_step(cfg, params, token, cache)  # warm
        token = logits.argmax(-1).to(torch.int32)[:, None]
        for label, fn in (
                ("prefill", lambda: steps.prefill_step(
                    cfg, params, batch, max_len=max_len)),
                ("decode step", lambda: steps.decode_step(
                    cfg, params, token, cache))):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            times, calls = _kernel_times(prof)
            require(bool(times), "torch.profiler recorded no device time")
            dev_ms = sum(times.values()) / 1e3
            print(f"serve {cfg.name} {label} profiled: wall {wall_ms:.3f} ms, "
                  f"device {dev_ms:.3f} ms (busy {dev_ms / wall_ms:.1%}), "
                  f"{sum(calls.values())} launches; top kernels:")
            for name, us in times.most_common(6):
                print(f"  {us / 1e3:9.3f} ms {us / 1e3 / dev_ms:6.1%} "
                      f"{calls[name]:6d}x  {name[:100]}")


# ------------------------------------------------------------------ phase 4d
@contextlib.contextmanager
def moe_routes(picks=None):
    """Every MoE call's ``Routing`` (experts, keep, slot tables), in call
    order: ``moe_block`` calls ``route``, and ``route`` calls ``top_k``,
    through their module. With ``picks`` (another run's routings, in call
    order) each call takes that run's top-k experts instead of its own,
    gated by its own probabilities."""
    from repro_torch.models import moe
    seen, real_route, real_top_k = [], moe.route, moe.top_k

    def top_k(probs, k):
        idx = picks[len(seen)].expert_idx
        return probs.gather(1, idx), idx

    moe.route = lambda *a: seen.append(real_route(*a)) or seen[-1]
    if picks is not None:
        moe.top_k = top_k
    try:
        yield seen
    finally:
        moe.route, moe.top_k = real_route, real_top_k


def cached_path(dev, cfg, params, prompts, served, picks=None):
    """The serving calls fed the served tokens: prefill of ``prompts``,
    then GEN - 1 decode steps of ``served``'s tokens, routing on their own
    or on ``picks`` (``moe_routes``). Returns the prefill and last logits
    and every MoE call's routing."""
    from repro_torch.train import steps
    tokens = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    served = served.to(dev)
    with torch.inference_mode(), moe_routes(picks) as routes:
        first, cache = steps.prefill_step(cfg, params, {"tokens": tokens},
                                          max_len=PROMPT + GEN)
        logits = first
        for i in range(GEN - 1):
            logits, cache = steps.decode_step(cfg, params, served[:, i:i + 1],
                                              cache)
    return first, logits, routes


# the plain path's SSD scan beside each attention path: two plain paths
# differ in both where a model has both
PLAIN_SCAN = {"chunked": "chunked", "reference": "sequential"}


def plain_cached_path(dev, cfg, params, prompts, served, attn_impl,
                      picks=None):
    """``cached_path`` with every kernel replaced by its plain version:
    ``rmsnorm_ref`` for every norm, the ``chunked`` (or ``reference``)
    attention and the ``chunked`` (or ``sequential``) SSD scan; the port's
    ``moe_block`` as it is (it has no kernel). No kernel may launch."""
    counters = launch_counters()
    _reset(counters)
    with plain_kernels(PLAIN_SCAN[attn_impl]):
        out = cached_path(dev, dataclasses.replace(cfg, attn_impl=attn_impl),
                          params, prompts, served, picks)
    require(not any(_read(counters).values()),
            ("the plain path launched a kernel", _read(counters)))
    return out


def plain_moe_logits(cfg, params, tokens, attn_impl, picks=None):
    """The no-cache forward on the plain path (``rmsnorm_ref``, plain
    attention and SSD scan), routing on its own or on ``picks``
    (``moe_routes``): the last position's logits."""
    from repro_torch.models import lm
    with (torch.inference_mode(), plain_kernels(PLAIN_SCAN[attn_impl]),
          moe_routes(picks)):
        return lm.forward(dataclasses.replace(cfg, attn_impl=attn_impl),
                          params, tokens).logits[:, -1]


def no_cache_picks(routes, n_layers, length):
    """A cached run's top-k picks (its prefill's calls, then a decode
    step's, layer by layer) as the no-cache forward over its first
    ``length`` positions meets them: one call a layer over every (row,
    position)."""
    b = BATCH
    out = []
    for layer in range(n_layers):
        calls = routes[layer::n_layers]
        idx = torch.cat([r.expert_idx.reshape(b, -1, r.expert_idx.shape[1])
                         for r in calls], 1)[:, :length]
        out.append(types.SimpleNamespace(expert_idx=idx.reshape(
            -1, idx.shape[-1])))
    return out


def routing_disagreement(a, b) -> dict:
    """Over two runs' MoE calls, in order: the share of (token, layer)
    rows whose top-k picks differ, and of (expert, slot) entries whose
    kept token differs (filled on one side only, or another token)."""
    require(len(a) == len(b), (len(a), len(b)))
    rows = picks = slots = kept = 0
    for x, y in zip(a, b):
        require(x.cap == y.cap, (x.cap, y.cap))
        rows += x.expert_idx.shape[0]
        picks += int((x.expert_idx != y.expert_idx).any(1).sum())
        slots += x.filled.numel()
        kept += int(((x.filled != y.filled) | (x.filled & (
            x.token_for_slot != y.token_for_slot))).sum())
    return {"picks": picks / rows, "kept_slots": kept / slots}


def dropped_share(routes) -> float:
    return (sum(int((~r.keep).sum()) for r in routes)
            / sum(r.keep.numel() for r in routes))


def serve_moe(dev):
    """Phase 4d: each MoE config at full width and depth (``moe_path``).
    Returns {arch: launch counts of its main path}."""
    from repro_torch import configs
    t_phase = time.perf_counter()
    out = {}
    for name in MOE_ARCHS:
        cfg = dataclasses.replace(configs.get(name), attn_impl="flash")
        n = cfg.num_layers
        out[name] = moe_path(dev, cfg, {
            "rmsnorm": (2 * n + 1) * GEN, "rmsnorm_bwd": 0,
            "flash_attention": n, "flash_attention_tc": n, "ssd": 0,
            "ssd_tc": 0})
        torch.cuda.empty_cache()
    print(f"serve moe: phase 4d {time.perf_counter() - t_phase:.1f} s")
    return out


def moe_path(dev, cfg, expect):
    """One config with MoE layers (phase 4d's, and jamba in phase 4f): the
    main path through ``serve.run`` with the exact counts ``expect``, a
    second run bitwise equal, the plain cached path and its noise floor,
    the routing disagreement and dropped shares, the drop-free run against
    the plain no-cache forward, the cache's bytes and a profiled prefill
    and decode step."""
    from repro_torch.launch import serve
    e = cfg.moe.num_experts
    # MoE calls a forward (every layer, or jamba's odd layers of a group)
    n = sum(cfg.layer_is_moe(i) for i in range(cfg.num_layers))
    res, launches, params, prompts = serve_main(dev, cfg, expect)
    print(f"{cfg.name}: {n} MoE layers of {e} experts top {cfg.moe.top_k} "
          f"(shared {cfg.moe.num_shared}), capacity factor "
          f"{cfg.moe.capacity_factor}; cache "
          f"{cache_bytes(cfg, PROMPT + GEN) / 1e6:.1f} MB")

    again = serve.run(cfg, params, prompts, GEN)
    require(torch.equal(again.tokens, res.tokens)
            and same_bits(again.prefill_logits, res.prefill_logits)
            and same_bits(again.last_logits, res.last_logits),
            f"{cfg.name}: two served runs differ")

    # the served calls again, teacher-forced, to read their routing; then
    # the plain cached path on the same calls, and its noise floor: each
    # path routing on its own hidden state, and the plain paths on the
    # served path's top-k picks, which takes out the routing flips that a
    # near-tie and a one-ulp difference make
    first, last, served = cached_path(dev, cfg, params, prompts, res.tokens)
    require(same_bits(first, res.prefill_logits)
            and same_bits(last, res.last_logits),
            f"{cfg.name}: the teacher-forced replay is not the served run")
    require(len(served) == n * GEN, len(served))
    plain = {}
    for picks in (None, served):
        for attn_impl in ("chunked", "reference"):
            plain[picks is None, attn_impl] = plain_cached_path(
                dev, cfg, params, prompts, res.tokens, attn_impl, picks)
    errs = {}
    for own in (True, False):
        (p_first, p_last, routes), (f_first, f_last, f_routes) = (
            plain[own, "chunked"], plain[own, "reference"])
        errs[own] = {"prefill": rel_err(p_first, res.prefill_logits),
                     "last_decode": rel_err(p_last, res.last_logits)}
        floor = {"prefill": rel_err(p_first, f_first),
                 "last_decode": rel_err(p_last, f_last)}
        label = "its own routing" if own else "the served picks"
        print(f"serve {cfg.name} vs the plain cached path on {label} "
              f"(max |diff| / max |logit|): {errs[own]}; noise floor between "
              f"two plain paths: {floor}; routing disagreement served vs "
              f"plain: {routing_disagreement(served, routes)}, between the "
              f"two plain paths: {routing_disagreement(routes, f_routes)}")
    caps = (served[0].cap, served[n].cap)
    print(f"serve {cfg.name}: capacity prefill {caps[0]}, decode {caps[1]}; "
          f"dropped share of assignments: prefill "
          f"{dropped_share(served[:n]):.4f}, decode "
          f"{dropped_share(served[n:]):.4f}; first sequence "
          f"{res.tokens[0][:16].tolist()}")
    require(all(err < LOGITS_REL_TOL for err in errs[False].values()),
            (cfg.name, "on the served picks", errs[False]))
    disagree = routing_disagreement(served, plain[True, "chunked"][2])
    require(disagree["picks"] < ROUTING_DISAGREE_MAX, (cfg.name, disagree))

    # drop-free: capacity = the tokens of the call, so the cached decode is
    # the no-cache forward of the same tokens; held as above, on the served
    # picks, with the plain forward on its own routing printed beside
    free = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(e)))
    res_free = serve.run(free, params, prompts, GEN)
    _, _, free_routes = cached_path(dev, free, params, prompts, res_free.tokens)
    tokens = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    seq = torch.cat([tokens, res_free.tokens[:, :-1].to(dev)], 1)
    for own in (True, False):
        picks = {t: None if own else no_cache_picks(free_routes, n, t.shape[1])
                 for t in (tokens, seq)}
        label = "its own routing" if own else "the served picks"
        plain = {t: plain_moe_logits(free, params, t, "chunked", picks[t])
                 for t in (tokens, seq)}
        errs = {"prefill": rel_err(plain[tokens], res_free.prefill_logits),
                "last_decode": rel_err(plain[seq], res_free.last_logits)}
        floor = rel_err(plain[seq], plain_moe_logits(free, params, seq,
                                                     "reference", picks[seq]))
        print(f"serve {cfg.name} drop-free (capacity factor {float(e)}) vs "
              f"the plain no-cache forward on {label}: {errs}; noise floor "
              f"at the last decode {floor:.4f}")
    require(all(err < LOGITS_REL_TOL for err in errs.values()),
            (cfg.name, "drop-free, on the served picks", errs))

    profile_serving(dev, cfg, params, prompts, PROMPT + GEN)
    del params
    return launches


# ------------------------------------------------------------------ phase 4e
def grid_positions(batch, seq, grid, dev, decode=0):
    """(3, batch, seq + decode) int32 M-RoPE ids in Qwen2-VL's layout: a
    ``grid`` x ``grid`` patch prefix at t = 0, h = row, w = col, then the
    text from the prefix's largest id + 1 in all three streams; then
    ``decode`` positions as a decode step takes them, its cache position
    ``seq + i`` in all three (the reference's decode step)."""
    n = grid * grid
    r = torch.arange(n, device=dev)
    vis = torch.stack([torch.zeros_like(r), r // grid, r % grid])
    text = (grid + torch.arange(seq - n, device=dev)).expand(3, -1)
    dec = (seq + torch.arange(decode, device=dev)).expand(3, -1)
    pos = torch.cat([vis, text, dec], 1).to(torch.int32)
    return pos[:, None].expand(3, batch, pos.shape[1]).contiguous()


def serve_vlm(dev):
    """Phase 4e: qwen2-vl-7b at full width and depth, each prompt's first
    VLM_GRID² positions a vision prefix of seeded random embeddings, with
    three different M-RoPE streams (``grid_positions``): flash in each
    layer of prefill (a GQA group of 7), every one on the tensor-core
    kernel; 2 norms a layer and the final norm in every forward. The
    prefill and last decode logits against the plain no-cache forward
    (its decode positions the cache's, in all three streams), with the
    noise floor between two plain paths; then the served prefill with
    equal streams, and with the vision embeddings + 1, each of which must
    move the logits beyond that floor; a profiled prefill and decode
    step. Returns the main path's launch counts."""
    from repro_torch import configs
    from repro_torch.launch import serve
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get(VLM_ARCH), attn_impl="flash")
    n = cfg.num_layers
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    vision = {"vision_embeds": (VLM_VISION_STD * torch.randn(
                  BATCH, VLM_GRID ** 2, cfg.d_model, generator=g,
                  device=dev)).bfloat16(),
              "mrope_positions": grid_positions(BATCH, PROMPT, VLM_GRID, dev)}
    res, launches, params, prompts = serve_main(dev, cfg, {
        "rmsnorm": (2 * n + 1) * GEN, "rmsnorm_bwd": 0,
        "flash_attention": n, "flash_attention_tc": n, "ssd": 0,
        "ssd_tc": 0}, inputs=vision)
    tokens = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    seq = torch.cat([tokens, res.tokens[:, :-1].to(dev)], 1)
    seq_streams = grid_positions(BATCH, PROMPT, VLM_GRID, dev, GEN - 1)
    emb = vision["vision_embeds"]
    with torch.inference_mode():
        plain = {impl: (
            plain_last_logits(cfg, params, tokens, impl, vision_embeds=emb,
                              mrope_positions=vision["mrope_positions"]),
            plain_last_logits(cfg, params, seq, impl, vision_embeds=emb,
                              mrope_positions=seq_streams))
            for impl in ("chunked", "reference")}
    errs = {"prefill": rel_err(plain["chunked"][0], res.prefill_logits),
            "last_decode": rel_err(plain["chunked"][1], res.last_logits)}
    floor = {"prefill": rel_err(plain["chunked"][0], plain["reference"][0]),
             "last_decode": rel_err(plain["chunked"][1],
                                    plain["reference"][1])}
    equal = torch.arange(PROMPT, dtype=torch.int32, device=dev).expand(
        3, BATCH, PROMPT)
    moved = {
        "equal streams": rel_err(res.prefill_logits, serve.run(
            cfg, params, prompts, 1, vision_embeds=emb,
            mrope_positions=equal).prefill_logits),
        "vision + 1": rel_err(res.prefill_logits, serve.run(
            cfg, params, prompts, 1, vision_embeds=emb + 1,
            mrope_positions=vision["mrope_positions"]).prefill_logits)}
    print(f"serve {cfg.name} vs the plain no-cache forward (max |diff| / "
          f"max |logit|): {errs}; noise floor between two plain paths: "
          f"{floor}; the served prefill moved by {moved}; first sequence "
          f"{res.tokens[0][:16].tolist()}")
    require(all(e < LOGITS_REL_TOL for e in errs.values()), errs)
    require(all(m > max(floor.values()) for m in moved.values()),
            ("the M-RoPE streams or the vision prefix moved the logits no "
             "more than the noise floor", moved, floor))
    profile_serving(dev, cfg, params, prompts, PROMPT + GEN, vision)
    del params, vision
    torch.cuda.empty_cache()
    print(f"serve {cfg.name}: phase 4e {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------------ phase 4f
def serve_hybrid(dev):
    """Phase 4f: jamba-v0.1-52b at full width, HYBRID_LAYERS layers (one
    group: 7 Mamba-2 layers, then attention; MoE of 16 experts on the odd
    layers), as phase 4d serves its MoE configs (``moe_path``): the SSD
    chunk kernel in each Mamba-2 layer of prefill and flash in the
    attention layer, all on the tensor-core kernels; ln1, ln2 and the
    mixer's gated norm in each Mamba-2 layer, ln1 and ln2 in the attention
    layer and the final norm in every forward. Decode runs the SSM
    recurrence and attends in plain torch, as in the reference. Returns
    the main path's launch counts."""
    from repro_torch import configs
    t_phase = time.perf_counter()
    full = configs.get(HYBRID_ARCH)
    cfg = dataclasses.replace(full, num_layers=HYBRID_LAYERS,
                              attn_impl="flash")
    groups, n_ssm = cfg.num_layers // cfg.attn_every, cfg.attn_every - 1
    print(f"{cfg.name}: cut to {cfg.num_layers} of {full.num_layers} layers "
          f"({groups} of {full.num_layers // full.attn_every} groups), "
          f"{cfg.param_count() / 1e9:.2f} B parameters of "
          f"{full.param_count() / 1e9:.2f} B")
    launches = moe_path(dev, cfg, {
        "rmsnorm": (groups * (3 * n_ssm + 2) + 1) * GEN, "rmsnorm_bwd": 0,
        "flash_attention": groups, "flash_attention_tc": groups,
        "ssd": groups * n_ssm, "ssd_tc": groups * n_ssm})
    torch.cuda.empty_cache()
    print(f"serve {cfg.name}: phase 4f {time.perf_counter() - t_phase:.1f} s")
    return launches


# ------------------------------------------------------------------ phase 4g
def serve_audio(dev):
    """Phase 4g: whisper-medium at full width and depth (24 encoder and 24
    decoder layers), AUDIO_FRAMES seeded random frames a row and a prompt
    of AUDIO_PROMPT tokens: flash in each encoder layer (non-causal over
    every frame) and in each decoder layer of prefill, every one on the
    tensor-core kernel; RMSNorm twice an encoder layer and ``enc_norm``,
    then three times a decoder layer and the final norm in every forward.
    Cross-attention and decode attend in plain torch, as in the reference.
    The encoder states and the prefill and last decode logits against the
    plain no-cache forward, with the noise floor between two plain paths;
    the served prefill with the frames + 1 must move the logits beyond
    that floor; a second served run must give the same bits; a profiled
    prefill and decode step, and the cross-attention K/V projections'
    share of the decode step's device time. Returns the main path's
    launch counts."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import encdec
    from repro_torch.train import steps
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.get(AUDIO_ARCH), attn_impl="flash")
    ed = cfg.encdec
    require(ed.cross_len == AUDIO_FRAMES, (ed.cross_len, AUDIO_FRAMES))
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    frames = torch.randn(BATCH, AUDIO_FRAMES, cfg.d_model, generator=g,
                         device=dev).bfloat16()
    n_attn = ed.enc_layers + ed.dec_layers
    res, launches, params, prompts = serve_main(dev, cfg, {
        "rmsnorm": 2 * ed.enc_layers + 1 + (3 * ed.dec_layers + 1) * GEN,
        "rmsnorm_bwd": 0, "flash_attention": n_attn,
        "flash_attention_tc": n_attn, "ssd": 0, "ssd_tc": 0},
        prompt=AUDIO_PROMPT, inputs={"frames": frames})
    again = serve.run(cfg, params, prompts, GEN, frames=frames)
    tokens = torch.as_tensor(prompts, dtype=torch.int32, device=dev)
    seq = torch.cat([tokens, res.tokens[:, :-1].to(dev)], 1)
    with torch.inference_mode():
        served_enc = steps.prefill_step(
            cfg, params, {"tokens": tokens, "frames": frames},
            max_len=AUDIO_PROMPT + GEN)[1]["enc_out"]
        moved = rel_err(res.prefill_logits, serve.run(
            cfg, params, prompts, 1, frames=frames + 1).prefill_logits)
        plain = {}
        with plain_kernels():
            for impl in ("chunked", "reference"):
                pcfg = dataclasses.replace(cfg, attn_impl=impl)
                enc = encdec.encode(pcfg, params, frames)
                logits = encdec.decode(pcfg, params, seq, enc).logits
                plain[impl] = (enc, logits[:, AUDIO_PROMPT - 1], logits[:, -1])
    served = (served_enc, res.prefill_logits, res.last_logits)
    names = ("enc_out", "prefill", "last_decode")
    errs = {k: rel_err(p, o) for k, p, o in zip(names, plain["chunked"], served)}
    floor = {k: rel_err(a, b) for k, a, b in
             zip(names, plain["chunked"], plain["reference"])}
    same = all(torch.equal(a, b) for a, b in (
        (res.tokens, again.tokens), (res.prefill_logits, again.prefill_logits),
        (res.last_logits, again.last_logits)))
    print(f"serve {cfg.name} vs the plain no-cache forward (max |diff| / "
          f"max |value|): {errs}; noise floor between two plain paths: "
          f"{floor}; the served prefill moved by {moved:.4g} with the frames "
          f"+ 1; two served runs bitwise equal: {same}; first sequence "
          f"{res.tokens[0][:16].tolist()}")
    require(all(e < LOGITS_REL_TOL for e in errs.values()), errs)
    require(all(f < LOGITS_REL_TOL for f in floor.values()),
            ("the noise floor passed the serving bound", floor))
    require(moved > max(floor.values()),
            ("the frames moved the logits no more than the noise floor",
             moved, floor))
    require(same, "two served runs differ")
    profile_serving(dev, cfg, params, prompts, AUDIO_PROMPT + GEN,
                    {"frames": frames})
    cross_kv_share(dev, cfg, params, tokens, frames)
    del params, frames, served_enc, plain
    torch.cuda.empty_cache()
    print(f"serve {cfg.name}: phase 4g {time.perf_counter() - t_phase:.1f} s")
    return launches


def cross_kv_share(dev, cfg, params, tokens, frames):
    """The share of one decode step's device time that goes to the
    cross-attention K/V projections, which project the encoder states
    again in every layer of every step (the reference's design): the
    matrix products whose input has BATCH x AUDIO_FRAMES rows, from
    ``torch.profiler`` with the ops' input shapes. Each decoder layer must
    show two."""
    from repro_torch.launch.profile_serve import _kernel_times
    from repro_torch.train import steps
    from torch.profiler import ProfilerActivity, profile
    rows = BATCH * AUDIO_FRAMES
    with torch.inference_mode():
        logits, cache = steps.prefill_step(
            cfg, params, {"tokens": tokens, "frames": frames},
            max_len=AUDIO_PROMPT + GEN)
        token = logits.argmax(-1).to(torch.int32)[:, None]
        steps.decode_step(cfg, params, token, cache)      # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as prof:
            steps.decode_step(cfg, params, token, cache)
            torch.cuda.synchronize()
    dev_us = sum(_kernel_times(prof)[0].values())
    kv_us, kv_calls = 0.0, 0
    for e in prof.key_averages(group_by_input_shape=True):
        first = e.input_shapes[0] if e.input_shapes else []
        if (e.key in ("aten::mm", "aten::bmm") and len(first) >= 2
                and int(np.prod(first[:-1])) == rows):
            kv_us += e.device_time_total
            kv_calls += e.count
    require(kv_calls == 2 * cfg.encdec.dec_layers,
            ("cross K/V products found in the decode step", kv_calls))
    flops = 2 * 2 * cfg.encdec.dec_layers * rows * cfg.d_model ** 2
    print(f"serve {cfg.name} decode step: the cross K/V projections take "
          f"{kv_us / 1e3:.3f} ms of {dev_us / 1e3:.3f} ms device time "
          f"({kv_us / dev_us:.1%}) in {kv_calls} products, {flops / 1e12:.3f} "
          f"TFLOP ({flops / kv_us / 1e6:.1f} TFLOP/s)")


# ------------------------------------------------------------------ phase 5
def serve_node_configs(cfg, gen_tokens, *, batch=BATCH, prompt=PROMPT,
                       max_len=SESSION_MAX_LEN, seed=SEED) -> dict:
    """The config of each node of the serving workflow: plain data, which
    the node's signature hashes, so a twin workflow built with the same
    configs in another package signs the same."""
    return {"params": {"arch": cfg.name, "layers": cfg.num_layers,
                       "d_model": cfg.d_model, "seed": seed},
            "prompts": {"seed": seed, "batch": batch, "prompt": prompt,
                        "vocab": cfg.vocab_size},
            "prefill": {"max_len": max_len, "attn_impl": cfg.attn_impl},
            "decode": {"gen_tokens": gen_tokens}}


def greedy_decode(cfg, params, logits, cache, gen_tokens):
    """``gen_tokens`` greedy tokens (the first from ``logits``) against
    ``cache``, which is cloned first: ``decode_step`` writes the KV cache
    in place, and ``cache`` is the prefill node's value, which the
    executor and the store's memory tier hand out as it is."""
    from repro_torch.train import steps
    with torch.no_grad():
        cache = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in cache.items()}
        out = [logits.argmax(-1).to(torch.int32)[:, None]]
        for _ in range(gen_tokens - 1):
            logits, cache = steps.decode_step(cfg, params, out[-1], cache)
            out.append(logits.argmax(-1).to(torch.int32)[:, None])
    return {"tokens": torch.cat(out, 1), "last_logits": logits}


def prefill_and_decode(cfg, params, tokens, gen_tokens,
                       max_len=SESSION_MAX_LEN):
    """The direct path, outside any session: prefill, then greedy decode."""
    from repro_torch.train import steps
    with torch.no_grad():
        logits, cache = steps.prefill_step(cfg, params, {"tokens": tokens},
                                           max_len=max_len)
    return logits, cache, greedy_decode(cfg, params, logits, cache,
                                        gen_tokens)


def serve_workflow(cfg, init_params, gen_tokens, *, device, batch=BATCH,
                   prompt=PROMPT, max_len=SESSION_MAX_LEN, seed=SEED,
                   computed=None):
    """The serving workflow: ``params`` (``init_params()``) and ``prompts``
    (``synth.lm_tokens``) → ``prefill`` (last logits and the KV cache) →
    ``decode`` (``gen_tokens`` greedy tokens), the output. With
    ``computed``, each node that runs stores a clone of its value there,
    taken as it returns, under its name."""
    from repro_torch.core import Workflow
    from repro_torch.core.tree import tree_map
    from repro_torch.train import steps
    conf = serve_node_configs(cfg, gen_tokens, batch=batch, prompt=prompt,
                              max_len=max_len, seed=seed)

    def keep(name, value):
        if computed is not None:
            computed[name] = tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                value)
        return value

    def prompts():
        return keep("prompts", torch.as_tensor(
            synth_prompts(cfg, batch, prompt, seed)).to(device))

    def prefill(params, tokens):
        with torch.no_grad():
            logits, cache = steps.prefill_step(cfg, params, {"tokens": tokens},
                                               max_len=max_len)
        return keep("prefill", {"logits": logits, "cache": cache})

    def decode(params, pre):
        return keep("decode", greedy_decode(cfg, params, pre["logits"],
                                            pre["cache"], gen_tokens))

    wf = Workflow(f"serve-{cfg.name}")
    p = wf.source("params", lambda: keep("params", init_params()),
                  config=conf["params"])
    t = wf.source("prompts", prompts, config=conf["prompts"])
    pre = wf.extractor("prefill", prefill, [p, t], config=conf["prefill"])
    wf.output(wf.extractor("decode", decode, [p, pre],
                           config=conf["decode"]))
    return wf


def same_bits(a, b) -> bool:
    """Leaf for leaf, the same types and, for tensors and arrays, the same
    dtype, shape and bits."""
    from repro_torch.core.tree import tree_flatten
    (la, da), (lb, db) = tree_flatten(a), tree_flatten(b)
    if da != db:
        return False
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(
                        x.reshape(-1).view(torch.uint8),
                        y.to(x.device).reshape(-1).view(torch.uint8))):
                return False
        elif isinstance(x, np.ndarray):
            if not (isinstance(y, np.ndarray) and x.dtype == y.dtype
                    and np.array_equal(x, y)):
                return False
        elif x != y:
            return False
    return True


def _rate(nbytes, seconds):
    return round(nbytes / seconds / 1e9, 3) if seconds > 0 else None


def session_iteration(label, session, cfg, init, gen, dev, place, direct):
    """One iteration of the serving workflow, with every launch count set
    to 0 just before it and read just after. Checks the counts against the
    states the planner chose and the tokens against the direct path;
    prints the iteration's times, per-tier traffic and each node's costs
    and OMP verdict. Returns (report, launches, computed values)."""
    from repro_torch.core import State
    computed = {}
    wf = serve_workflow(cfg, init, gen, device=dev, computed=computed)
    store = session.store
    loads0 = {t: dict(v) for t, v in store.load_stats.items()}
    writes0 = dict(store.write_stats)
    mem0 = store.tier_status()["memory"]
    counters = launch_counters()
    torch.cuda.synchronize()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    t0 = time.perf_counter()
    rep = session.run(wf, load_shardings=place)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: getattr(wrapper, attr)
                for name, (wrapper, attr) in counters.items()}
    store.writer_drain()            # queued writes and device offloads land
    drained = time.perf_counter() - t0

    ex = rep.execution
    states = ex.states
    prefill_runs = int(states["prefill"] is State.COMPUTE)
    forwards = prefill_runs + (gen - 1) * int(states["decode"] is State.COMPUTE)
    expect = {"rmsnorm": (2 * cfg.num_layers + 1) * forwards, "rmsnorm_bwd": 0,
              "flash_attention": cfg.num_layers * prefill_runs,
              "flash_attention_tc": cfg.num_layers * prefill_runs,
              "ssd": 0, "ssd_tc": 0}
    loads = {t: {k: v[k] - loads0[t][k] for k in ("hits", "bytes", "seconds")}
             for t, v in store.load_stats.items()}
    writes = {k: store.write_stats[k] - writes0[k] for k in writes0}
    mem = store.tier_status()["memory"]
    offload = {"entries": mem["offloads"] - mem0["offloads"],
               "bytes": mem["offload_bytes"] - mem0["offload_bytes"],
               "seconds": mem["offload_seconds"] - mem0["offload_seconds"]}
    print(f"session {label}: gen_tokens {gen}; wall {wall:.3f} s "
          f"({drained:.3f} s with the writer drained); computed "
          f"{ex.n_computed}, loaded {ex.n_loaded}, pruned {ex.n_pruned}; "
          f"mat_seconds {ex.mat_seconds:.3f}; launches {launches}")
    print(f"session {label}: loads by tier {json.dumps(loads)}; disk writes "
          f"{json.dumps(writes)}; device->host offload {json.dumps(offload)} "
          f"({_rate(offload['bytes'], offload['seconds'])} GB/s); "
          f"disk->cuda load {_rate(loads['local']['bytes'], loads['local']['seconds'])}"
          f" GB/s; memory->cuda {_rate(loads['memory']['bytes'], loads['memory']['seconds'])}"
          f" GB/s")
    for n in ("params", "prompts", "prefill", "decode"):
        verdict = (f"materialized ({ex.materialized[n]})"
                   if n in ex.materialized else
                   f"not materialized ({ex.skipped_mat.get(n, 'no decision')})")
        lc = rep.load_cost.get(n)
        print(f"  {n}: {states[n].name}; runtime "
              f"{ex.runtime.get(n, 0.0):.6f} s; planner c {rep.compute_cost[n]:.6f}"
              f" s, l {'-' if lc is None else f'{lc:.6f} s'}; OMP {verdict}")

    require(launches == expect, (label, launches, expect))
    tokens = rep.outputs["decode"]["tokens"]
    require(tokens.is_cuda and tuple(tokens.shape) == (BATCH, gen),
            (label, tokens.device, tokens.shape))
    require(torch.equal(tokens, direct[gen]), (label, "tokens differ from "
                                               "the direct path"))
    return rep, launches, computed


def session_path(dev):
    """Phase 5: Helix sessions serving internlm2-1.8b at full width and
    depth. Returns the launch counts summed over its iterations."""
    from repro_torch import configs
    from repro_torch.core import (EngineConfig, IterativeSession, Policy,
                                  Store, StoreConfig)
    from repro_torch.core.tree import tree_leaves
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.get(ARCH), attn_impl="flash")

    def init():
        return registry.init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             dev)

    link = subprocess.run(
        ["nvidia-smi", "--query-gpu=pcie.link.gen.current,pcie.link.width.current,"
         "pcie.link.gen.max,pcie.link.width.max", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"host link (PCIe gen, width current; gen, width max): {link}; "
          f"pinned copies of 1 GiB: {json.dumps(link_rates(dev))} GB/s")
    # every tensor leaf of every node's entry is placed on the card
    place = {n: (lambda i, shape, dtype: dev)
             for n in ("params", "prompts", "prefill", "decode")}
    total = {k: 0 for k in launch_counters()}
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="session-", dir=os.path.join(ROOT, "build"))
    try:
        # the direct path on the same weights, once per gen_tokens
        params = init()
        prompts = torch.as_tensor(synth_prompts(cfg)).to(dev)
        direct = {g: prefill_and_decode(cfg, params, prompts, g)[2]["tokens"]
                  for g in SESSION_GEN}
        require(torch.equal(direct[SESSION_GEN[1]][:, :SESSION_GEN[0]],
                            direct[SESSION_GEN[0]]),
                "the direct path's greedy tokens depend on gen_tokens")
        del params

        a_dir = os.path.join(workdir, "always")
        storage = StoreConfig(mem_budget_bytes=SESSION_MEM_BUDGET)
        always = EngineConfig(policy=Policy.ALWAYS)
        sess = IterativeSession(a_dir, engine=always, storage=storage)
        by_sig = {}                 # signature -> the value its node computed
        runs = []
        for label, gen, restart in (("A1 cold", SESSION_GEN[0], False),
                                    ("A2 gen_tokens edit", SESSION_GEN[1], False),
                                    ("A3 restart", SESSION_GEN[1], True)):
            if restart:
                sess = IterativeSession(a_dir, engine=always, storage=storage)
            rep, launches, computed = session_iteration(
                label, sess, cfg, init, gen, dev, place, direct)
            runs.append(rep)
            for name, value in computed.items():
                by_sig[rep.sigs[name]] = value
            for k in total:
                total[k] += launches[k]
            if label.startswith("A2"):
                t1 = runs[0].outputs["decode"]["tokens"]
                t2 = rep.outputs["decode"]["tokens"]
                require(torch.equal(t2[:, :SESSION_GEN[0] - 1],
                                    t1[:, :SESSION_GEN[0] - 1]),
                        "iteration 2's first 31 tokens differ from iteration 1's")
                # the decode node cloned the cache: the stored prefill
                # entry is the value the prefill node computed
                pre_sig = runs[0].sigs["prefill"]
                value, _ = Store(os.path.join(a_dir, "store")).load(
                    pre_sig, sharding_for_leaf=lambda i, s, d: dev)
                require(same_bits(value, by_sig[pre_sig]),
                        "the stored prefill entry changed after iteration 2")
        # every stored entry, from the disk tier onto the card, through a
        # memory tier that then offloads the card's copy to pinned host
        # memory on the writer thread
        disk = Store(os.path.join(a_dir, "store"),
                     mem_budget_bytes=SESSION_MEM_BUDGET)
        entries = disk.entries()
        require(len(entries) >= 4, f"session A stored {len(entries)} entries")
        for sig, meta in sorted(entries.items(), key=lambda kv: kv[1]["name"]):
            t0 = time.perf_counter()
            value, secs = disk.load(sig, sharding_for_leaf=lambda i, s, d: dev)
            torch.cuda.synchronize()
            on_card = all(t.is_cuda for t in tree_leaves(value)
                          if isinstance(t, torch.Tensor))
            equal = sig in by_sig and same_bits(value, by_sig[sig])
            print(f"stored {meta['name']} ({sig[:12]}): {meta['nbytes']} B, "
                  f"disk->cuda {time.perf_counter() - t0:.3f} s "
                  f"({_rate(meta['nbytes'], secs)} GB/s); on the card: "
                  f"{on_card}; bitwise equal to what its node computed: {equal}")
            require(on_card and equal, ("stored entry", meta["name"], sig,
                                        on_card, equal))
        t0 = time.perf_counter()
        disk.writer_drain()
        mem = disk.tier_status()["memory"]
        print(f"device->host offload of the reloaded entries: "
              f"{mem['offloads']} entries, {mem['offload_bytes']} B in "
              f"{mem['offload_seconds']:.3f} s on the writer thread "
              f"({_rate(mem['offload_bytes'], mem['offload_seconds'])} GB/s; "
              f"drain waited {time.perf_counter() - t0:.3f} s)")
        require(mem["offloads"] == len(entries), mem)
        for sig in entries:
            # no placement: a hit goes back to the device it came from
            value, _ = disk.load(sig)
            require(all(t.is_cuda for t in tree_leaves(value)
                        if isinstance(t, torch.Tensor)),
                    ("a hit after the offload is not on the card", sig))
            require(same_bits(value, by_sig[sig]),
                    ("pinned snapshot placed on the card differs", sig))
        del value, by_sig, runs, disk

        # session B passes no load_shardings: loads return to the card,
        # the device each value was computed on
        b_dir = os.path.join(workdir, "opt")
        sess = IterativeSession(b_dir, storage=storage)     # Policy.OPT
        for label, gen in (("B1 cold", SESSION_GEN[0]),
                           ("B2 gen_tokens edit", SESSION_GEN[1])):
            _, launches, _ = session_iteration(label, sess, cfg, init, gen,
                                               dev, None, direct)
            for k in total:
                total[k] += launches[k]
        sess.store.writer_drain()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"session path launches: {total}")
    return total


# ------------------------------------------------------------------ phase 6
def _plain_rmsnorm(x, w, eps=1e-5):
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    return rmsnorm_ref(x, w, eps)


@contextlib.contextmanager
def plain_kernels(scan="chunked"):
    """Every kernel of a model's path replaced by its plain version: the
    norms (the Mamba-2 mixer's gated norm too) go through ``rmsnorm_ref``
    (differentiable plain torch), and the SSD through the reference
    model's ``chunked`` scan or the ``sequential`` oracle ``ssd_ref``;
    attention takes the plain path its ``attn_impl`` names (training
    already runs the ``chunked`` one)."""
    from repro_torch.kernels.ssd.ref import ssd_ref
    from repro_torch.models import layers, ssd

    def plain_ssd(x, dt, a, B, C, *, chunk, h0=None):
        if scan == "chunked":
            return ssd.ssd_scan_reference(x, dt, a, B, C, chunk, h0=h0)
        return ssd_ref(x, dt, a, B, C, h0=h0)

    kernels = (layers.rmsnorm, ssd.rmsnorm, ssd.ssd_ops)
    layers.rmsnorm = ssd.rmsnorm = _plain_rmsnorm
    ssd.ssd_ops = types.SimpleNamespace(ssd=plain_ssd)
    try:
        yield
    finally:
        layers.rmsnorm, ssd.rmsnorm, ssd.ssd_ops = kernels


def _reset(counters):
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)


def _read(counters):
    return {name: getattr(wrapper, attr)
            for name, (wrapper, attr) in counters.items()}


NORM_LEAVES = ("final_norm", "blocks.ln1", "blocks.ln2")


def _norm_grads(grads):
    return {"final_norm": grads["final_norm"],
            "blocks.ln1": grads["blocks"]["ln1"],
            "blocks.ln2": grads["blocks"]["ln2"]}


def train_path(dev):
    """Phase 6: internlm2-1.8b at full width and depth through the
    trainer's step loop (``launch.train.train``), kernels vs plain. Returns
    the kernel run's launch counts."""
    from repro_torch import configs
    from repro_torch.data import synth
    from repro_torch.data.pipeline import TokenBatcher, batch_to
    from repro_torch.launch import train
    from repro_torch.launch.profile_serve import _kernel_times
    from repro_torch.optim import adamw
    from repro_torch.train import steps
    from torch.profiler import ProfilerActivity, profile

    cfg = configs.get(ARCH)                  # attn_impl "chunked", remat "block"
    L = cfg.num_layers
    t0 = time.perf_counter()
    params0 = steps.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(SEED), dev).params
    n_params = sum(t.numel() for t in _leaves(params0))
    tokens = synth.lm_tokens(SEED, max(2_000_000, BATCH * (PROMPT + 1) * 4),
                             cfg.vocab_size)
    batcher = TokenBatcher(tokens, BATCH, PROMPT, seed=SEED)
    torch.cuda.synchronize()
    print(f"train {cfg.name}: {L} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params, remat {cfg.remat}, attn_impl "
          f"{cfg.attn_impl}, xent {cfg.xent_impl}; batch {BATCH} x {PROMPT}; "
          f"init {time.perf_counter() - t0:.1f} s")

    def fresh():
        # the moments are zeros: only the params are kept between paths
        return steps.TrainState(params=params0, opt=adamw.init(params0))

    def run():
        return train.train(cfg, fresh(), batcher, 0, TRAIN_STEPS,
                           lr=TRAIN_LR, total_steps=TRAIN_TOTAL, device=dev,
                           log_every=1)

    batch0 = batch_to(batcher.batch_at(0), dev)
    counters = launch_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset(counters)
    kern = run()                            # the main path
    torch.cuda.synchronize()
    launches = _read(counters)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    steady = kern.step_s[1:]
    step_ms = sum(steady) / len(steady) * 1e3
    print(f"train {cfg.name} through the kernels: step s {kern.step_s}; "
          f"{step_ms:.1f} ms/step over steps 2-{TRAIN_STEPS} "
          f"({BATCH * PROMPT / step_ms * 1e3:.0f} tokens/s); peak memory "
          f"{peak_gb:.2f} GB; launches {launches}")
    expect = {k: 0 for k in counters}
    expect.update(rmsnorm=(4 * L + 1) * TRAIN_STEPS,
                  rmsnorm_bwd=(2 * L + 1) * TRAIN_STEPS)
    require(launches == expect, ("train launches", launches, expect))
    require(all(torch.isfinite(torch.tensor(m["loss"])) for m in kern.metrics),
            "a train loss is not finite")
    require(kern.metrics[-1]["step"] == TRAIN_STEPS, kern.metrics[-1])
    kern_metrics = kern.metrics
    del kern                                 # frees its state
    _, g_kern = steps.value_and_grad(cfg, params0, batch0)
    g_kern = _norm_grads(g_kern)
    before_plain = _read(counters)
    with plain_kernels():
        plain = run()
        _, g_plain = steps.value_and_grad(cfg, params0, batch0)
        g_plain = _norm_grads(g_plain)
        cfg_ref = dataclasses.replace(cfg, attn_impl="reference")
        floor_run = train.train(cfg_ref, fresh(), batcher, 0, TRAIN_STEPS,
                                lr=TRAIN_LR, total_steps=TRAIN_TOTAL,
                                device=dev, log_every=1)
        _, g_floor = steps.value_and_grad(cfg_ref, params0, batch0)
        g_floor = _norm_grads(g_floor)
    require(_read(counters) == before_plain, "the plain paths launched a kernel")

    def rel(a, b):
        return abs(a - b) / max(abs(a), 1e-30)

    errs, floor = {}, {}
    for i, (k_m, p_m, f_m) in enumerate(zip(kern_metrics, plain.metrics,
                                            floor_run.metrics)):
        for key in ("loss", "grad_norm"):
            errs[f"step{i + 1}.{key}"] = rel(p_m[key], k_m[key])
            floor[f"step{i + 1}.{key}"] = rel(p_m[key], f_m[key])
    for name in NORM_LEAVES:
        require(float(g_kern[name].abs().max()) > 0,
                f"the kernel path's {name} gradient is zero")
        errs[f"grad.{name}"] = rel_err(g_plain[name], g_kern[name])
        floor[f"grad.{name}"] = rel_err(g_plain[name], g_floor[name])
    print(f"train kernels vs plain path (relative): {json.dumps(errs)}; "
          f"noise floor between two plain paths: {json.dumps(floor)}")
    for key, err in errs.items():
        require(err < (GRAD_REL_TOL if "grad" in key else LOSS_REL_TOL),
                (key, err))
    del plain, floor_run, g_kern, g_plain, g_floor

    # one more step through the kernels, profiled: the card's busy share
    # of the step's wall time and where its device time goes
    state = fresh()
    batch = batch_to(batcher.batch_at(0), dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, metrics = steps.train_step(cfg, state, batch, peak_lr=TRAIN_LR,
                                          warmup_steps=20,
                                          total_steps=TRAIN_TOTAL)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    del state
    times, calls = _kernel_times(prof)
    require(bool(times), "torch.profiler recorded no device time")
    dev_ms = sum(times.values()) / 1e3
    print(f"train step profiled: wall {wall_ms:.1f} ms, device {dev_ms:.1f} ms "
          f"(busy {dev_ms / wall_ms:.1%}), {sum(calls.values())} launches; "
          f"top kernels by device time:")
    for name, us in times.most_common(12):
        print(f"  {us / 1e3:9.3f} ms {us / 1e3 / dev_ms:6.1%} "
              f"{calls[name]:6d}x  {name[:100]}")
    del params0, batch0
    torch.cuda.empty_cache()
    resume_check(dev)
    return launches


def resume_check(dev):
    """The trainer at reduced size on the card: 4 steps with a segment at
    2; then the job is taken as preempted after its step-2 checkpoint (step
    4's is removed) and restarted with ``--resume``. It must end on the
    uninterrupted run's state, bitwise."""
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import Store
    from repro_torch.launch import train
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="train-", dir=os.path.join(ROOT, "build"))
    try:
        args = ["--device", dev.type, "--reduced", "--arch", ARCH, "--steps", "4",
                "--segment-steps", "2", "--batch", "8", "--seq", "128",
                "--log-every", "1", "--workdir", workdir]
        full = train.main(args)
        run = f"{configs.reduced(configs.get(ARCH)).name}-s0"
        store = Store(os.path.join(workdir, "store"))
        require(store.delete(ckpt._sig(run, 4)) > 0, "no step-4 checkpoint")
        resumed = train.main(args + ["--resume"])
        leaves_on_card = all(t.is_cuda for t in _tree_leaves(resumed.state))
        equal = same_bits(resumed.state, full.state)
        print(f"resume check ({run}): resumed at step {resumed.start_step}, "
              f"losses {resumed.losses} vs {full.losses[2:]}; state on the "
              f"card: {leaves_on_card}; bitwise equal to the uninterrupted "
              f"run: {equal}")
        require(resumed.start_step == 2 and leaves_on_card and equal,
                "the resumed run differs from the uninterrupted one")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _tree_leaves(tree):
    from repro_torch.core.tree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


# ------------------------------------------------------------------ phase 7
def check_stored_states(store, dev, label):
    """Every stored ``TrainState`` (the initial one, and the train node's
    latest: the session drops a node's superseded entry), from the disk
    tier onto the card, against the memory tier's copy of the value its
    node computed."""
    from repro_torch.core import Store
    store.writer_drain()
    disk = Store(store.root, mem_budget_bytes=0.0)
    names = []
    for sig, meta in sorted(disk.entries().items(),
                            key=lambda kv: kv[1]["name"]):
        if meta["name"] not in ("initState", "train"):
            continue
        value, secs = disk.load(sig, sharding_for_leaf=lambda i, sh, d: dev)
        kept, _ = store.load(sig)
        on_card = all(t.is_cuda for t in _tree_leaves(value))
        equal = same_bits(value, kept)
        print(f"stored {meta['name']} ({sig[:12]}) {label}: {meta['nbytes']} B, "
              f"disk->cuda {secs:.4f} s; on the card: {on_card}; bitwise "
              f"equal to the memory tier's: {equal}")
        require(on_card and equal, ("stored TrainState", meta["name"], label))
        names.append(meta["name"])
    require(names == ["initState", "train"], (label, names))


def lm_workflow_path(dev):
    """Phase 7: the LM workflow in a Helix session on the card
    (``launch.bench_tier``: cold, warm; then an ``LI`` edit of
    ``peak_lr``). Returns the launch counts summed over its iterations."""
    from repro_torch import workflows as W
    from repro_torch.core import State
    from repro_torch.launch import bench_tier
    k = W.LMKnobs()
    L = k.n_layers
    counters = launch_counters()
    per_iter = {}

    @contextlib.contextmanager
    def around(label):
        torch.cuda.synchronize()
        _reset(counters)
        yield
        torch.cuda.synchronize()
        per_iter[label] = _read(counters)

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="lm-tier-", dir=os.path.join(ROOT, "build"))
    try:
        res = bench_tier.bench_tier(os.path.join(workdir, "lm_tier"), k,
                                    device=dev, around=around)
        sess = res.session
        check_stored_states(sess.store, dev, "after the warm run")
        edit = dataclasses.replace(k, peak_lr=3e-3)
        with around("LI edit"):
            rep = sess.run(W.build_lm(edit, device=dev))
        reports = {"cold": res.reports[0], "warm": res.reports[1],
                   "LI edit": rep}
        total = {name: 0 for name in counters}
        for label, r in reports.items():
            states = r.execution.states
            train_runs = int(states["train"] is State.COMPUTE)
            eval_runs = int(states["evalLoss"] is State.COMPUTE)
            expect = {name: 0 for name in counters}
            expect.update(
                rmsnorm=(4 * L + 1) * k.steps * train_runs + (2 * L + 1) * eval_runs,
                rmsnorm_bwd=(2 * L + 1) * k.steps * train_runs)
            print(f"lm workflow {label}: states "
                  f"{ {n: st.name for n, st in states.items()} }; launches "
                  f"{per_iter[label]}; evalLoss {r.outputs['evalLoss']}")
            require(per_iter[label] == expect, (label, per_iter[label], expect))
            for name in total:
                total[name] += per_iter[label][name]
        require(rep.outputs["evalLoss"]["train_losses"][0]
                == reports["cold"].outputs["evalLoss"]["train_losses"][0],
                "the edit's first step differs from the cold run's")
        sess.store.writer_drain()
        check_stored_states(sess.store, dev, "after the edit")
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"lm workflow launches: {total}")
    return total


# ------------------------------------------------------------------ phase 8
PAPER_FLOWS = ("census", "genomics", "nlp", "mnist")
PAPER_ITERS = 10
# each learner on the card against the CPU, as against its JAX twin in
# tests/test_torch_workflows.py: fp32 that differs only in summation order,
# relative to max(1, max |CPU value|); a logistic prediction may flip only
# where the CPU weights' logit is within FLIP_MARGIN of 0
LEARNER_TOL = 1e-5
FLIP_MARGIN = 1e-4
# the nodes whose learners run on the card; the others are numpy on the host
CARD_NODES = {"census": ("incPred",), "genomics": ("word2vec", "kmeans"),
              "nlp": ("corenlp", "spouseLR"), "mnist": ("softmax",)}


def evaluate_nodes(wf, timings=None):
    """Every node of ``wf`` run once, in order, outside any session. With
    ``timings`` (a dict), each node runs under ``torch.profiler`` and its
    wall seconds, device seconds (kernels and copies) and device launches
    land there."""
    from repro_torch.launch.profile_serve import _kernel_times
    from torch.profiler import ProfilerActivity, profile
    dag = wf.build()
    vals = {}
    for name in dag.topological():
        node = dag.nodes[name]
        args = [vals[p] for p in node.parents]
        if timings is None:
            vals[name] = node.fn(*args)
            continue
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            vals[name] = node.fn(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        times, calls = _kernel_times(prof)
        timings[name] = (wall, sum(times.values()) / 1e6, sum(calls.values()))
    return vals


def learner_err(cpu, card, what) -> float:
    cpu, card = np.asarray(cpu), np.asarray(card)
    require(cpu.dtype == card.dtype and cpu.shape == card.shape,
            (what, cpu.dtype, card.dtype, cpu.shape, card.shape))
    err = float(np.abs(card - cpu).max()) / max(1.0, float(np.abs(cpu).max()))
    require(err <= LEARNER_TOL, (what, "card vs CPU", err))
    return err


def boundary_flips(X, w_cpu, w_card, what) -> int:
    """Rows whose logistic prediction differs between the two weights; each
    must lie within FLIP_MARGIN of the CPU weights' boundary."""
    from repro_torch.workflows import logreg_predict
    margin = X @ w_cpu[:-1] + w_cpu[-1]
    flipped = logreg_predict(w_cpu, X) != logreg_predict(w_card, X)
    require(bool(np.all(np.abs(margin[flipped]) < FLIP_MARGIN)),
            (what, "a prediction flipped away from the boundary"))
    return int(flipped.sum())


def paper_learners(name, dev):
    """(b): ``name``'s workflow at its default knobs, every node run on the
    card and again on the CPU. Each deterministic learner runs a second
    time on the card on the same inputs (bitwise equal); the card's values
    are held against the CPU's (learners within LEARNER_TOL, int32
    assignments equal, host nodes bitwise). MNIST's projection is drawn
    afresh on each run, so its learner is held on the card's features."""
    from repro_torch import workflows as W
    wd = W.WORKFLOWS[name]
    k = wd.knobs0
    t0 = time.perf_counter()
    timings = {}
    card = evaluate_nodes(wd.build(k, device=dev), timings)
    wall, busy = (sum(t[i] for t in timings.values()) for i in (0, 1))
    per_node = {n: (round(w, 4), round(d, 4), c)
                for n, (w, d, c) in timings.items()}
    print(f"paper {name} cold on the card, profiled: wall {wall:.4f} s, "
          f"device {busy:.4f} s (busy {busy / wall:.1%}); per node (wall s, "
          f"device s, launches) {per_node}")
    require(busy > 0, (name, "no device time on the card"))
    cpu = evaluate_nodes(wd.build(k, device="cpu")) if name != "mnist" else {}
    dag = wd.build(k, device="cpu").build()
    host = [n for n in cpu
            if not ({n} | dag.ancestors(n)) & set(CARD_NODES[name])]
    require(all(same_bits(card[n], cpu[n]) for n in host), (name, host))
    again, errs, flips = {}, {}, 0
    if name == "census":
        ex = card["income"]
        X, y, n = ex["X"], ex["y"], ex["n_train"]
        again["incPred"] = W.train_logreg(X[:n], y[:n], k.reg,
                                          iters=k.train_iters, device=dev)
        errs["incPred"] = learner_err(cpu["incPred"], card["incPred"], name)
        flips = boundary_flips(X, cpu["incPred"], card["incPred"], name)
        require(flips > 0 or card["checkResults"] == cpu["checkResults"],
                (name, card["checkResults"], cpu["checkResults"]))
    elif name == "genomics":
        again["word2vec"] = W.train_embeddings(card["articles"], k.vocab,
                                               k.emb_dim, k.emb_epochs,
                                               device=dev)
        again["kmeans"] = W.kmeans(card["geneVectors"], k.n_clusters,
                                   device=dev)
        errs["word2vec"] = learner_err(cpu["word2vec"], card["word2vec"], name)
        errs["kmeans"] = learner_err(cpu["kmeans"][0], card["kmeans"][0], name)
        require(np.array_equal(cpu["kmeans"][1], card["kmeans"][1]),
                (name, "assignments differ between the card and the CPU"))
        jo, to = cpu["clusterReport"], card["clusterReport"]
        require(to["top_cluster_sizes"] == jo["top_cluster_sizes"]
                and abs(to["inertia"] - jo["inertia"])
                <= LEARNER_TOL * abs(jo["inertia"]), (name, jo, to))
    elif name == "nlp":
        again["corenlp"] = W.encoder_parse(card["news"], k.vocab, device=dev)
        X, y = card["candidates"]
        again["spouseLR"] = W.train_logreg(X, y, k.reg, iters=200,
                                           device=dev)
        errs["corenlp"] = learner_err(cpu["corenlp"], card["corenlp"], name)
        errs["spouseLR"] = learner_err(cpu["spouseLR"], card["spouseLR"], name)
        flips = boundary_flips(X, cpu["spouseLR"], card["spouseLR"], name)
        require(flips > 0 or card["scoreF1"] == cpu["scoreF1"],
                (name, card["scoreF1"], cpu["scoreF1"]))
    else:
        Z, y = card["randomFFT"]
        again["softmax"] = W.train_softmax(Z, y, k.reg, k.epochs, device=dev)
        errs["softmax"] = learner_err(
            W.train_softmax(Z, y, k.reg, k.epochs, device="cpu"),
            card["softmax"], name)
    twice = {n: same_bits(card[n], v) for n, v in again.items()}
    print(f"paper {name} learners: twice on the card bitwise {twice}; card vs "
          f"CPU max |diff| / max(1, max |CPU|) "
          f"{ {n: f'{e:.3g}' for n, e in errs.items()} }; predictions "
          f"flipped at the boundary {flips}; host nodes bitwise {len(host)}; "
          f"{time.perf_counter() - t0:.1f} s")
    require(all(twice.values()), (name, "a learner is not deterministic", twice))


def state_seconds(execution, state) -> float:
    """The realized C(n) (or l) of the nodes in ``state``, summed."""
    return round(sum(execution.runtime.get(n, 0.0)
                     for n, st in execution.states.items() if st is state), 4)


def paper_workflows_path(dev):
    """Phase 8: (a) the paper's runs, (b) correctness that needs the card,
    (c) the daily retrain, (d) no kernel launched. Returns the counts."""
    from repro_torch import workflows as W
    from repro_torch.core import Policy, State
    from repro_torch.launch import bench_workflows as B
    counters = launch_counters()
    torch.cuda.synchronize()
    _reset(counters)
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="paper-", dir=os.path.join(ROOT, "build"))
    try:
        results = {}
        for name in PAPER_FLOWS:
            t0 = time.perf_counter()
            results[name] = B.run_policies(W.WORKFLOWS[name], workdir,
                                           PAPER_ITERS, device=dev)
            print(f"paper {name}: NM, AM, OPT x {PAPER_ITERS} iterations in "
                  f"{time.perf_counter() - t0:.1f} s")
        cum = B.bench_cumulative_runtime(results, dev)
        B.bench_storage(results, dev)
        B.bench_state_fractions(results, dev)
        for name, runs in results.items():
            for policy, run in runs.items():
                ex = [r.execution for r in run.reports]
                total, speedup = cum[name][policy]
                outside = [round(t - e.total_seconds, 4)
                           for t, e in zip(run.times, ex)]
                print(f"paper {name} {policy.value}: wall s "
                      f"{[round(t, 4) for t in run.times]}; cumulative "
                      f"{total:.4f} s, {speedup:.3f}x NM; computed "
                      f"{[e.n_computed for e in ex]}; loaded "
                      f"{[e.n_loaded for e in ex]}; pruned "
                      f"{[e.n_pruned for e in ex]}; store bytes "
                      f"{[r.store_bytes for r in run.reports]}; compute s "
                      f"{[state_seconds(e, State.COMPUTE) for e in ex]}; load s "
                      f"{[state_seconds(e, State.LOAD) for e in ex]}; mat s "
                      f"{[round(e.mat_seconds, 4) for e in ex]}; outside "
                      f"execute s {outside}")
                print(f"paper {name} {policy.value} cold C(n) s: "
                      f"{ {n: round(c, 4) for n, c in ex[0].runtime.items()} }"
                      + (f"; OMP kept back: {ex[0].skipped_mat}"
                         if policy is Policy.OPT else ""))
            if name == "mnist":
                require(all(r.execution.states["randomFFT"] is State.COMPUTE
                            for run in runs.values() for r in run.reports),
                        "mnist: a random-FFT node was reused")
            else:
                for it in range(PAPER_ITERS):
                    outs = [run.reports[it].outputs for run in runs.values()]
                    require(outs[0] == outs[1] == outs[2],
                            (name, it, "outputs differ between policies"))
        t_paper = time.perf_counter() - t_phase
        for name in PAPER_FLOWS:
            paper_learners(name, dev)
        B.bench_incremental(workdir, device=dev)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    torch.cuda.synchronize()
    launches = _read(counters)
    print(f"paper workflows: the runs {t_paper:.1f} s, phase 8 "
          f"{time.perf_counter() - t_phase:.1f} s; launches {launches}")
    require(not any(launches.values()), ("a kernel launched", launches))
    return launches


# ------------------------------------------------------------------ phase 9
FLEET_BUDGET = 10 * 1024 ** 3            # the paper's 10 GB storage budget
FLEET_CENSUS_ROWS = 120_000              # census at the reference's size
# the 4-arm census grid: a learner knob x a result-analysis knob, in the
# order ``core.sweep.grid`` enumerates it
FLEET_AXES = {"reg": [0.03, 0.3], "eval_threshold": [0.5, 0.7]}
FLEET_GRID = [dict(zip(FLEET_AXES, v))
              for v in itertools.product(*FLEET_AXES.values())]
# the search, as the reference's examples/tune_census.py runs it: a
# budget of 4 arms over 8 candidates on one slot, then successive halving
# of 4 regs over the SGD steps on two. Halving over all 8 candidates
# re-estimates 7 of them between the first two submissions, long enough
# for the first arm to compute cheap shared extractors that OMP does not
# keep, which the second then recomputes (ROADMAP queue 3, item 3).
FLEET_SEARCH = [{"reg": r, "eval_threshold": t}
                for t in (0.5, 0.7) for r in (0.03, 0.3, 0.01, 1.0)]
FLEET_HALVING_REGS = (0.03, 0.3, 0.01, 1.0)
FLEET_HALVING = (60, 300)
# bench_fleet's --scale inside phase 9 (1 = the reference's sizes)
FLEET_BENCH_SCALE = 1.0
SERVE_NODES = ("params", "prompts", "prefill", "decode")


def fleet_registry(dev):
    """The server's registry: ``serve`` (phase 5's serving workflow of
    internlm2-1.8b at full width, flash in prefill) and ``census`` (at
    120,000 rows, learner on the card). Returns (registry, cfg)."""
    from repro_torch import configs
    from repro_torch import workflows as W
    from repro_torch.models import registry
    cfg = dataclasses.replace(configs.get(ARCH), attn_impl="flash")

    def init():
        return registry.init(cfg, torch.Generator(device=dev).manual_seed(SEED),
                             dev)

    def serve(gen_tokens=SESSION_GEN[0]):
        return serve_workflow(cfg, init, int(gen_tokens), device=dev)

    def census(**params):
        return W.build_census(dataclasses.replace(
            W.CensusKnobs(n_rows=FLEET_CENSUS_ROWS), **params), device=dev)
    return {"serve": serve, "census": census}, cfg


def _fleet_server(workdir, registry, **engine):
    from repro_torch.core import EngineConfig, StoreConfig
    from repro_torch.serve import SessionServer
    return SessionServer(
        workdir, registry=registry,
        engine=EngineConfig(**{"schedule": "prefix", "n_sessions": 2,
                               **engine}),
        storage=StoreConfig(budget_bytes=float(FLEET_BUDGET),
                            mem_budget_bytes=SESSION_MEM_BUDGET),
        poll_interval=0.01)


def _since(counters, before):
    """The launches counted since ``before`` (a ``_read``): the phase's
    counts run on underneath, set to 0 only at the phase's start."""
    return {k: v - before[k] for k, v in _read(counters).items()}


def _no_repr(tree) -> bool:
    if isinstance(tree, dict):
        return "__repr__" not in tree and all(_no_repr(v)
                                              for v in tree.values())
    if isinstance(tree, list):
        return all(_no_repr(v) for v in tree)
    return True


def _submit_all(client, submissions, out, errors):
    """One client thread: submit every (workflow, params), then wait for
    each with the detailed summary."""
    try:
        jobs = [client.submit(w, p) for w, p in submissions]
        out.extend(client.wait(j, timeout=1200.0, detail=True) for j in jobs)
    except BaseException as e:  # raised by the caller after the join
        errors.append(e)
    finally:
        client.close()


def fleet_server_run(dev, root, registry, cfg, iso):
    """(a) One server, two model users and a census grid over a unix
    socket, against the isolated runs ``iso``. Returns (server, socket
    path, launches in the run)."""
    from repro_torch.launch.profile_serve import _kernel_times
    from repro_torch.serve import connect_unix
    from torch.profiler import ProfilerActivity, profile
    server = _fleet_server(os.path.join(root, "a"), registry)
    sock = server.serve_unix(os.path.join(root, "a.sock"))
    users = [[("serve", {"gen_tokens": g})] for g in SESSION_GEN]
    users.append([("census", p) for p in FLEET_GRID])
    outs = [[] for _ in users]
    errors = []
    counters = launch_counters()
    torch.cuda.synchronize()
    before = _read(counters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        threads = [threading.Thread(target=_submit_all, args=(
            connect_unix(sock), subs, out, errors))
            for subs, out in zip(users, outs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = _since(counters, before)
    if errors:
        raise errors[0]
    times, calls = _kernel_times(prof)
    busy = sum(times.values()) / 1e6
    print(f"fleet server: 2 serve users + a 4-arm census grid over a unix "
          f"socket, n_sessions 2, schedule prefix: wall {wall:.3f} s, device "
          f"{busy:.3f} s (busy {busy / wall:.1%}), {sum(calls.values())} device "
          f"launches; dispatch order {server.dispatch_log}; kernel launches "
          f"{launches}")
    require(launches["flash_attention"] >= cfg.num_layers
            and launches["rmsnorm"] > 0, ("kernels under the server", launches))

    summaries = [s for out in outs for s in out]
    reports = {s["job"]: server._jobs[s["job"]].report for s in summaries}
    for s in summaries:
        require(s["status"] == "done", s)
        require(_no_repr(s["outputs"]), ("a __repr__ stub on the wire", s["job"]))
        print(f"  job {s['job']} {s['name']}: queued {s['queued_seconds']:.3f} s, "
              f"running {s['run_seconds']:.3f} s; computed "
              f"{s['execution']['n_computed']}, loaded {s['execution']['n_loaded']},"
              f" deduped {s['execution']['n_deduped']}, pruned "
              f"{s['execution']['n_pruned']}")
    # serve users: tokens bitwise the isolated sessions'; the wire summary
    # carries their shape and dtype
    for gen, s in zip(SESSION_GEN, (outs[0][0], outs[1][0])):
        rep = reports[s["job"]]
        tokens = rep.outputs["decode"]["tokens"]
        wire = s["outputs"]["decode"]["tokens"]
        require(tokens.device.type == torch.device(dev).type
                and torch.equal(tokens, iso["serve"][gen][0]),
                ("served tokens differ from the isolated session", gen))
        require(wire["shape"] == [BATCH, gen] and wire["dtype"] == "int32",
                ("wire tokens", wire))
        alone = iso["serve"][gen][1]
        print(f"  serve gen_tokens {gen}: tokens bitwise the isolated session's;"
              f" C(n) s alone / in the server: " + ", ".join(
                  f"{n} {alone.get(n, 0.0):.4f} / "
                  + (f"{rep.execution.runtime[n]:.4f}"
                     if rep.execution.states[n].name == "COMPUTE" else
                     rep.execution.states[n].name)
                  for n in SERVE_NODES))
    for params, s in zip(FLEET_GRID, outs[2]):
        require(reports[s["job"]].outputs == iso["census"][json.dumps(params)],
                ("census output differs from its isolated run", params))
    print(f"  census grid: {len(FLEET_GRID)} outputs == their isolated runs")
    # no signature blind-computed twice; every node computed twice printed
    # with the planner's reason
    computed, blind, names = {}, {}, {}
    for s in summaries:
        rep = reports[s["job"]]
        names.update({sig: n for n, sig in rep.sigs.items()})
        for sig in s["execution"]["computed_sigs"]:
            computed.setdefault(sig, []).append(s["job"])
        for sig in s["execution"]["blind_computed_sigs"]:
            blind[sig] = blind.get(sig, 0) + 1
    for sig, jobs in computed.items():
        if len(jobs) > 1:
            chose = [j for j in jobs
                     if names[sig] in reports[j].execution.chose_compute]
            print(f"  computed twice: {names[sig]} ({sig[:12]}) in {jobs}; the "
                  f"planner chose to compute it (load dearer) in {chose}")
    require(all(c == 1 for c in blind.values()),
            ("a signature blind-computed twice",
             {names[s]: c for s, c in blind.items() if c > 1}))
    return server, sock, launches


def fleet_router_run(root, registry, server_a, sock_a):
    """(b) A fleet of two: the same submissions through a hash router,
    then again through a fresh router: each repeat lands on its home
    shard and recomputes nothing that a shard holds (no flash or rmsnorm
    launch, no node computed whose entry was stored)."""
    from repro_torch.serve import FleetRouter
    server_b = _fleet_server(os.path.join(root, "b"), registry)
    shards = {"a": sock_a, "b": server_b}
    subs = [("serve", {"gen_tokens": g}) for g in SESSION_GEN] + [
        ("census", p) for p in FLEET_GRID]
    counters = launch_counters()
    passes = {}
    try:
        for label in ("first", "rerun"):
            router = FleetRouter(shards, registry=registry, route="hash")
            held = {sid: set(s.store.entries()) for sid, s in
                    (("a", server_a), ("b", server_b))}
            torch.cuda.synchronize()
            before = _read(counters)
            t0 = time.perf_counter()
            jobs = [router.submit(w, p) for w, p in subs]
            outs = [router.wait(j, timeout=1200.0, detail=True) for j in jobs]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = _since(counters, before)
            router.close()
            homes = [o["shard"] for o in outs]
            recomputed = [sig for o in outs
                          for sig in o["execution"]["blind_computed_sigs"]
                          if sig in held[o["shard"]]]
            chosen = sum(len(o["execution"]["computed_sigs"])
                         - len(o["execution"]["blind_computed_sigs"])
                         for o in outs)
            n_comp = [o["execution"]["n_computed"] - o["execution"]["n_deduped"]
                      for o in outs]
            print(f"fleet router {label} pass: wall {wall:.3f} s; shards "
                  f"{homes}; computed a job {n_comp}, {chosen} of them by the "
                  f"planner's choice; entries a shard held computed blindly "
                  f"{len(recomputed)}; launches {launches}")
            require(all(o["status"] == "done" for o in outs), outs)
            passes[label] = (homes, recomputed, launches, n_comp)
        homes0, _, _, _ = passes["first"]
        homes1, recomputed, launches, n_comp = passes["rerun"]
        require(homes1 == homes0, ("a repeat left its home shard", homes0, homes1))
        require(not recomputed and launches["flash_attention"] == 0
                and launches["rmsnorm"] == 0,
                ("the warm rerun recomputed", recomputed, launches))
    finally:
        server_b.shutdown()
    return server_b


def fleet_search(root, registry):
    """(c) ``tune`` over the census grid, as the reference's
    ``examples/tune_census.py``: the reuse frontier under a budget of 4
    arms, then successive halving over the SGD steps; each with 0 wasted
    recomputes (every node computed twice blindly is printed) and 0 B
    ledger drift."""
    from repro_torch.core import (EngineConfig, HalvingConfig, SearchConfig,
                                  StorageLedger, Store, StoreConfig,
                                  compute_signatures, tune)
    runs = {
        "budget": dict(space=FLEET_SEARCH, slots=1, config=SearchConfig(
            strategy="grid", max_arms=4, frontier="reuse", max_inflight=2,
            metric="checkResults.value")),
        "halving": dict(space=[{"reg": r} for r in FLEET_HALVING_REGS],
                        slots=2, config=SearchConfig(
            strategy="grid", frontier="reuse", max_inflight=2,
            metric="checkResults.value",
            halving=HalvingConfig(resource="train_iters",
                                  levels=list(FLEET_HALVING), eta=2.0)))}
    for label, run in runs.items():
        workdir = os.path.join(root, f"search-{label}")
        t0 = time.perf_counter()
        report = tune(workdir, {"census": registry["census"]}, "census",
                      space=run["space"], config=run["config"],
                      engine=EngineConfig(n_sessions=run["slots"]),
                      storage=StoreConfig(budget_bytes=float(FLEET_BUDGET)))
        wall = time.perf_counter() - t0
        store = Store(os.path.join(workdir, "store"))
        drift = StorageLedger(store.ledger_path).used() - store.total_bytes()
        names, blind = {}, {}
        for a in report.arms:
            names.update({sig: n for n, sig in compute_signatures(
                registry["census"](**a.params).build()).items()})
            for sig in (a.summary.get("execution") or {}).get(
                    "blind_computed_sigs", ()):
                blind.setdefault(sig, []).append(
                    f"#{a.order} {a.name} queued "
                    f"{a.summary.get('queued_seconds', 0):.3f} s, running "
                    f"{a.summary.get('run_seconds', 0):.3f} s")
        for sig, arms in blind.items():
            if len(arms) > 1:
                print(f"  blind-computed twice: {names.get(sig, sig[:12])} "
                      f"by {arms}")
        best = report.best()
        ran = [a for a in report.arms if a.status != "skipped"]
        print(f"fleet search {label}: tune over {len(run['space'])} census "
              f"candidates, {run['slots']} slot(s): {wall:.3f} s; rungs "
              f"{[(r['n_arms'], r['n_done'], r['n_cancelled'], r['n_skipped']) for r in report.rungs]}; "
              f"models trained {len({a.params['reg'] for a in ran})} in "
              f"{len(ran)} arms; best {best.name if best else None} metric "
              f"{best.metric if best else None}; wasted recomputes "
              f"{report.wasted_recomputes()}; ledger drift {drift:.0f} B")
        require(best is not None and report.wasted_recomputes() == 0
                and drift == 0, (label, report.wasted_recomputes(), drift))


def fleet_benches(dev, smi):
    """(d) ``launch.bench_fleet``'s six benches, checked where a fleet
    must hold at any size."""
    from repro_torch.launch import bench_fleet
    print(f"bench_fleet --scale {FLEET_BENCH_SCALE:g} on {smi}")
    out = bench_fleet.run(scale=FLEET_BENCH_SCALE, device=dev)
    for name in ("census", "mnist"):
        require(out["sweep_reuse"][name]["shared_recomputed"] == 0
                and out["server_reuse"][name]["shared_recomputed"] == 0
                and out["eviction"][name]["ledger_drift_b"] == 0,
                ("bench_fleet", name))
    require(out["remote_reuse"]["fleet_dup"] == 0
            and out["remote_reuse"]["evict_leased"] == 0, out["remote_reuse"])
    require(out["search_reuse"]["search"]["wasted"] == 0
            and out["search_reuse"]["halving"]["wasted"] == 0
            and out["search_reuse"]["halving"]["ledger_drift_b"] == 0,
            out["search_reuse"])
    require(out["multitenant"]["hash_recomputed"] == 0
            and out["multitenant"]["ledger_drift_b"] == 0, out["multitenant"])
    print("bench_fleet seconds: " + json.dumps(
        {k: round(v["bench_s"], 3) for k, v in out.items()}))


def fleet_path(dev, smi):
    """Phase 9: the serving and fleet layer on the card. Returns the
    launch counts of the whole phase."""
    from repro_torch.core import (EngineConfig, IterativeSession, Policy,
                                  grid, run_sweep)
    from repro_torch import workflows as W
    counters = launch_counters()
    torch.cuda.synchronize()
    _reset(counters)
    t_phase = time.perf_counter()
    registry, cfg = fleet_registry(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="fleet-", dir=os.path.join(ROOT, "build"))
    servers = []
    try:
        # isolated runs: each workflow in its own session, nothing stored
        never = EngineConfig(policy=Policy.NEVER)
        iso = {"serve": {}, "census": {}}
        for gen in SESSION_GEN:
            rep = IterativeSession(os.path.join(root, f"iso-serve{gen}"),
                                   engine=never).run(registry["serve"](gen))
            iso["serve"][gen] = (rep.outputs["decode"]["tokens"],
                                 dict(rep.execution.runtime))
            del rep
        for i, params in enumerate(FLEET_GRID):
            rep = IterativeSession(os.path.join(root, f"iso-census{i}"),
                                   engine=never).run(registry["census"](**params))
            iso["census"][json.dumps(params)] = rep.outputs
        # the same grid through run_sweep: one in-process server, one store
        sweep = run_sweep(
            os.path.join(root, "sweep"),
            grid(W.CensusKnobs(n_rows=FLEET_CENSUS_ROWS), FLEET_AXES,
                 lambda k: W.build_census(k, device=dev), name="census"))
        sweep.raise_errors()
        print(f"fleet run_sweep: {len(sweep.results)} census arms in "
              f"{sweep.wall_seconds:.3f} s; computes a signature "
              f"{sorted(set(sweep.fleet_computes().values()))}; wasted "
              f"{sweep.wasted_recomputes()}")
        require([r.outputs for r in sweep.results]
                == [iso["census"][json.dumps(p)] for p in FLEET_GRID]
                and sweep.wasted_recomputes() == 0,
                "run_sweep's outputs or compute-once")

        server_a, sock_a, _ = fleet_server_run(dev, root, registry, cfg, iso)
        servers.append(server_a)
        servers.append(fleet_router_run(root, registry, server_a, sock_a))
        fleet_search(root, registry)
        fleet_benches(dev, smi)
    finally:
        for server in servers:
            server.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    launches = _read(counters)
    print(f"fleet: phase 9 {time.perf_counter() - t_phase:.1f} s; launches "
          f"{launches}")
    return launches


# ------------------------------------------------------------------ phase 10
ENGINE_OVERLAP_MIN = 3.0       # the 8-wide diamond's speedup bar
EXAMPLE_SERVE_GEN = 32         # launch.serve's default --gen-tokens
EXAMPLE_TRAIN_STEPS = 50       # train_lm --small --steps 50, segments of 25


def engine_benches(root, smi):
    """``python -m repro_torch.launch.bench_engine`` in a subprocess on
    the card, BLAS pinned to one thread before numpy loads (this process
    has numpy loaded long since): OEP µs, both speedups, census outputs
    equal across the engines, the diamond at >= 3x, each census learner's
    C(n) under the sequential and the pipelined engine, and the card's
    busy share of one cold pipelined census iteration. Its temporary
    workdirs go under ``root``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), TMPDIR=root,
               **{v: "1" for v in ("OPENBLAS_NUM_THREADS", "OMP_NUM_THREADS",
                                   "MKL_NUM_THREADS")})
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bench_engine"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    print(f"bench_engine on {smi} ({time.perf_counter() - t0:.1f} s, "
          f"rc {proc.returncode}):")
    for line in lines[:-1]:
        print(f"  {line}")
    require(proc.returncode == 0, ("bench_engine failed", proc.stderr[-4000:]))
    out = json.loads(lines[-1])
    threads = out["threads"]
    require(all(threads[v] == "1" for v in ("OPENBLAS_NUM_THREADS",
                                            "OMP_NUM_THREADS",
                                            "MKL_NUM_THREADS"))
            and threads["torch_threads"] == 1 and out["device"] == "cuda",
            ("bench_engine's threads or device", threads, out["device"]))
    speed = out["parallel_speedup"]
    census, overlap = speed["census"], out["engine_overlap"]
    print("engine benches: OEP µs a solve " + json.dumps(
        {n: round(us, 1) for n, us in out["optimizer_overhead"].items()})
        + f"; census speedup {census['speedup']:.3f}x, mnist "
        f"{speed['mnist']['speedup']:.3f}x at {census['workers']} workers; "
        f"overlap {overlap['speedup']:.3f}x")
    require(census["outputs_equal"]
            and census["outputs_seq"] == census["outputs_par"],
            "census outputs differ between the engines")
    require(overlap["speedup"] >= ENGINE_OVERLAP_MIN, ("overlap", overlap))
    # speed item 11: a learner's C(n) alone (sequential) against beside the
    # other workers on the one stream (pipelined), where both computed it
    for i, (st_s, st_p, rt_s, rt_p) in enumerate(zip(
            census["states_seq"], census["states_par"],
            census["runtime_seq"], census["runtime_par"])):
        both = [n for n in census["learners"]
                if st_s.get(n) == st_p.get(n) == "COMPUTE"]
        print(f"  census iteration {i}: C(n) seq / par s " + json.dumps(
            {n: [round(rt_s[n], 6), round(rt_p[n], 6),
                 round(rt_p[n] / max(rt_s[n], 1e-9), 3)] for n in both})
            + f"; all nodes {sum(rt_s.values()):.4f} / "
            f"{sum(rt_p.values()):.4f} s")
    busy = out["census_busy"]
    print(f"  census cold pipelined iteration, profiled: wall "
          f"{busy['wall_s']:.4f} s, device {busy['device_s']:.4f} s (busy "
          f"{busy['busy']:.2%}), {busy['launches']} device launches")
    require(busy["device_s"] > 0, "no device time in the census iteration")
    return out


def example_expectations(label):
    """The exact launch counts of the example run ``label``, from the
    reduced configs."""
    from repro_torch import configs
    zero = {k: 0 for k in launch_counters()}
    lm = configs.reduced(configs.get(ARCH))
    ssm = configs.reduced(configs.get(SSM_ARCH))
    train = configs.reduced(configs.get("helix100m"))
    steps = EXAMPLE_TRAIN_STEPS + EXAMPLE_TRAIN_STEPS // 2   # run + resume
    return {
        # flash in each layer of prefill (bf16: the tensor-core kernel),
        # 2 norms a layer and the final norm in every forward
        "serve_lm": {**zero, "rmsnorm": (2 * lm.num_layers + 1)
                     * EXAMPLE_SERVE_GEN, "flash_attention": lm.num_layers,
                     "flash_attention_tc": lm.num_layers},
        # SSD in each layer of prefill; chunk 8 takes the CUDA-core kernel
        "serve_lm_mamba2": {**zero, "rmsnorm": (2 * ssm.num_layers + 1)
                            * EXAMPLE_SERVE_GEN, "ssd": ssm.num_layers},
        # remat "block": 4L + 1 forwards and 2L + 1 backwards a step
        "train_lm": {**zero, "rmsnorm": (4 * train.num_layers + 1) * steps,
                     "rmsnorm_bwd": (2 * train.num_layers + 1) * steps},
    }.get(label, zero)


def examples_path(dev, smi):
    """Phase 10: the engine benches in a subprocess, then the eight
    examples of ``repro_torch.examples`` on the card at the reference's
    defaults (``train_lm`` at ``--small --steps 50``, then ``--resume``
    after its last checkpoint is removed, bitwise the uninterrupted run),
    each with the launch counts set to 0 just before it and read just
    after. Their workdirs go under ``build/`` (``tempfile.tempdir``),
    removed at the end. Returns the launch counts of the examples."""
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import Store
    from repro_torch.examples import (genomics_iterate, incremental_census,
                                      quickstart, serve_lm, session_server,
                                      sweep_census, train_lm, tune_census)
    counters = launch_counters()
    t_phase = time.perf_counter()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="examples-", dir=os.path.join(ROOT, "build"))
    saved_tempdir = tempfile.tempdir
    total = {k: 0 for k in counters}
    try:
        engine_benches(root, smi)
        tempfile.tempdir = root
        train_dir = os.path.join(root, "train_lm")
        train_argv = ["--small", "--steps", str(EXAMPLE_TRAIN_STEPS),
                      "--workdir", train_dir, "--log-every", "25"]
        runs = [("quickstart", quickstart, []),
                ("genomics_iterate", genomics_iterate, []),
                ("incremental_census", incremental_census, []),
                ("session_server", session_server, []),
                ("sweep_census", sweep_census, []),
                ("tune_census", tune_census, []),
                ("serve_lm", serve_lm, []),
                ("serve_lm_mamba2", serve_lm, ["--arch", SSM_ARCH]),
                ("train_lm", train_lm, train_argv)]
        outs = {}
        for label, module, argv in runs:
            torch.cuda.synchronize()
            _reset(counters)
            t0 = time.perf_counter()
            outs[label] = module.main(argv)
            if label == "train_lm":
                run = f"{configs.reduced(configs.get('helix100m')).name}-s0"
                store = Store(os.path.join(train_dir, "store"))
                require(store.delete(ckpt._sig(run, EXAMPLE_TRAIN_STEPS)) > 0,
                        "no checkpoint at the last step")
                outs["train_lm_resumed"] = module.main(train_argv + ["--resume"])
            torch.cuda.synchronize()
            launches = _read(counters)
            print(f"example {label}: {time.perf_counter() - t0:.1f} s on {dev}; "
                  f"launches {launches}")
            require(launches == example_expectations(label),
                    (label, launches, example_expectations(label)))
            for k in total:
                total[k] += launches[k]
    finally:
        tempfile.tempdir = saved_tempdir
        shutil.rmtree(root, ignore_errors=True)

    q = outs["quickstart"]
    print("  quickstart: " + "; ".join(
        f"{s['title']}: computed {s['n_computed']}, loaded {s['n_loaded']}, "
        f"pruned {s['n_pruned']}, {s['total_seconds']:.3f} s, {s['output']}"
        for s in q))
    g = outs["genomics_iterate"]
    print(f"  genomics: NEVER {g['NEVER']['total_s']:.3f} s, OPT "
          f"{g['OPT']['total_s']:.3f} s, speedup {g['speedup']:.3f}x")
    days = outs["incremental_census"]
    print("  incremental_census: " + "; ".join(
        f"{d['title']} {d['seconds']:.3f} s {d['dailyEval']}" for d in days))
    require(all(c == (1, 6) for c in days[1]["chunks"].values()),
            ("the append computed other than one chunk", days[1]["chunks"]))
    srv = outs["session_server"]
    print(f"  session_server: dispatch {srv['dispatch_log']}; " + "; ".join(
        f"{u} {r['status']} {r['run_seconds']:.3f} s {r['outputs']}"
        for u, r in sorted(srv["results"].items())))
    require(all(r["status"] == "done" for r in srv["results"].values()), srv)
    sw = outs["sweep_census"]
    print(f"  sweep_census: isolated {sw['iso_s']:.3f} s, sweep "
          f"{sw['sweep_s']:.3f} s ({sw['speedup']:.3f}x), computed twice "
          f"{len(sw['recomputed'])}")
    tu = outs["tune_census"]
    print(f"  tune_census: {tu['search']['models']} models in "
          f"{len(tu['search']['arms'])} arms, wasted {tu['search']['wasted']}; "
          f"halving best {tu['halving']['best']}, ledger drift "
          f"{tu['halving']['ledger_drift_b']:.0f} B")
    for label in ("serve_lm", "serve_lm_mamba2"):
        res = outs[label]
        require(bool(torch.isfinite(res.last_logits).all())
                and tuple(res.tokens.shape)[1] == EXAMPLE_SERVE_GEN, label)
    full, resumed = outs["train_lm"], outs["train_lm_resumed"]
    equal = same_bits(resumed.state, full.state)
    print(f"  train_lm --small: loss {full.losses[0]:.4f} -> "
          f"{full.losses[-1]:.4f} in {len(full.losses)} steps, "
          f"{np.median(full.step_s) * 1e3:.2f} ms a step (median); resumed at "
          f"step {resumed.start_step}, bitwise the uninterrupted run: {equal}")
    require(resumed.start_step == EXAMPLE_TRAIN_STEPS // 2 and equal
            and resumed.losses == full.losses[EXAMPLE_TRAIN_STEPS // 2:],
            "train_lm --resume differs from the uninterrupted run")
    print(f"examples: phase 10 {time.perf_counter() - t_phase:.1f} s; "
          f"launches {total}")
    return total


def link_rates(dev, nbytes=1 << 30, n=5):
    """GB/s of a pinned host buffer copied to the card and back (CUDA
    events around ``n`` copies each way, after one warm-up copy): the
    rate the host link gives the store's copies, which can go no faster."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    rates = {}
    for name, dst, src in (("host->card", card, host),
                           ("card->host", host, card)):
        dst.copy_(src, non_blocking=True)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            dst.copy_(src, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        rates[name] = round(n * nbytes / (start.elapsed_time(end) / 1e3) / 1e9, 3)
    return rates


def synth_prompts(cfg, batch=BATCH, prompt=PROMPT, seed=SEED):
    """(batch, prompt) int32 prompts from the seeded token stream."""
    from repro_torch.data import synth
    toks = synth.lm_tokens(seed, batch * prompt + 1, cfg.vocab_size)
    return toks[:batch * prompt].reshape(batch, prompt)


def _leaves(tree):
    if isinstance(tree, (dict, list)):
        for v in (tree.values() if isinstance(tree, dict) else tree):
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

    t_start = t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"built {len(logs)} of {len(_build.sources())} kernel libraries in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, log in logs.items():
        print(f"{os.path.relpath(src, ROOT)}:\n  " + "\n  ".join(
            ptxas_report(log)))

    timer = ColdTimer(dev)
    rows = {"rmsnorm": check_rmsnorm(dev, timer, peaks),
            "rmsnorm_bwd": check_rmsnorm_bwd(dev, timer, peaks),
            "flash_attention": check_flash(dev, timer, peaks),
            "ssd": check_ssd(dev, timer, peaks)}
    del timer
    by_path = {ARCH: serve_full(dev), SSM_ARCH: serve_ssm(dev),
               WINDOWED_ARCH: serve_windowed(dev), **serve_moe(dev),
               VLM_ARCH: serve_vlm(dev), HYBRID_ARCH: serve_hybrid(dev),
               AUDIO_ARCH: serve_audio(dev),
               "helix-session": session_path(dev),
               "train-internlm2": train_path(dev),
               "lm-workflow": lm_workflow_path(dev),
               "paper-workflows": paper_workflows_path(dev),
               "fleet": fleet_path(dev, smi),
               "examples": examples_path(dev, smi)}

    meta = {
        "rmsnorm": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm/rmsnorm.py:28"),
        # no TPU kernel: the reference differentiates the jnp rmsnorm
        # (src/repro/models/layers.py:27) by autodiff
        "rmsnorm_bwd": ("src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu", None),
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
        if replaces is None:
            row["note"] = ("the reference differentiates "
                           "src/repro/models/layers.py:27 by autodiff")
        kernels.append({**row, **rows[k]})
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
