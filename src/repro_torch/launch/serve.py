"""Batched serving: prefill a batch of prompts, decode greedily.

Twin of the JAX package's ``launch/serve.py``, with two more flags:
``--device`` (default ``cuda``; asking for it without a card raises) and
``--attn-impl`` (default ``flash``, so prefill goes through the
FlashAttention kernel; the ssm family has no attention and ignores it).
``run`` is the library entry point; ``main`` and ``chip_smoke.py`` both
call it. It serves the dense family, its windowed configs among them
(gemma3-4b: ring KV caches for the local layers, flash at head_dim 256 in
prefill), the MoE family (granite-moe-1b-a400m, qwen2-moe-a2.7b: every
layer's FFN is ``models/moe.py`` ``moe_block``, whose capacity follows the
tokens of each call, so a decode step of batch 4 runs with capacity 1 per
expert and drops assignments, as the reference does), the vlm family
(qwen2-vl-7b: the prefill batch carries ``vision_embeds`` and the three
M-RoPE streams; ``main`` builds them as the reference's launcher does, a
zero 4-patch prefix and three equal streams, and decode passes neither),
the ssm family (mamba2-130m, whose prefill goes through the SSD chunk
kernel), the hybrid family (jamba-v0.1-52b, whose Mamba-2 layers'
prefill goes through the SSD chunk kernel and whose MoE layers run
``moe_block``) and, through ``run`` only, the audio family
(whisper-medium: the prefill batch carries the encoder's ``frames``, and
flash runs non-causal over every frame in the encoder). ``main``, like
the reference's launcher, refuses the audio family.

    python -m repro_torch.launch.serve --full          # on the card
    python -m repro_torch.launch.serve --arch mamba2-130m --full
    python -m repro_torch.launch.serve --arch gemma3-4b --full --prompt-len 1536
    python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --full --prompt-len 512
    python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --device cpu
    python -m repro_torch.launch.serve --arch qwen2-vl-7b --device cpu
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --device cpu
    python -m repro_torch.launch.serve --device cpu    # reduced, on the CPU
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from .. import configs
from ..data import synth
from ..device import resolve
from ..models import registry
from ..models.config import ArchConfig
from ..train import steps


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, gen_tokens) int32 greedy tokens, on the host
    prefill_logits: torch.Tensor  # (B, V) logits after the prompt
    last_logits: torch.Tensor     # (B, V) logits of the last decode step
    prefill_s: float
    decode_s: float


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(cfg: ArchConfig, params: Any, prompts, gen_tokens: int, *,
        device: str | torch.device | None = None,
        vision_embeds: torch.Tensor | None = None,
        mrope_positions: torch.Tensor | None = None,
        frames: torch.Tensor | None = None) -> ServeResult:
    """Prefill ``prompts`` (B, S) and decode ``gen_tokens`` greedy tokens
    (the first comes from the prefill logits). ``params`` must live on
    ``device`` (default ``cuda``). The vlm family's ``vision_embeds`` (B,
    npatch, D) and ``mrope_positions`` (3, B, S), and the audio family's
    ``frames`` (B, S_enc, D), go into the prefill batch only."""
    dev = resolve(device)
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int32).to(dev)
    batch = {"tokens": tokens}
    for key, t in (("vision_embeds", vision_embeds),
                   ("mrope_positions", mrope_positions), ("frames", frames)):
        if t is not None:
            batch[key] = t.to(dev)
    max_len = tokens.shape[1] + gen_tokens
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = steps.prefill_step(cfg, params, batch,
                                           max_len=max_len)
        _sync(dev)
        t_prefill = time.perf_counter() - t0
        prefill_logits = logits

        out = [logits.argmax(-1).to(torch.int32)[:, None]]
        t0 = time.perf_counter()
        for _ in range(gen_tokens - 1):
            logits, cache = steps.decode_step(cfg, params, out[-1], cache)
            out.append(logits.argmax(-1).to(torch.int32)[:, None])
        _sync(dev)
        t_decode = time.perf_counter() - t0
    return ServeResult(tokens=torch.cat(out, 1).cpu(),
                       prefill_logits=prefill_logits, last_logits=logits,
                       prefill_s=t_prefill, decode_s=t_decode)


def main(argv: list[str] | None = None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--attn-impl", default="flash",
                    choices=("reference", "chunked", "flash"))
    args = ap.parse_args(argv)

    dev = resolve(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = configs.reduced(cfg)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn_impl)
    if cfg.family == "audio":
        raise SystemExit("use an LM-family arch for serve (enc-dec decode "
                         "is exercised in tests)")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = registry.init(cfg, gen, dev)

    toks = synth.lm_tokens(args.seed, args.batch * args.prompt_len + 1,
                           cfg.vocab_size)
    prompts = toks[:args.batch * args.prompt_len].reshape(
        args.batch, args.prompt_len)
    vision = {}
    if cfg.family == "vlm":
        vision = {
            "vision_embeds": torch.zeros((args.batch, 4, cfg.d_model),
                                         dtype=torch.bfloat16, device=dev),
            "mrope_positions": torch.arange(
                args.prompt_len, dtype=torch.int32, device=dev).expand(
                    3, args.batch, args.prompt_len)}
    res = run(cfg, params, prompts, args.gen_tokens, device=dev, **vision)

    tok_s = args.batch * (args.gen_tokens - 1) / max(res.decode_s, 1e-9)
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen_tokens} device={dev} attn_impl={cfg.attn_impl}")
    print(f"prefill {res.prefill_s*1e3:.1f} ms; decode {res.decode_s*1e3:.1f} ms "
          f"({tok_s:.1f} tok/s)")
    print("first sequence:", res.tokens[0][:16].tolist())
    return res


if __name__ == "__main__":
    main()
