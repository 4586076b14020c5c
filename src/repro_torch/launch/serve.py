"""Serving driver of the port: batched prefill + decode with the model's
decode cache (stacked per-layer KV, MLA's latent, zamba2's Mamba2 states
and shared K/V, xLSTM's mLSTM and sLSTM states, or whisper's self and
cross K/V), on the card unless asked for the CPU.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch h2o-danube-1.8b --batch 4 --prompt-len 64 --gen 32 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch zamba2-7b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch xlstm-1.3b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch whisper-base --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch chameleon-34b --device cpu

The flags and printed lines are those of ``repro.launch.serve``; without
``--full`` it runs the arch's smoke config. Weights and prompts come from
``--seed``: weights from a generator on the run's device, prompts (and the
VLM family's patch embeddings, normal (B, P, d) in ``cfg.dtype``, and the
audio family's frames, normal (B, encoder_seq, d), the stub frontends'
output) from CPU generators (so every device serves the same inputs). The
VLM's P patches go before the prompt: its cache holds P + prompt + gen
slots, its decode continues at P + prompt, and the prefill's tokens/s
count the prompt's text tokens, as the reference's. ``serve(cfg, ...)``
is the same run as a function, for callers that want the tokens, logits and
timings. Greedy decoding (``temperature <= 0``) is deterministic; sampling
draws from a seeded generator on the run's device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import api


@dataclasses.dataclass
class ServeResult:
    prompts: torch.Tensor     # (B, prompt_len) int64
    tokens: torch.Tensor      # (B, gen) int64, the generated tokens
    logits: torch.Tensor      # (B, gen, V): token t was drawn from logits[:, t]
    prefill_s: float          # host wall time of the prefill, synchronized
    decode_s: float           # host wall time of the gen - 1 decode steps


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ModelConfig, *, batch: int = 4, prompt_len: int = 64,
          gen: int = 32, temperature: float = 0.0, seed: int = 0,
          device=None, params: Optional[dict] = None) -> ServeResult:
    """Prefill ``batch`` random prompts of ``prompt_len`` tokens, then
    decode until ``gen`` tokens per sequence (the first from the prefill's
    logits). ``params`` (on ``device``) replaces the seeded init."""
    if gen < 1:
        raise ValueError(f"gen = {gen}: serve generates at least one token")
    if cfg.ssm.enabled and prompt_len % min(cfg.ssm.chunk_size, prompt_len):
        raise ValueError(
            f"prompt_len = {prompt_len}: the SSM prefill scans whole "
            f"chunks of min(chunk_size, prompt_len) = "
            f"{min(cfg.ssm.chunk_size, prompt_len)} positions; give a "
            f"multiple of {cfg.ssm.chunk_size} or a prompt shorter than it")
    dev = resolve_device(device)
    with torch.inference_mode():
        if params is None:
            params = api.init(cfg, torch.Generator(dev).manual_seed(seed),
                              dev)
        prompts = torch.randint(
            0, cfg.vocab_size, (batch, prompt_len),
            generator=torch.Generator().manual_seed(seed + 1)).to(dev)
        inputs = {"tokens": prompts}
        off = 0
        if cfg.family == "vlm":
            off = cfg.num_patch_tokens
            inputs["patch_embeds"] = torch.randn(
                (batch, off, cfg.d_model),
                generator=torch.Generator().manual_seed(seed + 2)
            ).to(device=dev, dtype=getattr(torch, cfg.dtype))
        if cfg.family == "audio":
            inputs["frames"] = torch.randn(
                (batch, cfg.encoder_seq, cfg.d_model),
                generator=torch.Generator().manual_seed(seed + 3)
            ).to(device=dev, dtype=getattr(torch, cfg.dtype))
        sampler = torch.Generator(dev).manual_seed(seed + 10)

        def sample(lg):
            last = lg[:, -1].float()
            if temperature <= 0:
                return last.argmax(dim=-1, keepdim=True)
            probs = torch.softmax(last / temperature, dim=-1)
            return torch.multinomial(probs, 1, generator=sampler)

        cache_len = off + prompt_len + gen
        _sync(dev)
        t0 = time.monotonic()
        logits, cache = api.prefill(params, cfg, inputs, cache_len)
        _sync(dev)
        prefill_s = time.monotonic() - t0

        tok = sample(logits)
        toks, lgs = [tok], [logits[:, -1]]
        t0 = time.monotonic()
        for t in range(gen - 1):
            logits, cache = api.decode_step(params, cfg, cache, tok,
                                            off + prompt_len + t)
            tok = sample(logits)
            toks.append(tok)
            lgs.append(logits[:, -1])
        _sync(dev)
        decode_s = time.monotonic() - t0
    return ServeResult(prompts=prompts, tokens=torch.cat(toks, dim=1),
                       logits=torch.stack(lgs, dim=1), prefill_s=prefill_s,
                       decode_s=decode_s)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else get_smoke_config(args.arch)
    B = args.batch
    r = serve(cfg, batch=B, prompt_len=args.prompt_len, gen=args.gen,
              temperature=args.temperature, seed=args.seed,
              device=args.device)
    print(f"arch={args.arch} B={B} prompt={args.prompt_len} gen={args.gen}")
    print(f"prefill: {r.prefill_s*1e3:8.1f} ms "
          f"({B*args.prompt_len/r.prefill_s:9.0f} tok/s)")
    print(f"decode : {r.decode_s*1e3:8.1f} ms "
          f"({B*(args.gen-1)/max(r.decode_s,1e-9):9.0f} tok/s)")
    print("sample token ids:", r.tokens[0, :16].tolist())


if __name__ == "__main__":
    main()
