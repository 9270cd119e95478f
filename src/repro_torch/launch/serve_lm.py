"""Batched LM serving: prefill once, then token-by-token greedy
decode (the reference's ``launch.serve_lm``).

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch olmoe-1b-7b \
        --batch 4 --prompt-len 64 --gen 32 [--full-size] [--torch-device cpu]

Random weights drawn from a seed on a CPU generator and copied to the
device, so one seed serves the same weights on every device
(``serve(seed=0)``; nothing is downloaded); the prompts are
``SyntheticLM`` batch 0. Every family of the registry but ``ising``:
dense, moe and vlm prefill the prompt in one pass
(vlm with no vision embeddings, as in the reference); the recurrent
families (hybrid, rwkv) warm their state token by token through
``decode_step``; the encoder (hubert) has no decode and exits with the
reference's message. Runs on ``torch_device`` (default ``cuda``; without
CUDA it raises unless given ``cpu``).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..configs import get_config
from ..data import SyntheticLM
from ..device import resolve_device
from ..models import build


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(arch: str, batch: int, prompt_len: int, gen: int,
          reduced: bool = True, greedy: bool = True, seed: int = 0,
          torch_device: str | torch.device = "cuda",
          n_layers: int | None = None):
    """Serve ``batch`` synthetic prompts of ``prompt_len`` tokens and
    generate ``gen`` tokens each by greedy argmax (``greedy`` is the
    reference's flag; decoding is greedy either way). Returns the generated
    tokens (batch, gen), prefill and decode seconds (host clock around work
    that ends in a synchronize), decode tokens per second, and whether
    every step's logits were finite. ``n_layers`` cuts the config's depth
    and keeps its widths (a full-width smoke run on a smaller budget)."""
    dev = resolve_device(torch_device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build(cfg)
    if model.decode_step is None:
        raise SystemExit(f"{arch} is encoder-only; no decode path")
    params = model.init(torch.Generator().manual_seed(seed), dev)
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=prompt_len,
                     global_batch=batch)
    prompts, _ = ds.batch_at(0)
    prompts = torch.as_tensor(prompts, device=dev)
    max_len = prompt_len + gen

    with torch.inference_mode():
        t0 = time.perf_counter()
        if model.prefill is not None:
            logits, cache = model.prefill(params, {"tokens": prompts},
                                          max_len=max_len)
        else:
            # recurrent families: warm the state token by token
            cache = model.init_cache(batch, max_len, torch_device=dev)
            for t in range(prompt_len):
                logits, cache = model.decode_step(params, cache,
                                                  prompts[:, t])
        _sync(dev)
        t_prefill = time.perf_counter() - t0

        tok = torch.argmax(logits, -1)
        out = [tok]
        finite = torch.isfinite(logits).all()
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, cache = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)
            out.append(tok)
            finite &= torch.isfinite(logits).all()
        _sync(dev)
        t_decode = time.perf_counter() - t0
    gen_tokens = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()
    return {"generated": gen_tokens, "prefill_s": t_prefill,
            "decode_s": t_decode,
            "tok_per_s": batch * (gen - 1) / max(t_decode, 1e-9),
            "logits_finite": bool(finite)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b",
                    help="any registry arch but ising64 (hubert-xlarge, "
                         "an encoder, has no decode)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full-size", action="store_true",
                    help="the arch's full config (bfloat16); the default "
                         "is its reduced() config (float32)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the config to this many layers, widths "
                         "kept (default: its own depth)")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device to run on (default cuda; pass cpu "
                         "to serve on the host)")
    args = ap.parse_args(argv)
    out = serve(args.arch, args.batch, args.prompt_len, args.gen,
                reduced=not args.full_size, torch_device=args.torch_device,
                n_layers=args.layers)
    print(f"prefill {out['prefill_s']:.2f}s, decode {out['decode_s']:.2f}s "
          f"({out['tok_per_s']:.1f} tok/s), sample: "
          f"{np.asarray(out['generated'][0][:16])}")


if __name__ == "__main__":
    main()
