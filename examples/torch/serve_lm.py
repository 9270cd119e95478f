"""Serve a small model with batched requests on the port: prefill +
token-by-token decode through the KV-cache path (the decode step the
dry-run traces at 32k/512k scale). The counterpart of
``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch/serve_lm.py --arch qwen3-0.6b
    PYTHONPATH=src python examples/torch/serve_lm.py --arch rwkv6-3b   # state decode
    PYTHONPATH=src python examples/torch/serve_lm.py --torch-device cpu
"""
import argparse

from repro_torch.device import resolve_device
from repro_torch.launch.serve_lm import serve


def run(arch: str, batch: int, prompt_len: int, gen: int,
        torch_device="cuda") -> dict:
    """``arch``'s reduced config served to ``batch`` prompts of
    ``prompt_len`` tokens, ``gen`` tokens each; returns ``serve``'s
    record."""
    out = serve(arch, batch, prompt_len, gen, reduced=True,
                torch_device=torch_device)
    print(f"[{arch}] prefill {out['prefill_s']:.2f}s | "
          f"decode {out['decode_s']:.2f}s ({out['tok_per_s']:.1f} tok/s)")
    print("sample generation:", out["generated"][0][:16].tolist())
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.torch_device)
    return run(args.arch, args.batch, args.prompt_len, args.gen,
               args.torch_device)


if __name__ == "__main__":
    main()
