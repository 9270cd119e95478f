"""End-to-end training on the port: train a ~100M-parameter qwen3-family
model for a few hundred steps on the synthetic pipeline, with
checkpointing + fault tolerance (reduced further via --small for
CI-speed runs). The counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 300
    PYTHONPATH=src python examples/torch/train_lm.py --small --steps 40
    PYTHONPATH=src python examples/torch/train_lm.py --small --steps 40 --torch-device cpu

A run resumes from ``--ckpt-dir`` when it holds a checkpoint.
"""
import argparse
import dataclasses
import logging
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import train as t
from repro_torch.launch.train import train


def run(small: bool, steps: int, ckpt_dir: str, torch_device="cuda") -> list:
    """Train to ``steps`` steps: reduced qwen3-0.6b at batch 8 x 128 with
    ``small``, else the ~100M config at 8 x 512; returns the losses."""
    if small:
        losses = train("qwen3-0.6b", steps=steps, batch=8, seq=128,
                       ckpt_dir=ckpt_dir, reduced=True,
                       torch_device=torch_device)
    else:
        # ~100M-class: full qwen3-0.6b backbone with a trimmed vocab and 12
        # layers in float32; the full config runs through launch/train.py
        cfg = dataclasses.replace(get_config("qwen3-0.6b"),
                                  vocab_size=8192, dtype="float32",
                                  n_layers=12)
        orig = t.get_config
        t.get_config = lambda a: cfg          # inject the 100M config
        try:
            losses = train("qwen3-0.6b", steps=steps, batch=8, seq=512,
                           ckpt_dir=ckpt_dir, reduced=False,
                           torch_device=torch_device)
        finally:
            t.get_config = orig
    print(f"loss: first={losses[0]:.3f} last={losses[-1]:.3f} "
          f"({len(losses)} steps)")
    return losses


def main(argv=None) -> list:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--small", action="store_true",
                    help="tiny config (seconds instead of minutes)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.torch_device)
    return run(args.small, args.steps, args.ckpt_dir, args.torch_device)


if __name__ == "__main__":
    main()
