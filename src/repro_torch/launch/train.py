"""Training driver with fault tolerance (the reference's ``launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
        --steps 200 --batch 8 --seq 512 --ckpt-dir ckpt \\
        [--full-size] [--torch-device cpu]

Random weights from seed 0 (nothing is downloaded), ``SyntheticLM`` data,
AdamW at lr 1e-3 with a fixed schedule horizon (10,000 steps, 5 warm-up
steps) so that a restarted run replays the lr sequence of an
uninterrupted one. A checkpoint in the reference's format every
``ckpt_every`` steps and at the last step; a run whose directory holds
one resumes from it, data iterator included. Each step runs under
``resilient_step`` (restore and replay on a device failure or a
non-finite loss) and is timed into a ``StragglerDetector``.

Reduced configs train in float32; ``--full-size`` keeps the config's
dtype (bfloat16 activations over float32 weights). Runs on
``torch_device`` (default ``cuda``; without CUDA it raises unless given
``cpu``), under ``mesh`` (default ``make_host_mesh(torch_device)``, the
card's (1, 1)): the mesh is ambient while the run lasts, the state is
placed by ``param_shardings`` and restored with those shardings. The
weights are drawn from seed 0 on a CPU generator, so every device starts
from the same weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile
import time

import torch

from ..checkpoint import Checkpointer
from ..configs import get_config
from ..data import DataState, SyntheticLM
from ..device import resolve_device
from ..distributed.fault_tolerance import StragglerDetector, resilient_step
from ..distributed.sharding import param_shardings, place_tree
from ..optim import AdamWConfig
from ..training.steps import init_train_state, make_train_step
from .mesh import activate_mesh, make_host_mesh

log = logging.getLogger("repro_torch.train")


def train(arch: str, steps: int, batch: int, seq: int, ckpt_dir: str,
          ckpt_every: int = 50, reduced: bool = True, mesh=None,
          inject_failure_at: int = -1,
          torch_device: str | torch.device = "cuda"):
    """Train ``arch`` to ``steps`` total steps (resuming from ``ckpt_dir``
    when it holds a checkpoint) under ``mesh`` on ``torch_device``; returns
    the loss of every step this call ran. ``inject_failure_at``: the step
    whose batch is replaced, once, by an all-masked one."""
    dev = resolve_device(torch_device)
    mesh = mesh if mesh is not None else make_host_mesh(dev)
    if mesh.torch_device != dev:
        raise ValueError(f"mesh is on {mesh.torch_device}, torch_device is "
                         f"{dev}")
    with activate_mesh(mesh):
        return _train(arch, steps, batch, seq, ckpt_dir, ckpt_every, reduced,
                      mesh, inject_failure_at, dev)


def _train(arch, steps, batch, seq, ckpt_dir, ckpt_every, reduced, mesh,
           inject_failure_at, dev):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype="float32") if reduced else cfg
    ds = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=seq,
                     global_batch=batch)
    ckpt = Checkpointer(ckpt_dir)
    detector = StragglerDetector()

    state = init_train_state(cfg, torch.Generator().manual_seed(0), dev)
    shardings = param_shardings(mesh, cfg, state)
    state = place_tree(state, shardings)
    # schedule horizon fixed (NOT tied to `steps`) so a restarted run
    # replays the exact same lr sequence as an uninterrupted one
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3), total_steps=10_000,
                              warmup_steps=5)

    data_state = DataState()
    restored, meta = ckpt.restore(state, shardings=shardings)
    if restored is not None:
        state = restored
        data_state.step = int(meta.get("data_step", meta["step"]))
        log.info("restored from step %d", meta["step"])

    def restore_fn():
        r, m = ckpt.restore(state, shardings=shardings)
        if r is None:
            return state
        data_state.step = int(m.get("data_step", m["step"]))
        return r

    def raw_step(st, batch_tensors):
        new_st, metrics = step_fn(st, batch_tensors)
        return new_st, {k: float(v) for k, v in metrics.items()}

    safe_step = resilient_step(raw_step, restore_fn)

    losses = []
    while int(state.step) < steps:
        tokens, labels = ds.batch_at(data_state.step)
        data_state.step += 1
        batch_tensors = {"tokens": torch.as_tensor(tokens, device=dev),
                         "labels": torch.as_tensor(labels, device=dev)}
        if inject_failure_at == int(state.step):
            inject_failure_at = -1  # only once
            batch_tensors["labels"] = torch.full_like(
                batch_tensors["labels"], -1)  # all-masked
        t0 = time.time()
        state, metrics = safe_step(state, batch_tensors)
        dt = time.time() - t0
        detector.observe(dt)
        losses.append(metrics["loss"])
        s = int(state.step)
        if s % 10 == 0 or s == steps:
            log.info("step %d loss %.4f (%.2fs)", s, metrics["loss"], dt)
        if s % ckpt_every == 0 or s == steps:
            ckpt.save(s, state, {"data_step": data_state.step,
                                 "arch": arch})
    return losses


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--full-size", action="store_true",
                    help="the full config in its dtype (bfloat16 "
                         "activations); a card, not the CPU")
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args(argv)
    losses = train(args.arch, args.steps, args.batch, args.seq,
                   args.ckpt_dir, reduced=not args.full_size,
                   torch_device=args.torch_device)
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")


if __name__ == "__main__":
    main()
