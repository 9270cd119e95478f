"""Every LM family's reduced outputs off a mesh of processes, to hold one
tree's plain path bitwise against another's.

    PYTHONPATH=src python scripts/torch/plain_outputs.py --save new.pt
    PYTHONPATH=<other tree>/src python scripts/torch/plain_outputs.py \\
        --save old.pt
    python scripts/torch/plain_outputs.py --compare old.pt new.pt

For each family's ``reduced()`` config (zamba2 at 5 layers), with no mesh
and under a virtual (2, 2) mesh (every rank in this process, on the CPU):
the loss and every gradient leaf of a (2, 24) batch, prefill's logits and
KV cache, and three decode steps' logits. ``--compare`` prints the keys
whose bytes differ (none when the paths are bitwise the same) and exits 1
if any does.
"""
from __future__ import annotations

import argparse
import contextlib
import sys

import torch


def outputs() -> dict:
    """{arch/mesh/what: tensor} of every family."""
    from repro_torch.configs import REGISTRY, get_config
    from repro_torch.launch.mesh import activate_mesh, virtual_mesh
    from repro_torch.models import build
    from repro_torch.pytree import leaves, unflatten
    out = {}
    for arch, c in sorted(REGISTRY.items()):
        if c.family == "ising":
            continue
        cfg = get_config(arch)
        cfg = (cfg.reduced(n_layers=5) if cfg.family == "hybrid"
               else cfg.reduced())
        model = build(cfg)
        for name, mesh in (("none", None), ("virtual-2x2", virtual_mesh(
                (2, 2), ("data", "model"), "cpu"))):
            key = f"{arch}/{name}"
            params = model.init(torch.Generator().manual_seed(0), "cpu")
            g = torch.Generator().manual_seed(1)
            batch = {k: torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
                     for k in ("tokens", "labels")}
            if cfg.family == "encoder":
                batch["embeds"] = torch.randn((2, 24, cfg.d_model),
                                              generator=g)
            if cfg.family == "vlm":
                batch["vision_embeds"] = torch.randn(
                    (2, cfg.n_vision_tokens, cfg.d_model), generator=g)
            with (activate_mesh(mesh) if mesh is not None
                  else contextlib.nullcontext()):
                leaf = [t.clone().requires_grad_() for t in leaves(params)]
                loss = model.loss(unflatten(params, leaf), batch)
                out[f"{key}/loss"] = loss.detach()
                for i, gr in enumerate(torch.autograd.grad(
                        loss, leaf, allow_unused=True,
                        materialize_grads=True)):
                    out[f"{key}/grad{i}"] = gr
                with torch.no_grad():
                    if cfg.has_decode and model.prefill is not None:
                        logits, cache = model.prefill(
                            params, {"tokens": batch["tokens"]})
                        out[f"{key}/prefill"] = logits
                        out.update({f"{key}/cache_{k}": cache[k]
                                    for k in ("k", "v") if k in cache})
                    if cfg.has_decode:
                        cache = model.init_cache(2, 16, torch_device="cpu")
                        for t in range(3):
                            logits, cache = model.decode_step(
                                params, cache, batch["tokens"][:, t])
                            out[f"{key}/decode{t}"] = logits
    return out


def differing(a: dict, b: dict) -> list:
    """The keys of ``a`` and ``b`` whose tensors differ in a byte (or that
    only one holds)."""
    def raw(t):
        return t.contiguous().reshape(-1).view(torch.uint8)
    return sorted(set(a) ^ set(b)) + [
        k for k in sorted(set(a) & set(b))
        if a[k].shape != b[k].shape or a[k].dtype != b[k].dtype
        or not torch.equal(raw(a[k]), raw(b[k]))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--save", help="write this tree's outputs here")
    ap.add_argument("--compare", nargs=2, metavar=("OLD", "NEW"))
    args = ap.parse_args(argv)
    if args.save:
        torch.set_num_threads(1)
        out = outputs()
        torch.save(out, args.save)
        print(f"{len(out)} tensors -> {args.save}")
    if args.compare:
        a, b = (torch.load(p) for p in args.compare)
        bad = differing(a, b)
        print(f"{len(a)} / {len(b)} tensors; {len(bad)} differ"
              + "".join(f"\n  {k}" for k in bad[:40]))
        return 1 if bad else 0
    return 0


if __name__ == "__main__":
    sys.exit(main())
