"""Train / eval step builders (the reference's ``training.steps``).

A step is functional: it returns a new ``TrainState`` and never writes
into the state it was given. ``distributed.resilient_step`` retries a
failed step with the state it holds, and its NaN guard rejects a step
after the fact; a step that updated in place would already have
corrupted the state the retry reuses.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig
from ..device import resolve_device
from ..models import build
from ..optim import (AdamWConfig, adamw, apply_updates, clip_by_global_norm,
                     init_opt_state, linear_warmup_cosine)
from ..pytree import leaves, tree_map, unflatten


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: Any               # {"m": tree, "v": tree, "step": 0-d int32}
    step: torch.Tensor     # 0-d int32


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     torch_device: str | torch.device) -> TrainState:
    """Parameters drawn from the CPU ``generator`` and placed on
    ``torch_device``, zero moments, step 0."""
    params = build(cfg).init(generator, torch_device)
    return TrainState(params=params, opt=init_opt_state(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=resolve_device(torch_device)))


def _laid_out_as(grad, param):
    """``grad`` in its parameter's layout. On a mesh of processes a
    gradient arrives partial over the axes its parameter is replicated on
    (each data rank's batch adds a share); redistributing it is the
    data-parallel all-reduce. Plain tensors pass through."""
    want = getattr(param, "placements", None)
    if want is None or tuple(grad.placements) == tuple(want):
        return grad
    return grad.redistribute(param.device_mesh, want)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    total_steps: int = 10_000, warmup_steps: int = 200,
                    max_grad_norm: float = 1.0) -> Callable:
    """(state, batch) -> (state, metrics): the gradient of ``model.loss``
    over every parameter leaf, clipped to ``max_grad_norm``, the schedule
    at ``step + 1`` (so the first step has a nonzero lr), AdamW. A leaf
    the loss does not reach (the encoder's token embedding) gets a zero
    gradient, as ``jax.grad`` gives it. Metrics are 0-d tensors: loss,
    grad_norm (before clipping), lr_scale."""
    opt_cfg = opt_cfg or AdamWConfig()
    model = build(cfg)

    def step_fn(state: TrainState, batch) -> tuple[TrainState, dict]:
        with torch.enable_grad():
            params = tree_map(lambda p: p.detach().requires_grad_(),
                              state.params)
            loss = model.loss(params, batch)
            grads = unflatten(params, [_laid_out_as(g, p) for g, p in zip(
                torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                    materialize_grads=True),
                leaves(params))])
        del params
        with torch.no_grad():
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            lr_scale = linear_warmup_cosine(state.step + 1, warmup_steps,
                                            total_steps)
            updates, opt = adamw(grads, state.opt, state.params, opt_cfg,
                                 lr_scale)
            del grads
            params = apply_updates(state.params, updates)
        new_state = TrainState(params=params, opt=opt, step=state.step + 1)
        metrics = {"loss": loss.detach(), "grad_norm": gnorm,
                   "lr_scale": lr_scale}
        return new_state, metrics

    return step_fn


def make_eval_step(cfg: ModelConfig) -> Callable:
    """(params, batch) -> the loss, without grad."""
    model = build(cfg)

    def eval_fn(params, batch):
        with torch.no_grad():
            return model.loss(params, batch)

    return eval_fn
