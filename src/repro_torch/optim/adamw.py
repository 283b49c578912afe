"""AdamW with global-norm clipping and a warmup-cosine schedule.

Port of ``repro/optim/adamw.py``.  The state is a named tuple of an int32
step count and two fp32 moment trees shaped like the parameters, with the
reference's field names, so a checkpoint of ``{"params", "opt"}`` written
by either package restores in the other.  The schedule, the bias
corrections and the clip scale are float32 tensors on the count's device,
as in the reference; nothing is computed in Python doubles.

Weight decay applies to every leaf with two or more dimensions, as the
reference decides it on the STACKED leaf (``adamw.py:85``): the per-layer
norm weights ``blocks.ln1/ln2/qn/kn`` (shape ``(n_layers, d)``) are
decayed and ``final_norm`` is not.  Keep the optimizer's leaves the
stacked tensors, as ``models.params`` builds them, to keep that rule.

On a device mesh the parameters are ``DTensor``s: the moments take their
placements (``init``), the gradients must come with them too
(``train.step``), and ``global_norm`` is the whole tree's norm on every
rank, so every rank clips by the same factor.

``update`` writes the new moments into the state's tensors and
``apply_updates`` adds the updates into the parameters, in place and under
``torch.no_grad()``: the counterpart of the reference's donated
``(params, opt_state)``.  ``abstract_state`` gives the state as ``meta``
tensors for the dry-run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch import tree as tree_util
from repro_torch.distributed.shardings import full

F32 = torch.float32


class AdamWState(NamedTuple):
    count: torch.Tensor    # int32 scalar
    m: dict                # first moment, like params
    v: dict                # second moment, like params


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a float32 scalar tensor on ``like``'s device."""
    return torch.full((), x, dtype=F32, device=like.device)


def warmup_cosine(peak_lr: float, *, warmup: int = 100,
                  total: int = 10_000, floor: float = 0.1) -> Callable:
    """lr(step): linear warmup to ``peak_lr`` then cosine to ``floor*peak``,
    a float32 tensor on the step's device."""

    def lr(step):
        step = torch.as_tensor(step).to(F32)
        warm = peak_lr * step / _f32(max(warmup, 1), step)
        frac = torch.clamp((step - warmup) / _f32(max(total - warmup, 1), step),
                           0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (
            1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf, in fp32, the leaves'
    sums added in the reference's (sorted key) order.  Over DTensor leaves
    each rank adds its blocks' partial sums and one reduction completes
    them: the result is a plain tensor, the same on every rank."""
    return full(torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                               for x in tree_util.leaves(tree))))


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params: dict) -> AdamWState:
        """Zero moments in fp32, each placed as its parameter."""
        def zeros():
            return tree_util.map(lambda p: torch.zeros_like(
                p, dtype=F32, memory_format=torch.contiguous_format), params)
        dev = next(tree_util.leaves(params)).device
        return AdamWState(count=torch.zeros((), dtype=torch.int32, device=dev),
                          m=zeros(), v=zeros())

    def _lr(self, count):
        if callable(self.learning_rate):
            return self.learning_rate(count)
        return _f32(self.learning_rate, count)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamWState, params: dict):
        """Returns (updates, new_state, metrics).  ``params + updates`` is
        the new parameter value (updates include the weight-decay term).
        The new state holds ``state``'s moment tensors, updated in place."""
        count = state.count + 1
        gnorm = global_norm(grads)
        if self.clip_norm is not None:
            scale = torch.clamp(
                _f32(self.clip_norm, gnorm) / torch.clamp(gnorm, min=1e-9),
                max=1.0)
            grads = tree_util.map(lambda g: g * scale, grads)

        b1, b2 = self.b1, self.b2
        tree_util.map(lambda mu, g: mu.copy_(b1 * mu + (1 - b1) * g.to(F32)),
                      state.m, grads)
        tree_util.map(lambda nu, g: nu.copy_(
            b2 * nu + (1 - b2) * torch.square(g.to(F32))), state.v, grads)
        c = count.to(F32)
        one = _f32(1.0, c)
        mhat_scale = one / (1 - _f32(b1, c) ** c)
        vhat_scale = one / (1 - _f32(b2, c) ** c)
        lr = self._lr(count)

        def upd(p, mu, nu):
            step = mu * mhat_scale / (torch.sqrt(nu * vhat_scale) + self.eps)
            # decay only matrices (norm vectors/bias-like 1-D params exempt)
            wd = self.weight_decay if p.ndim >= 2 else 0.0
            return (-(lr * (step + wd * p.to(F32)))).to(p.dtype)

        updates = tree_util.map(upd, params, state.m, state.v)
        return updates, AdamWState(count=count, m=state.m, v=state.v), {
            "gnorm": gnorm, "lr": lr}


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """``params + updates``, added into ``params`` in place; returns it."""
    tree_util.map(lambda p, u: p.add_(u.to(p.dtype)), params, updates)
    return params


def abstract_state(params_abstract: dict) -> AdamWState:
    """The state as ``meta`` tensors, each moment fp32 at its parameter's
    (local) shape (``models.params.abstract_params``): no allocation."""

    def moments():
        return tree_util.map(lambda p: torch.empty(p.shape, dtype=F32,
                                                   device="meta"),
                             params_abstract)

    return AdamWState(count=torch.empty((), dtype=torch.int32, device="meta"),
                      m=moments(), v=moments())
