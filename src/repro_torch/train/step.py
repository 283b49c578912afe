"""Train step: loss + gradient (+ microbatch accumulation) + AdamW update.

Port of ``repro/train/step.py``.  Activation memory is bounded by
``cfg.remat`` (the model's rematerialized blocks) and by gradient
accumulation: ``accum > 1`` splits the global batch's leading axis into
``accum`` microbatches, whose gradients are summed in ``accum_dtype``.

``grad_compression="int8"`` applies int8 quantization with error feedback
to the gradients before the optimizer (on a mesh the quantized tensor is
what crosses the data-parallel axis, cutting the all-reduce's bytes 4x;
the error-feedback buffer keeps the optimizer unbiased over time).

The step runs eagerly (the reference jits it; ``jit_train_step`` has no
counterpart).  Gradients come from ``torch.autograd.grad`` on detached
aliases of the parameters, so the caller's tensors need not require a
gradient; the optimizer then updates those tensors in place, the
counterpart of the reference's donated ``(params, opt_state)``.

``rules`` (keyword; the single-device rules by default) trains on a real
device mesh: the parameters are DTensors, ``model.loss_fn`` runs under the
rules, and each gradient is redistributed to its parameter's placements
(a reduce-scatter or all-reduce of the partial sums over the batch's
shards) before the optimizer reads it.  The microbatches are the
reference's reshape of the *global* batch into (accum, B / accum): with
B = 4, accum = 2 and data = 2, microbatch 0 is rows 0 and 1, both on data
rank 0's shard of the batch, so the batch is gathered whole and each
microbatch placed on "batch" again (each microbatch's loss is a mean over
its own unmasked labels: a rank's own rows would be another function).
The accumulation buffers and the int8 error buffers are placed as their
parameters, and the int8 scale is the largest |x| over the whole leaf
(``compression.quantize``).
"""

from __future__ import annotations

import torch

from torch.distributed.tensor import DTensor

from repro_torch import tree as tree_util
from repro_torch.distributed import compression
from repro_torch.distributed.shardings import MeshRules, full
from repro_torch.models import model
from repro_torch.models.config import ArchConfig
from repro_torch.optim.adamw import AdamW, apply_updates

F32 = torch.float32
#: the logical axes of a training batch's entries, by rank: tokens and
#: labels (B, S), a vlm's patches and an audio batch's frames (B, S, d)
BATCH_AXES = {2: ("batch", "seq"), 3: ("batch", "seq", "d_model")}


def batch_shardings(rules: MeshRules, batch: dict) -> dict:
    """``{name: NamedSharding}`` for each entry of an example ``batch``
    (arrays or tensors) under ``rules``: every entry split on "batch"
    (``BATCH_AXES``); empty without a real mesh."""
    if not rules.is_real:
        return {}
    return {k: rules.sharding(v.shape, BATCH_AXES[len(v.shape)])
            for k, v in batch.items()}


def microbatches(batch: dict, accum: int, rules: MeshRules = model.SINGLE):
    """The reference's split of the global ``batch``'s leading axis into
    ``accum`` microbatches of B / accum rows, in order.  On a real mesh
    the batch's entries (DTensors split on "batch", or whole tensors) are
    taken whole and each microbatch is placed per ``batch_shardings``
    again, so that microbatch i holds the global rows i * B / accum on,
    whichever ranks held them."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"batch {b} does not split into {accum} "
                         f"microbatches")
    whole = {k: full(v) for k, v in batch.items()}
    mb = [{k: v[i * (b // accum):(i + 1) * (b // accum)]
           for k, v in whole.items()} for i in range(accum)]
    if not rules.is_real:
        return mb
    sh = batch_shardings(rules, mb[0])
    return [{k: sh[k].place(v) for k, v in m.items()} for m in mb]


def _placed_as(g, p):
    """The gradient ``g`` with its parameter's placements (a DTensor's
    gradient may come out partial or otherwise placed)."""
    if isinstance(p, DTensor) and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _value_and_grad(cfg: ArchConfig, params: dict, batch: dict, *,
                    rules: MeshRules = model.SINGLE):
    """(loss, metrics, grads) of ``model.loss_fn`` at ``params``.  A leaf
    the loss does not read (a stack of zero layers, as deepseek-v2's MoE
    blocks at ``n_layers = first_k_dense``) gets a zero gradient, as
    ``jax.grad`` gives it.  On a real mesh the gradients take the
    parameters' placements, and the loss and metrics are plain tensors,
    the same on every rank."""
    live = tree_util.map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, metrics = model.loss_fn(cfg, live, batch, rules=rules)
        grads = torch.autograd.grad(loss, list(tree_util.leaves(live)),
                                    allow_unused=True, materialize_grads=True)
    it = iter(grads)
    grads = tree_util.map(lambda p: _placed_as(next(it), p), live)
    return (full(loss.detach()),
            {k: full(v.detach()) for k, v in metrics.items()}, grads)


def make_train_step(cfg: ArchConfig, opt: AdamW, *,
                    rules: MeshRules = model.SINGLE, accum: int = 1,
                    grad_compression: str = "none", accum_dtype=F32):
    """Returns train_step(params, opt_state, batch[, err]) -> (params,
    opt_state, metrics[, err]); ``params`` and the state's moments are
    updated in place and returned.

    ``accum_dtype=torch.bfloat16`` halves the accumulation buffer: each
    microbatch gradient is produced in fp32 and rounded to bf16 before it
    is added, as in the reference (bounded by accum * eps_bf16 relative
    error)."""
    if grad_compression not in ("none", "int8"):
        raise ValueError(f"grad_compression {grad_compression!r}: expected "
                         f"'none' or 'int8'")

    def compute_grads(params, batch):
        if accum == 1:
            return _value_and_grad(cfg, params, batch, rules=rules)
        mb = microbatches(batch, accum, rules)
        gsum = tree_util.map(lambda p: torch.zeros_like(p, dtype=accum_dtype),
                             params)
        lsum = torch.zeros((), dtype=F32, device=batch["tokens"].device)
        mets = []
        for micro in mb:
            l, met, g = _value_and_grad(cfg, params, micro, rules=rules)
            gsum = tree_util.map(lambda s, x: s + x.to(accum_dtype), gsum, g)
            lsum = lsum + l
            mets.append(met)
        grads = tree_util.map(lambda g: g.to(F32) / accum, gsum)
        metrics = {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}
        return lsum / accum, metrics, grads

    if grad_compression == "int8":

        def train_step(params, opt_state, batch, err):
            loss, metrics, grads = compute_grads(params, batch)
            grads, err = compression.compress_tree(grads, err)
            updates, opt_state, om = opt.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            return params, opt_state, dict(metrics, loss=loss, **om), err

        return train_step

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, batch)
        updates, opt_state, om = opt.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step
