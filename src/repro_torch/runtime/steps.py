"""train_step / serve_step builders, in torch.

Port of `repro.runtime.steps`. The functions take explicit param,
optimizer and cache trees and run eagerly (no jit). Where the reference's
launcher donates the params and optimizer state to its jitted step, the
train step here updates them in place (see `make_train_step`).
"""

from __future__ import annotations

import math
from typing import Any

import torch

from ..core import pytree
from ..models import nn
from ..models.model import BaseLM
from ..optim import adamw, compress


def make_train_step(model: BaseLM, opt_cfg: adamw.AdamWConfig,
                    grad_comp: compress.GradCompressConfig | None = None):
    """Returns step(params, opt_state, batch) -> (params, opt_state, metrics).

    The loss and its gradients with respect to every param leaf come from
    `torch.autograd.grad` (the forward recomputes each layer in the
    backward, `cfg.remat`); then, with `grad_comp`, the gradients are
    compressed with error feedback (`opt_state['gc']` holds the
    residuals), and `adamw.update` applies them. The params, Adam's m and
    v and the residuals are updated IN PLACE: the returned trees hold the
    given tensors (a caller that needs the old values copies them first).
    The metrics are 0-d tensors on the device: 'loss', 'tokens',
    'grad_norm', 'lr', and 'wire_bits_per_value' when compressing.

    Under a mesh (`runtime.sharding.activate`, DTensor params and a batch
    laid out by `launch.dryrun.batch_shardings`), each gradient comes back
    in its param's placements (a sum left pending over a mesh dim the
    param is whole on is added there), the statistics that span a leaf
    cross the ranks (`compress`, `adamw.global_norm`), each rank updates
    its own shards, and the metrics are the same plain tensors on every
    rank.
    """

    def step(params, opt_state, batch):
        grads, metrics = loss_and_grads(model, params, batch)
        new_state = {}
        with torch.no_grad():
            if grad_comp is not None:
                grads, gc_state, gm = compress.compress(grad_comp, grads, opt_state["gc"])
                for r, new in zip(pytree.leaves(opt_state["gc"]), pytree.leaves(gc_state)):
                    r.copy_(new)
                del gc_state  # its copy is in place: free it before AdamW's temporaries
                new_state["gc"] = opt_state["gc"]
                metrics.update(gm)
            params, new_state["adam"], om = adamw.update(
                opt_cfg, grads, opt_state["adam"], params)
        metrics.update(om)
        return params, new_state, metrics

    return step


def loss_and_grads(model: BaseLM, params: Any, batch: dict) -> tuple[Any, dict]:
    """(gradients, metrics): the gradient of `model.loss` with respect to
    every param leaf (a tree like `params`, each DTensor gradient in its
    param's placements), and the loss's metrics as plain 0-d tensors
    (the same on every rank under a mesh)."""
    leaves, treedef = pytree.flatten_with_path(params)
    # fresh leaves that share the params' storage, so the caller's
    # tensors keep requires_grad off and take the update in place
    tracked = [p.detach().requires_grad_(True) for _, p in leaves]
    loss, aux = model.loss(pytree.unflatten(treedef, tracked), batch)
    grads = [_laid_out_like(g, p) for g, p in zip(torch.autograd.grad(loss, tracked), tracked)]
    return pytree.unflatten(treedef, grads), {k: nn.local_value(v.detach()) for k, v in aux.items()}


def _laid_out_like(g, p):
    """Gradient `g` in the placements of its param `p` (a DTensor whose
    gradient autograd left in another layout: a pending sum, a split that
    the param does not have); plain gradients as they are."""
    if not nn.is_sharded(p) or tuple(g.placements) == tuple(p.placements):
        return g
    from . import sharding

    return sharding.redistribute(g, tuple(p.placements))


def init_opt_state(params: Any, grad_comp: compress.GradCompressConfig | None = None) -> dict:
    out = {"adam": adamw.init(params)}
    if grad_comp is not None:
        out["gc"] = compress.init(params)
    return out


def make_prefill_step(model: BaseLM):
    """serve prefill: (params, batch, cache) -> (last-token logits, cache)."""

    def prefill(params, batch, cache):
        logits, cache = model.forward(params, batch, cache=cache)
        return logits[:, -1:], cache

    return prefill


def greedy(last: torch.Tensor) -> torch.Tensor:
    """(B, V) logits -> (B, 1) int32: each row's first maximum, as
    `jnp.argmax`. A DTensor row split over the vocab takes each shard's
    first maximum, gathers the candidates (a value and an index a shard,
    in vocab order) and keeps the first of the largest, so every rank of
    the row's group holds the same token; the result keeps the rows' batch
    split."""
    if not nn.is_sharded(last):
        return torch.argmax(last, dim=-1)[:, None].to(torch.int32)
    from torch.distributed.tensor import Replicate, Shard

    from . import sharding

    mesh = last.device_mesh
    split = [j for j, p in enumerate(last.placements) if p == Shard(1)]
    layout = sharding.NamedSharding(mesh, tuple(last.placements))
    start, _ = sharding.local_box(layout, tuple(last.shape))
    val, idx = torch.max(last.to_local(), dim=-1)
    shape = (last.shape[0], math.prod(mesh.size(j) for j in split))
    whole = tuple(Replicate() if j in split else p for j, p in enumerate(last.placements))

    def gathered(x):  # one candidate a vocab shard, in vocab order
        return sharding.redistribute(sharding.from_local(x[:, None].contiguous(), layout, shape),
                                     whole).to_local()

    vals, ids = gathered(val), gathered((idx + start[1]).to(torch.int32))
    tok = torch.gather(ids, 1, torch.argmax(vals, dim=-1, keepdim=True))
    return sharding.from_local(tok, sharding.NamedSharding(mesh, whole), (last.shape[0], 1))


def make_decode_step(model: BaseLM, sample: bool = False, temperature: float = 1.0):
    """serve decode: (params, tokens (B, 1), cache[, generator]) -> (next
    (B, 1) int32, cache). Greedy decoding takes the argmax (`greedy`: the
    first maximum, as `jnp.argmax`); sampling draws from softmax(logits /
    T) with the explicit `generator`, so its draws are torch's, not the
    reference's `jax.random` ones (under a mesh every rank draws from the
    whole row with its own generator, which must be seeded alike)."""

    def decode(params, tokens, cache, generator=None):
        logits, cache = model.forward(params, {"tokens": tokens}, cache=cache)
        last = logits[:, -1]
        if not sample:
            return greedy(last), cache
        whole = last.full_tensor() if nn.is_sharded(last) else last
        probs = torch.softmax(whole / temperature, dim=-1)
        nxt = torch.multinomial(probs, 1, generator=generator).to(torch.int32)
        return nn.shard(nxt, "batch", None), cache

    return decode
