"""Step builders (the port of ``repro.launch.steps``): the training step
with gradient accumulation over micro-batches, and the prefill and decode
steps the serving launcher runs.

The prefill and decode steps take any ``ShardCtx``: on a mesh they run
the models' sharded paths (each rank its batch rows and its slice of the
cache). The training step runs on one device: training over a mesh (the
reference's ZeRO ``grad_specs``, the weights' specs, compressed
reductions) is ROADMAP §1's next item, and a context with a mesh
raises.
"""
from __future__ import annotations

import torch

from ..models import ModelConfig, ShardCtx, decode_step, loss_fn, prefill
from ..models import layers
from ..optim import AdamWConfig, adamw_update
from ..tree import leaves as tree_leaves, tree_map


def _rebuild(tree, values):
    """``values``, one for each of ``tree``'s leaves in their order, in
    ``tree``'s structure."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, sh: ShardCtx,
                    micro_batches: int = 1):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: the loss's gradients (in each parameter's
    dtype at one micro-batch; summed in float32 over ``micro_batches``
    and scaled by their inverse), then one AdamW step, parameters and
    moments updated in place. Forward and backward sum bfloat16 products
    in float32 (``layers.fp32_sums``). metrics: loss (the micro-batches'
    mean), the last micro-batch's ce and aux, lr and grad_norm."""
    if sh.mesh is not None:
        raise NotImplementedError(
            "make_train_step on a mesh: training over a mesh (weight "
            "specs, ZeRO-1/2, compressed reductions) is the next item of "
            "ROADMAP §1; models.loss_fn and models.reduce_grads give a "
            "sharded gradient")

    def grads_of(params, leaves, batch):
        loss, metrics = loss_fn(cfg, params, batch, sh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def compute_grads(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if micro_batches == 1:
            loss, metrics, grads = grads_of(params, leaves, batch)
            return loss, metrics, _rebuild(params, grads)
        n = next(iter(batch.values())).shape[0] // micro_batches
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_sum = None
        for i in range(micro_batches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, leaves, mb)
            for a, g in zip(acc, grads):
                a.add_(g.float())
            del grads
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / micro_batches
        for a in acc:
            a.mul_(inv)
        return loss_sum * inv, metrics, _rebuild(params, acc)

    def train_step(params, opt_state, batch):
        with layers.fp32_sums():
            loss, metrics, grads = compute_grads(params, batch)
        params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                             opt_state)
        return params, opt_state, {"loss": loss, **metrics, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, sh: ShardCtx, smax: int):
    def prefill_step(params, inputs):
        return prefill(cfg, params, inputs, sh, smax)
    return prefill_step


def make_serve_step(cfg: ModelConfig, sh: ShardCtx):
    def serve_step(params, tokens, cache, pos):
        return decode_step(cfg, params, tokens, cache, pos, sh)
    return serve_step
