"""Step builders (the port of ``repro.launch.steps``): the training step
with gradient accumulation over micro-batches, and the prefill and decode
steps the serving launcher runs.

Every step takes any ``ShardCtx``. On a mesh the prefill and decode steps
run the models' sharded paths (each rank its batch rows and its slice of
the cache), and the training step trains over the mesh: the parameters
held as the context's stored specs say (``ShardCtx.with_stored``,
``launch.shardings.param_specs``), the gradients reduced to
``grad_specs``'s layout (ZeRO-2) and the moments held in it (ZeRO-1).
"""
from __future__ import annotations

import torch

from ..models import ModelConfig, ShardCtx, decode_step, loss_fn, prefill
from ..models import layers
from ..models.transformer import reduce_grads, stored_specs
from ..optim import AdamWConfig, adamw_update
from ..tree import leaves as tree_leaves, tree_map


def _rebuild(tree, values):
    """``values``, one for each of ``tree``'s leaves in their order, in
    ``tree``'s structure."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, sh: ShardCtx,
                    micro_batches: int = 1, grad_specs=None):
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)``: the loss's gradients (in each parameter's
    dtype at one micro-batch; summed in float32 over ``micro_batches``
    and scaled by their inverse), then one AdamW step, parameters and
    moments updated in place. Forward and backward sum bfloat16 products
    in float32 (``layers.fp32_sums``). metrics: loss (the micro-batches'
    mean), the last micro-batch's ce and aux, lr and grad_norm.

    On a mesh (``ShardCtx.from_mesh``) ``params`` are this rank's blocks
    under ``sh``'s stored specs (without them, the whole weights as
    ``models.shard_params`` gives them), and ``batch`` is the global
    batch: each micro-batch is split over the batch axes, as the
    reference's ``pjit`` splits it. Each micro-batch's gradients are
    reduced to the global loss's (``models.reduce_grads``) in
    ``grad_specs``'s layout (the ZeRO-1 specs: reduce-scattered over
    ``"data"``, ZeRO-2; None: the parameters' layout) and accumulated at
    that size; the moments are held in that layout too, and AdamW updates
    the parameters from them (``optim.adamw_update``).
    ``train_step.compute_grads(params, batch)`` is the first half alone,
    (loss, metrics, gradients in that layout), which each step calls
    through that attribute."""
    mesh = sh.mesh is not None

    def rows(batch):
        if not mesh:
            return batch
        r = sh.batch_rows(next(iter(batch.values())).shape[0])
        return {k: v[r] for k, v in batch.items()}

    def grads_of(params, leaves, batch):
        loss, metrics = loss_fn(cfg, params, rows(batch), sh)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        if mesh:
            grads = tree_leaves(reduce_grads(cfg, _rebuild(params, grads),
                                             sh, grad_specs))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    @layers.fp32_accumulation
    def compute_grads(params, batch):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        if micro_batches == 1:
            loss, metrics, grads = grads_of(params, leaves, batch)
            return loss, metrics, _rebuild(params, grads)
        n = next(iter(batch.values())).shape[0] // micro_batches
        acc = None
        loss_sum = None
        for i in range(micro_batches):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            loss, metrics, grads = grads_of(params, leaves, mb)
            if acc is None:
                acc = [torch.zeros(g.shape, dtype=torch.float32,
                                   device=g.device) for g in grads]
            for a, g in zip(acc, grads):
                a.add_(g.float())
            del grads
            loss_sum = loss if loss_sum is None else loss_sum + loss
        inv = 1.0 / micro_batches
        for a in acc:
            a.mul_(inv)
        return loss_sum * inv, metrics, _rebuild(params, acc)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = train_step.compute_grads(params, batch)
        if mesh:
            pspecs = stored_specs(cfg, sh, params)
            params, opt_state, om = adamw_update(
                opt_cfg, params, grads, opt_state, sh, pspecs,
                pspecs if grad_specs is None else grad_specs)
        else:
            params, opt_state, om = adamw_update(opt_cfg, params, grads,
                                                 opt_state)
        return params, opt_state, {"loss": loss, **metrics, **om}

    train_step.compute_grads = compute_grads
    return train_step


def make_prefill_step(cfg: ModelConfig, sh: ShardCtx, smax: int):
    def prefill_step(params, inputs):
        return prefill(cfg, params, inputs, sh, smax)
    return prefill_step


def make_serve_step(cfg: ModelConfig, sh: ShardCtx):
    def serve_step(params, tokens, cache, pos):
        return decode_step(cfg, params, tokens, cache, pos, sh)
    return serve_step
