"""The tensor-parallel axis (the port of ``parallel/sweep.py::make_dp_tp_mesh``
and ``param_shardings``): W = dp x tp processes, one GPU each, in which the
tp ranks of a group split every Linear and Conv2d by output columns.

Layout (``make_groups``): rank r sits at dp index ``r // tp`` and tp index
``r % tp``, the row-major reshape of the JAX (dp, tp) mesh; there is one
``dist.new_group`` per tp group and one per dp group. Images (or a training
batch's rows) are split over the dp index; the ranks of one tp group run the
same ones.

Sharding (``shard_columns_``): each Linear and Conv2d (float or w8:
``ops/quant.py``) whose output dimension divides by tp and is at least 2 tp
(JAX's rule) keeps only its rank's block of output channels: the weight's
rows, the bias and the w8 scale sliced together. Its forward computes the
block and gathers the blocks along the channel axis
(``multihost.all_gather_columns``), so every activation between layers is
whole on every rank: attention, the norms and the controls run unchanged,
at the shapes of one process, on every rank of the group. Embedding tables
stay whole (the JAX package places them split but computes the same
function). For training the gather and the layer's input form Megatron's
pair of autograd functions: the gather's backward keeps this rank's block
of the gradient, and the input's identity all-reduces the input gradient
(summed in f32) over the tp group. Every gradient that reaches a replicated
parameter or an input then passes through that all-reduce, so the tp ranks
hold the same replicated values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from pnpinversion_tpu_torch.ops.quant import QConv2d, QLinear
from pnpinversion_tpu_torch.parallel import multihost

COLUMN_LAYERS = (nn.Linear, nn.Conv2d, QLinear, QConv2d)


@dataclasses.dataclass(frozen=True)
class Layout:
    """This process's place in the (dp, tp) grid and its two groups (None
    where the run has one process)."""

    dp: int
    tp: int
    dp_index: int
    tp_index: int
    dp_group: Any = None
    tp_group: Any = None


def grid_position(rank: int, world: int, tp: int) -> Tuple[int, int]:
    """(dp index, tp index) of ``rank``: the row-major (world / tp, tp) grid."""
    if tp < 1 or world % tp:
        raise ValueError(f"--tp {tp} does not divide the {world} processes")
    return rank // tp, rank % tp


def make_groups(tp: int) -> Layout:
    """The groups of a (W / tp, tp) grid over the default group (a collective:
    every rank calls it, with the same tp). With tp = 1 the dp group is the
    default group (None for one process) and there is no tp group."""
    world, rank = multihost.world(), multihost.rank()
    dp_index, tp_index = grid_position(rank, world, tp)
    dp = world // tp
    if tp == 1:
        return Layout(dp, 1, dp_index, 0, dist.group.WORLD if dist.is_initialized() else None)
    tp_groups = [dist.new_group([d * tp + t for t in range(tp)]) for d in range(dp)]
    dp_groups = [dist.new_group([d * tp + t for d in range(dp)]) for t in range(tp)]
    return Layout(dp, tp, dp_index, tp_index, dp_groups[tp_index], tp_groups[dp_index])


def splits(n: int, tp: int) -> bool:
    """JAX's rule (``param_shardings``): n divides by tp and is at least 2 tp."""
    return n % tp == 0 and n >= 2 * tp


def _column_axis(layer: nn.Module) -> int:
    """The output's channel axis: last for a Linear's (..., C), 1 for a
    conv's (B, C, H, W)."""
    return 1 if isinstance(layer, (nn.Conv2d, QConv2d)) else -1


def column_block_(layer: nn.Module, rank: int, tp: int) -> nn.Module:
    """Keeps rank's block of the layer's output channels (the weight's rows,
    the bias and a w8 scale), in place; returns the layer."""
    n = layer.weight.shape[0] // tp
    for name in ("weight", "bias", "weight_scale"):
        t = getattr(layer, name, None)
        if t is None:
            continue
        piece = t.detach().narrow(0, rank * n, n).clone()
        if name in layer._parameters:
            layer._parameters[name] = nn.Parameter(piece, requires_grad=t.requires_grad)
        else:
            layer._buffers[name] = piece
    for attr in ("out_features", "out_channels"):
        if hasattr(layer, attr):
            setattr(layer, attr, n)
    return layer


class _EnterColumns(torch.autograd.Function):
    """The identity on a column-parallel layer's input; its backward sums
    the input gradient over the tp group (in f32)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        total = g.float().contiguous()
        dist.all_reduce(total, group=ctx.group)
        return total.to(g.dtype), None


class _GatherColumns(torch.autograd.Function):
    """The blocks of a layer's output gathered along ``axis``; the backward
    keeps this rank's block of the gradient."""

    @staticmethod
    def forward(ctx, y, axis, group):
        ctx.axis, ctx.group, ctx.n = axis, group, y.shape[axis]
        return multihost.all_gather_columns(y, axis, group)

    @staticmethod
    def backward(ctx, g):
        me = dist.get_rank(ctx.group)
        return g.narrow(ctx.axis, me * ctx.n, ctx.n).contiguous(), None, None


def _enter_hook(layer, args):
    x = args[0]
    if torch.is_grad_enabled() and x.requires_grad:
        return (_EnterColumns.apply(x, layer.tp_group),) + tuple(args[1:])
    return None


def _gather_hook(layer, args, y):
    return _GatherColumns.apply(y, _column_axis(layer), layer.tp_group)


def column_plan(module: nn.Module, tp: int) -> Dict[str, nn.Module]:
    """The layers of ``module`` that a tp group splits, by qualified name."""
    return {name: m for name, m in module.named_modules()
            if isinstance(m, COLUMN_LAYERS) and not hasattr(m, "tp_group")
            and splits(m.weight.shape[0], tp)}


def shard_columns_(module: nn.Module, group) -> int:
    """Splits ``module``'s layers by output columns over ``group`` (this rank
    keeps its block; the forward gathers the blocks), in place. Returns the
    number of layers split. cuDNN turns deterministic in this process: the
    ranks' replicated work (a whole layer's weight gradient, StyleDiffusion's
    networks) must give the same bits on every rank, or their early stops
    could part and stall the group's collectives."""
    torch.backends.cudnn.deterministic = True
    tp, rank = dist.get_world_size(group), dist.get_rank(group)
    plan = column_plan(module, tp)
    for layer in plan.values():
        column_block_(layer, rank, tp)
        layer.tp_group = group
        layer.register_forward_pre_hook(_enter_hook)
        layer.register_forward_hook(_gather_hook)
    return len(plan)


def tp_axes(module: nn.Module) -> Dict[str, Optional[int]]:
    """Each parameter's axis split over the tp group (0: the output rows of
    a split layer's weight and bias), None where it is whole, by name."""
    split = {name for name, m in module.named_modules() if hasattr(m, "tp_group")}
    return {name: 0 if name.rpartition(".")[0] in split else None
            for name, _ in module.named_parameters()}


def shard_pipeline_(pipe, group) -> None:
    """Splits a pipeline's UNet, VAE and text tower over ``group`` once (the
    JAX sweep's ``param_shardings`` of the whole pipeline); a second call
    with the same group does nothing, with another it raises."""
    if pipe.tp_group is group:
        return
    if pipe.tp_group is not None:
        raise ValueError("the pipeline is split over another tp group")
    for m in (pipe.unet, pipe.vae, pipe.text_encoder):
        shard_columns_(m, group)
    pipe.tp_group = group
