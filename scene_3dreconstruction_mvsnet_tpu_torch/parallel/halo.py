"""The two collectives of the split cost volume, over a sweep group.

Under the JAX package's ``volume_sharding`` the cost volume's depth axis D
is split over the 'sweep' mesh axis and GSPMD inserts the 3D U-Net's halo
exchanges (``scene_3dreconstruction_mvsnet_tpu/parallel/mesh.py:7-10``).
Here rank s of a sweep group of S ranks holds planes [s D/S, (s+1) D/S), and
the model calls these two differentiable collectives itself:

  - ``exchange_halos`` attaches the neighbours' boundary planes to a rank's
    slice, so a conv with no padding on D computes the unsplit conv's planes;
    the ranks at the volume's ends get zeros, the unsplit conv's padding;
  - ``gather_depth`` concatenates the slices, so every rank of the group then
    holds the whole axis and computes the same function of it.

Both move their planes with one all-gather over the group (gloo reduces and
gathers CUDA tensors, but its point-to-point calls are not relied on), and
both keep a tensor's memory layout: CostRegNet's NDHWC activations
(``torch.channels_last_3d``) stay NDHWC through a halo exchange. With
a group of None or of one rank nothing is exchanged: ``exchange_halos``
attaches zero planes (the unsplit conv's padding) and ``gather_depth`` is
the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .collectives import world_size


def _rank(group) -> int:
    return 0 if world_size(group) == 1 else dist.get_rank(group)


def _all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``x``, each part in the layout of ``x`` where that is
    dense (contiguous or NDHWC), else contiguous."""
    if not (x.is_contiguous() or x.is_contiguous(memory_format=torch.channels_last_3d)):
        x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class _ExchangeHalos(torch.autograd.Function):
    """y = [the lower neighbour's last ``lower`` planes, x, the upper
    neighbour's first ``upper`` planes] along ``dim``. Rank s's first planes
    are its lower neighbour's upper halo and its last planes its upper
    neighbour's lower halo, so the backward sends each halo's gradient back
    to its owner and adds it to those planes."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, lower: int, upper: int, group) -> torch.Tensor:
        ctx.dim, ctx.lower, ctx.upper, ctx.group = dim, lower, upper, group
        S, s, L = world_size(group), _rank(group), x.shape[dim]
        lo = torch.zeros_like(x.narrow(dim, 0, lower))  # in the layout of x
        up = torch.zeros_like(x.narrow(dim, 0, upper))
        if S > 1:
            parts = _all_gather(torch.cat([x.narrow(dim, 0, upper), x.narrow(dim, L - lower, lower)], dim), group)
            if s > 0:
                lo = parts[s - 1].narrow(dim, upper, lower)
            if s < S - 1:
                up = parts[s + 1].narrow(dim, 0, upper)
        return torch.cat([lo, x, up], dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        dim, lower, upper, group = ctx.dim, ctx.lower, ctx.upper, ctx.group
        S, s, L = world_size(group), _rank(group), g.shape[dim] - lower - upper
        dx = g.narrow(dim, lower, L).clone()
        if S > 1:
            parts = _all_gather(torch.cat([g.narrow(dim, 0, lower), g.narrow(dim, lower + L, upper)], dim), group)
            if s > 0:  # the lower neighbour's upper halo was this rank's first planes
                dx.narrow(dim, 0, upper).add_(parts[s - 1].narrow(dim, lower, upper))
            if s < S - 1:  # the upper neighbour's lower halo was this rank's last planes
                dx.narrow(dim, L - lower, lower).add_(parts[s + 1].narrow(dim, 0, lower))
        return dx, None, None, None, None


def exchange_halos(x: torch.Tensor, dim: int, lower: int, upper: int, group) -> torch.Tensor:
    """``x`` (this rank's slice along ``dim``) with ``lower`` planes of the
    lower neighbour's slice before it and ``upper`` planes of the upper
    neighbour's after it; zeros beyond the volume's ends. Differentiable.
    Every rank of ``group`` must call it with the same arguments, and each
    slice must hold at least ``max(lower, upper)`` planes."""
    if x.shape[dim] < max(lower, upper):
        raise ValueError(f"a slice of {x.shape[dim]} planes cannot give halos of {lower} and {upper} planes")
    return _ExchangeHalos.apply(x, dim, lower, upper, group)


class _GatherDepth(torch.autograd.Function):
    """y = the ranks' slices concatenated along ``dim``, in rank order. Every
    rank computes the same function of y, so each rank's share of the
    gradient is its own slice of y's gradient (a sum over the ranks would
    count it S times)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group) -> torch.Tensor:
        ctx.dim, ctx.index, ctx.size = dim, _rank(group), x.shape[dim]
        return torch.cat(_all_gather(x, group), dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.narrow(ctx.dim, ctx.index * ctx.size, ctx.size).contiguous(), None, None


def gather_depth(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The whole axis ``dim`` from every rank's equal slice of it, on every
    rank of ``group``; differentiable. ``x`` itself for a group of None or
    of one rank."""
    return x if world_size(group) == 1 else _GatherDepth.apply(x, dim, group)
