"""The data-parallel train step and the sharded inference of the port.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/parallel/sharding.py``.
There, parameters are replicated, the batch is split over the mesh's 'data'
axis and GSPMD places the collectives, so BatchNorm, the loss and the
metrics see the global batch. Here:

  - ``make_sharded_train_step``: one process per rank of a
    ``torch.distributed`` group; every rank starts from rank 0's weights,
    takes its rows of the global batch, and the step reduces BatchNorm's
    statistics, the loss's valid count, the gradients and the metrics over
    the ranks (``parallel/collectives.py``), so every rank keeps equal
    parameters and buffers and the step equals the single-process step on
    the whole batch;
  - the same step over a data x sweep ``Mesh`` (``parallel/mesh.py``):
    the ranks of a sweep group hold the same rows and each sweeps and
    regularises its slice of the depth planes (``volume_sharding``, the
    counterpart of the JAX package's ``P('data', 'sweep')`` volume);
  - ``make_sharded_infer``: one process, a replica of the model per
    device, the view/batch axis split over the devices in order.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import torch
import torch.distributed as dist

from .collectives import all_reduce_grads, broadcast_module, world_size
from .mesh import Mesh

BATCH_FIELDS = ("imgs", "proj_matrices", "depth_values", "depth", "mask")


def shard_rows(n: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``n``: [r n/W, (r+1) n/W).
    The batch must divide by the world size, as the JAX package's
    ``shard_batch`` requires."""
    if n % world:
        raise ValueError(f"global batch {n} must be a multiple of the {world} ranks")
    per = n // world
    return slice(rank * per, (rank + 1) * per)


# CostRegNet's three stride-2 levels halve every rank's slice three times,
# and each level's slice must start at an even plane
SWEEP_DEPTH_MULTIPLE = 8


@dataclass(frozen=True)
class VolumeSharding:
    """How the cost volume's depth axis is split: this rank is ``index`` of
    the ``size`` ranks of the sweep ``group`` (None for one rank) and holds
    the planes ``depth_slice(D)``. The model takes it as
    ``MVSNet(volume_sharding=...)``."""

    group: Any
    size: int
    index: int

    def depth_slice(self, D: int) -> slice:
        """This rank's planes [index D/size, (index+1) D/size). D must be a
        multiple of 8 x size: CostRegNet halves each slice three times with
        its stride-2 convs, and every slice must start on an even plane at
        each level for the halo exchanges to give the unsplit convs' planes
        (the JAX package lets GSPMD pad uneven shards; here they are
        refused)."""
        if D % (SWEEP_DEPTH_MULTIPLE * self.size):
            raise ValueError(f"D={D} planes cannot be split over {self.size} sweep ranks: D must be a multiple of "
                             f"{SWEEP_DEPTH_MULTIPLE * self.size} (8 x the sweep ranks)")
        per = D // self.size
        return slice(self.index * per, (self.index + 1) * per)


def volume_sharding(mesh: Mesh) -> VolumeSharding:
    """The depth split of ``mesh``'s sweep axis, for ``MVSNet``."""
    return VolumeSharding(mesh.sweep_group, mesh.sweep, mesh.sweep_index)


def make_sharded_train_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    scheduler: torch.optim.lr_scheduler.LRScheduler,
    device: torch.device | str,
    group=None,
    mesh: Mesh | None = None,
) -> tuple[Callable[[Mapping[str, Any]], dict[str, torch.Tensor]], Callable[[Mapping[str, Any]], dict]]:
    """Build ``(train_step, shard_fn)`` for data-parallel training over
    ``group`` (default: the default process group), ``model`` already on
    ``device``; or, with ``mesh``, for data x sweep training
    (``_make_mesh_train_step``).

    Rank 0's parameters and buffers are broadcast to every rank here, and
    every BatchNorm of ``model`` takes its training statistics over the
    group. ``shard_fn(global_batch)`` returns this rank's rows of each
    batch field; ``train_step(rows)`` is ``train/state.py::make_train_step``
    with the group: the loss is this rank's share of the global masked mean,
    the gradients are summed over the ranks before ``optimizer.step()``, and
    the aux's loss and metrics are the global batch's. BatchNorm's buffers
    stay equal on every rank by construction (they take the same global
    statistics), so they are not broadcast again."""
    from ..models.blocks import _FlaxRunningVar
    from ..train.state import make_train_step

    if mesh is not None:
        if group is not None:
            raise ValueError("pass a group or a mesh, not both")
        return _make_mesh_train_step(model, optimizer, scheduler, device, mesh)
    group = dist.group.WORLD if group is None else group
    rank, world = dist.get_rank(group), world_size(group)
    broadcast_module(model, group)
    for m in model.modules():
        if isinstance(m, _FlaxRunningVar):
            m.process_group = group

    def shard_fn(batch: Mapping[str, Any]) -> dict:
        rows = shard_rows(len(batch["imgs"]), rank, world)
        return {k: (v[rows] if k in BATCH_FIELDS else v) for k, v in batch.items()}

    return make_train_step(model, optimizer, scheduler, device, group), shard_fn


def _make_mesh_train_step(model, optimizer, scheduler, device, mesh: Mesh):
    """The data x sweep step: the step on the whole batch, every quantity
    counted once.

      - ``model`` must be an ``MVSNet`` built with this mesh's
        ``volume_sharding``; rank 0 of the mesh's world gives every rank its
        weights;
      - the ranks of a sweep group take the same rows (their data index's);
      - BatchNorm: FeatureNet's and RefineNet's inputs are the same on every
        rank of a sweep group, so their statistics are taken over the data
        group; CostRegNet's slices make up the global volume, so its
        statistics are taken over the whole mesh (equal shares per rank, as
        D divides);
      - the loss and the metrics: every rank of a sweep group computes its
        rows' share, so they reduce over the data group only;
      - the gradients: a rank's gradients of FeatureNet and CostRegNet come
        from its planes alone (the gathered logits give each rank its own
        slice of their gradient), so they sum over the whole mesh; what lies
        after the gather (RefineNet) is computed whole on each rank of a
        sweep group, so its sum over the mesh counts it ``sweep`` times and
        is divided by ``sweep``. One collective over the mesh gives every
        rank the same gradients, so the parameters stay equal on all ranks."""
    from ..models.blocks import _FlaxRunningVar
    from ..train.state import make_train_step

    sharding = getattr(model, "volume_sharding", None)
    if sharding is None or sharding.group is not mesh.sweep_group or sharding.index != mesh.sweep_index:
        raise ValueError("the model must be built with MVSNet(volume_sharding=volume_sharding(mesh)) of this mesh")
    broadcast_module(model, mesh.world)
    for m in model.modules():
        if isinstance(m, _FlaxRunningVar):
            m.process_group = mesh.data_group
    for m in model.cost_regularization.modules():
        if isinstance(m, _FlaxRunningVar):
            m.process_group = mesh.world
    whole = list(model.refine_network.parameters()) if model.refine_network is not None else []

    def reduce_grads() -> None:
        all_reduce_grads(model.parameters(), mesh.world)
        for p in whole:
            if p.grad is not None:
                p.grad.div_(mesh.sweep)

    def shard_fn(batch: Mapping[str, Any]) -> dict:
        rows = shard_rows(len(batch["imgs"]), mesh.data_index, mesh.data)
        return {k: (v[rows] if k in BATCH_FIELDS else v) for k, v in batch.items()}

    return make_train_step(model, optimizer, scheduler, device, mesh.data_group, reduce_grads), shard_fn


def make_sharded_infer(
    model: torch.nn.Module, devices: list[torch.device | str]
) -> Callable[..., dict[str, torch.Tensor]]:
    """Multi-device inference: a replica of ``model`` (in eval mode) on each
    of ``devices`` (a device may be named more than once; ``model`` itself
    moves to the first), and
    ``infer(imgs, proj_matrices, depth_values) -> {'depth',
    'photometric_confidence'}`` that splits the batch axis over the
    replicas in order, launches every shard before it waits for any, and
    returns the outputs in input order on the first device. The batch must
    divide by the number of devices, as in the JAX package's stage A."""
    from ..infer import make_infer_step

    devices = [torch.device(d) for d in devices]
    replicas = [copy.deepcopy(model) for _ in devices[1:]]
    steps = [make_infer_step(m, d) for m, d in zip([model, *replicas], devices)]

    def infer(imgs, proj_matrices, depth_values) -> dict[str, torch.Tensor]:
        arrays = [torch.as_tensor(a) for a in (imgs, proj_matrices, depth_values)]
        parts = [shard_rows(arrays[0].shape[0], i, len(steps)) for i in range(len(steps))]
        outs = [step(*(a[rows] for a in arrays)) for step, rows in zip(steps, parts)]  # all launched
        return {k: torch.cat([o[k].to(devices[0], non_blocking=True) for o in outs]) for k in outs[0]}

    return infer
