"""Process groups and device lists for multi-device runs.

Counterpart of ``scene_3dreconstruction_mvsnet_tpu/parallel/mesh.py``. The
JAX package builds a ('data', 'sweep') device mesh and lets XLA place the
collectives; here every rank is one process joined to a
``torch.distributed`` process group (``initialize_multihost``), or, within
one process, a list of devices (``local_devices``, the device pick of
``make_mesh`` for the sharded eval). ``make_mesh`` lays the ranks of a group
out as a data x sweep grid and makes the groups of its rows and columns:
the ranks of a sweep group each hold a slice of the cost volume's depth
axis (``parallel/halo.py``), the ranks of a data group each hold rows of
the batch.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


def auto_mesh_shape(n_devices: int, max_sweep: int = 4) -> tuple[int, int]:
    """Factor ``n_devices`` into (data, sweep), giving the sweep axis up to
    ``max_sweep`` ways and the rest to data parallelism (the JAX package's
    factoring, kept for readers of its configurations)."""
    sweep = 1
    for cand in (4, 2):
        if cand <= max_sweep and n_devices % cand == 0:
            sweep = cand
            break
    return n_devices // sweep, sweep


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    local_rank: int | None = None,
    timeout_s: float = 600.0,
) -> tuple[int, int, int]:
    """Join this process to the default ``torch.distributed`` process group
    and return (rank, world size, local rank).

    The arguments default to torch's standard environment variables, as
    ``torchrun`` sets them: ``MASTER_ADDR``:``MASTER_PORT`` for
    ``coordinator_address`` ("host:port"), ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK`` (the rank when unset). The backend is ``nccl`` where a
    card is and ``gloo`` elsewhere, unless ``backend`` names one; with
    ``nccl`` the card ``cuda:<local rank>`` becomes the current device.
    Call once, before the first collective."""
    env = os.environ
    if coordinator_address is None:
        coordinator_address = f"{env.get('MASTER_ADDR', '127.0.0.1')}:{env['MASTER_PORT']}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(env["RANK"]) if process_id is None else int(process_id)
    local_rank = int(env.get("LOCAL_RANK", rank)) if local_rank is None else int(local_rank)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world, local_rank


def local_devices(n: int, device: torch.device | str = "cuda") -> list[torch.device]:
    """The first ``n`` devices of ``device``'s type in this process
    (``cuda:0`` ... ``cuda:n-1``; the CPU counts as one device), the
    counterpart of ``make_mesh``'s device pick. Raises as ``make_mesh`` does
    when fewer exist."""
    kind = torch.device(device).type
    have = torch.cuda.device_count() if kind == "cuda" else 1
    if n > have:
        raise ValueError(f"mesh {n}x1 needs {n} devices, have {have} ({kind})")
    return [torch.device(kind, i) if kind == "cuda" else torch.device(kind) for i in range(n)]


@dataclass(frozen=True)
class Mesh:
    """A data x sweep layout of the ranks of ``world``, as this rank sees it.

    Rank r of ``world`` sits at (r // sweep, r % sweep), the order of the
    JAX package's ``devices.reshape(data, sweep)``. ``sweep_group`` holds the
    ranks of this rank's data index (they split the depth planes),
    ``data_group`` those of its sweep index (they split the batch); a group
    of one rank is None, as the collectives take a lone process."""

    data: int
    sweep: int
    data_index: int
    sweep_index: int
    world: dist.ProcessGroup
    data_group: dist.ProcessGroup | None
    sweep_group: dist.ProcessGroup | None


def make_mesh(data: int | None = None, sweep: int = 1, group=None) -> Mesh:
    """Lay the ranks of ``group`` (default: the default process group) out
    as a ``data`` x ``sweep`` mesh; ``data`` defaults to the ranks over
    ``sweep``. Every rank of ``group`` must call it with the same arguments:
    each makes every row and column group in the same order (only the
    members of a group wait for each other)."""
    group = dist.group.WORLD if group is None else group
    ranks = dist.get_process_group_ranks(group)
    if data is None:
        data = len(ranks) // sweep
    if data < 1 or sweep < 1 or data * sweep != len(ranks):
        raise ValueError(f"mesh {data}x{sweep} needs {data * sweep} ranks, the group has {len(ranks)}")
    data_index, sweep_index = divmod(dist.get_rank(group), sweep)

    def new_group(members: list[int]):
        return dist.new_group(members, use_local_synchronization=True) if len(members) > 1 else None

    rows = [new_group([ranks[d * sweep + s] for s in range(sweep)]) for d in range(data)]
    cols = [new_group([ranks[d * sweep + s] for d in range(data)]) for s in range(sweep)]
    return Mesh(data, sweep, data_index, sweep_index, group, cols[sweep_index], rows[data_index])


def make_global_mesh(sweep: int = 1, max_sweep: int = 4) -> Mesh:
    """A mesh over every rank of the default process group; ``sweep`` <= 0
    picks it with ``auto_mesh_shape(world size, max_sweep)``. Raises when
    the world does not divide by ``sweep``."""
    n = dist.get_world_size()
    if sweep <= 0:
        _, sweep = auto_mesh_shape(n, max_sweep=max_sweep)
    if n % sweep:
        raise ValueError(f"{n} global ranks not divisible by sweep={sweep}")
    return make_mesh(data=n // sweep, sweep=sweep)
