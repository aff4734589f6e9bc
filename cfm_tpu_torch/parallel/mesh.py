"""Process groups, device meshes and per-rank batches (counterpart of
``cfm_tpu/parallel/mesh.py``).

The JAX package is one SPMD program over a ``jax.sharding.Mesh``; the port
runs one process per card under ``torch.distributed`` (NCCL on the card,
gloo on the CPU) and uses explicit collectives where JAX has ``pmean`` and
``psum``:

- :func:`initialize_distributed` joins the process group that ``torchrun``
  describes (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``), or one given explicitly; without either it does nothing.
- :func:`make_mesh` is a ``DeviceMesh`` with named dims where JAX has a
  ``Mesh``, "data" varying slowest.
- :func:`replicated_sharding` and :func:`data_parallel_sharding` are the
  DTensor placements of JAX's ``P()`` and ``P("data")``.
- :func:`shard_batch_per_host` puts a process's own rows on its card.
- :func:`local_coupling_step` runs a step on each rank's own rows, the
  coupling per rank, with a per-rank generator (JAX folds the axis index
  into the key).
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from cfm_tpu_torch.device import DeviceLike

Axes = Union[str, Tuple[str, ...]]

_TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def initialize_distributed(device: DeviceLike = None, init_method: Optional[str] = None,
                           world_size: Optional[int] = None, rank: Optional[int] = None,
                           local_rank: Optional[int] = None) -> bool:
    """Join the default process group; True when one is initialised after
    the call.

    The group is the one ``torchrun`` describes in its environment, or the
    one ``init_method`` (``tcp://host:port``, ``file://path``), ``world_size``
    and ``rank`` give. Without either it does nothing (one process). A group
    already initialised is kept, as JAX's guard against a second
    initialisation does. With ``device="cpu"`` the backend is gloo;
    otherwise NCCL on card ``LOCAL_RANK`` (``torch.cuda.set_device``), and
    an NCCL failure raises."""
    if dist.is_initialized():
        return True
    if init_method is None:
        if not all(v in os.environ for v in _TORCHRUN_VARS):
            return False
        init_method = "env://"
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(os.environ["RANK"]) if rank is None else rank
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        local = int(os.environ.get("LOCAL_RANK", rank)) if local_rank is None else local_rank
        torch.cuda.set_device(local)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=init_method,
                            world_size=world_size, rank=rank,
                            device_id=None if cpu else torch.device("cuda", local))
    return True


def _device_type() -> str:
    return "cpu" if dist.get_backend() == "gloo" else "cuda"


def make_mesh(axis_names: Sequence[str] = ("data",), axis_sizes: Optional[Sequence[int]] = None,
              devices: Optional[Union[str, torch.device]] = None):
    """A ``DeviceMesh`` over the process group's ranks with named dims.
    Default: one "data" dim over every rank; for ("data", "model") give
    ``axis_sizes`` (e.g. (2, 4) on 8 ranks): the first dim varies slowest.
    ``devices`` is the mesh's device type (default: "cuda" under NCCL,
    "cpu" under gloo)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = [world] + [1] * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != world:
        raise ValueError(f"mesh {tuple(axis_sizes)} does not cover the {world} ranks")
    device_type = torch.device(devices).type if devices is not None else _device_type()
    return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))


def replicated_sharding(mesh) -> list:
    """JAX's ``P()``: every dim of the mesh holds the whole tensor."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in mesh.mesh_dim_names]


def data_parallel_sharding(mesh, axis: str = "data") -> list:
    """JAX's ``P(axis)``: rows split over ``axis``, whole along the other dims."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names]


def rank_device(mesh) -> torch.device:
    """This rank's device in ``mesh``."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def shard_batch_per_host(mesh, local_batch, axis: str = "data") -> torch.Tensor:
    """This process's own rows on its device: the global batch is the ranks'
    local batches in rank order along ``axis`` (each process reads its own
    data; nothing is gathered)."""
    return torch.as_tensor(np.asarray(local_batch)).to(rank_device(mesh))


def axis_index(mesh, axes: Axes) -> Tuple[int, int]:
    """(index, count): this rank's row-major index over the mesh ``axes`` and
    the number of ranks they span, as the JAX step linearises
    ``axis_index`` over a tuple of axes."""
    idx, count = 0, 1
    for a in ((axes,) if isinstance(axes, str) else tuple(axes)):
        size = mesh.size(mesh.mesh_dim_names.index(a))
        idx, count = idx * size + mesh.get_local_rank(a), count * size
    return idx, count


def axis_group(mesh, axes: Axes):
    """The process group over ``axes`` of ``mesh`` (the default group
    without a mesh)."""
    if mesh is None:
        return dist.group.WORLD
    if isinstance(axes, str):
        return mesh.get_group(axes)
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def rank_streams(index: int) -> Callable[[torch.Generator], torch.Generator]:
    """``stream(generator)``: rank ``index``'s own generator for a caller's
    ``generator`` (seeded alike on every rank), made once from its seed and
    the index, mixed by numpy's SeedSequence, and kept for later calls."""
    made = {}

    def stream(generator: torch.Generator) -> torch.Generator:
        if id(generator) not in made:
            seed = np.random.SeedSequence([generator.initial_seed(), index]).generate_state(1)[0]
            made[id(generator)] = torch.Generator(device=generator.device).manual_seed(int(seed))
        return made[id(generator)]

    return stream


def local_coupling_step(train_step: Callable, mesh, axis: str = "data") -> Callable:
    """Run ``train_step`` on each rank's rows of the global batch, the OT
    coupling within those rows: the reference DDP's per-rank plans. Trades
    coupling quality for no gather; at global batch 128 on 8 cards each
    rank couples 16 samples.

    The gradient all-reduce lives inside the step: ``train_step`` must come
    from ``make_train_step(..., data_axis=axis)``; a step tagged otherwise
    is refused, since each rank would apply only its own gradients and the
    parameters would drift apart.

    Returns ``step(state, x0, x1, *labels, generator=None, draws=None)``
    with x0, x1 (and labels) the global batch, the same on every rank. With
    ``generator`` (seeded alike on every rank) each rank draws from its own
    stream (:func:`rank_streams`); ``draws`` are this rank's own draws
    instead."""
    tagged = getattr(train_step, "_data_axis", "<untagged>")
    if tagged != axis:
        raise ValueError(
            f"local_coupling_step(axis={axis!r}) needs a step built with "
            f"make_train_step(..., data_axis={axis!r}); got data_axis="
            f"{tagged!r} — without the in-step pmean every shard would "
            "apply only its local gradients and params would drift apart"
        )
    idx, count = axis_index(mesh, axis)
    stream = rank_streams(idx)

    def step(state, x0, x1, *labels, generator: Optional[torch.Generator] = None, draws=None):
        if x0.shape[0] % count:
            raise ValueError(f"global batch {x0.shape[0]} must divide over {count} devices")
        shard = x0.shape[0] // count
        rows = [t[idx * shard:(idx + 1) * shard] for t in (x0, x1, *labels)]
        if generator is not None and draws is None:
            generator = stream(generator)
        return train_step(state, *rows, generator=generator, draws=draws)

    return step
