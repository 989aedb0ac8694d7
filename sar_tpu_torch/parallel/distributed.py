"""Multi-process execution over torch.distributed (counterpart of
sar_tpu/parallel/distributed.py).

One process per rank, each on `cuda:LOCAL_RANK` with NCCL (gloo on the
CPU, as the tests run it):

- `maybe_initialize_distributed()` starts the default process group when
  the environment is multi-process: explicit arguments, JAX's
  `COORDINATOR_ADDRESS` / `NUM_PROCESSES` / `PROCESS_ID`, torchrun's
  `MASTER_ADDR` / `RANK` / `WORLD_SIZE` with `WORLD_SIZE` > 1, or a SLURM
  allocation with `SLURM_NTASKS` > 1. It is a no-op returning False for a
  single process, so every CLI calls it first. It sets the rank's CUDA
  device before anything touches the card (`device.resolve_device` takes
  the current device). The TPU-pod metadata path of the JAX package has no
  GPU counterpart.
- `make_multislice_mesh()` builds a mesh with a leading "replica" axis
  over nodes (the GPU analogue of a slice) and ("data", "model") inside a
  node, so the tensor-parallel collectives stay on a node's NVLink and
  only the once-per-step gradient sum crosses nodes.
- `put_global_batch()` keeps this rank's rows of the batch that every
  rank loaded: the semantics of a single-process JAX mesh, which its
  parity tests use. Every rank loads the same global batch (the loaders
  are seeded), so no rows cross between processes.

Batches split on their leading axis over every axis but "model"
(`batch_axis_names`); the ranks of one "model" group hold the same rows.
"""

from __future__ import annotations

import logging
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


class RankDevice(NamedTuple):
    """One rank of the world as a mesh entry: its global rank (`id`) and
    its node (`slice_index`, the JAX package's slice)."""
    id: int
    slice_index: int = 0


def maybe_initialize_distributed(coordinator_address: str | None = None,
                                 num_processes: int | None = None,
                                 process_id: int | None = None,
                                 device: str | None = None) -> bool:
    """Initialize the default process group when the environment is
    multi-process; see the module docstring for the detection order.
    NCCL when CUDA is present, gloo without it or when `device` (a CLI's
    --device) names the CPU. Returns True when a multi-process group was
    (or already is) set up, False for a plain single process. Idempotent."""
    if dist.is_initialized():
        return True
    env = os.environ
    local_rank = None
    if coordinator_address is None and env.get("COORDINATOR_ADDRESS"):
        coordinator_address = env["COORDINATOR_ADDRESS"]
        num_processes = int(env["NUM_PROCESSES"]) if env.get("NUM_PROCESSES") else None
        process_id = int(env["PROCESS_ID"]) if env.get("PROCESS_ID") else None
    world_env = int(env.get("WORLD_SIZE", "1") or 1)
    torchrun = world_env > 1 and "MASTER_ADDR" in env and "RANK" in env
    slurm_ntasks = int(env.get("SLURM_NTASKS", "1") or 1)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes and "
                             "process_id too")
        init_method = f"tcp://{coordinator_address}"
        world, rank = num_processes, process_id
    elif torchrun:
        init_method, world, rank = "env://", world_env, int(env["RANK"])
        local_rank = int(env.get("LOCAL_RANK", "0"))
    elif slurm_ntasks > 1:
        addr = env.get("MASTER_ADDR") or env.get("SLURM_LAUNCH_NODE_IPADDR")
        if not addr:
            raise RuntimeError("SLURM_NTASKS > 1 but neither MASTER_ADDR nor "
                               "SLURM_LAUNCH_NODE_IPADDR names the coordinator")
        init_method = f"tcp://{addr}:{env.get('MASTER_PORT', '29500')}"
        world, rank = slurm_ntasks, int(env["SLURM_PROCID"])
        local_rank = int(env.get("SLURM_LOCALID", "0"))
    else:
        return False                     # single process: nothing to do
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", "0"))
    cuda = torch.cuda.is_available() and (device is None
                                          or torch.device(device).type == "cuda")
    if cuda:
        torch.cuda.set_device(local_rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init_method,
                            world_size=world, rank=rank)
    logger.info("torch.distributed: rank %d/%d on %s", dist.get_rank(),
                dist.get_world_size(),
                f"cuda:{local_rank}" if cuda else "cpu")
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0 (or a single process): the one that writes and logs results."""
    return rank() == 0


def devices() -> list[RankDevice]:
    """Every rank of the world, its node from torchrun's contiguous layout
    (`LOCAL_WORLD_SIZE` ranks per node)."""
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0) or world_size()
    return [RankDevice(r, r // per_node) for r in range(world_size())]


def num_slices(devices_=None) -> int:
    """Number of distinct nodes among `devices_` (default: the world's)."""
    devs = devices() if devices_ is None else devices_
    return len({getattr(d, "slice_index", 0) for d in devs})


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def multislice_layout(dp: int = 1, tp: int = 1, replicas: int | None = None,
                      devices_=None) -> tuple[int, int, int, list]:
    """(replicas, dp, tp, the devices in mesh order) of
    `make_multislice_mesh`, with the JAX package's checks and messages."""
    devs = list(devices() if devices_ is None else devices_)
    if replicas is None:
        replicas = max(1, len(devs) // (dp * tp))
    want = replicas * dp * tp
    if want > len(devs):
        raise ValueError(
            f"mesh {replicas}x{dp}x{tp} needs {want} devices but only "
            f"{len(devs)} are visible")
    n_slices = num_slices(devs)
    if n_slices > 1:
        if replicas % n_slices:
            raise ValueError(
                f"replica axis ({replicas}) must be a multiple of the slice "
                f"count ({n_slices}) so DCN traffic stays on the replica axis")
        # An equal count from every node, each node's ranks contiguous:
        # "replica" strides across nodes, ("data", "model") stay in one.
        per_slice = want // n_slices
        groups: dict[int, list] = {}
        for d in sorted(devs, key=lambda d: (getattr(d, "slice_index", 0), d.id)):
            groups.setdefault(getattr(d, "slice_index", 0), []).append(d)
        short = {s: len(g) for s, g in groups.items() if len(g) < per_slice}
        if short:
            raise ValueError(
                f"mesh {replicas}x{dp}x{tp} needs {per_slice} devices from "
                f"each of {n_slices} slices, but slices {sorted(short)} have "
                f"only {short} — pick replicas/dp/tp to fit the smallest "
                f"slice")
        devs = [d for s in sorted(groups) for d in groups[s][:per_slice]]
    else:
        devs = devs[:want]
    return replicas, dp, tp, devs


def make_multislice_mesh(dp: int = 1, tp: int = 1, replicas: int | None = None,
                         devices=None):
    """A DeviceMesh with axes ("replica", "data", "model"): "replica" is
    data parallelism across nodes, ("data", "model") live inside a node.
    On one node it is a plain reshape of the ranks. Needs the default
    process group, and every rank builds it in the same order (it creates
    a process group for each axis)."""
    from sar_tpu_torch.parallel.sharding import new_mesh
    replicas, dp, tp, devs = multislice_layout(dp, tp, replicas, devices)
    ranks = torch.tensor([d.id for d in devs]).reshape(replicas, dp, tp)
    return new_mesh(ranks, ("replica", "data", "model"))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a mesh (JAX's `dict(mesh.shape)`)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axis_names(mesh) -> tuple[str, ...]:
    """Mesh axes the batch dimension shards over (everything but "model")."""
    return tuple(n for n in mesh.mesh_dim_names if n != "model")


def n_batch_shards(mesh) -> int:
    """Total batch-parallel ways (the product of the batch axes' sizes)."""
    n = 1
    for name, size in axis_sizes(mesh).items():
        if name != "model":
            n *= size
    return n


def global_batch_sharding(mesh, rows: int) -> range:
    """This rank's row range of a global batch of `rows` (which the batch
    shards must divide: JAX's error otherwise)."""
    from sar_tpu_torch.parallel.sharding import mesh_groups
    n = n_batch_shards(mesh)
    if rows % n:
        raise ValueError(f"global batch {rows} not divisible by {n} batch "
                         f"shards")
    per = rows // n
    i = mesh_groups(mesh).batch_index
    return range(i * per, (i + 1) * per)


def as_tensor(x) -> torch.Tensor:
    """A batch array (numpy, nested lists or a tensor on any device) as a
    tensor where it lies."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def pad_global_batch(x, mesh, value=0) -> torch.Tensor:
    """The global batch `x` as a tensor where it lies, with rows of `value`
    appended so that the batch shards divide its rows (none without a
    mesh)."""
    x = as_tensor(x)
    pad = 0 if mesh is None else -x.shape[0] % n_batch_shards(mesh)
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad, *x.shape[1:]), value)])


def put_global_batch(x, mesh, batch_axis: int = 0, device=None) -> torch.Tensor:
    """This rank's rows (on `batch_axis`) of the global batch `x` that
    every rank loaded, as a tensor on `device` (default: the rank's)."""
    from sar_tpu_torch.parallel.sharding import mesh_device
    x = as_tensor(x)
    r = global_batch_sharding(mesh, x.shape[batch_axis])
    return x.narrow(batch_axis, r.start, len(r)).to(
        mesh_device(mesh) if device is None else device)


def local_batch_size(global_batch_size: int, mesh=None) -> int:
    """Rows each rank keeps of a global batch: the batch shards must divide
    it (JAX's error otherwise); all of it without a mesh."""
    n = 1 if mesh is None else n_batch_shards(mesh)
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by "
                         f"{n} processes")
    return global_batch_size // n
