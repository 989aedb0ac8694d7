"""Device meshes and the tensor-parallel layout (counterpart of
sar_tpu/parallel/sharding.py).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with the JAX
package's axis names, ("data", "model") or ("replica", "data", "model"),
over one process per rank. Where JAX places a global array with a
`NamedSharding` and lets GSPMD insert the collectives, each rank here holds
its shard as a plain local tensor and the model calls the few collectives
its math needs (models/whisper.py, `tp=`). The rules are JAX's table
(weights [d_in, d_out] with a leading L on layer stacks):

- q/k/v and fc1: d_out split over "model" (column parallel);
- o and fc2: d_in split (row parallel: a partial product, summed over
  "model", then the bias once);
- token_embed [V, d]: V split (torch.tensor_split sizes: whisper's
  V = 51865 is odd); its fp32 logits copy likewise;
- the conv stems ([out, in, 3]): their output channels split;
- positions, LayerNorms and the LoRA bank: replicated.

Batches split on their leading axis over the batch axes
(distributed.batch_axis_names). Explicit tensor parallelism cannot split
a head, so "model" must divide the heads (`shard_params` says so), where
GSPMD resharded around it.

The process groups are the DeviceMesh's own: it makes one for each axis
when it is built, on every rank in the same order (making a group is
collective: a rank that skipped one would hang the others).
`mesh_groups` reads them. An axis of one rank is given no group, and
nothing then runs a collective over it: with "model" of one rank the
model runs none at all.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

from sar_tpu_torch.parallel import distributed as pdist


class ModelGroup(NamedTuple):
    """The "model" process group as the model takes it (`tp=`): the group,
    this rank's index in it (which shard it holds) and its size."""
    group: object
    rank: int
    size: int


class MeshGroups(NamedTuple):
    """A mesh's process groups and this rank's place in them: `model`
    (None for one rank); `batch`, the (group, size) of each batch axis of
    more than one rank, outermost first; this rank's `batch_index` of the
    `n_batch` batch shards."""
    model: ModelGroup | None
    batch: tuple
    batch_index: int
    n_batch: int


def new_mesh(ranks: torch.Tensor, names: tuple[str, ...]):
    """A DeviceMesh over `ranks` (one entry per mesh position, the world's
    ranks each once) with axis `names`."""
    from torch.distributed.device_mesh import DeviceMesh
    if ranks.numel() != pdist.world_size():
        raise ValueError(f"mesh {'x'.join(map(str, ranks.shape))} != "
                         f"{pdist.world_size()} processes: launch one process "
                         f"per mesh position")
    return DeviceMesh(pdist._device_type(), ranks, mesh_dim_names=names)


def mesh_groups(mesh) -> MeshGroups:
    """The groups of `mesh`'s axes of more than one rank, from the mesh
    itself, and this rank's place on them."""
    coord = mesh.get_coordinate()
    model, batch, index, n = None, [], 0, 1
    for i, (name, size) in enumerate(zip(mesh.mesh_dim_names, mesh.mesh.shape)):
        size = int(size)
        if name == "model":
            if size > 1:
                model = ModelGroup(mesh.get_group(name), coord[i], size)
            continue
        index, n = index * size + coord[i], n * size
        if size > 1:
            batch.append((mesh.get_group(name), size))
    return MeshGroups(model, tuple(batch), index, n)


def model_group(mesh) -> ModelGroup | None:
    """The `tp=` of the model under `mesh` (None without one, or for a
    "model" axis of one rank)."""
    return None if mesh is None else mesh_groups(mesh).model


def mesh_device(mesh) -> torch.device:
    """This rank's device: the current CUDA device under NCCL, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(n_data: int | None = None, n_model: int = 1, devices=None):
    """A ("data", "model") mesh over the world's ranks; pure data
    parallelism by default."""
    devs = list(pdist.devices() if devices is None else devices)
    if n_data is None:
        n_data = len(devs) // n_model
    if n_data * n_model != len(devs):
        raise ValueError(f"mesh {n_data}x{n_model} != {len(devs)} devices")
    ranks = torch.tensor([getattr(d, "id", d) for d in devs]).reshape(n_data, n_model)
    return new_mesh(ranks, ("data", "model"))


def mesh_from_flags(dp: int, tp: int, dcn_dp: int = 1):
    """CLI helper (--dp/--tp/--dcn_dp): a mesh over the world's
    dcn_dp*dp*tp ranks, or None when the product is 1. With --dcn_dp > 1
    it gains a leading "replica" axis across nodes
    (distributed.make_multislice_mesh). Call
    `distributed.maybe_initialize_distributed()` first."""
    want = dcn_dp * dp * tp
    if want <= 1:
        return None
    have = pdist.world_size()
    if have != want:
        raise SystemExit(
            f"error: --dcn_dp {dcn_dp} x --dp {dp} x --tp {tp} needs {want} "
            f"devices but {have} {'is' if have == 1 else 'are'} running "
            f"(one process per device); launch with torchrun "
            f"--nproc_per_node {want} (or --nnodes N --nproc_per_node "
            f"{want}/N) -m sar_tpu_torch.scripts.<cli>")
    if dcn_dp > 1:
        return pdist.make_multislice_mesh(dp=dp, tp=tp, replicas=dcn_dp)
    return make_mesh(n_data=dp, n_model=tp)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

def _layer_specs(prefix: str) -> dict:
    """Split dims of one stacked layer dict (leading L axis); None is
    replicated."""
    col = {"w": 2, "b": 1}
    row = {"w": 1, "b": None}
    ln = {"scale": None, "bias": None}
    if prefix == "encoder":
        return {"attn_ln": ln, "q": col, "k": {"w": 2}, "v": col, "o": row,
                "mlp_ln": ln, "fc1": col, "fc2": row}
    return {"self_ln": ln, "self_q": col, "self_k": {"w": 2}, "self_v": col,
            "self_o": row,
            "cross_ln": ln, "cross_q": col, "cross_k": {"w": 2}, "cross_v": col,
            "cross_o": row,
            "mlp_ln": ln, "fc1": col, "fc2": row}


def param_specs(params: dict) -> dict:
    """A tree of the params' structure whose leaves are the dim split over
    "model", or None (replicated): the counterpart of JAX's tree of
    PartitionSpecs. The conv weights are [out, in, 3], split on out."""
    ln = {"scale": None, "bias": None}
    specs = {
        "encoder": {"conv1": {"w": 0, "b": 0}, "conv2": {"w": 0, "b": 0},
                    "pos_embed": None, "layers": _layer_specs("encoder"), "ln": ln},
        "decoder": {"token_embed": 0, "pos_embed": None,
                    "layers": _layer_specs("decoder"), "ln": ln},
    }
    if "token_embed_f32" in params.get("decoder", {}):
        specs["decoder"]["token_embed_f32"] = 0
    return specs


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def lora_specs(lora: dict) -> dict:
    """The bank is replicated (tiny: L*A*d*r)."""
    return _tree_map(lambda _: None, lora)


def split_range(n: int, tp: ModelGroup | None) -> tuple[int, int]:
    """[lo, hi) of rank `tp.rank`'s share of n entries, as
    torch.tensor_split deals them (the first n % size ranks one more)."""
    if tp is None:
        return 0, n
    q, r = divmod(n, tp.size)
    lo = tp.rank * q + min(tp.rank, r)
    return lo, lo + q + (tp.rank < r)


def shard_params(params: dict, mesh, cfg=None) -> dict:
    """This rank's shard of a param tree, on the rank's device. With `cfg`
    it checks first that "model" divides the encoder and decoder heads."""
    tp = model_group(mesh)
    dev = mesh_device(mesh)
    n = 1 if tp is None else tp.size
    if cfg is not None:
        for name in ("encoder_heads", "decoder_heads"):
            heads = getattr(cfg, name)
            if heads % n:
                raise ValueError(
                    f"tensor parallelism over {n} ranks cannot split "
                    f"{cfg.name}'s {heads} {name.replace('_', ' ')}: pick "
                    f"--tp dividing {heads} (a head lives on one rank)")

    def shard(x, dim):
        if dim is not None and tp is not None:
            lo, hi = split_range(x.shape[dim], tp)
            x = x.narrow(dim, lo, hi - lo)
        return x.to(dev).contiguous()
    return _tree_map(shard, params, param_specs(params))


def shard_lora(lora: dict, mesh) -> dict:
    """The replicated bank on this rank's device."""
    dev = mesh_device(mesh)
    return _tree_map(lambda x: x.to(dev), lora)


def batch_sharding(mesh) -> tuple[int, int]:
    """(this rank's shard, the shard count) of the leading batch axis."""
    g = mesh_groups(mesh)
    return g.batch_index, g.n_batch


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's rows of every leading-batch array in a batch dict."""
    return _tree_map(lambda x: pdist.put_global_batch(x, mesh), batch)


# ---------------------------------------------------------------------------
# The collectives the model and the trainers call
# ---------------------------------------------------------------------------

class _Sum(torch.autograd.Function):
    """All-reduce (sum) over a group; its backward all-reduces the
    gradient, as torch.distributed.nn's: every rank's copy of the output
    feeds that rank's (replicated) loss, and the adjoint of a sum sent to
    every rank is the sum of what comes back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather of equal shards along `dim`, joined in group-rank order;
    the backward sums every rank's gradient of the whole (one all-reduce,
    which gloo has where it lacks reduce-scatter) and keeps this rank's
    shard of it."""

    @staticmethod
    def forward(ctx, x, group, rank, size, dim):
        ctx.group, ctx.rank, ctx.dim, ctx.width = group, rank, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.width, ctx.width), None, None, None, None


def model_sum(x: torch.Tensor, tp: ModelGroup | None) -> torch.Tensor:
    """The sum of `x` over the "model" group (a row-parallel product's
    partials), differentiable (`_Sum`); `x` itself for no group."""
    if tp is None:
        return x
    return _Sum.apply(x, tp.group)


def model_gather(x: torch.Tensor, tp: ModelGroup | None, dim: int,
                 full: int) -> torch.Tensor:
    """The shards of `x` along `dim` from every "model" rank, joined in
    rank order into `full` entries (shards dealt as split_range deals
    them, so they may differ by one: each is padded to the widest for the
    gather and cut after), differentiable (`_Gather`)."""
    if tp is None:
        return x
    dim = dim % x.dim()
    q, r = divmod(full, tp.size)
    width = q + (r > 0)
    pad = width - x.shape[dim]
    if pad:
        x = torch.cat([x, x.new_zeros(x.shape[:dim] + (pad,) + x.shape[dim + 1:])], dim)
    y = _Gather.apply(x, tp.group, tp.rank, tp.size, dim)
    if not r:
        return y
    return torch.cat([y.narrow(dim, i * width, q + (i < r)) for i in range(tp.size)], dim)


def reduce_gradients(grads: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """Gradients of replicated parameters (a LoRA bank, the LID head) from
    every rank's backward -> the gradient of the global objective: summed
    over the world, divided by the "model" size. The model's collectives
    (`_Sum`, `_Gather`) sum in their backward what every rank's copy of
    the (replicated) loss sends back, so each "model" rank's gradients
    carry the loss `size` times; the batch axes each hold a part of the
    global loss, which sums. One all-reduce over one flat buffer."""
    if pdist.world_size() == 1:
        return grads
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    tp = model_group(mesh)
    if tp is not None:
        flat /= tp.size
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].view_as(g))
        i += g.numel()
    return out


def batch_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """`x` summed over the batch shards (not differentiable)."""
    groups = () if mesh is None else mesh_groups(mesh).batch
    if not groups:
        return x
    x = x.clone()
    for g, _ in groups:
        dist.all_reduce(x, group=g)
    return x


def batch_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every batch shard's rows of `x` (equal row counts), in row order:
    gathered over the innermost batch axis first."""
    for g, size in reversed(() if mesh is None else mesh_groups(mesh).batch):
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=g)
        x = torch.cat(parts)
    return x


def batch_gather_objects(items: list, mesh) -> list:
    """Every batch shard's list `items`, joined in row order."""
    for g, size in reversed(() if mesh is None else mesh_groups(mesh).batch):
        out: list = [None] * size
        dist.all_gather_object(out, items, group=g)
        items = [x for part in out for x in part]
    return items
