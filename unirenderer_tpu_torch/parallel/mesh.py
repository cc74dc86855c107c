"""Data parallelism, FSDP and Megatron tensor parallelism on
`torch.distributed` (counterpart of `unirenderer_tpu/parallel/mesh.py`).

The JAX package jits one program over a `jax.sharding.Mesh` and lets
GSPMD place every collective.  Here each process is one rank of a
`DeviceMesh` (NCCL on the card, gloo on the CPU) and the collectives are
explicit:

  * DP: every rank holds the dual-stream masters, computes the gradients
    of its slice of the global batch, and the gradients are averaged over
    the `data` axis before the (identical) update on every rank.
  * FSDP (`fsdp_param_sharding`, the JAX rule in torch's layout): a
    parameter of at least FSDP_MIN_SIZE elements keeps only its rank's
    slice of its largest `data`-divisible flax dimension as the f32
    master, with the optimizer state of that slice (Adafactor's factored
    statistics whole on every rank, `train/adafactor.py`).  A step casts
    the slices to the compute type and all-gathers them, a bucket of tensors
    a collective, and reduce-scatters the gradients back to the slices;
    smaller tensors are replicated, their gradients all-reduced.  The
    gathered tensors live through the backward (no resharding after the
    forward).
  * Megatron TP (`tp_param_sharding`, dual-stream only): `to_q` / `to_k`
    / `to_v` and the GEGLU `ff.proj` are column-parallel (output rows
    split over `model`), `to_out` and `ff.out` row-parallel (input columns
    split, outputs all-reduced); each rank's `Attention` runs its
    num_heads / n heads.  With a `data` axis, the tensors TP leaves
    replicated go FSDP over `data`.  A model axis of one rank wraps
    nothing.

A sharded train step computes what the single-process step computes on
the same global batch: every rank draws the global batch's random numbers
and takes its slice, the loss is the mean over the global batch (the
contrastive term, which pairs the global batch's first two samples, is
counted on the first data rank only) and the gradients are the mean over
the ranks.  The JAX Megatron code never meets three traps here, because
GSPMD propagates its shardings: the local `Attention` must carry its
local head count (its head width is inner // num_heads); the GEGLU `proj`
output is split into its hidden and gate halves by `chunk(2)`, so each
half is split over the ranks on its own; and a column-parallel bias is
sliced with its rows, a row-parallel bias added once (by the first rank
of the group, before the all-reduce).

Usage (one process per rank, e.g. under `torchrun`):

    initialize_distributed()
    mesh = make_mesh()                                   # DP over all
    step, state = make_sharded_train_step(cfg, dual, make_train_step(...),
                                          mesh, fsdp=True)
    mesh = make_mesh_2d(2, 2)                            # DP x TP
    step, state = make_tp_train_step(cfg, dual, make_train_step(...),
                                     mesh, fsdp=True)
    metrics = step(state, ctx, batch, global_draws)   # batch: global
                                                      # or this rank's rows
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, \
    Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from unirenderer_tpu_torch.core.checkpoint import map_tensors
from unirenderer_tpu_torch.core.convert import flax_permutations

# (axis name, torch dim) of a sharded tensor; None: replicated
Placement = Optional[Tuple[str, int]]

_TP_COL = ("to_q", "to_k", "to_v")        # + GEGLU "proj": out-dim sharded
_TP_ROW = ("to_out",)                     # + GEGLU "out": in-dim sharded


# ---------------------------------------------------------------------------
# Process group, mesh, batch
# ---------------------------------------------------------------------------

def initialize_distributed(device=None) -> bool:
    """Join torchrun's process group (`env://`: WORLD_SIZE, RANK,
    MASTER_ADDR, MASTER_PORT).  NCCL when `device` (default the card) is a
    CUDA device, whose index becomes LOCAL_RANK; gloo on the CPU.  A
    single process (no WORLD_SIZE) is a no-op.  Returns whether a group
    is initialised."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ:
        return False
    from unirenderer_tpu_torch.utils.runtime import resolve_device
    dev = resolve_device(device or "cuda")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return True


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = "data"):
    """1-D data-parallel `DeviceMesh` over every rank (`n_devices`, when
    given, must be the world size)."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_devices not in (None, world):
        raise ValueError(f"a mesh of {n_devices} on a world of {world}")
    return init_device_mesh(_device_type(), (world,),
                            mesh_dim_names=(axis_name,))


def make_mesh_2d(dp: int, mp: int,
                 axis_names: Sequence[str] = ("data", "model")):
    """2-D (data x model) `DeviceMesh`, the model axis minor: rank
    d * mp + m holds data index d and model index m, so a TP group is
    adjacent ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    if dp * mp != dist.get_world_size():
        raise ValueError(f"mesh {dp} x {mp} on a world of "
                         f"{dist.get_world_size()}")
    return init_device_mesh(_device_type(), (dp, mp),
                            mesh_dim_names=tuple(axis_names))


def mesh_axis(mesh, axis: str):
    """(process group, size, this rank's index) of a mesh axis; (None, 1,
    0) for an axis the mesh lacks."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    i = mesh.mesh_dim_names.index(axis)
    return mesh.get_group(axis), mesh.mesh.shape[i], mesh.get_local_rank(axis)


def host_local_batch_slice(global_batch: int, mesh=None,
                           axis_name: str = "data") -> slice:
    """This rank's rows of the global batch: its index on `axis_name` of
    `mesh`, or its rank in the world without a mesh."""
    if mesh is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
        r = dist.get_rank() if dist.is_initialized() else 0
    else:
        _, n, r = mesh_axis(mesh, axis_name)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} over {n} ranks")
    per = global_batch // n
    return slice(r * per, (r + 1) * per)


def shard_batch(batch: Any, mesh, axis_name: str = "data") -> Any:
    """This rank's slice (dim 0, over `axis_name`) of every tensor of a
    global batch (nested dicts, lists, tuples)."""
    first = next(t for t in _tensors(batch))
    sl = host_local_batch_slice(first.shape[0], mesh, axis_name)
    return map_tensors(lambda t: t[sl], batch)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


BUCKET_ELEMENTS = 2 ** 26       # one collective's worth of coalesced tensors
FSDP_MIN_SIZE = 2 ** 18         # elements; smaller tensors stay replicated

# torch 2.13 renames the flat-tensor collectives (the older names warn)
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def buckets(tensors: Sequence[torch.Tensor]) -> List[List[int]]:
    """Indices of `tensors` in buckets of consecutive tensors of one type
    and device of up to BUCKET_ELEMENTS elements each: one collective a
    bucket, not a tensor."""
    out: List[List[int]] = []
    size = 0
    for i, t in enumerate(tensors):
        first = tensors[out[-1][0]] if out else None
        if first is None or t.dtype != first.dtype or t.device != \
                first.device or size + t.numel() > BUCKET_ELEMENTS:
            out.append([])
            size = 0
        out[-1].append(i)
        size += t.numel()
    return out


def coalesced(op: Callable[[torch.Tensor], None],
              tensors: List[torch.Tensor]) -> None:
    """Apply an in-place collective `op` to `tensors` (in place), one call
    a bucket (`buckets`)."""
    for idx in buckets(tensors):
        bucket = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in bucket])
        op(flat)
        for t, piece in zip(bucket, flat.split([t.numel() for t in bucket])):
            t.copy_(piece.view_as(t))


def replicate(tree: Any, mesh=None) -> Any:
    """Every tensor of `tree` (or a module's parameters and buffers)
    broadcast in place from rank 0, so that every rank holds rank 0's
    values; returns `tree`.  The mesh must span the world."""
    if mesh is not None and mesh.mesh.numel() != dist.get_world_size():
        raise ValueError("replicate needs a mesh over the whole world")
    items = (list(tree.parameters()) + list(tree.buffers())
             if isinstance(tree, nn.Module) else list(_tensors(tree)))
    with torch.no_grad():
        coalesced(lambda flat: dist.broadcast(flat, src=0),
                  [t.data for t in items])
    return tree


# ---------------------------------------------------------------------------
# Sharding plans (the JAX rules, in torch's layout)
# ---------------------------------------------------------------------------

def _flax_shape(t: torch.Tensor, perm) -> Tuple[int, ...]:
    return tuple(t.shape) if perm is None else tuple(t.shape[d] for d in perm)


def _fsdp_dim(t: torch.Tensor, perm, n: int, min_size: Optional[int]
              ) -> Optional[int]:
    """The JAX FSDP rule: the largest flax dimension n divides (the first
    of equals), as a torch dimension; None below `min_size` (default
    FSDP_MIN_SIZE) elements or where no dimension divides."""
    if t.numel() < (FSDP_MIN_SIZE if min_size is None else min_size):
        return None
    shape = _flax_shape(t, perm)
    for d in sorted(range(len(shape)), key=lambda d: -shape[d]):
        if shape[d] % n == 0:
            return d if perm is None else perm[d]
    return None


def fsdp_param_sharding(module: nn.Module, n: int,
                        min_size: Optional[int] = None
                        ) -> Dict[str, Optional[int]]:
    """{parameter name: the torch dimension its masters are split on over
    n data ranks, or None (replicated)}: `fsdp_param_sharding` of the
    JAX package applied to the module's flax layout (`min_size` default
    FSDP_MIN_SIZE)."""
    perms = flax_permutations(module)
    return {name: _fsdp_dim(p, perms[name], n, min_size)
            for name, p in module.named_parameters()}


def tp_param_sharding(module: nn.Module, n_model: int,
                      n_data: Optional[int] = None,
                      fsdp_min_size: Optional[int] = None
                      ) -> Dict[str, Placement]:
    """{parameter name: ("model", torch dim) | ("data", torch dim) | None}:
    the JAX `tp_param_sharding` on the module's flax layout.  Kernels of
    `to_q` / `to_k` / `to_v` and `ff.proj` split their output features
    over `model`, those of `to_out` and `ff.out` their input features;
    with `n_data`, every other tensor of at least `fsdp_min_size`
    (default FSDP_MIN_SIZE) elements goes FSDP over `data`.  (As in JAX
    the plan names kernels only; `apply_tensor_parallel` slices the GEGLU
    `proj` bias with its rows.)"""
    perms = flax_permutations(module)
    out: Dict[str, Placement] = {}
    for name, p in module.named_parameters():
        perm = perms[name]
        parts = name.split(".")
        parent = parts[-2] if len(parts) >= 2 else ""
        grandp = parts[-3] if len(parts) >= 3 else ""
        place: Placement = None
        if parts[-1] == "weight" and perm is not None:   # a flax kernel
            shape = _flax_shape(p, perm)
            col = parent in _TP_COL or (parent == "proj" and grandp == "ff")
            row = parent in _TP_ROW or (parent == "out" and grandp == "ff")
            if col and shape[-1] % n_model == 0:
                place = ("model", perm[-1])
            elif row and shape[0] % n_model == 0:
                place = ("model", perm[0])
        if place is None and n_data is not None:
            d = _fsdp_dim(p, perm, n_data, fsdp_min_size)
            place = None if d is None else ("data", d)
        out[name] = place
    return out


# ---------------------------------------------------------------------------
# Tensor parallel modules
# ---------------------------------------------------------------------------

class _CopyToModelParallel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over the model group
    (Megatron's `f`: the replicated input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModelParallel(torch.autograd.Function):
    """All-reduce forward; identity backward (Megatron's `g`: the partial
    sums of a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class ColumnParallelLinear(nn.Module):
    """y_local = x W_local^T + b_local: this rank's output features."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group):
        super().__init__()
        self.group = group
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(_CopyToModelParallel.apply(x, self.group),
                        self.weight, self.bias)


class RowParallelLinear(nn.Module):
    """y = sum over ranks of x_local W_local^T, + b once: the first rank of
    the group adds it in its partial product (as nn.Linear does, so one
    rank computes nn.Linear's bits); the others add b - b, which is zero
    but gives b the same gradient on every rank."""

    def __init__(self, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 group):
        super().__init__()
        self.group = group
        self.first = dist.get_rank(group) == 0
        self.weight = nn.Parameter(weight)
        self.bias = None if bias is None else nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is None or self.first:
            y = F.linear(x, self.weight, self.bias)
        else:
            y = F.linear(x, self.weight) + (self.bias - self.bias.detach())
        return _ReduceFromModelParallel.apply(y, self.group)


def split_blocks(full: torch.Tensor, dim: int, blocks: int, n: int,
                 r: int) -> torch.Tensor:
    """Rank r's piece of `full` along `dim`, which holds `blocks`
    contiguous blocks each split in n (GEGLU's proj: 2 blocks, the hidden
    and the gate halves)."""
    length = full.shape[dim]
    if length % (blocks * n):
        raise ValueError(f"dim {dim} of {tuple(full.shape)} does not split "
                         f"in {blocks} x {n}")
    v = full.unflatten(dim, (blocks, n, length // (blocks * n)))
    return v.select(dim + 1, r).flatten(dim, dim + 1).contiguous()


def join_blocks(pieces: List[torch.Tensor], dim: int,
                blocks: int) -> torch.Tensor:
    """The inverse of `split_blocks` over all ranks' pieces."""
    v = torch.stack([p.unflatten(dim, (blocks, -1)) for p in pieces],
                    dim=dim + 1)
    return v.flatten(dim, dim + 2)


def _tp_blocks(name: str) -> int:
    return 2 if name.endswith("ff.proj.weight") or name.endswith(
        "ff.proj.bias") else 1


def apply_tensor_parallel(module: nn.Module, plan: Mapping[str, Placement],
                          mesh, model_axis: str = "model"
                          ) -> Dict[str, Tuple[int, int]]:
    """Make `module` this rank's tensor-parallel part, in place: every
    linear whose weight the plan puts on `model` becomes a
    `ColumnParallelLinear` / `RowParallelLinear` holding this rank's
    piece (a column-parallel bias sliced with its rows), and each
    `Attention` with sharded projections carries num_heads / n heads.
    Returns {parameter name: (torch dim, blocks)} of every tensor split
    over `model`."""
    from unirenderer_tpu_torch.models.layers import Attention
    group, n, r = mesh_axis(mesh, model_axis)
    layout: Dict[str, Tuple[int, int]] = {}
    for name, place in plan.items():
        if place is None or place[0] != model_axis:
            continue
        owner = name.rsplit(".", 1)[0]
        parent_name, _, leaf = owner.rpartition(".")
        parent = module.get_submodule(parent_name)
        lin = parent.get_submodule(leaf)
        dim = place[1]
        col = dim == 0
        blocks = _tp_blocks(name)
        w = split_blocks(lin.weight.detach(), dim, blocks, n, r)
        bias = lin.bias.detach() if lin.bias is not None else None
        if bias is not None and col:
            bias = split_blocks(bias, 0, blocks, n, r)
            layout[owner + ".bias"] = (0, blocks)
        layout[name] = (dim, blocks)
        cls = ColumnParallelLinear if col else RowParallelLinear
        setattr(parent, leaf, cls(w, bias, group))
        if isinstance(parent, Attention) and leaf == "to_q":
            if parent.num_heads % n:
                raise ValueError(f"{parent_name}: {parent.num_heads} heads "
                                 f"over a model axis of {n}")
            parent.num_heads //= n
    return layout


# ---------------------------------------------------------------------------
# Sharded training state
# ---------------------------------------------------------------------------

class ParamSharding:
    """Where each dual-stream parameter lives on this rank, and the
    collectives of a sharded step: `compute_params` (the tensors to
    compute with: FSDP slices cast to the compute type and all-gathered),
    `reduce_grads` (averaged over `data`; FSDP gradients reduce-scattered
    to the slice), `global_norm`, `mean_metrics` and the gathers and
    slices of checkpoints.  A model axis of one rank applies no tensor
    parallelism (its placements are replicated)."""

    def __init__(self, module: nn.Module, mesh,
                 plan: Optional[Mapping[str, Placement]] = None,
                 data_axis: str = "data", model_axis: str = "model"):
        self.mesh = mesh
        self.data_axis, self.model_axis = data_axis, model_axis
        self.dp_group, self.dp, self.dp_rank = mesh_axis(mesh, data_axis)
        self.mp_group, self.mp, self.mp_rank = mesh_axis(mesh, model_axis)
        plan = dict(plan or {})
        self.names = [n for n, _ in module.named_parameters()]
        # name -> (axis, torch dim, blocks)
        self.layout: Dict[str, Tuple[str, int, int]] = {
            n: (p[0], p[1], 1) for n, p in plan.items()
            if p is not None and p[0] == data_axis}
        if self.mp > 1 and any(p is not None and p[0] == model_axis
                               for p in plan.values()):
            for n, (d, b) in apply_tensor_parallel(module, plan, mesh,
                                                   model_axis).items():
                self.layout[n] = (model_axis, d, b)
        self.module = module
        self.perms = flax_permutations(module)

    # -- where a tensor lives --------------------------------------------
    def _axis(self, axis: str):
        return ((self.dp_group, self.dp, self.dp_rank) if axis ==
                self.data_axis else (self.mp_group, self.mp, self.mp_rank))

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a full tensor of parameter `name` (the
        tensor itself where it is replicated)."""
        if name not in self.layout:
            return full
        axis, dim, blocks = self.layout[name]
        _, n, r = self._axis(axis)
        return split_blocks(full, dim, blocks, n, r)

    def split(self, name: str):
        """The optimizer's view of where parameter `name` lives
        (`train/adafactor.Split`): None where it is whole on this rank, or
        split over an axis of one rank."""
        from unirenderer_tpu_torch.train.adafactor import Split
        if name not in self.layout:
            return None
        axis, dim, blocks = self.layout[name]
        group, n, r = self._axis(axis)
        return None if n == 1 else Split(dim, n, r, group, blocks)

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's piece (a collective over the
        tensor's axis; the tensor itself where it is replicated)."""
        if name not in self.layout:
            return local
        axis, dim, blocks = self.layout[name]
        group, n, _ = self._axis(axis)
        local = local.contiguous()
        pieces = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(pieces, local, group=group)
        return join_blocks(pieces, dim, blocks)

    # -- the step --------------------------------------------------------
    @property
    def contrastive_scale(self) -> float:
        """The weight of this rank's contrastive term in the mean over
        the data ranks: the term pairs the global batch's first two
        samples, which the first data rank holds."""
        return float(self.dp) if self.dp_rank == 0 else 0.0

    def _on_data(self, name: str) -> bool:
        return self.layout.get(name, (None,))[0] == self.data_axis

    def compute_params(self, masters: Mapping[str, torch.Tensor],
                       dtype: Optional[torch.dtype] = None
                       ) -> Dict[str, torch.Tensor]:
        """{name: tensor to differentiate}: the master itself, or for an
        FSDP master the full tensor in `dtype` (default the master's), a
        new leaf: every rank's slice cast into one buffer a bucket, which
        one all-gather makes whole.  The cast commutes with the gather, so
        the step computes what it computes from the full f32 tensor, and
        no full f32 copy is made."""
        names = [n for n in masters if self._on_data(n)]
        out = dict(masters)
        for name, full in zip(names, self._gather_data(
                [masters[n].detach() for n in names], names, dtype)):
            out[name] = full.requires_grad_()
        return out

    def _gather_data(self, pieces: List[torch.Tensor], names: List[str],
                     dtype: Optional[torch.dtype]) -> List[torch.Tensor]:
        """The full tensors (in `dtype`) of this rank's FSDP slices: one
        all-gather a bucket, each tensor written straight from the
        gathered rows into its full layout (channels_last for a 4-D conv
        weight, the port's)."""
        n = self.dp
        out: List[Optional[torch.Tensor]] = [None] * len(pieces)
        for idx in buckets(pieces):
            sizes = [pieces[i].numel() for i in idx]
            flat = torch.empty(sum(sizes), dtype=dtype or pieces[idx[0]].dtype,
                               device=pieces[idx[0]].device)
            for i, part in zip(idx, flat.split(sizes)):
                part.view_as(pieces[i]).copy_(pieces[i])
            rows = flat.new_empty(n * flat.numel())
            _all_gather(rows, flat, group=self.dp_group)
            del flat
            rows = rows.view(n, -1)
            for i, part in zip(idx, rows.split(sizes, dim=1)):
                p, dim = pieces[i], self.layout[names[i]][1]
                shape = list(p.shape)
                shape[dim] *= n
                fmt = (torch.channels_last if p.dim() == 4
                       else torch.contiguous_format)
                full = torch.empty(shape, dtype=rows.dtype,
                                   device=rows.device, memory_format=fmt)
                full.unflatten(dim, (n, -1)).movedim(dim, 0).copy_(
                    part.view(n, *p.shape))
                out[i] = full
        return out

    def _reduce_scatter_data(self, grads: List[torch.Tensor],
                             data: List[int]) -> None:
        """grads[i] for i in `data` (full FSDP gradients) <- their sum
        over the data ranks, this rank's slice only: one reduce-scatter a
        bucket, whose row r holds rank r's slices; each full gradient is
        dropped once its bucket is sent."""
        n = self.dp
        for idx in buckets([grads[i] for i in data]):
            idx = [data[j] for j in idx]
            sizes = [grads[i].numel() // n for i in idx]
            rows = grads[idx[0]].new_empty((n, sum(sizes)))
            shapes = []
            for i, part in zip(idx, rows.split(sizes, dim=1)):
                dim = self.layout[self.names[i]][1]
                src = grads[i].unflatten(dim, (n, -1)).movedim(dim, 0)
                part.view(src.shape).copy_(src)
                shapes.append(src.shape[1:])
                grads[i] = None
            mine = rows.new_empty(sum(sizes))
            _reduce_scatter(mine, rows.view(-1), group=self.dp_group)
            del rows
            for i, piece, shape in zip(idx, mine.split(sizes), shapes):
                grads[i] = piece.view(shape)

    def reduce_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """Gradients of `compute_params`' tensors (in the masters' order)
        -> gradients of the masters, in place in `grads` (returned): the
        mean over the data ranks, an FSDP gradient reduce-scattered to
        this rank's slice (the others all-reduced)."""
        data = [i for i, n in enumerate(self.names) if self._on_data(n)]
        rest = sorted(set(range(len(grads))) - set(data))
        if self.dp > 1 and rest:
            coalesced(lambda flat: dist.all_reduce(flat, group=self.dp_group),
                      [grads[i] for i in rest])
        self._reduce_scatter_data(grads, data)
        if self.dp > 1:
            torch._foreach_div_(grads, float(self.dp))
        return grads

    def global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the full gradients from the masters'
        gradients: each axis's sharded squares summed over its group."""
        sq = {}
        for name, g in zip(self.names, grads):
            axis = self.layout.get(name, (None,))[0]
            sq.setdefault(axis, []).append(g)
        total = torch.zeros((), device=grads[0].device)
        for axis in sorted(sq, key=str):
            part = torch.stack(torch._foreach_norm(sq[axis])).square().sum()
            group, n, _ = self._axis(axis) if axis else (None, 1, 0)
            if n > 1:
                dist.all_reduce(part, group=group)
            total = total + part
        return total.sqrt()

    def mean_metrics(self, metrics: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
        if self.dp == 1:
            return metrics
        keys = sorted(metrics)
        dev = metrics["loss"].device
        v = torch.stack([metrics[k].float().to(dev) for k in keys])
        dist.all_reduce(v, group=self.dp_group)
        return dict(zip(keys, (v / self.dp).unbind(0)))

    # -- full tensors (checkpoints, installs) -----------------------------
    def full_params(self, masters: Mapping[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return {n: self.gather(n, p.detach()) for n, p in masters.items()}

    def load_full_(self, masters: Mapping[str, torch.Tensor],
                   full: Mapping[str, torch.Tensor]) -> None:
        """masters <- this rank's pieces of full tensors (in place)."""
        with torch.no_grad():
            for n, p in masters.items():
                p.copy_(self.local(n, full[n].to(p.device)))

    def _map_optimizer_state(self, sd: Dict, fn) -> Dict:
        """`fn(name, tensor)` applied to each statistic that is cut like
        its parameter (the optimizer's one param group is in the order of
        `names`): AdamW's moments and Adafactor's unfactored `v` (kept in
        the flax layout: cut in the parameter's); Adafactor's `v_row` /
        `v_col` (whole on every rank) and the step counts stay."""
        from unirenderer_tpu_torch.train.adafactor import STATE_LAYOUT
        state = {}
        for i, s in sd["state"].items():
            name = self.names[int(i)]
            perm = self.perms[name]
            state[i] = {}
            for k, v in s.items():
                where = STATE_LAYOUT.get(k, "param")
                if isinstance(v, torch.Tensor) and v.dim() > 0 and \
                        where != "whole":
                    if where == "flax" and perm is not None:
                        inv = sorted(range(len(perm)), key=perm.__getitem__)
                        v = fn(name, v.permute(inv)).permute(
                            perm).contiguous()
                    else:
                        v = fn(name, v)
                state[i][k] = v
        return dict(sd, state=state)

    def full_optimizer_state(self, sd: Dict) -> Dict:
        """An optimizer state dict over the masters with every statistic
        that is cut like its parameter gathered full (a collective)."""
        return self._map_optimizer_state(sd, self.gather)

    def local_optimizer_state(self, sd: Dict, device) -> Dict:
        """The inverse of `full_optimizer_state` on this rank."""
        return self._map_optimizer_state(
            sd, lambda n, v: self.local(n, v.to(device)))

    def train_state(self, cfg, full: Mapping[str, torch.Tensor]):
        """A TrainState whose masters are this rank's pieces of `full`
        (replicated and tensor-parallel masters are the module's own
        parameters; an FSDP master is a parameter of its own, and the
        module keeps a meta-device placeholder in its place)."""
        from unirenderer_tpu_torch.train.train_step import TrainState
        own = dict(self.module.named_parameters())
        masters: Dict[str, nn.Parameter] = {}
        for name in self.names:
            p = own[name]
            if self._on_data(name):
                local = self.local(name, full[name].detach())
                owner, _, leaf = name.rpartition(".")
                mod = self.module.get_submodule(owner)
                mod._parameters[leaf] = nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype, device="meta"),
                    requires_grad=False)
                p = nn.Parameter(local.clone())
            elif p.dtype != torch.float32:
                raise TypeError(f"master parameters must be f32, got "
                                f"{p.dtype}")
            masters[name] = p.requires_grad_(True)
        return TrainState(masters, self.optimizer(cfg, masters),
                          sharding=self)

    def optimizer(self, cfg, masters: Mapping[str, torch.Tensor]):
        """`train_step.make_optimizer` over this rank's masters, each with
        its flax layout and its split (Adafactor's statistics are made
        whole over the split's group)."""
        from unirenderer_tpu_torch.train.train_step import make_optimizer
        return make_optimizer(cfg, masters, self.perms,
                              {n: self.split(n) for n in masters})


def shard_train_state(cfg, dual: nn.Module, mesh,
                      plan: Optional[Mapping[str, Placement]] = None,
                      data_axis: str = "data", model_axis: str = "model"):
    """This rank's TrainState of `dual` under `plan` (`fsdp_param_sharding`
    as {name: ("data", dim)}, `tp_param_sharding`, or None: DP): the
    parameters are first broadcast from rank 0, then tensor parallelism
    is applied to `dual` in place and the masters cut."""
    replicate(dual, mesh)
    full = {n: p.detach() for n, p in dual.named_parameters()}
    sharding = ParamSharding(dual, mesh, plan, data_axis, model_axis)
    return sharding.train_state(cfg, full)


def fsdp_plan(module: nn.Module, n: int,
              axis_name: str = "data") -> Dict[str, Placement]:
    """`fsdp_param_sharding` as a plan over `axis_name`."""
    return {k: None if d is None else (axis_name, d)
            for k, d in fsdp_param_sharding(module, n).items()}


# ---------------------------------------------------------------------------
# Sharded steps
# ---------------------------------------------------------------------------

def slice_draws(draws, sl: slice, n_keys: int):
    """This rank's rows of a step's Draws: `enc_noise` is key-major
    (n_keys x B), every other tensor batch-leading."""
    def cut(name, t):
        if name == "enc_noise":
            return t.unflatten(0, (n_keys, -1))[:, sl].flatten(0, 1)
        return t[sl]
    return dataclasses.replace(draws, **{
        f.name: cut(f.name, getattr(draws, f.name))
        for f in dataclasses.fields(draws)
        if isinstance(getattr(draws, f.name), torch.Tensor)})


def shard_step(train_step: Callable, mesh, axis_name: str = "data",
               replicate_batch: bool = False) -> Callable:
    """Wrap a train step (`make_train_step`, `make_render_train_step`, or
    with `replicate_batch` `make_bank_train_step`) so it takes the global
    draws and the global batch or this rank's rows of it: each rank keeps
    its data slice of the draws and of a global batch (of the scene draws
    with `replicate_batch`; the bank stays whole).  A batch of the global
    size is sliced, one of the global size / ranks is taken as this rank's
    rows.  The state must come from `shard_train_state`."""
    from unirenderer_tpu_torch.train.train_step import BATCH_KEYS
    _, n, r = mesh_axis(mesh, axis_name)

    def rows(t, b, sl):
        if t.shape[0] == b:
            return t[sl]
        if t.shape[0] != b // n:
            raise ValueError(f"a batch of {t.shape[0]} for a global batch "
                             f"of {b} over {n} data ranks")
        return t

    def step(state, ctx, *inputs):
        *data, draws = inputs
        b = draws.t_img.shape[0]
        if b % n:
            raise ValueError(f"global batch {b} over {n} data ranks")
        if n > 1 and b // n < 2:
            raise ValueError("each data rank needs 2 samples or more: the "
                             "contrastive term pairs the global batch's "
                             "first two on the first rank")
        sl = slice(r * b // n, (r + 1) * b // n)
        if replicate_batch:
            bank, scene_draws = data
            data = (bank, dataclasses.replace(scene_draws, **{
                f.name: getattr(scene_draws, f.name)[sl]
                for f in dataclasses.fields(scene_draws)}))
        else:
            data = [{k: rows(v, b, sl) for k, v in data[0].items()}]
        return train_step(state, ctx, *data,
                          slice_draws(draws, sl, len(BATCH_KEYS)))

    return step


def make_sharded_train_step(cfg, dual: nn.Module, train_step: Callable,
                            mesh, axis_name: str = "data",
                            fsdp: bool = False,
                            replicate_batch: bool = False):
    """DP (with `fsdp`, FSDP) over `axis_name` -> (step, state): the step
    takes the global batch (`shard_step`), the state holds this rank's
    masters.  `replicate_batch` for the scene-bank step: the bank stays
    whole on every rank, the drawn scenes are split."""
    _, n, _ = mesh_axis(mesh, axis_name)
    plan = fsdp_plan(dual, n, axis_name) if fsdp else None
    state = shard_train_state(cfg, dual, mesh, plan, data_axis=axis_name)
    return shard_step(train_step, mesh, axis_name, replicate_batch), state


def make_tp_train_step(cfg, dual: nn.Module, train_step: Callable, mesh,
                       data_axis: str = "data", model_axis: str = "model",
                       fsdp: bool = False):
    """Hybrid DP x Megatron TP over a (data, model) mesh -> (step, state):
    the batch split over `data`, the dual stream's attention and GEGLU
    linears over `model` (`tp_param_sharding`), and with `fsdp` the rest
    FSDP over `data`."""
    _, nd, _ = mesh_axis(mesh, data_axis)
    _, nm, _ = mesh_axis(mesh, model_axis)
    plan = tp_param_sharding(dual, nm, nd if fsdp else None)
    state = shard_train_state(cfg, dual, mesh, plan, data_axis, model_axis)
    return shard_step(train_step, mesh, data_axis), state


# ---------------------------------------------------------------------------
# Sharded serving
# ---------------------------------------------------------------------------

class _BatchSplit:
    """A module whose every call runs on this rank's slice of the batch:
    tensor arguments with the call's batch (the first tensor argument's
    leading size) are sliced over the data ranks, and tensor outputs are
    all-gathered back; a batch the ranks do not divide runs whole."""

    def __init__(self, module: nn.Module, group, n: int, r: int):
        self._module, self._group, self._n, self._r = module, group, n, r

    def _run(self, fn, args, kwargs):
        first = next(_tensors((args, kwargs)), None)
        b = None if first is None or first.dim() == 0 else first.shape[0]
        if b is None or self._n == 1 or b % self._n:
            return fn(*args, **kwargs)
        per = b // self._n
        sl = slice(self._r * per, (self._r + 1) * per)

        def cut(t):
            return t[sl] if t.dim() and t.shape[0] == b else t

        def join(t):
            if not (t.dim() and t.shape[0] == per):
                return t
            t = t.contiguous()
            pieces = [torch.empty_like(t) for _ in range(self._n)]
            dist.all_gather(pieces, t, group=self._group)
            return torch.cat(pieces)

        out = fn(*map_tensors(cut, args), **map_tensors(cut, kwargs))
        return map_tensors(join, out)

    def __call__(self, *args, **kwargs):
        return self._run(self._module, args, kwargs)

    def __getattr__(self, name):
        attr = getattr(self._module, name)
        if callable(attr) and not isinstance(attr, nn.Module):
            return lambda *a, **k: self._run(attr, a, k)
        return attr


def shard_pipeline(pipe, mesh, axis_name: str = "data",
                   model_axis: str = "model"):
    """Prepare a UniRendererPipeline for serving over the ranks (in place)
    and return `shard_call(method, **kwargs)`.  Every rank makes the same
    call with the whole request; the parameters are broadcast from rank
    0; each model call (dual stream and VAE) runs on this rank's slice of
    the request's batch over `axis_name` and its outputs are gathered, so
    every rank returns the whole result (the sampler's elementwise steps
    run on every rank).  On a 2-D mesh the dual stream is also
    tensor-parallel over `model_axis` (`tp_param_sharding`).

        shard_call = shard_pipeline(pipe, make_mesh())          # DP
        shard_call = shard_pipeline(pipe, make_mesh_2d(2, 2))   # DP x TP
        out = shard_call(pipe.mask2image_3mod_albedo, normal=..., ...)
    """
    for m in (pipe.dual, pipe.vae, pipe.text):
        replicate(m, mesh)
    group, n, r = mesh_axis(mesh, axis_name)
    _, nm, _ = mesh_axis(mesh, model_axis)
    if nm > 1:
        apply_tensor_parallel(pipe.dual, tp_param_sharding(pipe.dual, nm),
                              mesh, model_axis)
    pipe.dual = _BatchSplit(pipe.dual, group, n, r)
    pipe.vae = _BatchSplit(pipe.vae, group, n, r)

    def shard_call(method, **kwargs):
        return method(**kwargs)

    return shard_call
