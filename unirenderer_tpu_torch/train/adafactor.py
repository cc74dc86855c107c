"""Adafactor as optax computes it (`optax.adafactor(lr,
clipping_threshold=1.0, weight_decay_rate=wd)`, the JAX package's
`optimizer="adafactor"`), written out in PyTorch.

Per parameter, in order: factored second moments with the step-dependent
decay 1 - (t + 1)^-0.8 (`scale_by_factored_rms`), the update clipped to
an RMS of at most `clipping_threshold` (`clip_by_block_rms`), times the
learning rate, times the parameter's RMS floored at 1e-3
(`scale_by_param_block_rms`), plus `weight_decay_rate` x the parameter
(`add_decayed_weights`, after the learning rate: the decay is absolute),
subtracted from the parameter.

optax factors the two largest dimensions of a parameter's *flax* shape,
and not at all when the second largest is under `min_dim_size_to_factor`
or the parameter is 1-D (then it keeps a full second moment `v`).  The
port's conv and linear weights are transposed against flax's, so each
parameter carries the permutation to its flax layout
(`core/convert.flax_permutations`): the factored statistics are reduced
on that view and kept in the flax layout, and the elementwise work runs
as foreach operations over chunks of parameters in their own layout.

Over several ranks a parameter may be held as this rank's piece of it
(`Split`: FSDP's slice of one dimension, Megatron's rows or columns, in
`split_blocks`' block order for the 2-block GEGLU `proj`), and the
optimizer computes on the pieces what it computes on the full tensors,
up to the order of float sums:

  * the factoring (which dimensions, or none) is decided on the *full*
    flax shape: a piece may sort its dimensions otherwise;
  * `v_row` and `v_col` are kept whole on every rank (they are O(rows +
    cols)).  A mean over the split dimension is a local sum, summed over
    the group and divided by the full extent; a mean over another
    dimension gives this rank's slice of the statistic, placed in a
    zero tensor of the whole's shape and summed over the group.  The
    update then takes this rank's slice of the row and column factors;
  * an unfactored `v` has the parameter's shape and is cut like it;
  * the RMS of the update (the clip) and of the parameter (its scale) are
    norms over the whole tensor: the squared local norms are summed over
    the group and divided by the full element count.

The sums run as one coalesced all-reduce a process group a chunk for the
statistics and the parameters' norms, and one for the updates' norms.
Every rank must hold its parameters in the same order at the same local
sizes (the chunks, and so the collectives, are the same on all of them).
A parameter that is not split, or split in one piece, takes the
single-process path with no collective.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from unirenderer_tpu_torch.parallel.mesh import coalesced, split_blocks

Perm = Optional[Tuple[int, ...]]

# where each statistic lives for a split parameter, for code that gathers
# or cuts optimizer state with its parameter: "whole" on every rank,
# "flax" this rank's piece in the flax layout.  A statistic not named here
# (AdamW's) is the parameter's piece in its own layout.
STATE_LAYOUT = {"v": "flax", "v_row": "whole", "v_col": "whole"}


@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter held as this rank's piece: its torch dimension `dim`
    holds `blocks` contiguous blocks, each cut in `n` pieces over the
    process `group` (None: the world); the rank holds piece `rank` of
    each block."""
    dim: int
    n: int
    rank: int
    group: Any = None
    blocks: int = 1

    def flax_dim(self, perm: Perm) -> int:
        return self.dim if perm is None else perm.index(self.dim)


def piece(whole: torch.Tensor, dim: int, split: Split) -> torch.Tensor:
    """This rank's piece of `whole` along `dim`."""
    return split_blocks(whole, dim, split.blocks, split.n, split.rank)


def embed(part: torch.Tensor, dim: int, split: Split) -> torch.Tensor:
    """A tensor of the whole's shape holding `part` (this rank's piece
    along `dim`, as `split_blocks` cuts it) in its place and zeros
    elsewhere."""
    shape = list(part.shape)
    shape[dim] *= split.n
    whole = part.new_zeros(shape)
    whole.unflatten(dim, (split.blocks, split.n, -1)).select(
        dim + 1, split.rank).copy_(part.unflatten(dim, (split.blocks, -1)))
    return whole


def factored_dims(shape: Sequence[int],
                  min_dim_size_to_factor: int = 128
                  ) -> Optional[Tuple[int, int]]:
    """optax `_factored_dims`: (second largest, largest) axes of `shape`
    (numpy's argsort order), or None when not factored."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


# parameters updated together, at most this many elements (a larger one
# alone): the foreach temporaries stay ~1 GiB, not the size of the model
CHUNK_ELEMENTS = 1 << 26


def _flax(t: torch.Tensor, perm: Perm) -> torch.Tensor:
    return t if perm is None else t.permute(perm)


def _torch_layout(t: torch.Tensor, perm: Perm) -> torch.Tensor:
    return t if perm is None else t.permute(tuple(np.argsort(perm)))


def _sum_over_groups(pending: List[Tuple[Split, torch.Tensor]]) -> None:
    """Each tensor <- its sum over its split's group, in place: one
    coalesced all-reduce a group, the groups in the order first met (the
    same on every rank)."""
    groups: Dict[int, Tuple[Any, List[torch.Tensor]]] = {}
    for split, t in pending:
        groups.setdefault(id(split.group), (split.group, []))[1].append(t)
    for group, tensors in groups.values():
        coalesced(lambda flat: dist.all_reduce(flat, group=group), tensors)


class Adafactor(torch.optim.Optimizer):
    """`params`: an iterable of (tensor, flax permutation or None) or
    (tensor, permutation, Split or None): one param group, in the given
    order.  The learning rate is the param group's `lr`, set before every
    step as for AdamW."""

    def __init__(self, params: Iterable[Tuple], lr: float,
                 weight_decay_rate: Optional[float] = None,
                 clipping_threshold: Optional[float] = 1.0,
                 decay_rate: float = 0.8, eps: float = 1e-30,
                 min_dim_size_to_factor: int = 128,
                 multiply_by_parameter_scale: bool = True):
        tensors, layout = [], {}
        for entry in params:
            p, perm, split = (tuple(entry) + (None,))[:3]
            if split is not None and split.n == 1:
                split = None
            tensors.append(p)
            layout[p] = (perm, split)
        defaults = dict(lr=lr, weight_decay_rate=weight_decay_rate,
                        clipping_threshold=clipping_threshold,
                        decay_rate=decay_rate, eps=eps,
                        min_dim_size_to_factor=min_dim_size_to_factor,
                        multiply_by_parameter_scale=(
                            multiply_by_parameter_scale))
        super().__init__(tensors, defaults)
        # parameter -> (flax permutation, Split or None)
        self.layout: Dict[torch.Tensor, Tuple[Perm, Optional[Split]]] = \
            layout

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            chunk, size = [], 0
            for p in group["params"]:
                if p.grad is None:
                    continue
                if chunk and size + p.numel() > CHUNK_ELEMENTS:
                    self._update(chunk, group)
                    chunk, size = [], 0
                chunk.append(p)
                size += p.numel()
            if chunk:
                self._update(chunk, group)
        return None

    def full_shape(self, p: torch.Tensor) -> Tuple[int, ...]:
        """The flax shape of the whole parameter `p` is a piece of."""
        perm, split = self.layout[p]
        shape = list(_flax(p, perm).shape)
        if split is not None:
            shape[split.flax_dim(perm)] *= split.n
        return tuple(shape)

    def _init_state(self, p: torch.Tensor, shape: Tuple[int, ...],
                    dims: Optional[Tuple[int, int]]) -> None:
        state = self.state[p]
        state["step"] = 0
        g = p.grad.new_zeros(())
        if dims is not None:
            d1, d0 = dims
            state["v_row"] = g.new_zeros(np.delete(shape, d0).tolist())
            state["v_col"] = g.new_zeros(np.delete(shape, d1).tolist())
        else:
            state["v"] = g.new_zeros(_flax(p, self.layout[p][0]).shape)

    def _norms(self, tensors: List[torch.Tensor],
               splits: List[Optional[Split]],
               pending: List[Tuple[Split, torch.Tensor]]):
        """The norms of `tensors` (a vector), and a function that makes
        those of split tensors whole once `pending` (where their squared
        local norms go, one tensor a group) has been summed."""
        norms = torch.stack(torch._foreach_norm(tensors))
        by_group: Dict[int, Tuple[Split, List[int]]] = {}
        for i, sp in enumerate(splits):
            if sp is not None:
                by_group.setdefault(id(sp.group), (sp, []))[1].append(i)
        parts = []
        for sp, idx in by_group.values():
            parts.append((idx, norms[idx].square()))
            pending.append((sp, parts[-1][1]))

        def whole() -> torch.Tensor:
            out = norms
            for idx, sq in parts:
                out = out.index_copy(0, torch.tensor(idx, device=out.device),
                                     sq.sqrt())
            return out
        return whole

    def _update(self, params: Sequence[torch.Tensor], group) -> None:
        """One update of some of the group's parameters.  The elementwise
        parts run as foreach operations over all of them, each in its own
        layout; only the factored statistics are reduced one parameter at
        a time, on the flax view."""
        perms = [self.layout[p][0] for p in params]
        splits = [self.layout[p][1] for p in params]
        grads = [p.grad for p in params]
        shapes = [self.full_shape(p) for p in params]
        dims = [factored_dims(s, group["min_dim_size_to_factor"])
                for s in shapes]
        for p, shape, d in zip(params, shapes, dims):
            if not self.state[p]:
                self._init_state(p, shape, d)
        decays, keeps = [], []
        for p in params:
            t = torch.tensor(self.state[p]["step"] + 1, dtype=torch.float32)
            decay_t = 1.0 - t ** (-group["decay_rate"])      # f32, as optax
            decays.append(float(decay_t))
            keeps.append(float(1.0 - decay_t))
        grad_sqr = torch._foreach_mul(grads, grads)
        torch._foreach_add_(grad_sqr, group["eps"])
        updates: List[Optional[torch.Tensor]] = [None] * len(params)
        full = [i for i, d in enumerate(dims) if d is None]
        if full:
            vs = [_torch_layout(self.state[params[i]]["v"], perms[i])
                  for i in full]
            torch._foreach_mul_(vs, [decays[i] for i in full])
            torch._foreach_add_(vs, torch._foreach_mul(
                [grad_sqr[i] for i in full], [keeps[i] for i in full]))
            for i, u in zip(full, torch._foreach_mul(
                    [grads[i] for i in full], torch._foreach_pow(vs, -0.5))):
                updates[i] = u
        # the factored statistics' means over d0 (rows) and d1 (columns):
        # whole where nothing is split; for a split parameter a local sum
        # over the split dimension, or this rank's slice of the whole
        pending: List[Tuple[Split, torch.Tensor]] = []
        means: Dict[int, List[torch.Tensor]] = {}
        for i, d in enumerate(dims):
            if d is None:
                continue
            d1, d0 = d
            sq = _flax(grad_sqr[i], perms[i])
            sp = splits[i]
            s = None if sp is None else sp.flax_dim(perms[i])
            means[i] = []
            for red in (d0, d1):            # v_row's, then v_col's
                if sp is None:
                    m = sq.mean(red)
                elif s == red:
                    m = sq.sum(red)
                else:
                    m = embed(sq.mean(red), s - (s > red), sp)
                if sp is not None:
                    pending.append((sp, m))
                means[i].append(m)
        param_norms = None
        if group["multiply_by_parameter_scale"]:
            param_norms = self._norms(list(params), splits, pending)
        _sum_over_groups(pending)
        for i, (row, col) in means.items():
            d1, d0 = dims[i]
            sp = splits[i]
            s = None if sp is None else sp.flax_dim(perms[i])
            if s == d0:
                row = row / shapes[i][d0]
            if s == d1:
                col = col / shapes[i][d1]
            state = self.state[params[i]]
            v_row = decays[i] * state["v_row"] + keeps[i] * row
            v_col = decays[i] * state["v_col"] + keeps[i] * col
            state["v_row"], state["v_col"] = v_row, v_col
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = v_row.mean(reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            if sp is not None:          # this rank's slice of each factor
                if s != d0:
                    row_factor = piece(row_factor, s - (s > d0), sp)
                if s != d1:
                    col_factor = piece(col_factor, s - (s > d1), sp)
            updates[i] = grads[i] * _torch_layout(
                row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1),
                perms[i])
        # one scale a parameter: the RMS clip, the learning rate and the
        # parameter's RMS floored at 1e-3, over the whole tensor
        sizes = torch.tensor([float(math.prod(s)) for s in shapes],
                             device=params[0].device).sqrt()
        scale = torch.full_like(sizes, group["lr"])
        if group["clipping_threshold"] is not None:
            pending = []
            update_norms = self._norms(updates, splits, pending)
            _sum_over_groups(pending)
            rms = update_norms() / sizes
            scale = scale / torch.clamp(rms / group["clipping_threshold"],
                                        min=1.0)
        if param_norms is not None:
            rms = param_norms() / sizes
            scale = scale * torch.clamp(rms, min=1e-3)
        torch._foreach_mul_(updates, list(scale.unbind()))
        if group["weight_decay_rate"] is not None:
            torch._foreach_add_(updates, torch._foreach_mul(
                params, group["weight_decay_rate"]))
        torch._foreach_sub_(params, updates)
        for p in params:
            self.state[p]["step"] += 1
