"""Tensor parallelism over the model group: the JAX package's sharding rules
and the megatron operators that carry them out on the port (counterpart of
mmnas_tpu/parallel/sharding.py).

The JAX package places its params on a (data, model) mesh and lets GSPMD
partition the matmuls. Its rules (`_spec_for_path`, sharding.py:23-40)
split, over the model axis:

- by output columns: 2-d leaves under `wq`, `wk`, `wv` and any path that
  holds `mlp/fc`;
- by input rows: `wm` and any path that holds `mlp/linear`;

and replicate everything else. What they hit in the nets: every attention
op's four projections, AttFlat's `mlp` pair and `feed_forward_deep`'s
inner `mlp` pair. The `feed_forward` op's own `core/fc`, `core/linear`
stay replicated (the rules' text, not their module docstring, decides), as
do the RSA head projection `wr`, the stems, `attflat_*/merge` and `proj`.

The port runs one process per card, so each model rank holds its shard of
the split leaves (`shard_module` slices a full-width net in place, after
its seeded init) and runs its share of the split layers:

- an attention op of H heads runs H / M heads (those of its block of
  `wq`/`wk`/`wv` columns) through the fused kernels, its RSA bias with
  rows [h0, h0 + H / M) of the replicated `wr`, and draws the unsplit
  op's dropout masks for its heads; `wm`'s rows of its block give a
  partial output that `reduce_from_model` sums (the megatron `g`);
- an `mlp` pair runs its block of fc's columns (the bias's block of the
  replicated fc bias), ReLU and dropout on the hidden shard (the unsplit
  mask's columns) and linear's rows of its block; the partial output is
  summed by `g`, then linear's replicated bias added;
- the replicated inputs of a split layer (the activations, and replicated
  leaves of which a rank uses a block: fc's bias, `wr`, the relation
  stem's W1 and b1) enter through `copy_to_model` (the megatron `f`:
  identity forward, their gradients summed over the model group
  backward), so every replicated leaf ends the backward with its whole
  gradient on every model rank;
- an attention op whose heads the model axis does not divide (the JAX
  package accepts it) runs whole on every model rank: `gather_from_model`
  assembles its four projections for the step, and each rank keeps its
  block of their gradients.

With M = 1 nothing here runs: the modules' `tp` is None and their forward
is the unsplit one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import torch

from mmnas_tpu_torch.parallel import mesh as pmesh


# ------------------------------------------------------------------ rules
def jax_path(name: str) -> str:
    """A port parameter's name -> its leaf's path in the JAX pytree, as
    `_spec_for_path` joins it ('dec.0.1.0.core.wq.weight' ->
    'dec/0/1/0/core/wq/w'; the embedding is a bare array)."""
    if name == "embedding.weight":
        return "embedding"
    *head, last = name.split(".")
    return "/".join(head + [{"weight": "w", "bias": "b"}.get(last, last)])


def spec_for_path(path: str, ndim: int) -> Optional[int]:
    """The JAX rules (mmnas_tpu/parallel/sharding.py:23-40) on a leaf's
    path and ndim: the dim of the JAX leaf ([in, out] for a Linear) split
    over the model axis, 1 (columns) or 0 (rows), or None (replicated)."""
    if ndim != 2:
        return None
    if any(f"/{w}/" in path or path.endswith(f"/{w}/w") for w in ("wv", "wk", "wq")):
        return 1
    if "/wm/" in path or path.endswith("/wm/w"):
        return 0
    if "mlp/fc" in path:
        return 1
    if "mlp/linear" in path:
        return 0
    return None


def split_dim(name: str, ndim: int) -> Optional[int]:
    """The dim of the port's parameter `name` (torch's [out, in] Linear
    layout) that the rules split, or None."""
    dim = spec_for_path(jax_path(name), ndim)
    return None if dim is None else 1 - dim


@dataclass(frozen=True)
class Shard:
    """Model rank `rank` of `size`."""
    rank: int
    size: int

    def block(self, n: int) -> slice:
        """This rank's contiguous block of n (the JAX package's even split)."""
        if n % self.size:
            raise ValueError(f"width {n} does not split over model axis {self.size}")
        w = n // self.size
        return slice(self.rank * w, (self.rank + 1) * w)


def shard_module(net: torch.nn.Module, rank: Optional[int] = None,
                 size: Optional[int] = None) -> torch.nn.Module:
    """Slice a full-width net, in place, to model rank `rank` of `size`
    (default: this process's place in the grid). Each submodule with a
    `shard_model(shard)` method whose leaves the rules split takes its
    blocks and returns the names of the leaves it split; a split leaf that
    no such module takes raises. Records `net.tp_split` (parameter name ->
    split dim, torch layout) and `net.tp` (the Shard). At size 1 the net is
    returned as it is."""
    rank = pmesh.model_rank() if rank is None else rank
    size = pmesh.model_axis_size() if size is None else size
    if size == 1:
        return net
    dims = {n: d for n, p in net.named_parameters()
            if (d := split_dim(n, p.dim())) is not None}
    shard, taken = Shard(rank, size), set()
    for prefix, m in net.named_modules():
        pre = prefix + "." if prefix else ""
        if hasattr(m, "shard_model") and any(pre + n in dims for n in m.SPLIT):
            taken.update(pre + n for n in m.shard_model(shard))
    if taken != set(dims):
        raise NotImplementedError(f"the rules split {sorted(set(dims) - taken)}, which no "
                                  "module runs split")
    net.tp_split, net.tp = dims, shard
    return net


def split_of(net: torch.nn.Module) -> Dict[str, int]:
    """The sharded net's split leaves (name -> torch dim); {} unsharded."""
    return getattr(net, "tp_split", {})


def split_flags(net: torch.nn.Module, names: Sequence[str]) -> Optional[List[bool]]:
    """Which of `names` are split leaves, for the clip's norm; None for an
    unsharded net (the clip's single-process path)."""
    split = split_of(net)
    return [n in split for n in names] if split else None


def slice_named(values: Mapping[str, torch.Tensor], split: Mapping[str, int],
                shard: Shard) -> Dict[str, torch.Tensor]:
    """Full-width tensors by parameter name -> this rank's (split leaves
    sliced along their dim; others as they are)."""
    out = {}
    for n, t in values.items():
        if n in split and isinstance(t, torch.Tensor):
            block = shard.block(t.shape[split[n]])
            t = t.narrow(split[n], block.start, block.stop - block.start).contiguous()
        out[n] = t
    return out


def gather_named(values: Mapping[str, torch.Tensor], split: Mapping[str, int]
                 ) -> Dict[str, torch.Tensor]:
    """This rank's tensors by parameter name -> the full-width ones (the
    split leaves gathered over the model group, in order). Collective:
    every model rank calls it with the same names."""
    if not split:
        return dict(values)
    return {n: torch.cat(pmesh.model_all_gather(t), dim=split[n])
            if n in split and isinstance(t, torch.Tensor) else t for n, t in values.items()}


# -------------------------------------------------------- megatron operators
class _CopyToModel(torch.autograd.Function):
    """f: the tensors as they are; backward, their gradients summed over the
    model group in one all-reduce."""

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        live = [i for i, g in enumerate(grads) if g is not None]
        if not live:
            return grads
        flat = pmesh.model_all_reduce(torch.cat([grads[i].reshape(-1).float() for i in live]))
        out, offset = list(grads), 0
        for i in live:
            n = grads[i].numel()
            out[i] = flat[offset:offset + n].view(grads[i].shape).to(grads[i].dtype)
            offset += n
        return tuple(out)


class _ReduceFromModel(torch.autograd.Function):
    """g: the sum over the model group of the ranks' partial outputs;
    backward, the gradient as it is."""

    @staticmethod
    def forward(ctx, x):
        return pmesh.model_all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _GatherFromModel(torch.autograd.Function):
    """A split leaf made whole: the model ranks' blocks concatenated along
    `dim`; backward, this rank's block of the gradient (every rank computed
    the whole one)."""

    @staticmethod
    def forward(ctx, t, dim):
        ctx.dim, ctx.n = dim, t.shape[dim]
        ctx.rank = pmesh.model_rank()
        return torch.cat(pmesh.model_all_gather(t), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None


def copy_to_model(*tensors):
    """The megatron f on `tensors` (a tuple of the same tensors). Those
    that need no gradient pass as they are: through the Function every
    output would need one (the arch step would then run the relation pass
    for W1, which it does not differentiate)."""
    live = [i for i, t in enumerate(tensors) if t.requires_grad]
    if not live or not torch.is_grad_enabled():
        return tensors
    outs = _CopyToModel.apply(*(tensors[i] for i in live))
    outs = (outs,) if isinstance(outs, torch.Tensor) else outs
    got = list(tensors)
    for i, o in zip(live, outs):
        got[i] = o
    return tuple(got)


def reduce_from_model(x):
    """The megatron g: the sum of the model ranks' partial `x`."""
    return _ReduceFromModel.apply(x)


def gather_from_model(t, dim: int):
    """The whole leaf from the model ranks' blocks of it along `dim`."""
    return _GatherFromModel.apply(t, dim)
