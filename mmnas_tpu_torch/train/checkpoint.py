"""Checkpoint save/load in the JAX package's pickle format.

A checkpoint is `{state_dict, net_optim, epoch}` with pytrees of numpy
arrays, pickled (mmnas_tpu/train/checkpoint.py:53-83). The port reads and
writes exactly that, so the two packages read each other's checkpoints:
models/convert.py turns the `state_dict` tree into the port's modules and
the `net_optim` tree into the port's optimizer state, and back. The orbax
backend is not ported.

Under tensor parallelism (parallel/sharding.py) a checkpoint is still the
JAX package's unsharded pytree: `params_tree` and `optim_tree` gather the
split leaves and their Adam moments over the model group (collective:
every rank calls them), and `load_params` / `load_optim_state` slice a
full checkpoint to the rank's shards, so a checkpoint written at one model
axis resumes at any other, and in either package. Unsharded, they are
`to_jax_params`, `optim_state_to_jax`, `from_jax_params` and
`optim_state_from_jax` themselves.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Mapping

from torch import nn

from mmnas_tpu_torch.models.convert import (
    from_jax_params, optim_state_from_jax, optim_state_to_jax, to_jax_params,
)
from mmnas_tpu_torch.parallel.sharding import gather_named, slice_named, split_of


def save_checkpoint(path: str, state: Dict) -> None:
    """Pickle `state` to `path`, atomically (tmp file + rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    if path.endswith(".orbax") or path.endswith(".orbax/"):
        raise NotImplementedError("orbax checkpoints are not ported (ROADMAP.md, 'Not "
                                  "ported'); save with --CKPT_BACKEND pickle")
    with open(path, "rb") as f:
        return pickle.load(f)


def ckpt_path(ckpt_root: str, version: str, epoch: int) -> str:
    """Reference naming: <root><version>_epoch<N>.pkl (train_vqa.py:321;
    mmnas_tpu/train/checkpoint.py:86 with the pickle backend)."""
    return os.path.join(ckpt_root, f"{version}_epoch{epoch}.pkl")


# ------------------------------------------------------- sharded nets
def params_tree(net: nn.Module) -> Dict:
    """The net's parameters as the JAX package's pytree, the split leaves
    gathered whole (collective over the model group when sharded)."""
    split = split_of(net)
    if not split:
        return to_jax_params(net)
    return to_jax_params(net, gather_named(dict(net.named_parameters()), split))


def optim_tree(state: Mapping, net: nn.Module) -> Dict:
    """The optimizer state as the JAX package's pytree, the split leaves'
    moments gathered whole (collective over the model group when
    sharded)."""
    split = split_of(net)
    if split:
        state = {k: gather_named(v, split) if isinstance(v, dict) else v
                 for k, v in state.items()}
    return optim_state_to_jax(state, net)


def load_params(net: nn.Module, tree) -> None:
    """Load the JAX package's param pytree into the net, each split leaf
    sliced to the net's shard."""
    sd = from_jax_params(tree)
    if split_of(net):
        sd = slice_named(sd, split_of(net), net.tp)
    net.load_state_dict(sd, strict=True)


def load_optim_state(net: nn.Module, state: Mapping, device=None) -> Dict:
    """The JAX optimizer state pytree -> the port's state for the net's
    parameters (split leaves' moments sliced to its shard)."""
    out = optim_state_from_jax(state, device)
    split = split_of(net)
    if split:
        out = {k: slice_named(v, split, net.tp) if isinstance(v, dict) else v
               for k, v in out.items()}
    return out
