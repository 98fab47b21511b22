"""Weights between the JAX param pytree and the port's modules.

The JAX package stores a Linear as {'w': [in, out], 'b': [out]} (the
gated-linear units' too, [in, 2 out]), a Conv1d as {'w': [out, in / groups,
k], 'b': [out]} (torch's layout already), the reference LayerNorm as
{'a', 'b'}, the LSTM as {'w_ih': [in, 4H], 'w_hh': [H, 4H], 'b_ih',
'b_hh'}, the embedding as a bare [V, E] array, and cells as nested lists.
The port's modules carry the same names, with Linear and LSTM weights
transposed to torch's [out, in] and conv weights as they are. Every JAX leaf is
consumed exactly once: a leaf that fits no rule raises here, and a missing
or extra one raises in `load_state_dict(strict=True)`.

The optimizer state goes through the same per-leaf rules: its params-shaped
trees (Adam's moments "m", "v" and per-leaf step counts "t", SGD's "v")
become dicts keyed by parameter name, the moments transposed like their
parameters, the 0-d step counts as ints; its scalars ("step", "lr_base",
"epoch") stay scalars.

The search's architecture weights are a bare {"enc": [n, C], "dec": [n, C]}
pair of arrays in both packages; `alpha_from_jax`/`alpha_to_jax` move them
and their Adam state (the same "m", "v", "t", "step", "lr_base" over those
two leaves).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from mmnas_tpu_torch.ops.primitives import LSTM, Conv1d, LayerNorm

_LSTM_KEYS = {"w_ih", "w_hh", "b_ih", "b_hh"}


def _t(x, transpose: bool = False) -> torch.Tensor:
    a = np.asarray(x)
    return torch.tensor(a.T if transpose else a)           # a copy, contiguous; 0-d stays 0-d


def from_jax_params(tree) -> "OrderedDict[str, torch.Tensor]":
    """JAX param pytree (of numpy arrays) -> state_dict for the port. A tree
    of 0-d leaves in the params' structure (the optimizer's step counts)
    maps name by name, with nothing to transpose."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk(node: Any, prefix: str) -> None:
        if isinstance(node, (list, tuple)):
            for i, child in enumerate(node):
                walk(child, f"{prefix}{i}.")
        elif isinstance(node, dict):
            keys = set(node)
            if keys == {"a", "b"}:                                # LayerNorm
                sd[prefix + "a"] = _t(node["a"])
                sd[prefix + "b"] = _t(node["b"])
            elif "w" in keys and keys <= {"w", "b"}:              # Linear or Conv1d
                if np.ndim(node["w"]) not in (0, 2, 3):
                    raise ValueError(f"{prefix}w: expected a 2-d Linear or 3-d Conv1d weight, "
                                     f"got shape {np.shape(node['w'])}")
                sd[prefix + "weight"] = _t(node["w"], transpose=np.ndim(node["w"]) == 2)
                if "b" in node:
                    sd[prefix + "bias"] = _t(node["b"])
            elif keys == _LSTM_KEYS:                              # LSTM
                sd[prefix + "w_ih"] = _t(node["w_ih"], transpose=True)
                sd[prefix + "w_hh"] = _t(node["w_hh"], transpose=True)
                sd[prefix + "b_ih"] = _t(node["b_ih"])
                sd[prefix + "b_hh"] = _t(node["b_hh"])
            else:
                for name, child in node.items():
                    walk(child, f"{prefix}{name}.")
        elif prefix == "embedding.":
            sd["embedding.weight"] = _t(node)
        else:
            raise ValueError(f"JAX leaf '{prefix[:-1]}' has no place in the port")

    walk(tree, "")
    return sd


def to_jax_params(module: nn.Module, values: Optional[Mapping[str, Any]] = None) -> Dict:
    """The port's module -> JAX param pytree of fp32 numpy arrays, the
    inverse of `from_jax_params`. With `values` (parameter name -> tensor or
    int), the tree holds those values in place of the parameters: tensors
    as fp32 arrays transposed like their parameters, ints as 0-d int32."""

    def arr(name: str, p: torch.Tensor, transpose: bool = False) -> np.ndarray:
        x = p if values is None else values[name]
        if not isinstance(x, torch.Tensor):
            return np.asarray(x, np.int32)
        a = x.detach().to("cpu", torch.float32).numpy()
        return np.ascontiguousarray(a.T if transpose else a)

    def walk(m: nn.Module, prefix: str):
        if isinstance(m, nn.Linear):
            out = {"w": arr(prefix + "weight", m.weight, transpose=True)}
            if m.bias is not None:
                out["b"] = arr(prefix + "bias", m.bias)
            return out
        if isinstance(m, Conv1d):
            return {"w": arr(prefix + "weight", m.weight), "b": arr(prefix + "bias", m.bias)}
        if isinstance(m, LayerNorm):
            return {"a": arr(prefix + "a", m.a), "b": arr(prefix + "b", m.b)}
        if isinstance(m, LSTM):
            return {"w_ih": arr(prefix + "w_ih", m.w_ih, True),
                    "w_hh": arr(prefix + "w_hh", m.w_hh, True),
                    "b_ih": arr(prefix + "b_ih", m.b_ih), "b_hh": arr(prefix + "b_hh", m.b_hh)}
        if isinstance(m, nn.Embedding):
            return arr(prefix + "weight", m.weight)
        if isinstance(m, nn.ModuleList):
            return [walk(c, f"{prefix}{i}.") for i, c in enumerate(m)]
        own = list(m.named_parameters(recurse=False))
        if own:
            raise ValueError(f"{type(m).__name__} holds parameters "
                             f"{[n for n, _ in own]} with no JAX counterpart")
        return {name: walk(c, f"{prefix}{name}.") for name, c in m.named_children()}

    return walk(module, "")


def optim_state_from_jax(state: Mapping[str, Any], device=None) -> Dict:
    """The JAX optimizer state pytree (WarmupAdam or MomentumSGD, numpy
    leaves) -> the port's optimizer state, tensors on `device`."""
    out = {}
    for key, val in state.items():
        if isinstance(val, (dict, list, tuple)):
            sd = from_jax_params(val)
            out[key] = {n: (int(t) if t.dim() == 0 and not t.is_floating_point()
                            else t.to(device)) for n, t in sd.items()}
        elif np.issubdtype(np.asarray(val).dtype, np.integer):
            out[key] = int(val)
        else:
            out[key] = np.float32(val)
    return out


def optim_state_to_jax(state: Mapping[str, Any], module: nn.Module) -> Dict:
    """The port's optimizer state -> the JAX package's pytree (fp32 numpy
    moments in the params' layout, int32 step counts, fp32 lr), the inverse
    of `optim_state_from_jax`."""
    out = {}
    for key, val in state.items():
        if isinstance(val, dict):
            out[key] = to_jax_params(module, values=val)
        elif isinstance(val, (int, np.integer)):
            out[key] = np.asarray(val, np.int32)
        else:
            out[key] = np.asarray(val, np.float32)
    return out


def alpha_from_jax(alpha: Mapping[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """{"enc": [n, C], "dec": [n, C]} numpy -> fp32 tensors on `device`."""
    return {c: torch.tensor(np.asarray(a, np.float32), device=device) for c, a in alpha.items()}


def alpha_to_jax(alpha: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of `alpha_from_jax`: fp32 numpy arrays."""
    return {c: a.detach().to("cpu", torch.float32).numpy() for c, a in alpha.items()}


def alpha_optim_state_from_jax(state: Mapping[str, Any], device=None) -> Dict:
    """The JAX package's alpha Adam state -> the port's WarmupAdam state over
    the alpha dict."""
    return {"m": alpha_from_jax(state["m"], device), "v": alpha_from_jax(state["v"], device),
            "t": {c: int(t) for c, t in state["t"].items()}, "step": int(state["step"]),
            "lr_base": np.float32(state["lr_base"])}


def alpha_optim_state_to_jax(state: Mapping[str, Any]) -> Dict:
    """The inverse of `alpha_optim_state_from_jax` (int32 step counts, fp32
    lr, as the JAX package's state holds them)."""
    return {"m": alpha_to_jax(state["m"]), "v": alpha_to_jax(state["v"]),
            "t": {c: np.asarray(t, np.int32) for c, t in state["t"].items()},
            "step": np.asarray(state["step"], np.int32),
            "lr_base": np.asarray(state["lr_base"], np.float32)}
