"""Checkpoint save/load in the JAX package's pickle format.

A checkpoint is `{state_dict, net_optim, epoch}` with pytrees of numpy
arrays, pickled (mmnas_tpu/train/checkpoint.py:53-83). The port reads and
writes exactly that, so the two packages read each other's checkpoints:
models/convert.py turns the `state_dict` tree into the port's modules and
the `net_optim` tree into the port's optimizer state, and back. The orbax
backend is not ported.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict


def save_checkpoint(path: str, state: Dict) -> None:
    """Pickle `state` to `path`, atomically (tmp file + rename)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(state, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict:
    if path.endswith(".orbax") or path.endswith(".orbax/"):
        raise NotImplementedError("orbax checkpoints are not ported; save with "
                                  "--CKPT_BACKEND pickle")
    with open(path, "rb") as f:
        return pickle.load(f)


def ckpt_path(ckpt_root: str, version: str, epoch: int) -> str:
    """Reference naming: <root><version>_epoch<N>.pkl (train_vqa.py:321;
    mmnas_tpu/train/checkpoint.py:86 with the pickle backend)."""
    return os.path.join(ckpt_root, f"{version}_epoch{epoch}.pkl")
