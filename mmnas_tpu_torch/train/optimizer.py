"""Warmup-Adam, plain Adam, momentum SGD and gradient clipping for the port
(counterpart of mmnas_tpu/train/optimizer.py, same semantics).

  - lr(step) = base * (1/4, 2/4, 3/4, 1) over the first three epochs, then
    constant; the step counter increments *before* the rate is computed, so
    step 1 already uses base/4 (reference optimizer.py:12-42).
  - Adam with per-parameter step counts for the bias correction, and an
    optional per-parameter 0/1 mask: a masked-out parameter updates neither
    its moments, nor itself, nor its step count (torch skips parameters
    whose grad is None, which the NAS weight step relies on).
  - State is a plain dict shaped like the JAX package's pytree, with one
    entry per parameter name where the JAX state has a params-shaped tree:
    WarmupAdam {"m", "v", "t", "step", "lr_base"}, MomentumSGD {"v",
    "epoch", "lr_base"}. models/convert.py turns it into that pytree and
    back, so either package resumes from the other's checkpoint.

`step` updates the parameters and the moments in place (no copy of the
50 M-parameter state per step), under `torch.no_grad()`.

`WarmupAdam.step_device` is the same update with no host number that
depends on the step: the mask, the step counts, the bias corrections and
the lr are device tensors, so that a search step captured in a CUDA graph
(engine/search.py, SCAN_STEPS) updates as the host version would on each
replay. Its per-parameter step counts are one fp32 tensor the caller keeps
(`counts_of`, `set_counts`); the state dict keeps the JAX package's host
format. The bias corrections 1 - beta^t come from a table that
`bias_table` computes on the host as `step` does, so on the same gradients
the update is `step`'s, op for op.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from mmnas_tpu_torch.parallel import mesh as pmesh


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        split: Optional[Sequence[bool]] = None,
                        slots: Optional[Tuple[Sequence[int], int]] = None):
    """torch.nn.utils.clip_grad_norm_ semantics (train_vqa.py:310), in place:
    grads *= min(1, max_norm / (norm + 1e-6)). Returns (grads, norm); the
    norm stays a device tensor, so nothing waits for the device.

    split: under tensor parallelism, which grads are a model rank's shard
    of a split leaf (parallel/sharding.py `split_flags`): the norm is then
    the whole gradient's, the squares of the shards summed over the model
    group and the replicated leaves (whole on every rank) counted once.

    slots: (each grad's position, the number of positions): without a
    split, the norm is that of a vector of per-leaf norms with the grads'
    at those positions and 0 elsewhere, so that it rounds as the norm over
    a longer list of grads whose others are 0."""
    if split is None or not any(split):
        norms = torch._foreach_norm(grads)
        if slots is not None:
            at, n = slots
            full = [norms[0].new_zeros(())] * n
            for i, j in enumerate(at):
                full[j] = norms[i]
            norms = full
        norm = torch.linalg.vector_norm(torch.stack(norms))
    else:
        squares = torch.stack(torch._foreach_norm(grads)) ** 2
        is_split = torch.tensor(list(split), device=squares.device)
        sharded = pmesh.model_all_reduce(squares[is_split].sum())
        norm = torch.sqrt(squares[~is_split].sum() + sharded)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    torch._foreach_mul_(grads, scale)
    return grads, norm


def _active(params: Mapping[str, torch.Tensor], mask: Optional[Mapping[str, float]]):
    if mask is None:
        return list(params)
    return [n for n in params if float(mask[n]) > 0]


def _bias_correction(beta: float, t: int) -> float:
    """1 - beta^t in fp32, as the JAX package computes it (at beta 0.999 and
    t 1 it differs from the float64 value by 1.3e-5 relative)."""
    return float(np.float32(1) - np.float32(beta) ** np.float32(t))


class WarmupAdam:
    """Warmup-Adam on named parameters. `epoch_steps` sets the warmup."""

    def __init__(self, lr_base: float, betas=(0.9, 0.98), eps: float = 1e-9,
                 weight_decay: float = 0.0, epoch_steps: int = 1,
                 warmup: bool = True, decay_list=(), decay_r: float = 0.2):
        self.lr_base = lr_base
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.epoch_steps = max(int(epoch_steps), 1)
        self.warmup = warmup
        self.decay_list = tuple(decay_list)
        self.decay_r = decay_r

    def epoch_hook(self, state: Dict, epoch: int) -> Dict:
        """Milestone lr decay at epoch start (train_vqa.py:286-288)."""
        if epoch in self.decay_list:
            return WarmupAdam.decay(state, self.decay_r)
        return state

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        return {
            "m": {n: torch.zeros_like(p) for n, p in params.items()},
            "v": {n: torch.zeros_like(p) for n, p in params.items()},
            "t": {n: 0 for n in params},
            "step": 0,
            "lr_base": np.float32(self.lr_base),
        }

    def rate(self, state: Dict) -> np.float32:
        """lr for the *next* update (pre-incremented step), in fp32."""
        step = state["step"] + 1
        base = np.float32(state["lr_base"])
        if not self.warmup:
            return base
        es = self.epoch_steps
        frac = 0.25 if step <= es else 0.5 if step <= 2 * es else 0.75 if step <= 3 * es else 1.0
        return np.float32(base * np.float32(frac))

    @torch.no_grad()
    def step(self, state: Dict, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor],
             mask: Optional[Mapping[str, float]] = None) -> np.float32:
        """One update of `params` and `state`, in place. mask: optional
        parameter name -> 0/1; 0 freezes that parameter entirely. Returns
        the lr used."""
        lr = self.rate(state)
        names = _active(params, mask)
        for n in names:
            state["t"][n] += 1
        state["step"] += 1
        if not names:
            return lr
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        ms = [state["m"][n] for n in names]
        vs = [state["v"][n] for n in names]
        if self.weight_decay:
            # torch.optim.Adam couples L2 into the gradient before the moments
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        torch._foreach_mul_(ms, self.b1)
        torch._foreach_add_(ms, gs, alpha=1 - self.b1)
        torch._foreach_mul_(vs, self.b2)
        torch._foreach_addcmul_(vs, gs, gs, value=1 - self.b2)
        m_hat = torch._foreach_div(ms, [_bias_correction(self.b1, state["t"][n]) for n in names])
        v_hat = torch._foreach_div(vs, [_bias_correction(self.b2, state["t"][n]) for n in names])
        denom = torch._foreach_sqrt(v_hat)
        torch._foreach_add_(denom, self.eps)
        # p += -lr * (m_hat / denom), one rounding an op, as `step_device`
        # computes it (a fused addcdiv leaves whether its multiply and add
        # round once or twice to each backend's compiler)
        torch._foreach_div_(m_hat, denom)
        torch._foreach_mul_(m_hat, -float(lr))
        torch._foreach_add_(ps, m_hat)
        return lr

    def bias_table(self, n: int) -> np.ndarray:
        """[2, n + 1] fp32: 1 - b1^t and 1 - b2^t for t = 0 .. n, as `step`
        computes them, for `step_device`."""
        return np.asarray([[_bias_correction(b, t) for t in range(n + 1)]
                           for b in (self.b1, self.b2)], np.float32)

    @torch.no_grad()
    def step_device(self, state: Dict, params: Mapping[str, torch.Tensor],
                    grads: Mapping[str, torch.Tensor], names: Sequence[str],
                    counts: torch.Tensor, mask: Optional[torch.Tensor],
                    lr: torch.Tensor, bias: torch.Tensor) -> None:
        """`step` on the parameters `names` with device tensors in place of
        its host numbers: `counts` fp32 [len(names)], their step counts,
        advanced in place; `mask` fp32 0/1 [len(names)] (None: all 1); `lr`
        the rate of this update (fp32, 0-d; the caller takes `rate` ahead
        and advances state["step"]); `bias` the device copy of a
        `bias_table` past the largest count. A masked-out parameter keeps
        its value, its moments and its count. Launches only device work."""
        active = torch.ones_like(counts) if mask is None else mask
        counts.add_(active)
        bc1, bc2 = (row.unbind() for row in bias[:, counts.long()])
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        ms = [state["m"][n] for n in names]
        vs = [state["v"][n] for n in names]
        if self.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        m_new = torch._foreach_mul(ms, self.b1)
        torch._foreach_add_(m_new, gs, alpha=1 - self.b1)
        v_new = torch._foreach_mul(vs, self.b2)
        torch._foreach_addcmul_(v_new, gs, gs, value=1 - self.b2)
        neg_lr = -lr
        keep = (active > 0).unbind()
        for i, (p, m, v) in enumerate(zip(ps, ms, vs)):
            denom = torch.sqrt(v_new[i] / bc2[i]) + self.eps
            p_new = p + (m_new[i] / bc1[i]) / denom * neg_lr
            for old, new in ((m, m_new[i]), (v, v_new[i]), (p, p_new)):
                old.copy_(torch.where(keep[i], new, old))

    @staticmethod
    def counts_of(state: Dict, names: Sequence[str]) -> np.ndarray:
        """The step counts of `names`, fp32, for `step_device`."""
        return np.asarray([state["t"][n] for n in names], np.float32)

    @staticmethod
    def set_counts(state: Dict, names: Sequence[str], counts) -> None:
        """Write `step_device`'s counts (a host array) back into state["t"]."""
        for n, t in zip(names, np.asarray(counts).tolist()):
            state["t"][n] = int(t)

    @staticmethod
    def decay(state: Dict, decay_r: float) -> Dict:
        """Milestone lr decay (optimizer.py:44-45); call between epochs."""
        state = dict(state)
        state["lr_base"] = np.float32(np.float32(state["lr_base"]) * np.float32(decay_r))
        return state

    @staticmethod
    def set_start_step(state: Dict, step: int) -> Dict:
        """Resume support (optimizer.py:47-48)."""
        state = dict(state)
        state["step"] = int(step)
        return state


def plain_adam(lr: float, betas=(0.0, 0.999), eps: float = 1e-8,
               weight_decay: float = 0.0) -> WarmupAdam:
    """torch.optim.Adam equivalent for the arch parameters
    (search_vqa.py:195-196: lr=0.1, betas=(0,0.999), wd=0)."""
    return WarmupAdam(lr, betas=betas, eps=eps, weight_decay=weight_decay,
                      epoch_steps=1, warmup=False)


class MomentumSGD:
    """NET_OPTIM='sgd': torch SGD with momentum + CosineAnnealingLR over
    MAX_EPOCH with eta_min (train_vqa.py:163-170, :265-267)."""

    def __init__(self, lr_base: float, momentum: float = 0.9,
                 weight_decay: float = 0.0, max_epoch: int = 20,
                 eta_min: float = 0.0):
        self.lr_base = lr_base
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.max_epoch = max(int(max_epoch), 1)
        self.eta_min = eta_min

    def init(self, params: Mapping[str, torch.Tensor]) -> Dict:
        return {"v": {n: torch.zeros_like(p) for n, p in params.items()},
                "epoch": 0, "lr_base": np.float32(self.lr_base)}

    def rate(self, state: Dict) -> np.float32:
        """CosineAnnealingLR: eta_min + (base-eta_min)*(1+cos(pi e/E))/2."""
        base = np.float32(state["lr_base"])
        cos = np.float32(math.cos(math.pi * state["epoch"] / self.max_epoch))
        return np.float32(self.eta_min + (base - self.eta_min) * (1.0 + cos) / 2.0)

    @torch.no_grad()
    def step(self, state: Dict, params: Mapping[str, torch.Tensor],
             grads: Mapping[str, torch.Tensor],
             mask: Optional[Mapping[str, float]] = None) -> np.float32:
        lr = self.rate(state)
        names = _active(params, mask)
        if not names:
            return lr
        ps = [params[n] for n in names]
        gs = [grads[n] for n in names]
        vs = [state["v"][n] for n in names]
        if self.weight_decay:
            gs = torch._foreach_add(gs, ps, alpha=self.weight_decay)
        torch._foreach_mul_(vs, self.momentum)           # torch SGD momentum
        torch._foreach_add_(vs, gs)
        torch._foreach_add_(ps, vs, alpha=-float(lr))
        return lr

    @staticmethod
    def next_epoch(state: Dict) -> Dict:
        state = dict(state)
        state["epoch"] = state["epoch"] + 1
        return state

    def epoch_hook(self, state: Dict, epoch: int) -> Dict:
        """lr_scheduler.step() per epoch (train_vqa.py:283-284)."""
        return MomentumSGD.next_epoch(state)


def build_net_optimizer(cfg, epoch_steps: int):
    """NET_OPTIM selection (train_vqa.py:205-221): 'wadam' (default) or the
    SGD + cosine-annealing alternative."""
    if cfg.NET_OPTIM == "sgd":
        return MomentumSGD(cfg.NET_LR_BASE, getattr(cfg, "NET_MOMENTUM", 0.9),
                           cfg.NET_WEIGHT_DECAY, cfg.MAX_EPOCH,
                           getattr(cfg, "NET_LR_MIN", 0.0))
    return WarmupAdam(cfg.NET_LR_BASE, cfg.OPT_BETAS, cfg.OPT_EPS,
                      cfg.NET_WEIGHT_DECAY, epoch_steps,
                      warmup=cfg.NET_OPTIM_WARMUP,
                      decay_list=tuple(cfg.NET_LR_DECAY_LIST),
                      decay_r=cfg.NET_LR_DECAY_R)
