"""Scaled-dot-product attention core shared by SA / RSA / GA (counterpart of
mmnas_tpu/ops/attention.py, [B, H, L, D] layout).

Reference semantics (mmnas/model/modules.py:191-199, :233-240):
    scores = q @ k^T / sqrt(d_k)
    scores = scores + log(clamp(rel_bias, min=1e-6))   # RSA only
    scores = masked_fill(mask, -1e9)
    out    = dropout(softmax(scores)) @ v

There is no dispatch knob: every call goes through `fused_attention`, which
runs the CUDA kernels for CUDA tensors and their plain PyTorch versions for
CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from mmnas_tpu_torch.ops.fused_attention import fused_attention, rsa_log_bias

__all__ = ["rsa_log_bias", "scaled_dot_attention"]


def scaled_dot_attention(q, k, v, mask=None, log_bias=None, *, rel=None,
                         dropout_r: float = 0.0, train: bool = False,
                         generator: Optional[torch.Generator] = None, heads=None):
    """q,k,v: [B, H, Lq|Lk, D]; mask: [B, 1, 1, Lk] bool (True = pad);
    log_bias: [B, H, Lq, Lk] additive pre-softmax bias (already logged);
    rel: (raw, W1, b1, Wr, br), the RSA chain computed inside the kernel.
    In train mode the attention weights are dropped at dropout_r, with the
    mask drawn from `generator` (modules.py:197). heads: (head0,
    heads_total) when these H heads are a model rank's share of a call of
    heads_total, whose dropout masks they draw; None outside tensor
    parallelism."""
    rate = dropout_r if train else 0.0
    extra = {} if heads is None else {"head0": heads[0], "heads_total": heads[1]}
    return fused_attention(q, k, v, mask, log_bias, rel=rel, dropout_r=rate,
                           generator=generator, **extra)
