"""The ported candidate ops (counterpart of mmnas_tpu/ops/modules.py).

Every op is an `nn.Module` called as
`op(x, y, x_mask, y_mask, rel, train=False, generator=None) -> x'`, the
5-ary contract of the reference (modules.py:92): `x` is the stream being
transformed, `y` the other modality, masks are [B,1,1,L] booleans
(True = pad), and `rel` is the relation bundle {'raw', 'w1', 'b1'} from the
stem (raw [B,L,L,Rr] plus the stem's Linear weight and bias).

Residual + LayerNorm placement matches the reference:
    x_att = dropout(core(x)); x = x + x_att (if residual); x = LN(x) (if norm)
Parameter names mirror the JAX pytree ({'core': ..., 'ln': ...}), so
models/convert.py maps one onto the other by name.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from mmnas_tpu_torch.ops import primitives as P
from mmnas_tpu_torch.ops.attention import scaled_dot_attention


@dataclass(frozen=True)
class OpCfg:
    """Static op-level hyperparameters (subset of the reference `__C`)."""
    hsize: int = 512
    dropout_r: float = 0.1
    rel_size: int = 64
    attflat_glimpses: int = 1
    attflat_out_size: int = 1024
    attflat_mlp_size: int = 512


class Op(nn.Module):
    """dropout -> residual -> LayerNorm around a core (modules.py:47-63)."""

    def __init__(self, cfg: OpCfg, core: nn.Module, norm: bool, residual: bool):
        super().__init__()
        self.core = core
        self.ln = P.LayerNorm(cfg.hsize) if norm else None
        self.dropout_r = cfg.dropout_r
        self.residual = residual

    def forward(self, x, y, x_mask, y_mask, rel, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x_att = self.core(x, y, x_mask, y_mask, rel, train, generator)
        x_att = P.dropout(x_att, self.dropout_r, train, generator)
        out = x + x_att if self.residual else x_att
        return self.ln(out) if self.ln is not None else out


# ---------------------------------------------------------------------------
# multi-head attention cores (reference modules.py:158-245)
# ---------------------------------------------------------------------------

def _split_heads(t, n_heads):
    B, L, C = t.shape
    return t.view(B, L, n_heads, C // n_heads).transpose(1, 2).contiguous()


def _merge_heads(t):
    B, H, L, D = t.shape
    return t.transpose(1, 2).reshape(B, L, H * D)


class MHAtt(nn.Module):
    """Projections `wv`, `wk`, `wq`, `wm` (no bias); `wr` [REL_SIZE -> heads]
    for the relation op."""

    def __init__(self, cfg: OpCfg, base: int, with_rel: bool = False):
        super().__init__()
        if cfg.hsize % base:
            raise ValueError(f"hsize {cfg.hsize} is not a multiple of head size {base}")
        self.n_heads = cfg.hsize // base
        self.dropout_r = cfg.dropout_r
        self.wv = nn.Linear(cfg.hsize, cfg.hsize, bias=False)
        self.wk = nn.Linear(cfg.hsize, cfg.hsize, bias=False)
        self.wq = nn.Linear(cfg.hsize, cfg.hsize, bias=False)
        self.wm = nn.Linear(cfg.hsize, cfg.hsize, bias=False)
        if with_rel:
            self.wr = nn.Linear(cfg.rel_size, self.n_heads)

    def attend(self, v, k, q, mask, train, generator, rel=None):
        vh = _split_heads(self.wv(v), self.n_heads)
        kh = _split_heads(self.wk(k), self.n_heads)
        qh = _split_heads(self.wq(q), self.n_heads)
        atted = scaled_dot_attention(qh, kh, vh, mask, rel=rel, dropout_r=self.dropout_r,
                                     train=train, generator=generator)
        return self.wm(_merge_heads(atted))


class SelfAtt(MHAtt):
    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return self.attend(x, x, x, x_mask, train, generator)


class RelSelfAtt(MHAtt):
    """Self-attention with the geometry bias; the whole chain from the raw
    relation tensor runs inside the attention kernel (modules.py:179-215,
    dict path)."""

    def __init__(self, cfg: OpCfg, base: int):
        super().__init__(cfg, base, with_rel=True)

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        fused = (rel["raw"], rel["w1"], rel["b1"], self.wr.weight, self.wr.bias)
        return self.attend(x, x, x, x_mask, train, generator, rel=fused)


class GuidedAtt(MHAtt):
    """Cross-attention x <- y: mhatt(v=y, k=y, q=x, mask=y_mask)
    (modules.py:331-336)."""

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return self.attend(y, y, x, y_mask, train, generator)


class FeedForward(P.MLP):
    def __init__(self, cfg: OpCfg):
        super().__init__(cfg.hsize, cfg.hsize * 4, cfg.hsize, cfg.dropout_r, True)

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return super().forward(x, train, generator)


class Zero(nn.Module):
    """'none' op: x * 0, with no residual/norm wrapper (modules.py:445-450)."""

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return x * 0.0


# ---------------------------------------------------------------------------
# candidate-op factories (cfg, norm, residual) -> Op
# ---------------------------------------------------------------------------

def self_att(cfg: OpCfg, norm: bool, residual: bool, base: int = 64) -> Op:
    return Op(cfg, SelfAtt(cfg, base), norm, residual)


def rel_self_att(cfg: OpCfg, norm: bool, residual: bool, base: int = 64) -> Op:
    return Op(cfg, RelSelfAtt(cfg, base), norm, residual)


def guided_att(cfg: OpCfg, norm: bool, residual: bool, base: int = 64) -> Op:
    return Op(cfg, GuidedAtt(cfg, base), norm, residual)


def feed_forward(cfg: OpCfg, norm: bool, residual: bool) -> Op:
    return Op(cfg, FeedForward(cfg), norm, residual)


def zero(cfg: OpCfg, norm: bool, residual: bool) -> Zero:
    return Zero()


# ---------------------------------------------------------------------------
# AttFlat head (reference modules.py:59-85), not a candidate op
# ---------------------------------------------------------------------------

class AttFlat(nn.Module):
    """Attention pooling over L: [B, L, H] -> [B, ATTFLAT_OUT_SIZE]."""

    def __init__(self, cfg: OpCfg):
        super().__init__()
        self.mlp = P.MLP(cfg.hsize, cfg.attflat_mlp_size, cfg.attflat_glimpses, cfg.dropout_r)
        self.merge = nn.Linear(cfg.hsize * cfg.attflat_glimpses, cfg.attflat_out_size)

    def forward(self, x, x_mask, train: bool = False,
                generator: Optional[torch.Generator] = None):
        att = self.mlp(x, train, generator)                   # [B, L, G]
        if x_mask is not None:
            att = P.mask_scores(att, x_mask[:, 0, 0, :, None])
        att = torch.softmax(att, dim=1)
        x_atted = torch.einsum("blg,blh->bgh", att, x)     # glimpse-weighted sums
        return self.merge(x_atted.reshape(x.shape[0], -1))
