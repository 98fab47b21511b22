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
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmnas_tpu_torch.ops import primitives as P
from mmnas_tpu_torch.ops.attention import rsa_log_bias, scaled_dot_attention
from mmnas_tpu_torch.parallel.sharding import (
    copy_to_model, gather_from_model, reduce_from_model,
)


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
    """Projections `wv`, `wk`, `wq` [hsize -> inside], `wm` [inside -> hsize]
    (no bias), inside = hsize * hsize_k (hsize without hsize_k), in heads of
    `base`; `wr` [REL_SIZE -> heads] for the relation op.

    Split over the model group (parallel/sharding.py), a rank holds its
    block of wv/wk/wq's output columns and of wm's input rows: H / M heads,
    run through the kernels with `wr`'s rows of those heads, the partial
    outputs summed over the group. When M does not divide the heads the op
    runs whole on every rank, on the projections gathered for the step."""

    SPLIT = ("wv.weight", "wk.weight", "wq.weight", "wm.weight")
    tp = None           # the model rank's Shard once split

    def __init__(self, cfg: OpCfg, base: int, with_rel: bool = False,
                 hsize_k: Optional[float] = None):
        super().__init__()
        inside = int(cfg.hsize * hsize_k) if hsize_k else cfg.hsize
        if inside % base:
            raise ValueError(f"inner width {inside} is not a multiple of head size {base}")
        self.n_heads = inside // base
        self.dropout_r = cfg.dropout_r
        self.wv = nn.Linear(cfg.hsize, inside, bias=False)
        self.wk = nn.Linear(cfg.hsize, inside, bias=False)
        self.wq = nn.Linear(cfg.hsize, inside, bias=False)
        self.wm = nn.Linear(inside, cfg.hsize, bias=False)
        if with_rel:
            self.wr = nn.Linear(cfg.rel_size, self.n_heads)

    def shard_model(self, shard) -> tuple:
        """Keep this model rank's block of the projections (wv, wk, wq by
        output columns, wm by input rows); returns the split leaves."""
        block = shard.block(self.wq.weight.shape[0])
        for lin in (self.wv, self.wk, self.wq):
            lin.weight = nn.Parameter(lin.weight.detach()[block].clone())
        self.wm.weight = nn.Parameter(self.wm.weight.detach()[:, block].clone())
        self.tp = shard
        return self.SPLIT

    def attend(self, v, k, q, mask, train, generator, rel=None):
        if self.tp is not None:
            if self.n_heads % self.tp.size:
                return self.attend_whole(v, k, q, mask, train, generator, rel)
            return self.attend_split(v, k, q, mask, train, generator, rel)
        vh = _split_heads(self.wv(v), self.n_heads)
        kh = _split_heads(self.wk(k), self.n_heads)
        qh = _split_heads(self.wq(q), self.n_heads)
        atted = scaled_dot_attention(qh, kh, vh, mask, rel=rel, dropout_r=self.dropout_r,
                                     train=train, generator=generator)
        return self.wm(_merge_heads(atted))

    def attend_split(self, v, k, q, mask, train, generator, rel=None):
        """This model rank's heads, their partial output summed over the
        group. The replicated inputs (each distinct activation once, and
        the relation chain's W1, b1, wr, br, of which the rank uses wr's
        rows) pass the megatron f, so their gradients are summed."""
        heads = self.n_heads // self.tp.size
        h0 = self.tp.rank * heads
        distinct = list({id(t): t for t in (v, k, q)}.values())
        chain = () if rel is None else tuple(rel[1:]) + ((rel[0],) if rel[0].requires_grad
                                                        else ())
        copied = copy_to_model(*distinct, *chain)
        by_id = {id(t): c for t, c in zip(distinct, copied)}
        v, k, q = by_id[id(v)], by_id[id(k)], by_id[id(q)]
        if rel is not None:
            w1, b1, wr, br = copied[len(distinct):len(distinct) + 4]
            raw = copied[-1] if rel[0].requires_grad else rel[0]
            rel = (raw, w1, b1, wr[h0:h0 + heads], br[h0:h0 + heads])
        vh = _split_heads(self.wv(v), heads)
        kh = _split_heads(self.wk(k), heads)
        qh = _split_heads(self.wq(q), heads)
        atted = scaled_dot_attention(qh, kh, vh, mask, rel=rel, dropout_r=self.dropout_r,
                                     train=train, generator=generator,
                                     heads=(h0, self.n_heads))
        return reduce_from_model(self.wm(_merge_heads(atted)))

    def attend_whole(self, v, k, q, mask, train, generator, rel=None):
        """Every head on every model rank, with the projections gathered
        from the ranks' blocks (each rank keeps its block's gradient)."""
        wv, wk, wq = (gather_from_model(lin.weight, 0) for lin in (self.wv, self.wk, self.wq))
        wm = gather_from_model(self.wm.weight, 1)
        vh = _split_heads(F.linear(v, wv), self.n_heads)
        kh = _split_heads(F.linear(k, wk), self.n_heads)
        qh = _split_heads(F.linear(q, wq), self.n_heads)
        atted = scaled_dot_attention(qh, kh, vh, mask, rel=rel, dropout_r=self.dropout_r,
                                     train=train, generator=generator)
        return F.linear(_merge_heads(atted), wm)


class SelfAtt(MHAtt):
    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return self.attend(x, x, x, x_mask, train, generator)


class RelSelfAtt(MHAtt):
    """Self-attention with the geometry bias; the whole chain from the raw
    relation tensor runs inside the attention kernel (modules.py:179-215,
    dict path)."""

    def __init__(self, cfg: OpCfg, base: int, hsize_k: Optional[float] = None):
        super().__init__(cfg, base, with_rel=True, hsize_k=hsize_k)

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        fused = (rel["raw"], rel["w1"], rel["b1"], self.wr.weight, self.wr.bias)
        return self.attend(x, x, x, x_mask, train, generator, rel=fused)


class GuidedAtt(MHAtt):
    """Cross-attention x <- y: mhatt(v=y, k=y, q=x, mask=y_mask)
    (modules.py:331-336)."""

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return self.attend(y, y, x, y_mask, train, generator)


class UniimgAtt(MHAtt):
    """x attends over concat(x, y) with no mask, as in the reference
    (modules.py:417-418)."""

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        xy = torch.cat((x, y), dim=1)
        return self.attend(xy, xy, x, None, train, generator)


def unified_att_node(ops, idx, s, pre, s_mask, pre_mask, rel, train: bool = False,
                     generator: Optional[torch.Generator] = None):
    """The decoder's attention candidates (self_att_64, rel_self_att_64,
    guided_att_64: `ops[:3]`, the first three ops of a dec_safe node) as one
    program for the switch-free weight step (mmnas_tpu/ops/modules.py:231-306).

    `idx` is the node's sampled index, a 0-d integer tensor on the device
    (3 = feed_forward, selected by the caller); nothing here reads it on the
    host, so one code path serves every index:

    - the three candidates' wv, wk, wq, wm and LayerNorms are stacked and
      indexed at min(idx, 2);
    - `kv = cat(s, pre)` is projected once by cat(wv, wk), q from s, and the
      key mask [B,1,1,Ls+Lt] is `s_mask | is_guided` over the image keys and
      `pre_mask | ~is_guided` over the text keys (self and rel attend to s,
      guided to pre; a masked key's probability is exactly 0);
    - the RSA bias of the rel candidate's wr over the image keys is computed
      outside the kernel (`rsa_log_bias`, recomputed in the backward under
      `torch.utils.checkpoint`), multiplied by `is_rel`, and padded with
      zeros over the text keys: a dense log_bias [B,H,Ls,Ls+Lt];
    - the attention is `scaled_dot_attention` (the kernels on the card: the
      forward or the dropout forward, and the backward with dbias), then the
      gathered wm, dropout, the residual and the gathered LayerNorm.

    Indexing a stack scatters zero gradients into the unsampled candidates'
    slices, and the zero-gated bias gives wr none unless rel is sampled.

    Split over the model group, the stacks hold the rank's blocks of the
    candidates' projections; s, pre and the relation chain's W1, b1, wr, br
    enter through `copy_to_model`, the rank runs its heads (wr's rows of
    them, the whole call's dropout masks) and `reduce_from_model` sums the
    partial outputs, as `MHAtt.attend_split`; when the model axis does not
    divide the heads every rank runs them all on the gathered projections,
    as `MHAtt.attend_whole`."""
    cands = list(ops[:3])
    if any(op.ln is None or not op.residual for op in cands):
        raise ValueError("the unified node needs the candidates' LayerNorm and residual "
                         "(OPS_NORM and OPS_RESIDUAL)")
    core = cands[1].core
    weights = {k: [getattr(op.core, k).weight for op in cands] for k in ("wv", "wk", "wq", "wm")}
    w1, b1, wr, br = rel["w1"], rel["b1"], core.wr.weight, core.wr.bias
    s_in, pre_in, heads, split = s, pre, core.n_heads, None
    if core.tp is not None and core.n_heads % core.tp.size:
        weights = {k: [gather_from_model(t, 1 if k == "wm" else 0) for t in ts]
                   for k, ts in weights.items()}
    elif core.tp is not None:
        heads = core.n_heads // core.tp.size
        split = (core.tp.rank * heads, core.n_heads)
        s_in, pre_in, w1, b1, wr, br = copy_to_model(s, pre, w1, b1, wr, br)
        wr, br = wr[split[0]:split[0] + heads], br[split[0]:split[0] + heads]
    sel = torch.clamp(idx, max=2).reshape(1)
    is_rel, is_guided = idx == 1, idx == 2

    def gather(tensors):
        return torch.index_select(torch.stack(tensors), 0, sel)[0]

    w = {k: gather(ts) for k, ts in weights.items()}
    vv, kk = F.linear(torch.cat((s_in, pre_in), dim=1),
                      torch.cat((w["wv"], w["wk"]), dim=0)).chunk(2, dim=-1)
    qq = F.linear(s_in, w["wq"])
    mask = torch.cat((s_mask | is_guided, pre_mask | ~is_guided), dim=-1).contiguous()
    chain = (rel["raw"].detach(), w1, b1, wr, br)
    if torch.is_grad_enabled() and any(t.requires_grad for t in chain):
        bias = checkpoint(rsa_log_bias, *chain, use_reentrant=False, preserve_rng_state=False)
    else:
        bias = rsa_log_bias(*chain)
    bias = bias.to(s.dtype) * is_rel.to(s.dtype)
    # the chain's [B,Lq,Lk,H] layout, permuted, survives the product and the pad
    log_bias = F.pad(bias, (0, pre.shape[1])).contiguous()
    atted = scaled_dot_attention(_split_heads(qq, heads), _split_heads(kk, heads),
                                 _split_heads(vv, heads), mask, log_bias,
                                 dropout_r=core.dropout_r, train=train, generator=generator,
                                 heads=split)
    out = F.linear(_merge_heads(atted), w["wm"])
    if split is not None:
        out = reduce_from_model(out)
    out = P.dropout(out, cands[1].dropout_r, train, generator)
    return P.layernorm(s + out, gather([op.ln.a for op in cands]),
                       gather([op.ln.b for op in cands]), cands[1].ln.eps)


# ---------------------------------------------------------------------------
# feed-forward, gated-linear and convolution cores (modules.py:122-155, :431-491)
# ---------------------------------------------------------------------------

class FeedForward(P.MLP):
    """MLP hsize -> hsize * mid_k (4 without mid_k) -> hsize."""

    def __init__(self, cfg: OpCfg, mid_k: Optional[int] = None):
        mid = cfg.hsize * mid_k if mid_k else cfg.hsize * 4
        super().__init__(cfg.hsize, mid, cfg.hsize, cfg.dropout_r, True)

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return super().forward(x, train, generator)


class FeedForwardDeep(nn.Module):
    """fc (linear + relu + dropout) hsize -> 2 hsize, then an MLP 2 hsize ->
    2 hsize -> hsize; params `fc`, `mlp`."""

    def __init__(self, cfg: OpCfg):
        super().__init__()
        mid = cfg.hsize * 2
        self.dropout_r = cfg.dropout_r
        self.fc = nn.Linear(cfg.hsize, mid)
        self.mlp = P.MLP(mid, mid, cfg.hsize, cfg.dropout_r, True)

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        h = P.fc(self.fc, x, self.dropout_r, True, train, generator)
        return self.mlp(h, train, generator)


def gated_linear(linear: nn.Linear, x):
    """a * sigmoid(b) for (a, b) the halves of linear(x) (modules.py:122-130)."""
    a, b = linear(x).chunk(2, dim=-1)
    return a * torch.sigmoid(b)


class GLU(nn.Module):
    """One gated-linear unit hsize -> hsize (`unit`), or two (`unit_0`
    hsize -> 2 hsize, relu and dropout, `unit_1` 2 hsize -> hsize); each
    unit's Linear has twice its output width (modules.py:133-155)."""

    def __init__(self, cfg: OpCfg, layers: int):
        super().__init__()
        if layers not in (1, 2):
            raise ValueError(f"gated_linear takes 1 or 2 layers, got {layers}")
        self.layers = layers
        self.dropout_r = cfg.dropout_r
        h = cfg.hsize
        if layers == 1:
            self.unit = nn.Linear(h, 2 * h)
        else:
            self.unit_0 = nn.Linear(h, 4 * h)
            self.unit_1 = nn.Linear(2 * h, 2 * h)

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        if self.layers == 1:
            return gated_linear(self.unit, x)
        h = torch.relu(gated_linear(self.unit_0, x))
        h = P.dropout(h, self.dropout_r, train, generator)
        return gated_linear(self.unit_1, h)


class SepConv(nn.Module):
    """Depthwise Conv1d of width k, then pointwise (modules.py:431-462);
    params `dw`, `pw`."""

    def __init__(self, cfg: OpCfg, k: int):
        super().__init__()
        self.dw = P.Conv1d(cfg.hsize, cfg.hsize, k, groups=cfg.hsize)
        self.pw = P.Conv1d(cfg.hsize, cfg.hsize, 1)

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return self.pw(self.dw(x))


class StdConv(nn.Module):
    """One Conv1d of width k (modules.py:465-491); param `conv`."""

    def __init__(self, cfg: OpCfg, k: int):
        super().__init__()
        self.conv = P.Conv1d(cfg.hsize, cfg.hsize, k)

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return self.conv(x)


# ---------------------------------------------------------------------------
# parameter-free ops, with no residual/norm wrapper (modules.py:92-119)
# ---------------------------------------------------------------------------

class Zero(nn.Module):
    """'none' op: x * 0, with no residual/norm wrapper (modules.py:445-450)."""

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return x * 0.0


class Elementwise(nn.Module):
    """skip_connect, relu, gelu (tanh form) or leakyrelu (slope 0.01) of x."""

    FNS = {"skip_connect": lambda x: x, "relu": torch.relu, "gelu": P.gelu_tanh,
           "leakyrelu": lambda x: torch.nn.functional.leaky_relu(x, 0.01)}

    def __init__(self, name: str):
        super().__init__()
        self.fn = self.FNS[name]

    def forward(self, x, y, x_mask, y_mask, rel, train=False, generator=None):
        return self.fn(x)


# ---------------------------------------------------------------------------
# candidate-op factories (cfg, norm, residual, **kw) -> module
# ---------------------------------------------------------------------------

def self_att(cfg: OpCfg, norm: bool, residual: bool, base: int = 64,
             hsize_k: Optional[float] = None) -> Op:
    return Op(cfg, SelfAtt(cfg, base, hsize_k=hsize_k), norm, residual)


def rel_self_att(cfg: OpCfg, norm: bool, residual: bool, base: int = 64,
                 hsize_k: Optional[float] = None) -> Op:
    return Op(cfg, RelSelfAtt(cfg, base, hsize_k=hsize_k), norm, residual)


def guided_att(cfg: OpCfg, norm: bool, residual: bool, base: int = 64,
               hsize_k: Optional[float] = None) -> Op:
    return Op(cfg, GuidedAtt(cfg, base, hsize_k=hsize_k), norm, residual)


def uniimg_att(cfg: OpCfg, norm: bool, residual: bool, base: int = 64,
               hsize_k: Optional[float] = None) -> Op:
    return Op(cfg, UniimgAtt(cfg, base, hsize_k=hsize_k), norm, residual)


def feed_forward(cfg: OpCfg, norm: bool, residual: bool, mid_k: Optional[int] = None) -> Op:
    return Op(cfg, FeedForward(cfg, mid_k), norm, residual)


def feed_forward_deep(cfg: OpCfg, norm: bool, residual: bool) -> Op:
    return Op(cfg, FeedForwardDeep(cfg), norm, residual)


def glu(cfg: OpCfg, norm: bool, residual: bool, layers: int = 1) -> Op:
    return Op(cfg, GLU(cfg, layers), norm, residual)


def sep_conv(cfg: OpCfg, norm: bool, residual: bool, k: int = 3) -> Op:
    return Op(cfg, SepConv(cfg, k), norm, residual)


def std_conv(cfg: OpCfg, norm: bool, residual: bool, k: int = 3) -> Op:
    return Op(cfg, StdConv(cfg, k), norm, residual)


def zero(cfg: OpCfg, norm: bool, residual: bool) -> Zero:
    return Zero()


def elementwise(cfg: OpCfg, norm: bool, residual: bool, name: str = "skip_connect"
                ) -> Elementwise:
    return Elementwise(name)


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
