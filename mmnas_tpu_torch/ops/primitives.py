"""Low-level building blocks shared by every ported op (counterpart of
mmnas_tpu/ops/primitives.py).

Linear layers are `torch.nn.Linear`, weights stored torch-style [out, in].
Parameter initialization follows the JAX package's distributions (the
reference framework's PyTorch defaults) and is drawn from an explicit
`torch.Generator` by `init_parameters`.

Every random draw of an op (`dropout`'s keep masks here, the fused
attention's kernel keys and CPU masks in ops/fused_attention.py) goes
through `keep_mask` or `draw_key`, so that `remat` can hand a
rematerialized op's recompute the draws of its first pass.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmnas_tpu_torch.parallel.sharding import copy_to_model, reduce_from_model

MASK_FILL = -1e9


# ---------------------------------------------------------------------------
# layer norm (reference modules.py:44-56)
# ---------------------------------------------------------------------------

def layernorm(x, a, b, eps: float = 1e-6):
    """a*(x-mean)/(std+eps)+b with the *unbiased* std and eps added to the
    std, not the variance. Statistics in fp32; result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    n = x.shape[-1]
    var = ((xf - mean) ** 2).sum(dim=-1, keepdim=True) / max(n - 1, 1)
    out = a.float() * (xf - mean) / (var.sqrt() + eps) + b.float()
    return out.to(x.dtype)


class LayerNorm(nn.Module):
    """The reference LayerNorm (not `nn.LayerNorm`); params `a`, `b`."""

    def __init__(self, size: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a = nn.Parameter(torch.ones(size))
        self.b = nn.Parameter(torch.zeros(size))

    def forward(self, x):
        return layernorm(x, self.a, self.b, self.eps)


# ---------------------------------------------------------------------------
# dropout, FC / MLP (reference modules.py:13-41)
# ---------------------------------------------------------------------------

def dropout(x, rate: float, train: bool, generator: Optional[torch.Generator] = None,
            cols=None):
    """Inverted dropout (torch semantics). No-op when eval or rate == 0.
    The keep mask is drawn from `generator`, which lives on x's device (a
    CPU generator cannot draw a CUDA tensor). cols: (block, width) when x
    holds the columns `block` of a `width`-wide activation (a model rank's
    hidden shard): the whole activation's mask is drawn and its columns
    taken, so the shard drops what the unsplit layer drops."""
    if not train or rate <= 0.0:
        return x
    if generator is not None and generator.device.type != x.device.type:
        raise ValueError(f"dropout of a {x.device.type} tensor needs a generator on that "
                         f"device, got one on {generator.device}")
    keep = 1.0 - rate
    shape = x.shape if cols is None else (*x.shape[:-1], cols[1])
    mask = keep_mask(shape, keep, generator, x.device)
    if cols is not None:
        mask = mask[..., cols[0]]
    return torch.where(mask, x / keep, torch.zeros_like(x))


def keep_mask(shape, keep: float, generator, device):
    """A bool keep mask of `shape`: uniforms from `generator` below `keep`
    (or the next draw a `DrawTape` hands back)."""
    if isinstance(generator, DrawTape):
        return generator.draw(lambda g: keep_mask(shape, keep, g, device))
    return torch.rand(shape, generator=generator, device=device) < keep


def draw_key(generator, device):
    """A 64-bit key for the attention kernel's Philox generator, drawn from
    `generator` by a PyTorch op on `device` (int64 [1]), so that a CUDA
    graph that captures the draw draws a new key in each replay (or the next
    draw a `DrawTape` hands back)."""
    if isinstance(generator, DrawTape):
        return generator.draw(lambda g: draw_key(g, device))
    return torch.randint(-2**63, 2**63 - 1, (1,), dtype=torch.int64, generator=generator,
                         device=device)


class DrawTape:
    """Stands in for a generator in one rematerialized op: in the first
    pass it draws from `generator` and keeps each draw (a keep mask, one
    byte an element, or a kernel key), in the recompute it hands them back
    in the same order. `remat` uses it under CUDA-graph capture, where a
    generator's state cannot be read: its offset then advances inside the
    graph, and `get_state` returns the state from before the capture."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.draws = []
        self.replay = None      # position of the next draw handed back, in the recompute

    @property
    def device(self):
        return self.generator.device

    def draw(self, fn):
        if self.replay is None:
            out = fn(self.generator)
            self.draws.append(out)
            return out
        out = self.draws[self.replay]
        self.replay += 1
        return out


def _capturing(generator: torch.Generator) -> bool:
    return generator.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def remat(fn, generator: Optional[torch.Generator], *args):
    """`fn(*args, generator)` under `torch.utils.checkpoint`: its
    activations are freed after the forward and recomputed in the backward
    (the JAX package's `jax.checkpoint` of a candidate op under REMAT,
    mmnas_tpu/models/supernet.py:216-242). The recompute draws the first
    pass's dropout masks, as the JAX closure replays the same fold keys, and
    `generator` is left where one pass leaves it:

    - eagerly, the first pass draws from `generator` and the recompute from
      a generator of its own set to `generator`'s state at entry;
    - under CUDA-graph capture, where that state cannot be read, through a
      `DrawTape`: the first pass's draws are kept and handed back.

    So the op's output, the gradients and the generator's state are those
    of the op run once without checkpointing."""
    if generator is None:
        return checkpoint(fn, *args, None, use_reentrant=False, preserve_rng_state=False)
    tape = DrawTape(generator) if _capturing(generator) else None
    state = generator.get_state() if tape is None else None
    passes = 0

    def run(*a):
        nonlocal passes
        passes += 1
        if tape is not None:
            tape.replay = None if passes == 1 else 0
            return fn(*a, tape)
        if passes == 1:
            return fn(*a, generator)
        own = torch.Generator(generator.device)
        own.set_state(state)
        return fn(*a, own)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)


def fc(linear: nn.Linear, x, dropout_r: float, use_relu: bool, train: bool,
       generator: Optional[torch.Generator] = None):
    x = linear(x)
    if use_relu:
        x = torch.relu(x)
    return dropout(x, dropout_r, train, generator)


class MLP(nn.Module):
    """fc (linear + relu + dropout) -> linear; params `fc`, `linear`.

    Named `mlp` in a net, the pair is split over the model group
    (parallel/sharding.py): fc by output columns, linear by input rows."""

    SPLIT = ("fc.weight", "linear.weight")
    tp = None           # the model rank's Shard once split

    def __init__(self, in_size: int, mid_size: int, out_size: int,
                 dropout_r: float = 0.0, use_relu: bool = True):
        super().__init__()
        self.fc = nn.Linear(in_size, mid_size)
        self.linear = nn.Linear(mid_size, out_size)
        self.dropout_r = dropout_r
        self.use_relu = use_relu

    def shard_model(self, shard) -> tuple:
        """Keep this model rank's block of fc's output columns and of
        linear's input rows (the biases stay whole); returns the split
        leaves."""
        cols = shard.block(self.fc.weight.shape[0])
        self.fc.weight = nn.Parameter(self.fc.weight.detach()[cols].clone())
        self.linear.weight = nn.Parameter(self.linear.weight.detach()[:, cols].clone())
        self.tp = shard
        return self.SPLIT

    def forward(self, x, train: bool = False, generator: Optional[torch.Generator] = None):
        if self.tp is None:
            return self.linear(fc(self.fc, x, self.dropout_r, self.use_relu, train, generator))
        # this rank's hidden columns: fc's block with its block of the
        # replicated bias, then linear's rows, summed over the model group
        # before linear's bias
        width = self.fc.weight.shape[0] * self.tp.size
        cols = self.tp.block(width)
        x, bias = copy_to_model(x, self.fc.bias)
        h = F.linear(x, self.fc.weight, bias[cols])
        if self.use_relu:
            h = torch.relu(h)
        h = dropout(h, self.dropout_r, train, generator, cols=(cols, width))
        return reduce_from_model(F.linear(h, self.linear.weight)) + self.linear.bias


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

def make_mask(feature):
    """Boolean pad mask [B, 1, 1, L], True where the feature row is all
    zero (reference full_vqa.py:113-114)."""
    return (feature.abs().sum(dim=-1) == 0)[:, None, None, :]


def mask_scores(scores, mask):
    """masked_fill(mask, -1e9) (reference modules.py:195)."""
    if mask is None:
        return scores
    return scores.masked_fill(mask, MASK_FILL)


# ---------------------------------------------------------------------------
# GELU (tanh approximation, reference modules.py:104-109)
# ---------------------------------------------------------------------------

def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


# ---------------------------------------------------------------------------
# 1-D convolutions (reference modules.py:431-491)
# ---------------------------------------------------------------------------

def conv1d(x, weight, bias, groups: int = 1):
    """x [B, L, C_in] -> [B, L, C_out], stride 1, padding k // 2; weight in
    the JAX package's (and torch's) layout [out, in / groups, k]."""
    k = weight.shape[-1]
    y = F.conv1d(x.transpose(1, 2), weight, bias, padding=k // 2, groups=groups)
    return y.transpose(1, 2)


class Conv1d(nn.Module):
    """Params `weight` [out, in / groups, k] and `bias` [out] (the JAX
    package's {'w', 'b'})."""

    def __init__(self, in_ch: int, out_ch: int, k: int, groups: int = 1):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch // groups, k))
        self.bias = nn.Parameter(torch.empty(out_ch))

    def forward(self, x):
        return conv1d(x, self.weight, self.bias, self.groups)


# ---------------------------------------------------------------------------
# LSTM (1 layer, batch_first; reference full_vqa.py:63-68)
# ---------------------------------------------------------------------------

def lstm(x, w_ih, w_hh, b_ih, b_hh):
    """x [B, L, D] -> outputs [B, L, H] with h0 = c0 = 0, gate order
    i, f, g, o. The input projection for all steps is one matmul; the loop
    carries only the [B, H] recurrent product. Padding tokens run through
    the recurrence like any other (no packing), as in the JAX package."""
    hsize = w_hh.shape[1]
    x_proj = F.linear(x, w_ih, b_ih)                   # [B, L, 4H]
    h = x.new_zeros(x.shape[0], hsize)
    c = x.new_zeros(x.shape[0], hsize)
    ys = []
    for t in range(x.shape[1]):
        gates = x_proj[:, t] + F.linear(h, w_hh, b_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1)


class LSTM(nn.Module):
    """Params `w_ih` [4H, in], `w_hh` [4H, H], `b_ih`, `b_hh` [4H]."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.w_ih = nn.Parameter(torch.empty(4 * hidden_size, input_size))
        self.w_hh = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        self.b_ih = nn.Parameter(torch.empty(4 * hidden_size))
        self.b_hh = nn.Parameter(torch.empty(4 * hidden_size))

    def forward(self, x):
        return lstm(x, self.w_ih, self.w_hh, self.b_ih, self.b_hh)


# ---------------------------------------------------------------------------
# initialization (mmnas_tpu/ops/primitives.py:29-47, :131-142, :164-178)
# ---------------------------------------------------------------------------

@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module` from `generator`:
    Linear weight and bias U(-1/sqrt(in), 1/sqrt(in)); LSTM all
    U(-1/sqrt(H), 1/sqrt(H)); Conv1d weight kaiming normal
    N(0, 2 / fan_in), bias zeros; LayerNorm ones/zeros; Embedding N(0, 1)."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / math.sqrt(m.in_features)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, LSTM):
            bound = 1.0 / math.sqrt(m.w_hh.shape[1])
            for p in (m.w_ih, m.w_hh, m.b_ih, m.b_hh):
                p.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, Conv1d):
            fan_in = m.weight.shape[1] * m.weight.shape[2]
            m.weight.normal_(0.0, math.sqrt(2.0 / fan_in), generator=generator)
            m.bias.zero_()
        elif isinstance(m, LayerNorm):
            m.a.fill_(1.0)
            m.b.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(generator=generator)
