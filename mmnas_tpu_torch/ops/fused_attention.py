"""Fused SA / GA / RSA attention: the CUDA kernels' wrappers, their plain
PyTorch versions, and the autograd Function that ties them together.

Counterpart of mmnas_tpu/ops/pallas_attention.py. Per (batch, head):

    s = q k^T / sqrt(d)  (+ log_bias | + RSA bias from the raw geometry)
                         (+ additive -1e9 pad row)
    a = softmax(s)       (fp32)
    o = (a * keep / (1 - r)) v    (keep: the attention-dropout mask, train only)

The kernels live in `csrc/`, are built with nvcc at first use and are
called through ctypes:

- `fused_attention_fwd` (csrc/fused_attention_fwd.cu): the forward without
  dropout (replaces `_fwd_kernel`, pallas_attention.py:173-213); with the
  RSA chain it computes the chain once per (b, i, j) for each group of up
  to 16 heads and, when the call will be differentiated, writes it out
  ([B,H,Lq,Lk] fp32 `pre`) for the backward;
- `fused_attention_fwd_dropout`: the same kernel drawing the keep mask with
  a counter-based Philox4x32-10 (key: a 64-bit seed that the kernel reads
  from device memory, an int64 [1] tensor drawn by `draw_key` from the
  caller's generator, so a CUDA graph that captures the call draws a new
  mask in each replay; counter: (j // 4, i,
  b*heads_total + head0 + h, 0), word j % 4; head0 0 and heads_total H
  outside tensor parallelism, where a model rank runs heads [head0, head0 +
  H) of heads_total and so draws the unsplit call's masks for them) and
  emitting it as a uint8 [B,H,Lq,Lk] residual (replaces the dropout
  variant, :201-210);
- `fused_attention_bwd` (csrc/fused_attention_bwd.cu): dq, dk, dv, dbias
  and, with the RSA chain (read from the forward's `pre`), dpre = d s / d
  pre (replaces `_bwd_kernel`, :325-467, without its relation reductions);
  when no relation input needs a gradient (the search's arch step) it
  writes no dpre;
- `fused_attention_bwd_rel`: the relation pass, the gradients of W1, b1,
  Wr, br (per-block partials over long element runs, summed in a fixed
  order by a second kernel of the same call), and the raw geometry's
  gradient when asked for (the relation half of `_bwd_kernel`).

The kernels take heads of 16 to 256 (multiples of 16) and, with the RSA
chain, up to 32 heads: every shape the ported ops reach. Past that the
wrapper raises; nothing falls back to the plain version.

`FusedAttentionFn` is the counterpart of the custom VJP (:572-599). Traced
by torch.export (tools/export_serving.py), a call that needs no gradient and
no dropout goes instead through the custom op
`mmnas_tpu_torch::fused_attention_fwd` (`fused_attention_fwd_op`), the
forward kernel as one node of the exported graph; eager calls keep the
Function. Dispatch follows the tensor: a CUDA tensor goes
through the kernels (or raises), a CPU tensor through
`fused_attention_reference`, whose autograd is the plain backward. In bf16
the kernels run their products on tensor cores (fp32 accumulation), in
fp32 as register-tiled FMAs (no TF32). The kernels add the -1e9 pad row to
the scores while the plain version replaces masked scores with -1e9
(mmnas_tpu/ops/primitives.py:113-117); the two agree whenever a row has at
least one valid key.

`LAUNCHES` counts launches per kernel, so a run can show that its attention
went through the kernels.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from mmnas_tpu_torch.ops.primitives import draw_key, keep_mask, mask_scores

MAX_REL_CHANNELS = 8  # raw geometry channels the kernels hold in registers
REL_HEAD_GROUP = 16   # heads the relation chain and its pass hold in registers at a time
MAX_REL_HEADS = 32    # heads the relation chain takes (in groups of REL_HEAD_GROUP)
MAX_HEAD_DIM = 256    # head widths the kernels take: multiples of 16 up to this

LAUNCHES = {"fused_attention_fwd": 0, "fused_attention_fwd_dropout": 0,
            "fused_attention_bwd": 0, "fused_attention_bwd_rel": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def rsa_log_bias(raw, w1, b1, wr, br):
    """The RSA bias chain from the raw geometry tensor, materialized in fp32:
    log(clamp(relu(relu(raw W1^T + b1) Wr^T + br), 1e-6)) -> [B, H, Lq, Lk]
    (stem projection full_vqa.py:103 + modules.py:231-235). raw [B,Lq,Lk,Rr],
    w1 [R,Rr], b1 [R], wr [H,R], br [H] (torch Linear layout)."""
    proj = torch.relu(torch.matmul(raw.float(), w1.float().t()) + b1.float())
    r = torch.relu(torch.matmul(proj, wr.float().t()) + br.float())
    return torch.log(torch.clamp(r, min=1e-6)).permute(0, 3, 1, 2)


def fused_attention_reference(q, k, v, mask=None, log_bias=None, *, rel=None,
                              keep=None, dropout_r: float = 0.0):
    """Plain PyTorch version of the kernels, with the arguments of
    `fused_attention` plus a given keep mask (bool or 0/1 [B,H,Lq,Lk]) that
    is applied as `a * keep / (1 - dropout_r)`: the bias chain is
    materialized, scores and softmax are fp32, the (dropped-out)
    probabilities are rounded to v's dtype before the a.v product (as
    mmnas_tpu/ops/attention.py:152 does) and the output takes q's dtype.
    Autograd through it is the plain backward."""
    if rel is not None:
        log_bias = rsa_log_bias(*rel)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if log_bias is not None:
        scores = scores + log_bias.float()
    att = torch.softmax(mask_scores(scores, mask), dim=-1)
    if keep is not None:
        att = att * keep.float() / (1.0 - dropout_r)
    att = att.to(v.dtype)
    return torch.matmul(att.float(), v.float()).to(q.dtype)


def relation_bwd_reference(raw, w1, b1, wr, br, dpre, need_draw: bool = False):
    """Plain version of the relation pass: autograd of the relation chain
    pre = relu(raw W1^T + b1) Wr^T + br ([B,H,Lq,Lk] after the permute)
    for the cotangent dpre, in fp32. Returns (draw or None, dW1, db1, dWr,
    dbr) in fp32."""
    leaves = [t.detach().float().requires_grad_() for t in (raw, w1, b1, wr, br)]
    x, w1f, b1f, wrf, brf = leaves
    pre = (torch.matmul(torch.relu(torch.matmul(x, w1f.t()) + b1f), wrf.t()) + brf)
    grads = torch.autograd.grad(pre.permute(0, 3, 1, 2), leaves if need_draw else leaves[1:],
                                dpre.float())
    return tuple(grads) if need_draw else (None, *grads)


_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def philox4x32_10(counter, seed: int):
    """Philox4x32-10 (Salmon et al., SC'11) in numpy: counter uint32 [..., 4],
    key = the 64-bit seed -> uint32 [..., 4]. The plain version of the bits
    the dropout kernel draws."""
    mask32 = np.uint64(0xFFFFFFFF)
    x = [np.asarray(counter, np.uint64)[..., i] for i in range(4)]
    k0, k1 = np.uint64(seed & 0xFFFFFFFF), np.uint64((seed >> 32) & 0xFFFFFFFF)
    m0, m1 = np.uint64(_PHILOX_M[0]), np.uint64(_PHILOX_M[1])
    for _ in range(10):
        p0, p1 = m0 * x[0], m1 * x[2]
        x = [(p1 >> np.uint64(32)) ^ x[1] ^ k0, p1 & mask32,
             (p0 >> np.uint64(32)) ^ x[3] ^ k1, p0 & mask32]
        k0 = (k0 + np.uint64(_PHILOX_W[0])) & mask32
        k1 = (k1 + np.uint64(_PHILOX_W[1])) & mask32
    return np.stack(x, axis=-1).astype(np.uint32)


def keep_threshold(dropout_r: float) -> int:
    """Keep an element when its 32 random bits are below (1 - r) 2^32
    (pallas_attention.py:205-207)."""
    return min(int((1.0 - dropout_r) * 4294967296.0), 4294967295)


def keep_mask_reference(seed: int, B: int, H: int, Lq: int, Lk: int, dropout_r: float,
                        head0: int = 0, heads_total: int = None):
    """The keep mask [B,H,Lq,Lk] (bool) that the dropout kernel draws for
    `seed`: word j % 4 of Philox4x32-10 at counter (j // 4, i,
    b*heads_total + head0 + h, 0), so one call serves four keys. Heads
    [head0, head0 + H) of a call of heads_total (default H) heads: a model
    rank's heads draw the unsplit call's masks."""
    heads_total = H if heads_total is None else heads_total
    groups = -(-Lk // 4)
    bh = (np.arange(B)[:, None] * heads_total + head0 + np.arange(H)[None, :]).reshape(-1)
    bh, i, c = np.meshgrid(bh, np.arange(Lq), np.arange(groups), indexing="ij")
    counter = np.stack([c, i, bh, np.zeros_like(c)], axis=-1)
    bits = philox4x32_10(counter, seed).reshape(B * H, Lq, 4 * groups)[..., :Lk]
    return torch.from_numpy(bits < keep_threshold(dropout_r)).reshape(B, H, Lq, Lk)


def key_tensor(seed, device):
    """The kernel's key as an int64 [1] tensor on `device`: `seed` itself
    when it is one, else the Python int's 64 bits, written by a fill on the
    device (no copy from the host, so a CUDA graph can capture it)."""
    if isinstance(seed, torch.Tensor):
        return seed
    seed &= 2**64 - 1
    return torch.full((1,), seed - 2**64 if seed >= 2**63 else seed, dtype=torch.int64,
                      device=device)


def key_value(key: torch.Tensor) -> int:
    """The 64-bit key a key tensor holds, as `keep_mask_reference` takes it
    (one device-to-host read)."""
    return int(key.item()) & (2**64 - 1)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def fused_attention(q, k, v, mask=None, log_bias=None, *, rel=None,
                    dropout_r: float = 0.0, generator=None, head0: int = 0,
                    heads_total: int = None):
    """q [B,H,Lq,D]; k, v [B,H,Lk,D]; mask [B,1,1,Lk] bool (True = pad);
    log_bias [B,H,Lq,Lk] additive pre-softmax bias; rel (RSA fusion):
    (raw [B,Lq,Lk,Rr], W1 [R,Rr], b1 [R], Wr [H,R], br [H]), the whole bias
    chain computed in the kernels. dropout_r > 0 applies attention-weight
    dropout with a mask drawn from `generator` (a CPU tensor draws the mask
    itself, a CUDA tensor a key for the kernel, `draw_key`). head0, heads_total: these
    H heads are heads [head0, head0 + H) of a call of heads_total (default
    H), and draw that call's dropout masks (a model rank's share of the
    heads under tensor parallelism). Returns o [B,H,Lq,D] in q's dtype,
    differentiable in q, k, v, log_bias and the rel weights."""
    heads_total = q.shape[1] if heads_total is None else heads_total
    if head0 < 0 or head0 + q.shape[1] > heads_total:
        raise ValueError(f"heads [{head0}, {head0 + q.shape[1]}) are not within {heads_total}")
    if rel is not None and log_bias is not None:
        raise ValueError("pass log_bias or rel, not both")
    if dropout_r > 0.0 and generator is None:
        raise ValueError("attention dropout needs a generator")
    rel_args = rel if rel is not None else (None,) * 5
    needs_grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, log_bias, *rel_args))
    if (torch.compiler.is_compiling() and dropout_r == 0.0 and not needs_grad
            and q.device.type in ("cpu", "cuda")):
        # traced by torch.export: the forward as one op, one node of the graph
        return torch.ops.mmnas_tpu_torch.fused_attention_fwd(q, k, v, mask, log_bias, *rel_args)
    if q.device.type == "cpu":
        keep = None
        if dropout_r > 0.0:
            # the whole call's draw, this call's heads taken
            shape = (q.shape[0], heads_total, q.shape[2], k.shape[2])
            keep = keep_mask(shape, 1.0 - dropout_r, generator, q.device
                             )[:, head0:head0 + q.shape[1]]
        return fused_attention_reference(q, k, v, mask, log_bias, rel=rel, keep=keep,
                                         dropout_r=dropout_r)
    if dropout_r > 0.0 and generator.device.type != q.device.type:
        raise ValueError(f"attention dropout of a {q.device.type} tensor needs a generator "
                         f"on that device, got one on {generator.device}")
    seed = draw_key(generator, q.device) if dropout_r > 0.0 else None
    # the relation chain is kept for the backward only when one will run
    want_pre = rel is not None and needs_grad
    return FusedAttentionFn.apply(q, k, v, mask, log_bias, *rel_args,
                                  float(dropout_r), seed, want_pre, head0, heads_total)


class FusedAttentionFn(torch.autograd.Function):
    """The kernels' forward and backward as one differentiable op
    (counterpart of `_fused`, pallas_attention.py:572-599). The forward
    saves its inputs, the keep mask and, with the RSA chain and want_pre
    (the caller will differentiate), the chain's pre; the backward
    recomputes the probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, mask, log_bias, raw, w1, b1, wr, br, dropout_r, seed,
                want_pre=True, head0=0, heads_total=None):
        rel = None if raw is None else (raw, w1, b1, wr, br)
        out, keep, pre = attention_fwd(q, k, v, mask, log_bias, rel, dropout_r, seed,
                                       want_pre=want_pre and rel is not None, head0=head0,
                                       heads_total=heads_total)
        ctx.save_for_backward(q, k, v, mask, log_bias, raw, w1, b1, wr, br, keep, pre)
        ctx.dropout_r = dropout_r
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, mask, log_bias, raw, w1, b1, wr, br, keep, pre = ctx.saved_tensors
        rel = None if raw is None else (raw, w1, b1, wr, br)
        if rel is not None and pre is None:
            raise RuntimeError("the forward kept no relation chain (want_pre=False), so "
                               "this call cannot be differentiated")
        # the production path never differentiates the geometry (input data);
        # the search's arch step differentiates none of the relation inputs
        need_draw = raw is not None and ctx.needs_input_grad[5]
        need_rel = raw is not None and any(ctx.needs_input_grad[5:10])
        dq, dk, dv, dbias, drel = attention_bwd(q, k, v, mask, log_bias, rel, keep,
                                                ctx.dropout_r, do.contiguous(), need_draw,
                                                need_rel, pre=pre)
        drel = drel if drel is not None else (None,) * 5
        return (dq, dk, dv, None, dbias, *drel, None, None, None, None, None)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _fwd_kernel():
    from mmnas_tpu_torch.csrc import build

    fn = build.load("fused_attention_fwd").mmnas_fused_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 9
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_uint32, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_kernels():
    from mmnas_tpu_torch.csrc import build

    lib = build.load("fused_attention_bwd")
    bwd = lib.mmnas_fused_attention_bwd
    bwd.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    rel = lib.mmnas_fused_attention_bwd_rel
    rel.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                    + [ctypes.c_void_p])
    rel.restype = ctypes.c_int
    chunks = lib.mmnas_fused_attention_bwd_rel_chunks
    chunks.argtypes = [ctypes.c_int] * 7
    chunks.restype = ctypes.c_int
    return bwd, rel, chunks


@functools.lru_cache(maxsize=None)
def _rel_chunks(device: int, dtype_code: int, B, H, Lq, Lk, Rr, R) -> int:
    """Runs per batch row of the relation pass on this device: the kernel
    picks them from its occupancy and the SM count, so that its blocks fill
    the card once (no run under 1024 elements unless the row is shorter)."""
    with torch.cuda.device(device):
        n = _bwd_kernels()[2](dtype_code, B, H, Lq, Lk, Rr, R)
    if n <= 0:
        _raise_on(-n, "fused_attention_bwd_rel")
    return n


def _check(t, name, shape, like, dtype=None, rows=False):
    """rows: the kernels copy t's rows by 16-byte loads, so t must start on a
    16-byte boundary."""
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    _check_shape(t, name, shape, dtype or like.dtype)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if rows and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (the kernels copy its rows "
                         "by 16-byte loads)")


def _check_shape(t, name, shape, dtype):
    """t's dtype (TypeError; a mask's ValueError) and shape (ValueError)."""
    if t.dtype != dtype:
        raise (ValueError if name == "mask" else TypeError)(
            f"{name} is {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _shapes(q, k, v, mask, log_bias, rel):
    """The shape and dtype checks of the kernels' inputs, without the device,
    layout and pointer checks, so that the op's fake runs them on fake
    tensors (a symbolic batch is not held to its bound); the kernels' limits
    on head width, relation channels and heads apply to CUDA tensors.
    Returns (B, H, Lq, Lk, D, Rr, R)."""
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q, k, v must be [B, H, L, D]")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    limits = q.device.type == "cuda"
    if (min(H, Lq, Lk, D) < 1 or H > 65535 or Lq > 65535 or Lk > 65535
            or isinstance(B, int) and not 1 <= B <= 65535):
        raise ValueError(f"unsupported attention shape q {tuple(q.shape)}, k {tuple(k.shape)}")
    if limits and (D % 16 or D > MAX_HEAD_DIM):
        raise ValueError(f"head width {D}: the kernels take multiples of 16 up to "
                         f"{MAX_HEAD_DIM}")
    for t, name, shape, dtype in ((q, "q", (B, H, Lq, D), None), (k, "k", (B, H, Lk, D), None),
                                  (v, "v", (B, H, Lk, D), None),
                                  (log_bias, "log_bias", (B, H, Lq, Lk), None),
                                  (mask, "mask", (B, 1, 1, Lk), torch.bool)):
        if t is not None:
            _check_shape(t, name, shape, dtype or q.dtype)
    Rr = R = 0
    if rel is not None:
        raw, w1, b1, wr, br = rel
        if raw.dim() != 4 or w1.dim() != 2:
            raise ValueError("rel must be (raw [B,Lq,Lk,Rr], W1 [R,Rr], b1 [R], Wr [H,R], br [H])")
        Rr, R = raw.shape[3], w1.shape[0]
        if limits and not 1 <= Rr <= MAX_REL_CHANNELS:
            raise ValueError(f"raw has {Rr} channels; the kernel takes 1..{MAX_REL_CHANNELS}")
        if limits and H > MAX_REL_HEADS:
            raise ValueError(f"the relation chain takes at most {MAX_REL_HEADS} heads, got {H}")
        for t, name, shape in ((raw, "raw", (B, Lq, Lk, Rr)), (w1, "W1", (R, Rr)),
                               (b1, "b1", (R,)), (wr, "Wr", (H, R)), (br, "br", (H,))):
            _check_shape(t, name, shape, q.dtype)
    return B, H, Lq, Lk, D, Rr, R


def _validate(q, k, v, mask, log_bias, rel):
    """Checks what the kernels take (`_shapes`, then device, layout and
    alignment); returns (B, H, Lq, Lk, D, Rr, R)."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention has no kernel for device {q.device}")
    dims = _shapes(q, k, v, mask, log_bias, rel)
    B, H, Lq, Lk, D, Rr, R = dims
    _check(q, "q", (B, H, Lq, D), q, rows=True)
    _check(k, "k", (B, H, Lk, D), q, rows=True)
    _check(v, "v", (B, H, Lk, D), q, rows=True)
    if log_bias is not None:
        _check(log_bias, "log_bias", (B, H, Lq, Lk), q)
    if mask is not None and (mask.device != q.device or not mask.is_contiguous()):
        raise ValueError(f"mask must be a contiguous bool [B,1,1,Lk] on {q.device}, got "
                         f"{mask.dtype} {tuple(mask.shape)} on {mask.device}")
    if rel is not None:
        raw, w1, b1, wr, br = rel
        _check(raw, "raw", (B, Lq, Lk, Rr), q)
        _check(w1, "W1", (R, Rr), q)
        _check(b1, "b1", (R,), q)
        _check(wr, "Wr", (H, R), q)
        _check(br, "br", (H,), q)
    return dims


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err, name):
    if err == 1:
        raise RuntimeError(f"{name} launch failed with CUDA error 1 (invalid value): the "
                           "shape is outside the kernel's limits (keys up to 208 forward, "
                           "128 with the relation chain, past 128-wide heads or backward, "
                           "queries up to 128 in a backward whose tiles exceed shared "
                           "memory; the block's tiles within 227 KB of shared memory)")
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def attention_fwd(q, k, v, mask=None, log_bias=None, rel=None, dropout_r: float = 0.0,
                  seed=0, want_pre: bool = False, head0: int = 0,
                  heads_total: int = None):
    """Launch the forward kernel: (o [B,H,Lq,D] in q's dtype; with
    dropout_r > 0 the keep mask it drew for the key `seed`, an int64 [1]
    tensor on q's device that the kernel reads there, or a Python int
    copied into one (`key_tensor`) (uint8 [B,H,Lq,Lk]; the
    masks of heads [head0, head0 + H) of a call of heads_total, default H),
    else None; with rel and want_pre the relation chain pre ([B,H,Lq,Lk]
    fp32, the backward's residual), else None)."""
    B, H, Lq, Lk, D, Rr, R = _validate(q, k, v, mask, log_bias, rel)
    heads_total = H if heads_total is None else heads_total
    if not 0.0 <= dropout_r < 1.0:
        raise ValueError(f"dropout rate {dropout_r} outside [0, 1)")
    raw, w1, b1, wr, br = rel if rel is not None else (None,) * 5
    out = torch.empty_like(q)
    keep = key = None
    if dropout_r > 0.0:
        keep = torch.empty((B, H, Lq, Lk), dtype=torch.uint8, device=q.device)
        key = key_tensor(seed, q.device)
        _check(key, "key", (1,), q, dtype=torch.int64)
    pre = (torch.empty((B, H, Lq, Lk), dtype=torch.float32, device=q.device)
           if rel is not None and want_pre else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _fwd_kernel()(_DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(log_bias),
                            _ptr(mask), _ptr(raw), _ptr(w1), _ptr(b1), _ptr(wr), _ptr(br),
                            _ptr(out), _ptr(keep), _ptr(pre), B, H, Lq, Lk, D, Rr, R, head0,
                            heads_total, 1.0 / math.sqrt(D), _ptr(key),
                            keep_threshold(dropout_r) if keep is not None else 0,
                            1.0 - dropout_r, stream)
    name = "fused_attention_fwd_dropout" if keep is not None else "fused_attention_fwd"
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return out, keep, pre


# the forward without dropout as a custom op: torch.export keeps a call as one
# node of its graph (the kernel launches through ctypes on data pointers,
# which the export tracer cannot follow), and a reloaded program calls the
# kernel through it. Calls that need a gradient go through FusedAttentionFn.
@torch.library.custom_op(
    "mmnas_tpu_torch::fused_attention_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor? mask=None, Tensor? log_bias=None, "
           "Tensor? raw=None, Tensor? w1=None, Tensor? b1=None, Tensor? wr=None, "
           "Tensor? br=None) -> Tensor")
def fused_attention_fwd_op(q, k, v, mask=None, log_bias=None, raw=None, w1=None, b1=None,
                           wr=None, br=None):
    """The forward kernel (`attention_fwd`, counted in LAUNCHES) on CUDA
    tensors, its plain version on CPU tensors; rel as five tensors."""
    rel = None if raw is None else (raw, w1, b1, wr, br)
    return attention_fwd(q, k, v, mask, log_bias, rel)[0]


@fused_attention_fwd_op.register_kernel("cpu")
def _fused_attention_fwd_cpu(q, k, v, mask=None, log_bias=None, raw=None, w1=None, b1=None,
                             wr=None, br=None):
    rel = None if raw is None else (raw, w1, b1, wr, br)
    return fused_attention_reference(q, k, v, mask, log_bias, rel=rel)


@fused_attention_fwd_op.register_fake
def _fused_attention_fwd_fake(q, k, v, mask=None, log_bias=None, raw=None, w1=None, b1=None,
                              wr=None, br=None):
    _shapes(q, k, v, mask, log_bias, None if raw is None else (raw, w1, b1, wr, br))
    return torch.empty_like(q)


def attention_bwd(q, k, v, mask, log_bias, rel, keep, dropout_r: float, do,
                  need_draw: bool = False, need_rel: bool = True, *, pre=None):
    """Launch the backward kernel (and, with rel and need_rel, the relation
    pass) for the forward on the same inputs, keep mask and, with rel, the
    relation chain `pre` that the forward wrote (`attention_fwd(...,
    want_pre=True)`). Returns (dq, dk, dv, dbias, drel): dbias is None
    without log_bias; drel is None without rel or need_rel, else (draw or
    None, dW1, db1, dWr, dbr) in the layouts and dtypes of rel. Without
    need_rel the kernel writes no dpre and no relation pass runs."""
    B, H, Lq, Lk, D, Rr, R = _validate(q, k, v, mask, log_bias, rel)
    _check(do, "do", (B, H, Lq, D), q, rows=True)
    if (keep is None) != (dropout_r <= 0.0):
        raise ValueError("pass a keep mask exactly when dropout_r > 0")
    if keep is not None:
        _check(keep, "keep", (B, H, Lq, Lk), q, dtype=torch.uint8)
    if (pre is None) != (rel is None):
        raise ValueError("pass the forward's relation chain pre exactly with rel")
    if pre is not None:
        _check(pre, "pre", (B, H, Lq, Lk), q, dtype=torch.float32)
    raw, w1, b1, wr, br = rel if rel is not None else (None,) * 5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dbias = torch.empty_like(log_bias) if log_bias is not None else None
    need_rel = rel is not None and need_rel
    dpre = (torch.empty((B, H, Lq, Lk), dtype=torch.float32, device=q.device)
            if need_rel else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _bwd_kernels()[0](
            _DTYPE_CODES[q.dtype], _ptr(q), _ptr(k), _ptr(v), _ptr(log_bias), _ptr(mask),
            _ptr(pre), _ptr(keep), _ptr(do), _ptr(dq), _ptr(dk), _ptr(dv), _ptr(dbias),
            _ptr(dpre), B, H, Lq, Lk, D, 1.0 / math.sqrt(D), 1.0 - dropout_r, stream)
    _raise_on(err, "fused_attention_bwd")
    LAUNCHES["fused_attention_bwd"] += 1
    drel = relation_bwd(raw, w1, b1, wr, br, dpre, need_draw) if need_rel else None
    return dq, dk, dv, dbias, drel


def relation_bwd(raw, w1, b1, wr, br, dpre, need_draw: bool = False):
    """Launch the relation pass for the cotangent dpre [B,H,Lq,Lk] (fp32,
    contiguous) of pre = relu(raw W1^T + b1) Wr^T + br, on the rel tensors
    that `attention_bwd` has validated. Returns (draw or None, dW1, db1,
    dWr, dbr) in the layouts and dtypes of raw, w1, b1, wr, br."""
    B, Lq, Lk, Rr = raw.shape
    R, H = w1.shape[0], wr.shape[0]
    code = _DTYPE_CODES[raw.dtype]
    chunks = _rel_chunks(raw.device.index if raw.device.index is not None
                         else torch.cuda.current_device(), code, B, H, Lq, Lk, Rr, R)
    groups = -(-H // REL_HEAD_GROUP)
    rows = B * chunks * groups
    # the per-(batch row, run, head group) partials: fp64 db1, dbr, then fp32
    # dW1, dWr; a group writes its own heads' dWr and dbr only, so with more
    # than one group the others must read 0
    work = (torch.zeros if groups > 1 else torch.empty)(
        rows * ((R + H) * 8 + (R * Rr + H * R) * 4), dtype=torch.uint8, device=raw.device)
    dw1, db1, dwr, dbr = (torch.empty_like(t) for t in (w1, b1, wr, br))
    draw = torch.empty_like(raw) if need_draw else None
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        err = _bwd_kernels()[1](code, _ptr(raw), _ptr(w1), _ptr(b1), _ptr(wr), _ptr(dpre),
                                _ptr(dw1), _ptr(db1), _ptr(dwr), _ptr(dbr), _ptr(draw),
                                _ptr(work), B, H, Lq, Lk, Rr, R, chunks, stream)
    _raise_on(err, "fused_attention_bwd_rel")
    LAUNCHES["fused_attention_bwd_rel"] += 1
    return draw, dw1, db1, dwr, dbr
