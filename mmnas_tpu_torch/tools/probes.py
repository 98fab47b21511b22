"""The Pallas debug probes of tools/debug/ on the GPU: the CUDA kernels'
wrappers, their plain PyTorch versions, and a CLI that prints what the TPU
scripts print.

    python -m mmnas_tpu_torch.tools.probes [--only bias|bias2|slice|outer|wrblock]
                                           [--device cpu]

Each kernel of `csrc/probes.cu` computes what its TPU probe computes:

- `probe_bias` (`_probe_bias.py:13`) and `probe_bias2` (`_probe_bias2.py:13`):
  the RSA log-bias log(max(relu(raw W1^T + b1) Wr^T + br, 1e-6)) ->
  [B, H, L, L], the relation features computed once per element for all
  heads, and once per head. A thread computes several elements over a flat
  grid, the chain's shapes fixed at compile time for Rr 4, R 64, H 4 or 8
  (a generic instance takes the rest). Both run the operations of the
  attention kernels' chain (`csrc/attention_common.cuh`) in its order, so
  they give equal bits, equal to log(max(pre, 1e-6)) of the RSA attention
  forward's `pre`.
- `probe_slice` (`_probe_slice.py:7`): 2 plane in fp32, in row chunks.
- `probe_outer` (`_probe_outer.py:9`): plane (x) w + b1 in fp32.
- `probe_wrblock` (`_probe_wrblock.py:9,21`): Wr copied per (b, h) through
  a per-head slice (variant "a") and a dynamic index (variant "b").

A CUDA tensor goes through the kernel (or raises), a CPU tensor through the
plain version. `LAUNCHES` counts the kernels' launches. The CLI makes the
probes' inputs as the TPU scripts do (numpy RandomState(0), in their order),
in the port's layouts (W1 [R, Rr], Wr [H, R]), runs the kernels (on the
card unless --device cpu) and prints the scripts' lines: max diff, worst
index and the per-(b, h) table for the bias probes against the fp64 numpy
chain, the max diff against the exact result for the others.
"""

from __future__ import annotations

import argparse
import ctypes
import functools

import numpy as np
import torch

from mmnas_tpu_torch.ops.fused_attention import rsa_log_bias

PROBES = ("bias", "bias2", "slice", "outer", "wrblock")
LAUNCHES = {"probe_bias": 0, "probe_bias2": 0, "probe_slice": 0, "probe_outer": 0,
            "probe_wrblock_a": 0, "probe_wrblock_b": 0}
B, H, L, RR, R = 8, 8, 100, 4, 64  # the TPU scripts' shapes
CHUNKS = 4                          # _probe_slice.py writes four row chunks
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_HEADS, _MAX_CHANNELS = 16, 8   # attention_common.cuh kMaxH, kMaxRr
_MAX_BIAS_ELEMENTS = 1 << 30        # probes.cu kMaxBiasElements (B L L)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bias_reference(raw, w1, b1, wr, br):
    """log(max(relu(raw W1^T + b1) Wr^T + br, 1e-6)) -> [B, H, L, L] fp32
    (the attention's RSA chain, `rsa_log_bias`)."""
    return rsa_log_bias(raw, w1, b1, wr, br)


def slice_reference(plane):
    """[1, L, L] -> 2 plane[0] in fp32."""
    return plane[0].float() * 2.0


def outer_reference(plane, w, b1):
    """plane [L, L] (x) w [R] + b1 [R] -> [L, L, R] fp32, the product and the
    sum each rounded to fp32."""
    return plane.float()[..., None] * w.float() + b1.float()


def wrblock_reference(wr):
    """Wr [H, R, 1] -> [2, H, R, 1]: a copy per b < 2."""
    return torch.stack([wr, wr]).float()


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _kernels():
    from mmnas_tpu_torch.csrc import build

    lib = build.load("probes")
    p, i, s = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
    lib.mmnas_probe_bias.argtypes = [i] + [p] * 6 + [i] * 5 + [s]
    lib.mmnas_probe_slice.argtypes = [i, p, p, i, i, s]
    lib.mmnas_probe_outer.argtypes = [i, p, p, p, p, ctypes.c_long, i, s]
    lib.mmnas_probe_wrblock.argtypes = [i, p, p, i, i, s]
    for fn in (lib.mmnas_probe_bias, lib.mmnas_probe_slice, lib.mmnas_probe_outer,
               lib.mmnas_probe_wrblock):
        fn.restype = ctypes.c_int
    return lib


def _require(t, name, dtypes, dim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}, expected one of {dtypes}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-d tensor, got {tuple(t.shape)}")


def _launched(err, name):
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def probe_bias(raw, w1, b1, wr, br, fresh: bool = False):
    """The RSA log-bias [B, H, L, L] fp32 from raw [B, L, L, Rr], W1 [R, Rr],
    b1 [R], Wr [H, R], br [H], all fp32. fresh=False: the `probe_bias`
    kernel (features once for all heads); True: `probe_bias2` (per head)."""
    if raw.device.type == "cpu":
        return bias_reference(raw, w1, b1, wr, br)
    _require(raw, "raw", (torch.float32,), 4, raw.device)
    Bn, Lq, Lk, Rr = raw.shape
    Rn, Hn = w1.shape[0], wr.shape[0]
    if Lq != Lk or not 1 <= Rr <= _MAX_CHANNELS or not 1 <= Hn <= _MAX_HEADS:
        raise ValueError(f"raw {tuple(raw.shape)} with {Hn} heads: the kernel takes a square "
                         f"plane, 1..{_MAX_CHANNELS} channels and 1..{_MAX_HEADS} heads")
    if Bn * Lq * Lk > _MAX_BIAS_ELEMENTS:
        raise ValueError(f"raw {tuple(raw.shape)}: the kernel takes up to {_MAX_BIAS_ELEMENTS} "
                         "elements B L L")
    for t, name, shape in ((w1, "W1", (Rn, Rr)), (b1, "b1", (Rn,)), (wr, "Wr", (Hn, Rn)),
                           (br, "br", (Hn,))):
        _require(t, name, (torch.float32,), len(shape), raw.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    out = torch.empty((Bn, Hn, Lq, Lk), dtype=torch.float32, device=raw.device)
    with torch.cuda.device(raw.device):
        err = _kernels().mmnas_probe_bias(int(fresh), raw.data_ptr(), w1.data_ptr(),
                                          b1.data_ptr(), wr.data_ptr(), br.data_ptr(),
                                          out.data_ptr(), Bn, Hn, Lq, Rr, Rn, _stream(raw))
    _launched(err, "probe_bias2" if fresh else "probe_bias")
    return out


def probe_slice(plane, chunks: int = CHUNKS):
    """2 plane[0] in fp32 from a [1, L, L] fp32 or bf16 plane, written in
    `chunks` row chunks."""
    if plane.device.type == "cpu":
        return slice_reference(plane)
    _require(plane, "plane", tuple(_DTYPE_CODES), 3, plane.device)
    Ln = plane.shape[1]
    if plane.shape != (1, Ln, Ln) or not 1 <= chunks <= Ln:
        raise ValueError(f"plane {tuple(plane.shape)}, {chunks} chunks: expected [1, L, L], "
                         "1..L chunks")
    out = torch.empty((Ln, Ln), dtype=torch.float32, device=plane.device)
    with torch.cuda.device(plane.device):
        err = _kernels().mmnas_probe_slice(_DTYPE_CODES[plane.dtype], plane.data_ptr(),
                                           out.data_ptr(), Ln, chunks, _stream(plane))
    _launched(err, "probe_slice")
    return out


def probe_outer(plane, w, b1):
    """plane [L, L] (x) w [R] + b1 [R] -> [L, L, R] fp32; operands fp32 or
    bf16, all of one type."""
    if plane.device.type == "cpu":
        return outer_reference(plane, w, b1)
    _require(plane, "plane", tuple(_DTYPE_CODES), 2, plane.device)
    Rn = w.shape[0]
    for t, name in ((w, "w"), (b1, "b1")):
        _require(t, name, (plane.dtype,), 1, plane.device)
        if t.shape[0] != Rn:
            raise ValueError(f"{name} has {t.shape[0]} entries, w has {Rn}")
    out = torch.empty((*plane.shape, Rn), dtype=torch.float32, device=plane.device)
    with torch.cuda.device(plane.device):
        err = _kernels().mmnas_probe_outer(_DTYPE_CODES[plane.dtype], plane.data_ptr(),
                                           w.data_ptr(), b1.data_ptr(), out.data_ptr(),
                                           plane.numel(), Rn, _stream(plane))
    _launched(err, "probe_outer")
    return out


def probe_wrblock(wr, variant: str):
    """Wr [H, R, 1] fp32 -> [2, H, R, 1], copied per (b, h) by kernel
    variant "a" (a per-head slice) or "b" (the whole array, indexed)."""
    if variant not in ("a", "b"):
        raise ValueError(f"variant {variant!r}: 'a' or 'b'")
    if wr.device.type == "cpu":
        return wrblock_reference(wr)
    _require(wr, "Wr", (torch.float32,), 3, wr.device)
    Hn, Rn = wr.shape[:2]
    if wr.shape[2] != 1:
        raise ValueError(f"Wr has shape {tuple(wr.shape)}, expected [H, R, 1]")
    out = torch.empty((2, Hn, Rn, 1), dtype=torch.float32, device=wr.device)
    with torch.cuda.device(wr.device):
        err = _kernels().mmnas_probe_wrblock(0 if variant == "a" else 1, wr.data_ptr(),
                                             out.data_ptr(), Hn, Rn, _stream(wr))
    _launched(err, f"probe_wrblock_{variant}")
    return out


# ---------------------------------------------------------------------------
# the probes' inputs and the CLI
# ---------------------------------------------------------------------------

def bias_inputs():
    """raw, W1, b1, Wr, br as numpy fp32 in the port's layouts, drawn as
    _probe_bias.py:6-11 draws them (W1 [Rr, R] and Wr [R, H] there)."""
    r = np.random.RandomState(0)
    raw = np.abs(r.randn(B, L, L, RR)).astype(np.float32)
    w1 = (r.randn(RR, R) * 0.5).astype(np.float32)
    b1 = (r.randn(R) * 0.1).astype(np.float32)
    wrw = (r.randn(R, H) * 0.3).astype(np.float32)
    wrb = (r.randn(H) * 0.1).astype(np.float32)
    return raw, np.ascontiguousarray(w1.T), b1, np.ascontiguousarray(wrw.T), wrb


def bias_fp64(raw, w1, b1, wr, br):
    """The fp64 numpy chain of _probe_bias.py:41-43 (port layouts)."""
    t64 = np.maximum(raw.astype(np.float64) @ w1.T.astype(np.float64) + b1, 0)
    pre64 = np.einsum("bxyr,hr->bhxy", t64, wr.astype(np.float64)) + br[None, :, None, None]
    return np.log(np.maximum(pre64, 1e-6))


def slice_inputs():
    """The fp32 and bf16 planes of _probe_slice.py:4-6, in its order."""
    r = np.random.RandomState(0)
    return {dt: torch.from_numpy(r.randn(1, L, L).astype(np.float32)).to(dt)
            for dt in (torch.float32, torch.bfloat16)}


def outer_inputs():
    """(plane, w1 row, b1) per dtype, as _probe_outer.py:4-8 draws them."""
    r = np.random.RandomState(0)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        plane = torch.from_numpy(r.randn(L, L).astype(np.float32)).to(dt)
        w = torch.from_numpy((r.randn(R) * 0.5).astype(np.float32)).to(dt)
        b1 = torch.from_numpy((r.randn(R) * 0.1).astype(np.float32)).to(dt)
        out[dt] = (plane, w, b1)
    return out


def wrblock_inputs():
    """Wr [H, R, 1] of _probe_wrblock.py:5-6."""
    return torch.from_numpy(np.random.RandomState(0).randn(H, R, 1).astype(np.float32))


def _dtname(dt):
    return str(dt).replace("torch.", "")


def run_bias(device, fresh: bool):
    raw, w1, b1, wr, br = bias_inputs()
    args = [torch.from_numpy(a).to(device) for a in (raw, w1, b1, wr, br)]
    got = probe_bias(*args, fresh=fresh).cpu().numpy()
    want = bias_fp64(raw, w1, b1, wr, br)
    d = np.abs(got - want)
    bad = np.unravel_index(d.argmax(), d.shape)
    print("bias maxdiff:", float(d.max()))
    print("worst at (b,h,l,l'):", tuple(int(i) for i in bad), "got", float(got[bad]),
          "want", float(want[bad]))
    print(("FRESH-T " if fresh else "") + "per-(b,h) maxdiff:\n",
          np.array2string(d.max(axis=(2, 3)), precision=3))
    return {"max_diff_fp64": float(d.max()), "out": got}


def run_slice(device):
    out = {}
    for dt, plane in slice_inputs().items():
        got = probe_slice(plane.to(device)).cpu()
        d = float((got - plane[0].float() * 2.0).abs().max())
        print(f"{_dtname(dt)}: chunked sublane slice maxdiff {d:.3e}")
        out[_dtname(dt)] = d
    return out


def run_outer(device):
    out = {}
    for dt, (plane, w, b1) in outer_inputs().items():
        got = probe_outer(plane.to(device), w.to(device), b1.to(device)).cpu()
        want = (plane.float().numpy()[:, :, None] * w.float().numpy()[None, None, :]
                + b1.float().numpy()[None, None, :])
        d = float(np.abs(got.numpy() - want).max())
        print(f"{_dtname(dt)}: outer+bias maxdiff {d:.3e}")
        out[_dtname(dt)] = d
    return out


def run_wrblock(device):
    wr = wrblock_inputs()
    out = {}
    for variant, label in (("a", "A per-h block"), ("b", "B dyn-index")):
        got = probe_wrblock(wr.to(device), variant).cpu()
        d = float((got - wr[None]).abs().max())
        print(f"{label} maxdiff:", d)
        out[variant] = d
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="the Pallas debug probes, on the GPU")
    p.add_argument("--only", choices=PROBES, default=None)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (plain versions)")
    args = p.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probes' kernels run on the GPU "
                           "(--device cpu runs their plain versions)")
    results = {}
    for name in PROBES if args.only is None else (args.only,):
        print(f"== {name}")
        if name in ("bias", "bias2"):
            results[name] = run_bias(device, fresh=name == "bias2")
        else:
            results[name] = {"slice": run_slice, "outer": run_outer,
                             "wrblock": run_wrblock}[name](device)
    return results


if __name__ == "__main__":
    main()
