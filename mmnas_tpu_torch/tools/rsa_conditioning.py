"""How far the RSA attention forward is from exact, and why: the fused
forward kernel and its plain fp32 version, each against an fp64 chain and
attention, on random RSA inputs drawn as `chip_smoke.py` draws them (a pad
tail of keys, init-like relation weights).

    python -m mmnas_tpu_torch.tools.rsa_conditioning [--B 3200 ...] [--H 8 ...]
        [--L 36] [--dtype float32|bfloat16] [--seed 0] [--device cpu]

The chain pre = relu(raw W1^T + b1) Wr^T + br sums R = 64 terms of size
~1, so fp32 rounds it by ~1e-7 absolute in any order, and the attention
takes log(clamp(relu(pre), 1e-6)) as its bias: where all of a row's keys
have pre near the clamp, that rounding alone moves the row's output. For
each (B, H) one JSON line: the largest output difference kernel vs plain,
kernel vs fp64 and plain vs fp64, how many outputs differ by more than
1e-3 in each, the kernel against the plain attention on the kernel's own
pre (the attention alone), and each chain's largest distance from the
fp64 chain. A CUDA tensor goes through the kernel, a CPU tensor through
the wrapper's plain version.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from mmnas_tpu_torch.ops import fused_attention as FA

D, RR, R = 64, 4, 64


def make_inputs(g, B, H, L):
    """q, k, v [B, H, L, D]; a key mask with 8 to L valid keys a row, then
    pad; the relation chain's operands (raw, W1, b1, Wr, br)."""
    def uniform(*shape, bound):
        return (torch.rand(*shape, generator=g) * 2 - 1) * bound

    q, k, v = (torch.randn(B, H, L, D, generator=g) for _ in range(3))
    valid = torch.randint(min(8, L), L + 1, (B, 1, 1, 1), generator=g)
    mask = torch.arange(L).view(1, 1, 1, L) >= valid
    rel = (torch.randn(B, L, L, RR, generator=g) * 2.0, uniform(R, RR, bound=0.5),
           uniform(R, bound=0.5), uniform(H, R, bound=0.125), uniform(H, bound=0.125))
    return q, k, v, mask, rel


def chain(rel, dtype):
    """pre = relu(raw W1^T + b1) Wr^T + br in `dtype`, as [B, H, Lq, Lk]."""
    raw, w1, b1, wr, br = (t.to(dtype) for t in rel)
    return (torch.relu(raw @ w1.t() + b1) @ wr.t() + br).permute(0, 3, 1, 2)


def log_pre(pre):
    return torch.log(torch.clamp(torch.relu(pre), min=1e-6))


def attention(q, k, v, mask, pre, dtype):
    """softmax(q k^T / sqrt(D) + log_pre(pre), pad keys -1e9) v in `dtype`."""
    q, k, v, pre = (t.to(dtype) for t in (q, k, v, pre))
    s = q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]) + log_pre(pre)
    return torch.softmax(s.masked_fill(mask, -1e9), -1) @ v


def kernel_pre(q, k, v, mask, rel):
    """The chain's output as the forward kernel computes it (on the CPU, the
    wrapper's plain version: the fp32 chain)."""
    if q.device.type == "cpu":
        return chain(rel, torch.float32)
    return FA.attention_fwd(q, k, v, mask, None, rel, want_pre=True)[2]


def measure(B, H, L, dtype, seed, device):
    g = torch.Generator().manual_seed(seed)
    q, k, v, mask, rel = make_inputs(g, B, H, L)
    q, k, v = (t.to(device, dtype) for t in (q, k, v))
    mask, rel = mask.to(device), tuple(t.to(device, dtype) for t in rel)
    with torch.no_grad():
        out_k = FA.fused_attention(q, k, v, mask, rel=rel).double()
        out_p = FA.fused_attention_reference(q, k, v, mask, rel=rel).double()
        pre_64 = chain(rel, torch.float64)
        out_64 = attention(q, k, v, mask, pre_64, torch.float64)
        pre_k = kernel_pre(q, k, v, mask, rel)
        on_pre = FA.fused_attention_reference(q, k, v, mask, log_pre(pre_k)).double()
        pre_p = chain(rel, torch.float32)
        diffs = {"kernel_vs_plain": out_k - out_p, "kernel_vs_fp64": out_k - out_64,
                 "plain_vs_fp64": out_p - out_64, "kernel_vs_plain_on_kernel_pre": out_k - on_pre}
        row = {"B": B, "H": H, "L": L, "dtype": str(dtype).replace("torch.", ""), "seed": seed}
        for name, d in diffs.items():
            row[name] = d.abs().max().item()
            row[f"{name}_over_1e-3"] = int((d.abs() > 1e-3).sum())
        row["kernel_pre_vs_fp64"] = (pre_k.double() - pre_64).abs().max().item()
        row["plain_pre_vs_fp64"] = (pre_p.double() - pre_64).abs().max().item()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, nargs="+", default=[3200])
    ap.add_argument("--H", type=int, nargs="+", default=[8])
    ap.add_argument("--L", type=int, default=36)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("rsa_conditioning: no CUDA device (pass --device cpu for the plain "
                         "versions)")
    rows = []
    for B in args.B:
        for H in args.H:
            rows.append(measure(B, H, args.L, getattr(torch, args.dtype), args.seed,
                                torch.device(args.device)))
            print(json.dumps(rows[-1]), flush=True)
            if args.device != "cpu":
                torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    main()
