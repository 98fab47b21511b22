"""How far the RSA attention forward is from exact, and why: the fused
forward kernel and its plain fp32 version, each against an fp64 chain and
attention, on random RSA inputs drawn as `chip_smoke.py` draws them (a pad
tail of keys, init-like relation weights), or on a trained net's relation
chain.

    python -m mmnas_tpu_torch.tools.rsa_conditioning [--B 3200 ...] [--H 8 ...]
        [--L 36] [--dtype float32|bfloat16] [--seed 0] [--device cpu]
    python -m mmnas_tpu_torch.tools.rsa_conditioning --ckpt <pickle> --data_root <corpus>
        [--B 256 ...]

With --ckpt and --data_root the chain's weights are a trained checkpoint's
(either package's pickle: the stem's linear_y_rel as W1, b1 and each RSA
op's wr as Wr, br, one row per op) and its inputs a VQA rehearsal corpus's
(tools/make_rehearsal_data.py): the geometry relation tensors and pad masks
of the val split's first B items, cycled, at FRCNFEAT_LEN 100 regions;
q, k and v stay random.

The chain pre = relu(raw W1^T + b1) Wr^T + br sums R = 64 terms of size
~1, so fp32 rounds it by ~1e-7 absolute in any order, and the attention
takes log(clamp(relu(pre), 1e-6)) as its bias: where all of a row's keys
have pre near the clamp, that rounding alone moves the row's output. For
each (B, H) one JSON line: the largest output difference kernel vs plain,
kernel vs fp64 and plain vs fp64, how many outputs differ by more than
1e-3 in each, the kernel against the plain attention on the kernel's own
pre (the attention alone), each chain's largest distance from the fp64
chain, and the share of the chain's elements at valid keys whose relu(pre)
is below 1e-5 (near the clamp). A CUDA tensor goes through the kernel, a CPU tensor through
the wrapper's plain version.
"""

from __future__ import annotations

import argparse
import json
import math

import numpy as np
import torch

from mmnas_tpu_torch.config import Cfg
from mmnas_tpu_torch.data.vqa import VqaDataset
from mmnas_tpu_torch.models.convert import from_jax_params
from mmnas_tpu_torch.ops import fused_attention as FA
from mmnas_tpu_torch.train.checkpoint import load_checkpoint

D, RR, R = 64, 4, 64


def make_inputs(g, B, H, L, trained=None):
    """q, k, v [B, H, L, D]; a key mask with 8 to L valid keys a row, then
    pad; the relation chain's operands (raw, W1, b1, Wr, br). `trained`
    (mask, raw, W1, b1, Wr, br) takes the place of the random mask and
    chain."""
    def uniform(*shape, bound):
        return (torch.rand(*shape, generator=g) * 2 - 1) * bound

    q, k, v = (torch.randn(B, H, L, D, generator=g) for _ in range(3))
    if trained is not None:
        return q, k, v, trained[0], tuple(trained[1:])
    valid = torch.randint(min(8, L), L + 1, (B, 1, 1, 1), generator=g)
    mask = torch.arange(L).view(1, 1, 1, L) >= valid
    rel = (torch.randn(B, L, L, RR, generator=g) * 2.0, uniform(R, RR, bound=0.5),
           uniform(R, bound=0.5), uniform(H, R, bound=0.125), uniform(H, bound=0.125))
    return q, k, v, mask, rel


def corpus_relations(data_root: str, B: int):
    """(mask [B, 1, 1, L], raw [B, L, L, 4]) of the VQA val split's first B
    items, cycled: the per-item loader's geometry relation tensors and the
    pad mask the net takes from the region features."""
    ds = VqaDataset(Cfg(TASK="vqa", DATA_ROOT=data_root, GLOVE_FEATURE=False), "val")
    items = [ds[i % len(ds)] for i in range(B)]
    feat = torch.from_numpy(np.stack([it["frcn_feat"] for it in items]))
    mask = (feat.abs().sum(-1) == 0)[:, None, None, :]
    return mask, torch.from_numpy(np.stack([it["rel_img"] for it in items])).float()


def checkpoint_chains(path: str):
    """{RSA op: (W1, b1, Wr, br)} of a checkpoint: the stem's linear_y_rel
    and each op's wr."""
    tree = load_checkpoint(path)["state_dict"]
    sd = {k: v.contiguous() for k, v in from_jax_params(tree).items()}
    w1, b1 = sd["linear_y_rel.weight"], sd["linear_y_rel.bias"]
    return {name[:-len(".weight")]: (w1, b1, sd[name], sd[name[:-len("weight")] + "bias"])
            for name in sd if name.endswith(".wr.weight")}


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


def measure(B, H, L, dtype, seed, device, trained=None):
    g = torch.Generator().manual_seed(seed)
    q, k, v, mask, rel = make_inputs(g, B, H, L, trained)
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
        # the chain's elements at valid keys whose bias the clamp holds or
        # nearly holds: relu(pre) below 1e-5
        valid = ~mask.expand_as(pre_64)
        row["pre_below_1e-5_share"] = (torch.relu(pre_64)[valid] < 1e-5).double().mean().item()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--B", type=int, nargs="+", default=[3200])
    ap.add_argument("--H", type=int, nargs="+", default=[8])
    ap.add_argument("--L", type=int, default=36)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt", default="", help="a trained checkpoint: its relation chains")
    ap.add_argument("--data_root", default="",
                    help="with --ckpt, a VQA rehearsal corpus: its relation inputs")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("rsa_conditioning: no CUDA device (pass --device cpu for the plain "
                         "versions)")
    if bool(args.ckpt) != bool(args.data_root):
        raise SystemExit("rsa_conditioning: --ckpt and --data_root go together")
    rows = []
    if args.ckpt:
        chains = checkpoint_chains(args.ckpt)
        if not chains:
            raise SystemExit(f"rsa_conditioning: {args.ckpt} has no RSA op")
        for B in args.B:
            mask, raw = corpus_relations(args.data_root, B)
            for op, (w1, b1, wr, br) in chains.items():
                rows.append(measure(B, wr.shape[0], raw.shape[1], getattr(torch, args.dtype),
                                    args.seed, torch.device(args.device),
                                    (mask, raw, w1, b1, wr, br)))
                rows[-1].update(ckpt=args.ckpt, op=op, data_root=args.data_root)
                print(json.dumps(rows[-1]), flush=True)
        return rows
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
