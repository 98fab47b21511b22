"""Export a fixed-arch net's eval forward as a serving artifact
(torch.export), the PyTorch port's twin of the JAX package's
tools/export_serving.py.

The artifact is a torch.export program (`.pt2`) of `NetFull.forward(batch,
train=False)`: a server loads it with `torch.export.load(path).module()`
and calls it on a batch without the dataset layer, the engines or the NAS
machinery. Every attention op of the net is one node of the custom op
`mmnas_tpu_torch::fused_attention_fwd` in the program's graph, so the
reloaded program launches the hand-written forward kernel on a CUDA
device; importing `mmnas_tpu_torch.ops.fused_attention` registers the op,
and a process must do so before it loads an artifact. The weights travel
in the artifact; another epoch's are loaded into the reloaded module with
`load_state_dict`, so one export serves every epoch's weights.

Usage:
    python -m mmnas_tpu_torch.tools.export_serving --task vqa --arch ./arch/mmnas_vqa.json \\
        --ckpt logs/ckpts/train_vqa-mmnas_epoch13.pkl --bs 64 \\
        --out logs/serving/vqa_mmnas.pt2 [--symbolic-batch]
    # smoke (no checkpoint: fresh init from the seed, synthetic shapes), on the CPU:
    python -m mmnas_tpu_torch.tools.export_serving --task vqa --bs 8 --out /tmp/m.pt2 --device cpu

`--symbolic-batch` exports with a symbolic leading batch dimension (a
`torch.export.Dim` of at least 2: torch.export specializes a size of 1), so
one artifact serves any batch size; without it the artifact is locked to
--bs. `--ckpt` takes a checkpoint of the port or of the JAX package (pickled
numpy pytrees; either package reads the other's). `--device` (default cuda;
without a card the tool raises unless given cpu) takes the place of the JAX
tool's --platforms.

Verification: the tool loads its own output back and checks the result
against the in-process forward on the example batch, bit for bit (and with
--symbolic-batch at half the batch too), then loads a second set of
weights (a fresh init from another seed) into the reloaded module and
checks it against that net's in-process forward.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from mmnas_tpu_torch.config import Cfg
from mmnas_tpu_torch.data.loader import _stack
from mmnas_tpu_torch.data.synth import SynthVqaDataset
from mmnas_tpu_torch.genotype import load_genotype
from mmnas_tpu_torch.models.net import NetFull
from mmnas_tpu_torch.tools.rehearsal import check_device
from mmnas_tpu_torch.train.checkpoint import load_checkpoint, load_params

FEED_KEYS = ("frcn_feat", "bbox_feat", "rel_img", "ques_ix", "rel_ques")
OP = "mmnas_tpu_torch.fused_attention_fwd"


def build_eval_fwd(task: str, arch_path: str, ckpt_path: str, batch: int,
                   device="cpu", seed: int = None):
    """Returns (net, example_batch) for the task's fixed net, on `device`,
    in eval mode and without gradients.

    With a checkpoint: its weights (the net must match its arch JSON).
    Without: a fresh init from `seed` (default the Cfg's SEED) on synthetic
    metadata (export smoke)."""
    if task != "vqa":
        raise NotImplementedError(
            "vgd/itm exports follow the same pattern; vqa is the flagship")
    cfg = Cfg(TASK=task, SYNTH=True, ARCH_PATH=arch_path)
    ds = SynthVqaDataset(cfg, size=max(batch, 8), seed=0)
    generator = torch.Generator().manual_seed(cfg.SEED if seed is None else seed)
    net = NetFull(cfg, load_genotype(arch_path),
                  {"token_size": ds.token_size, "ans_size": ds.ans_size,
                   "pretrained_emb": ds.pretrained_emb}, task=task, generator=generator)
    if ckpt_path:
        load_params(net, load_checkpoint(ckpt_path)["state_dict"])
    batch_np = _stack([ds[i] for i in range(batch)])
    example = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in batch_np.items() if k in FEED_KEYS}
    return net.to(device).eval().requires_grad_(False), example


def export_artifact(net, example, symbolic_batch: bool):
    """torch.export of `net`'s eval forward on `example`: the batch
    dimension of every input a `Dim` of at least 2 with symbolic_batch,
    else the example's."""
    dynamic = None
    if symbolic_batch:
        b = torch.export.Dim("batch", min=2)
        dynamic = ({k: {0: b} for k in example},)
    with torch.no_grad():
        return torch.export.export(net, (example,), dynamic_shapes=dynamic)


def attention_nodes(program) -> int:
    """Calls of the custom attention op in an exported program's graph."""
    return sum(1 for n in program.graph.nodes
               if n.op == "call_function" and str(n.target).startswith(OP))


def sub_batch(example, n: int):
    return {k: v[:n].contiguous() for k, v in example.items()}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--task", default="vqa")
    p.add_argument("--arch", default="./arch/mcan.json")
    p.add_argument("--ckpt", default="",
                   help="checkpoint (.pkl, the port's or the JAX package's); empty = fresh init")
    p.add_argument("--bs", type=int, default=64)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card the tool raises unless given cpu")
    p.add_argument("--symbolic-batch", action="store_true")
    args = p.parse_args(argv)
    device = check_device(args.device)

    net, example = build_eval_fwd(args.task, args.arch, args.ckpt, args.bs, device)
    t0 = time.time()
    program = export_artifact(net, example, args.symbolic_batch)
    export_s = time.time() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.export.save(program, args.out)
    size = os.path.getsize(args.out)
    print(f"exported {args.task} eval forward -> {args.out} ({size / 1e6:.1f} MB, "
          f"device={device}, batch={'symbolic' if args.symbolic_batch else args.bs}, "
          f"{attention_nodes(program)} attention ops as {OP}, {export_s:.1f} s)")

    served = torch.export.load(args.out).module()
    sizes = [args.bs] + ([args.bs // 2] if args.symbolic_batch and args.bs // 2 >= 2 else [])
    with torch.no_grad():
        for n in sizes:
            b = sub_batch(example, n)
            got, want = served(b), net(b)
            if not torch.equal(got, want):
                raise AssertionError(f"the reloaded artifact differs from the in-process forward "
                                     f"at batch {n}: {float((got - want).abs().max())}")
        other, _ = build_eval_fwd(args.task, args.arch, "", args.bs, device, seed=net.cfg.SEED + 1)
        served.load_state_dict(other.state_dict())
        if not torch.equal(served(example), other(example)):
            raise AssertionError("the reloaded artifact on a second set of weights differs from "
                                 "their in-process forward")
    print(f"roundtrip verified: the output bit-exact vs the in-process forward on "
          f"{device} at batch {', '.join(map(str, sizes))}; a second set of weights too")
    return program


if __name__ == "__main__":
    main()
