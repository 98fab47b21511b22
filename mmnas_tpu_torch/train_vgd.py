"""Fixed-architecture VGD (visual grounding) CLI of the PyTorch port, on one
CUDA GPU.

The same flags as the JAX package's train_vgd.py (make_arg_parser("vgd")):

    python -m mmnas_tpu_torch.train_vgd --RUN train --SYNTH \
        --ARCH_PATH ./arch/mmnas_vgd.json
    python -m mmnas_tpu_torch.train_vgd --RUN val --SYNTH \
        --ARCH_PATH ./arch/mmnas_vgd.json --CKPT_PATH logs/ckpts/train_vgd-full_epoch13.pkl
    python -m mmnas_tpu_torch.train_vgd --RUN train --DATASET refcoco --FEAT vg_woref \
        --ARCH_PATH ./arch/mmnas_vgd.json

KLD score loss plus SmoothL1 box regression; eval is IoU@0.5 accuracy.
Checkpoints are the pickled numpy pytrees either package writes; --RESUME
--CKPT_PATH continues from either package's. --DTYPE bfloat16 computes in
bf16 on fp32 master weights; --MULTIHOST is not ported yet.
"""

from __future__ import annotations

import torch

from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.engine.vgd import Execution


def main(argv=None):
    args = make_arg_parser("vgd").parse_args(argv)
    if args.MULTIHOST:
        raise NotImplementedError("--MULTIHOST is not ported (ROADMAP.md, queue 1: parallel/)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU")
    cfg = cfg_from_args("vgd", args)
    print("Use the GENOTYPE PATH:", cfg.ARCH_PATH)
    print("Use the GENOTYPE EPOCH:", cfg.GENO_EPOCH)
    return Execution(cfg, torch.device("cuda", int(args.GPU))).run()


if __name__ == "__main__":
    main()
