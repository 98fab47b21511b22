"""Fixed-architecture VQA CLI of the PyTorch port, on one CUDA GPU.

The same flags as the JAX package's train_vqa.py (reference train_vqa.py:23-79):

    python -m mmnas_tpu_torch.train_vqa --RUN train --SYNTH \
        --ARCH_PATH ./arch/mmnas_vqa.json
    python -m mmnas_tpu_torch.train_vqa --RUN val --SYNTH \
        --ARCH_PATH ./arch/mmnas_vqa.json --CKPT_PATH logs/ckpts/train_vqa-full_epoch13.pkl

Checkpoints are the pickled numpy pytrees either package writes; --RESUME
--CKPT_PATH continues from either package's. Training under --DTYPE
bfloat16 computes in bf16 on fp32 master weights; --MULTIHOST is not
ported yet.
"""

from __future__ import annotations

import torch

from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.engine.vqa import Execution


def main(argv=None):
    args = make_arg_parser("vqa").parse_args(argv)
    if args.MULTIHOST:
        raise NotImplementedError("--MULTIHOST is not ported (ROADMAP.md, queue 1: parallel/)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU")
    cfg = cfg_from_args("vqa", args)
    print("Use the GENOTYPE PATH:", cfg.ARCH_PATH)
    print("Use the GENOTYPE EPOCH:", cfg.GENO_EPOCH)
    return Execution(cfg, torch.device("cuda", int(args.GPU))).run()


if __name__ == "__main__":
    main()
