"""Fixed-architecture ITM (image-text matching) CLI of the PyTorch port, on
one CUDA GPU or data-parallel on several (--GPU 0,1, --NDEV N, or
--MULTIHOST under torchrun; see train_vqa.py).

The same flags as the JAX package's train_itm.py (make_arg_parser("itm")):

    python -m mmnas_tpu_torch.train_itm --RUN train --SYNTH \
        --ARCH_PATH ./arch/mmnas_itm.json
    python -m mmnas_tpu_torch.train_itm --RUN val --SYNTH \
        --ARCH_PATH ./arch/mmnas_itm.json --CKPT_PATH logs/ckpts/train_itm-full_epoch1.pkl
    python -m mmnas_tpu_torch.train_itm --RUN train --DATASET flickr \
        --ARCH_PATH ./arch/mmnas_itm.json

Triplet BCE loss over the positive pair and the mined hard-negative caption
and image, hard-negative mining before each epoch, R@1/5/10 over the full
score matrix. Checkpoints are the pickled numpy pytrees either package
writes; --RESUME --CKPT_PATH continues from either package's. --DTYPE
bfloat16 computes in bf16 on fp32 master weights.
"""

from __future__ import annotations

import torch

from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.engine.itm import Execution
from mmnas_tpu_torch.parallel.mesh import launch, run_engine


def main(argv=None):
    args = make_arg_parser("itm").parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU")
    cfg = cfg_from_args("itm", args)
    print("Use the GENOTYPE PATH:", cfg.ARCH_PATH)
    print("Use the GENOTYPE EPOCH:", cfg.GENO_EPOCH)
    return launch(run_engine, (Execution, cfg), args.GPU, cfg.N_DEVICES, cfg.MULTIHOST)


if __name__ == "__main__":
    main()
