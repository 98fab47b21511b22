"""Supernet architecture search for VQA with the PyTorch port, on one CUDA
GPU (counterpart of the JAX package's search_vqa.py).

The same flags as the JAX package's search CLI:

    python -m mmnas_tpu_torch.search_vqa --SYNTH --MAX_EPOCH 3 --BS 128
    python -m mmnas_tpu_torch.search_vqa --SYNTH --BS 256 --KPATH 8 --DTYPE bfloat16
    python -m mmnas_tpu_torch.search_vqa --RESUME --CKPT_PATH logs/ckpts/search_vqa-search_epoch3.pkl

Per-epoch genotypes are appended to ./arch/<VERSION>.json in the reference
schema {"epochK": {"enc": [[op]x12], "dec": [[op]x18]}}; checkpoints are the
pickled numpy pytrees either package writes and resumes from. --SCAN_STEPS,
the dense/unified/hybrid weight steps and --MULTIHOST are not ported.
"""

from __future__ import annotations

import torch

from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.engine.search import SearchExecution


def main(argv=None):
    args = make_arg_parser("vqa", search=True).parse_args(argv)
    if args.MULTIHOST:
        raise NotImplementedError("--MULTIHOST is not ported (ROADMAP.md, queue 1: parallel/)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU")
    cfg = cfg_from_args("vqa", args, search=True)
    return SearchExecution(cfg, torch.device("cuda", int(args.GPU))).run()


if __name__ == "__main__":
    main()
