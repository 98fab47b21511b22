"""Supernet architecture search for VGD with the PyTorch port, on one CUDA
GPU or data-parallel on several (counterpart of the JAX package's
search_vgd.py; --GPU 0,1, --NDEV N, or --MULTIHOST under torchrun).

The same flags as the JAX package's search CLI (make_arg_parser("vgd",
search=True)):

    python -m mmnas_tpu_torch.search_vgd --SYNTH --MAX_EPOCH 3 --BS 16
    python -m mmnas_tpu_torch.search_vgd --DATASET refcoco --FEAT vg_woref

Per-epoch genotypes are appended to ./arch/<VERSION>.json in the reference
schema; checkpoints are the pickled numpy pytrees either package writes and
resumes from. --DENSE_WEIGHT, --UNIFIED_WEIGHT and --HYBRID_WEIGHT choose the
weight step's program and --MODEL_AXIS splits the heads, as for VQA
(search_vqa.py), and so do --REMAT and --SCAN_STEPS.
"""

from __future__ import annotations

import torch

from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.engine.search_vgd import SearchExecution
from mmnas_tpu_torch.parallel.mesh import launch, run_engine


def main(argv=None):
    args = make_arg_parser("vgd", search=True).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU")
    cfg = cfg_from_args("vgd", args, search=True)
    return launch(run_engine, (SearchExecution, cfg), args.GPU, cfg.N_DEVICES, cfg.MULTIHOST)


if __name__ == "__main__":
    main()
