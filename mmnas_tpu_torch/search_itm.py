"""Supernet architecture search for ITM with the PyTorch port, on one CUDA
GPU or data-parallel on several (counterpart of the JAX package's
search_itm.py; --GPU 0,1, --NDEV N, or --MULTIHOST under torchrun).

The same flags as the JAX package's search CLI (make_arg_parser("itm",
search=True)):

    python -m mmnas_tpu_torch.search_itm --SYNTH --MAX_EPOCH 3 --BS 16
    python -m mmnas_tpu_torch.search_itm --DATASET flickr

Per-epoch hard-negative mining with a sampled path, genotypes appended to
./arch/<VERSION>.json in the reference schema, the argmax path's R@K on the
val split; checkpoints are the pickled numpy pytrees either package writes
and resumes from. --DENSE_WEIGHT, --UNIFIED_WEIGHT and --HYBRID_WEIGHT choose
the program of the weight step's three forwards and --MODEL_AXIS splits the
heads, as for VQA (search_vqa.py), and so do --REMAT and --SCAN_STEPS (the
mining stays at the start of its epochs, outside the chunks).
"""

from __future__ import annotations

import torch

from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.engine.search_itm import SearchExecution
from mmnas_tpu_torch.parallel.mesh import launch, run_engine


def main(argv=None):
    args = make_arg_parser("itm", search=True).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU")
    cfg = cfg_from_args("itm", args, search=True)
    return launch(run_engine, (SearchExecution, cfg), args.GPU, cfg.N_DEVICES, cfg.MULTIHOST)


if __name__ == "__main__":
    main()
