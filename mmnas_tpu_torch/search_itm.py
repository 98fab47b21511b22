"""Supernet architecture search for ITM with the PyTorch port, on one CUDA
GPU (counterpart of the JAX package's search_itm.py).

The same flags as the JAX package's search CLI (make_arg_parser("itm",
search=True)):

    python -m mmnas_tpu_torch.search_itm --SYNTH --MAX_EPOCH 3 --BS 16
    python -m mmnas_tpu_torch.search_itm --DATASET flickr

Per-epoch hard-negative mining with a sampled path, genotypes appended to
./arch/<VERSION>.json in the reference schema, the argmax path's R@K on the
val split; checkpoints are the pickled numpy pytrees either package writes
and resumes from. --SCAN_STEPS, the dense/unified/hybrid weight steps and
--MULTIHOST are not ported.
"""

from __future__ import annotations

import torch

from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.engine.search_itm import SearchExecution


def main(argv=None):
    args = make_arg_parser("itm", search=True).parse_args(argv)
    if args.MULTIHOST:
        raise NotImplementedError("--MULTIHOST is not ported (ROADMAP.md, queue 1: parallel/)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU")
    cfg = cfg_from_args("itm", args, search=True)
    return SearchExecution(cfg, torch.device("cuda", int(args.GPU))).run()


if __name__ == "__main__":
    main()
