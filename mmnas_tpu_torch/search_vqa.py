"""Supernet architecture search for VQA with the PyTorch port, on one CUDA
GPU or data-parallel on several (counterpart of the JAX package's
search_vqa.py; --GPU 0,1, --NDEV N, or --MULTIHOST under torchrun, as
train_vqa.py shows).

The same flags as the JAX package's search CLI:

    python -m mmnas_tpu_torch.search_vqa --SYNTH --MAX_EPOCH 3 --BS 128
    python -m mmnas_tpu_torch.search_vqa --SYNTH --BS 256 --KPATH 8 --DTYPE bfloat16
    python -m mmnas_tpu_torch.search_vqa --RESUME --CKPT_PATH logs/ckpts/search_vqa-search_epoch3.pkl
    python -m mmnas_tpu_torch.search_vqa --SYNTH --BS 128 --UNIFIED_WEIGHT
    python -m mmnas_tpu_torch.search_vqa --SYNTH --BS 128 --UNIFIED_WEIGHT --SCAN_STEPS 10
    python -m mmnas_tpu_torch.search_vqa --SYNTH --BS 128 --DENSE_WEIGHT --REMAT
    python -m mmnas_tpu_torch.search_vqa --SYNTH --NDEV 2 --MODEL_AXIS 2

Per-epoch genotypes are appended to ./arch/<VERSION>.json in the reference
schema {"epochK": {"enc": [[op]x12], "dec": [[op]x18]}}; checkpoints are the
pickled numpy pytrees either package writes and resumes from. The weight
step's program is the sampled one, or --DENSE_WEIGHT, --UNIFIED_WEIGHT or
--HYBRID_WEIGHT (KPATH 1; engine/search.py). --REMAT rematerializes each
candidate op of the 'full' program (the arch steps, --DENSE_WEIGHT) in the
backward, with the first pass's dropout masks (models/supernet.py).
--SCAN_STEPS N runs an epoch's steps in chunks of N (a multiple of
--ALPHA_EVERY) to the per-step loop's paths and states: replayed from CUDA
graphs under --UNIFIED_WEIGHT or --DENSE_WEIGHT with 'full' arch steps in
one process, on the per-step loop otherwise; the run prints which
(engine/search.py).
"""

from __future__ import annotations

import torch

from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.engine.search import SearchExecution
from mmnas_tpu_torch.parallel.mesh import launch, run_engine


def main(argv=None):
    args = make_arg_parser("vqa", search=True).parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU")
    cfg = cfg_from_args("vqa", args, search=True)
    return launch(run_engine, (SearchExecution, cfg), args.GPU, cfg.N_DEVICES, cfg.MULTIHOST)


if __name__ == "__main__":
    main()
