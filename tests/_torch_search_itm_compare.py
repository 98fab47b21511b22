"""The small tier's ITM search leg in both packages on the CPU: the JAX
package's and the port's search engines at the rehearsal's search settings
(tools/rehearsal.py run_search_itm: HSIZE 256, bf16, lr 3e-5, ALPHA_START 4,
mining from epoch 6, seed 44), stopped after --epochs epochs, side by side:
per-epoch losses and the alpha each ends with.

    python tests/_torch_search_itm_compare.py --data_root ./data_rehearsal --epochs 6

The corpus is tools/make_rehearsal_data.py's small tier with the stub GloVe
cache. Writes docs/evidence/rehearsal_search_itm_cpu_jax_vs_port.json (or
--out). Not collected by pytest: a run takes minutes.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

SETTINGS = dict(TASK="itm", RUN_MODE="train", DATASET="flickr", MAX_TOKEN=50, FRCNFEAT_LEN=36,
                SCORES_LOSS="bce", NET_LR_BASE=0.00003, NEG_START_EPOCH=6, NEG_NEPOCH=2,
                BATCH_SIZE=64, EVAL_BATCH_SIZE=64, NUM_WORKERS=2, ALPHA_START=4,
                ALPHA_BINARY_MODE="full", SEED=44, ARCH_ROOT="./logs/arch/",
                DTYPE="bfloat16", EVAL_EVERY_EPOCH=False)
EPOCH_LINE = re.compile(r"epoch = (\d+)\s+loss = ([0-9.eE+-]+)")


def losses_of(text: str):
    return [float(m.group(2)) for m in EPOCH_LINE.finditer(text)]


def run_jax(data_root: str, epochs: int):
    import jax
    jax.config.update("jax_platforms", "cpu")
    from mmnas_tpu.config import SearchCfg
    from mmnas_tpu.engine.search_itm import SearchExecution

    cfg = SearchCfg(DATA_ROOT=data_root, MAX_EPOCH=epochs, CKPT_EVERY=epochs,
                    VERSION="cpu_compare_search_itm_jax", **SETTINGS)
    out = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(out):
        _, alpha, _ = SearchExecution(cfg).run()
    return {"epoch_losses": losses_of(out.getvalue()), "seconds": round(time.time() - t0, 1),
            "alpha": {k: np.asarray(v, np.float32).tolist() for k, v in alpha.items()}}


def run_port(data_root: str, epochs: int):
    import torch
    from mmnas_tpu_torch.config import SearchCfg
    from mmnas_tpu_torch.engine.search_itm import SearchExecution

    cfg = SearchCfg(DATA_ROOT=data_root, MAX_EPOCH=epochs, CKPT_EVERY=epochs,
                    VERSION="cpu_compare_search_itm_port", **SETTINGS)
    t0 = time.time()
    result = SearchExecution(cfg, torch.device("cpu")).run()
    return {"epoch_losses": [round(x, 6) for x in result.epoch_losses],
            "seconds": round(time.time() - t0, 1),
            "alpha": {k: np.asarray(v, np.float32).tolist() for k, v in result.alpha_host.items()}}


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_root", default="./data_rehearsal")
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--out", default=os.path.join(
        REPO, "docs", "evidence", "rehearsal_search_itm_cpu_jax_vs_port.json"))
    args = p.parse_args()
    port = run_port(args.data_root, args.epochs)
    jx = run_jax(args.data_root, args.epochs)
    diff = {k: float(np.abs(np.asarray(jx["alpha"][k]) - np.asarray(port["alpha"][k])).max())
            for k in jx["alpha"]}
    record = {"settings": dict(SETTINGS, HSIZE=256, MAX_EPOCH=args.epochs),
              "jax_cpu": jx, "port_cpu": port, "alpha_max_abs_diff": diff,
              "command": "python tests/_torch_search_itm_compare.py " + " ".join(sys.argv[1:])}
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    print(json.dumps({"jax": jx["epoch_losses"], "port": port["epoch_losses"],
                      "alpha_max_abs_diff": diff}))


if __name__ == "__main__":
    main()
