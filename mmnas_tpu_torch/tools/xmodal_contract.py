"""The cross-modal discrimination contract on the PyTorch port: search on
the xmodal corpus, then train the searched genotype and an image-blind one
on the same schedule, and compare (the port's version of the JAX package's
tools/debug/_xmodal_k1_search_only.py and _xmodal_k1_train_contract.py).

    python -m mmnas_tpu_torch.tools.xmodal_contract [--data_root ./data_rehearsal_xmodal]
        [--epochs 8] [--device cuda]

The xmodal corpus's answer is ANSWERS[(keyword + image signature) % 12]
(tools/make_rehearsal_data.py gen_vqa): no image-blind predictor beats the
corpus's text-only ceiling, and guided attention is the only decoder op
that routes the text into the image trunk. One process runs, in order:

- corpus: tools/make_rehearsal_data.py --tier scaled --xmodal and
  tools/pack_features.py, run as programs, and the stub GloVe cache
  (tools/make_glove_cache.py here). The VQA loaders read the first packed
  store among the splits' feature directories (data/packed.py
  FeatureSource), so the images of every split are packed into one store
  at train2014.packed: with a store a split, the val split's whole-batch
  loader finds its images in no store;
- search: the K 1 search of _xmodal_k1_search_only.py:53-60 (8 epochs,
  ALPHA_START 2, mode full, DEVICE_REL and SHIP_INT8); the genotype archive
  goes to logs/arch/rehearsal_search_vqa-search.json;
- searched, bad: the two arms of _xmodal_k1_train_contract.py:156-162, the
  epoch-8 searched genotype and arch/unimodal_dec_none.json, trained 8
  epochs and scored with VQAEval on val;
- merge: the record in the schema of _xmodal_k1_train_contract.py's
  merge(), with both genotypes' cross-modal decoder ops counted from the
  genotypes, to docs/evidence/rehearsal_torch_search_vqa_scaled_xmodal.json
  (`_cpu` added on the CPU).

The JAX scripts ran the arms in processes of their own for the TPU host's
memory; one process holds all of it on a CUDA host.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from mmnas_tpu_torch.config import Cfg, SearchCfg
from mmnas_tpu_torch.engine.search import SearchExecution
from mmnas_tpu_torch.engine.vqa import Execution
from mmnas_tpu_torch.genotype import load_genotype
from mmnas_tpu_torch.tools.rehearsal import (
    EVIDENCE_DIR, REPO, SEED, check_device, dec_xmodal_count, pack_splits, provenance, timed_search,
    timed_train,
)

DATA_ROOT = "./data_rehearsal_xmodal"
EPOCHS = 8
CORPUS_SEED = 7                   # make_rehearsal_data.py's default --seed
SEARCH_DUMP = "./logs/arch/rehearsal_search_vqa-search.json"
BAD_ARCH = "./arch/unimodal_dec_none.json"
JAX_SEARCH_ONLY = os.path.join(EVIDENCE_DIR,
                               "rehearsal_search_vqa_scaled_xmodal_k1_searchonly.json")


def make_corpus(data_root: str) -> None:
    """The xmodal corpus, its stub GloVe cache and one packed store of every
    split's images, by the repo's programs."""
    tools = os.path.join(REPO, "tools")
    subprocess.run([sys.executable, os.path.join(tools, "make_rehearsal_data.py"), "--out",
                    data_root, "--tier", "scaled", "--xmodal", "--seed", str(CORPUS_SEED)],
                   check=True)
    subprocess.run([sys.executable, "-m", "mmnas_tpu_torch.tools.make_glove_cache", "--task",
                    "vqa", "--data_root", data_root, "--stub"], check=True, cwd=REPO)
    pack_splits(os.path.join(data_root, "vqa", "bua-r101-max100"),
                ("train2014", "val2014", "test2015"))


def search_cfg(data_root: str, epochs: int = EPOCHS) -> SearchCfg:
    """_xmodal_k1_search_only.py:53-60: run_search_vqa(epochs=8)'s search
    configuration with the int8 whole-batch loader."""
    return SearchCfg(TASK="vqa", DATA_ROOT=data_root,
                     RUN_MODE="train", BATCH_SIZE=64, EVAL_BATCH_SIZE=64,
                     NUM_WORKERS=2, MAX_EPOCH=epochs, ALPHA_START=2,
                     ALPHA_BINARY_MODE="full", KPATH=1, CKPT_EVERY=epochs,
                     SEED=SEED, VERSION="rehearsal_search_vqa-search",
                     ARCH_ROOT="./logs/arch/", DTYPE="bfloat16",
                     EVAL_EVERY_EPOCH=False,
                     DEVICE_REL=True, SHIP_INT8=True)


def arm_cfg(data_root: str, arch_path: str, geno_epoch: int, version: str,
            epochs: int = EPOCHS) -> Cfg:
    """_xmodal_k1_train_contract.py:156-162: run_vqa's configuration with the
    int8 whole-batch loader."""
    return Cfg(TASK="vqa", DATA_ROOT=data_root, RUN_MODE="train",
               BATCH_SIZE=64, EVAL_BATCH_SIZE=64, NUM_WORKERS=2,
               MAX_EPOCH=epochs, SEED=SEED, VERSION=version,
               ARCH_PATH=arch_path, GENO_EPOCH=geno_epoch,
               CKPT_EVERY=epochs, DTYPE="bfloat16",
               EVAL_EVERY_EPOCH=False,
               DEVICE_REL=True, SHIP_INT8=True)


ARMS = {"searched": (SEARCH_DUMP, True, "xmodal_k1-train"),    # arch, epoch-K genotype, version
        "bad": (BAD_ARCH, False, "xmodal_k1-compare")}


def run_search(data_root: str, epochs: int, device) -> dict:
    scfg = search_cfg(data_root, epochs)
    genotype, searched = timed_search(SearchExecution(scfg, device), scfg)
    return {"searched_genotype": genotype,
            "genotype_json": os.path.join(scfg.ARCH_ROOT, scfg.VERSION + ".json"), **searched}


def train_arm(data_root: str, epochs: int, arm: str, device) -> dict:
    arch_path, searched, version = ARMS[arm]
    geno_epoch = epochs if searched else 0
    cfg = arm_cfg(data_root, arch_path, geno_epoch, version, epochs)
    ex = Execution(cfg, device)
    train_set = ex.build_dataset("train")
    train_loader = ex.make_loader(train_set, cfg.BATCH_SIZE, shuffle=True)
    net, trained = timed_train(ex, cfg, train_set, train_loader)
    eval_set = ex.build_dataset("val")
    acc = ex.eval(ex.make_loader(eval_set, cfg.EVAL_BATCH_SIZE), net=net, valid=True).accuracy
    return {"value": None if acc is None else round(100.0 * acc, 2), **trained,
            "arch_path": arch_path, "geno_epoch": geno_epoch,
            "dec_xmodal_ops": dec_xmodal_count(load_genotype(arch_path, geno_epoch)),
            "ship": "int8+device_rel", "backend": ex.device.type}


def jax_search_only():
    """The JAX package's search-only leg of this contract on the TPU (its
    trained arms never ran)."""
    if not os.path.exists(JAX_SEARCH_ONLY):
        return None
    with open(JAX_SEARCH_ONLY) as f:
        ref = json.load(f)
    return {"file": os.path.relpath(JAX_SEARCH_ONLY, REPO),
            "device": ref["provenance"]["device"],
            **{k: ref[k] for k in ("dec_xmodal_ops", "searched_genotype", "search_epochs")}}


def merge(data_root: str, epochs: int, search: dict, searched: dict, bad: dict) -> dict:
    """The record of _xmodal_k1_train_contract.py merge() (:222-261), with
    both genotypes' cross-modal decoder ops counted from them."""
    with open(os.path.join(data_root, "rehearsal_meta.json")) as f:
        meta = json.load(f)
    out = {"metric": "search->train vqa_val_accuracy(VQAEval overall)",
           "value": searched["value"],
           "alpha_mode": "full", "kpath": 1,
           "searched_genotype": search["searched_genotype"],
           "genotype_json": search["genotype_json"],
           "search_epochs": epochs, "alpha_start": 2,
           "train_loss_per_example": searched["train_loss_per_example"],
           "compare_arch": BAD_ARCH,
           "compare_value": bad["value"],
           "compare_train_loss_per_example": bad["train_loss_per_example"],
           "epochs": epochs,
           "data_tier": meta,
           "train_ex_per_s_int8": {"searched": searched["train_ex_per_s"],
                                   "bad": bad["train_ex_per_s"]},
           "dec_xmodal_ops": searched["dec_xmodal_ops"],
           "compare_dec_xmodal_ops": bad["dec_xmodal_ops"],
           "checkpoint": searched["checkpoint"], "compare_checkpoint": bad["checkpoint"],
           "train_wall_s": {"searched": searched["train_wall_s"], "bad": bad["train_wall_s"]},
           **{k: search[k] for k in ("search_checkpoint", "search_wall_s", "search_ex_per_s",
                                     "search_loss_per_example")},
           "processes": "one process ran the corpus, the search, both arms and the merge",
           "jax_reference": jax_search_only()}
    if isinstance(searched["value"], (int, float)) and isinstance(bad["value"], (int, float)):
        out["discrimination_gap_value"] = round(searched["value"] - bad["value"], 2)
    return out


def evidence_path(device) -> str:
    suffix = "_cpu" if check_device(device).type == "cpu" else ""
    return os.path.join(EVIDENCE_DIR, f"rehearsal_torch_search_vqa_scaled_xmodal{suffix}.json")


def timed(name: str, phase):
    t0 = time.time()
    record = phase()
    record["phase_wall_s"] = round(time.time() - t0, 1)
    print(f"[xmodal] {name}: {json.dumps(record)[:400]}", flush=True)
    return record


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data_root", default=DATA_ROOT)
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--device", default="cuda",
                    help="torch device; without a card the tool raises unless given cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    if not os.path.exists(os.path.join(args.data_root, "rehearsal_meta.json")):
        make_corpus(args.data_root)
    search = timed("search", lambda: run_search(args.data_root, args.epochs, device))
    searched = timed("searched", lambda: train_arm(args.data_root, args.epochs, "searched", device))
    bad = timed("bad", lambda: train_arm(args.data_root, args.epochs, "bad", device))
    out = merge(args.data_root, args.epochs, search, searched, bad)
    out["provenance"] = provenance(device, "mmnas_tpu_torch.tools.xmodal_contract", argv)
    path = evidence_path(device)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: v for k, v in out.items() if k not in ("searched_genotype", "data_tier")}))
    print("wrote", path, flush=True)
    return out


if __name__ == "__main__":
    main()
