"""Accuracy rehearsal of the PyTorch port: the six engines trained and
searched to convergence on the planted-signal corpora (twin of the JAX
package's tools/rehearsal.py).

Runs the real data pipeline end to end for each task (the reference's
on-disk layouts, vocab and GloVe cache, the loaders, the port's engines,
the final checkpoint) and reports the official metrics (VQAEval overall,
IoU@0.5 accuracy, R@K) on the held-out split of the corpora made by
tools/make_rehearsal_data.py. Each runner builds the `Cfg` / `SearchCfg` of
its namesake in tools/rehearsal.py field for field and drives the port's
engines through their own build_dataset / make_loader / train / eval (or
run, for the searches).

Usage (from the repo root, on a CUDA GPU):

    python tools/make_rehearsal_data.py --out ./data_rehearsal
    python -m mmnas_tpu_torch.tools.make_glove_cache --task vqa --data_root ./data_rehearsal --stub
        (and --task vgd, --task itm)
    python -m mmnas_tpu_torch.tools.rehearsal --data_root ./data_rehearsal --task vqa --epochs 20

The flags are the JAX tool's, with --device (default cuda; without a card
the tool raises unless given --device cpu) in place of --cpu, and --seed
(default 44, the JAX runners' SEED) and --arch_path (the fixed-net tasks'
genotype, default ./arch/mcan.json) beside them. Each task writes
docs/evidence/rehearsal_torch_<task><tier><tags>.json: the JAX tool's keys
for that task, and beside them the final checkpoint's path, the train
loop's wall time and examples/s, the JAX package's recorded result for the
same command without --seed and --arch_path, which the JAX tool has not,
where the repo has one (`jax_reference`), and a provenance block with the
card's name and power limit. A CPU run adds `_cpu` to the name.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shlex
import shutil
import subprocess
import sys
import time

import torch

from mmnas_tpu_torch.config import Cfg, SearchCfg
from mmnas_tpu_torch.engine.itm import Execution as ItmExecution
from mmnas_tpu_torch.engine.search import SearchExecution as VqaSearchExecution
from mmnas_tpu_torch.engine.search_itm import SearchExecution as ItmSearchExecution
from mmnas_tpu_torch.engine.search_vgd import SearchExecution as VgdSearchExecution
from mmnas_tpu_torch.engine.vgd import Execution as VgdExecution
from mmnas_tpu_torch.engine.vqa import Execution as VqaExecution
from mmnas_tpu_torch.genotype import load_genotype
from mmnas_tpu_torch.train.checkpoint import ckpt_path

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
EVIDENCE_DIR = os.path.join(REPO, "docs", "evidence")
SEED = 44
TASKS = ("vqa", "vgd", "itm", "search_vqa", "search_vgd", "search_itm")
# the metrics of each task's JAX evidence file that `jax_reference` carries
METRICS = {"vqa": ("value",), "search_vqa": ("value",),
           "vgd": ("acc_iou0.5_val", "acc_iou0.5_test"),
           "search_vgd": ("acc_iou0.5_val", "acc_iou0.5_test"),
           "itm": ("i2t_r1", "i2t_r5", "i2t_r10", "t2i_r1", "t2i_r5", "t2i_r10"),
           "search_itm": ("i2t_r1", "i2t_r5", "i2t_r10", "t2i_r1", "t2i_r5", "t2i_r10")}
# JAX results whose evidence file was lost, by the file's name: what survives
TRANSCRIPTS = {"rehearsal_itm_scaled_noiseq0.3.json": {
    "file": None, "source": "docs/perf_analysis.md:359-377 (transcribed from the run's log; "
                            "the evidence file was lost)",
    "epochs": 30, "i2t_r1": 47.37, "t2i_r1": 46.32}}
# the keys this tool writes beside the JAX tool's
PORT_KEYS = ("checkpoint", "train_wall_s", "train_ex_per_s", "jax_reference")
SEARCH_KEYS = ("search_checkpoint", "search_wall_s", "search_ex_per_s",
               "search_loss_per_example")
COMPARE_KEYS = ("compare_checkpoint", "dec_xmodal_ops", "compare_dec_xmodal_ops")

# the decoder ops that route the text into the image trunk
# (tools/debug/_xmodal_k1_search_only.py:39-44)
XMODAL_OPS = ("guided_att",)


def dec_xmodal_count(genotype):
    return sum(1 for ops in genotype["dec"]
               for op in ops if any(op.startswith(p) for p in XMODAL_OPS))


def _knobs(cfg):
    """The schedule/config knobs needed to reproduce a run from its
    evidence file alone (docs/evidence/README.md contract)."""
    fields = ("TASK", "VERSION", "SEED", "BATCH_SIZE", "EVAL_BATCH_SIZE",
              "MAX_EPOCH", "NET_LR_BASE", "NET_LR_DECAY_LIST",
              "NET_LR_DECAY_R", "ARCH_PATH", "GENO_EPOCH", "DTYPE", "HSIZE",
              "SCORES_LOSS", "NEG_START_EPOCH", "NEG_NEPOCH", "ALPHA_START",
              "ALPHA_EVERY", "ALPHA_BINARY_MODE", "ALPHA_LR_BASE",
              "SPLIT_PORTION", "DATASET", "FEAT", "MAX_TOKEN", "CKPT_EVERY")
    out = {}
    for f in fields:
        if hasattr(cfg, f):
            v = getattr(cfg, f)
            out[f] = list(v) if isinstance(v, tuple) else v
    return out


def _small(cfg, hsize):
    if not hsize:
        return cfg
    # smoke-test scaling (CPU wiring checks); real rehearsals keep HSIZE=512
    return cfg.replace(HSIZE=hsize, ATTFLAT_OUT_SIZE=hsize * 2,
                       ATTFLAT_MLP_SIZE=hsize, DTYPE="float32")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def pack_splits(feat_dir: str, splits, dtype: str = "float16") -> str:
    """One packed store of the region features of every split in `splits`
    (npz directories under feat_dir), made by tools/pack_features.py (run as
    a program) at <feat_dir>/<splits[0]>.packed. The loaders read the first
    store they find among a corpus's feature directories (data/packed.py
    FeatureSource), so one store holds every split they read."""
    merged = os.path.join(feat_dir, "all_splits")
    shutil.rmtree(merged, ignore_errors=True)
    os.makedirs(merged)
    for split in splits:
        for path in glob.glob(os.path.join(feat_dir, split, "*.npz")):
            os.symlink(os.path.abspath(path), os.path.join(merged, os.path.basename(path)))
    subprocess.run([sys.executable, os.path.join(REPO, "tools", "pack_features.py"), "--src",
                    merged, "--max_len", "100", "--dtype", dtype], check=True,
                   capture_output=True, text=True)
    store = os.path.join(feat_dir, splits[0] + ".packed")
    shutil.rmtree(store, ignore_errors=True)
    os.replace(merged + ".packed", store)
    shutil.rmtree(merged)
    return store


def timed_train(ex, cfg, train_set, train_loader):
    """ex.train on the loader, timed: (the trained net, the record of the
    run: per-epoch losses, the final checkpoint, wall time, examples/s)."""
    t0 = time.time()
    result = ex.train(train_loader)
    _sync(ex.device)
    seconds = time.time() - t0
    return result.net, {
        "train_loss_per_example": [round(h, 4) for h in result.epoch_losses],
        "checkpoint": ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, cfg.MAX_EPOCH),
        "train_wall_s": round(seconds, 1),
        "train_ex_per_s": round(cfg.MAX_EPOCH * len(train_set) / seconds, 1)}


def timed_search(ex, scfg):
    """ex.run() of a search engine, timed: (the genotype of the last
    epoch's alpha, the record: checkpoint, wall time, weight-step
    examples/s as bench.py counts them, per-epoch losses)."""
    t0 = time.time()
    result = ex.run()
    _sync(ex.device)
    seconds = time.time() - t0
    return result.net.genotype(result.alpha_host), {
        "search_checkpoint": ckpt_path(scfg.CKPT_ROOT, scfg.VERSION, scfg.MAX_EPOCH),
        "search_wall_s": round(seconds, 1),
        "search_ex_per_s": round(len(result.step_losses) * scfg.BATCH_SIZE / seconds, 1),
        "search_loss_per_example": [round(h, 4) for h in result.epoch_losses]}


def run_vqa(data_root: str, epochs: int, hsize: int = 0,
            arch_path: str = "./arch/mcan.json", geno_epoch: int = 0,
            version: str = "rehearsal_vqa", device="cuda", seed: int = SEED,
            overrides=None):
    cfg = Cfg(TASK="vqa", DATA_ROOT=data_root, RUN_MODE="train",
              BATCH_SIZE=64, EVAL_BATCH_SIZE=64, NUM_WORKERS=2,
              MAX_EPOCH=epochs, SEED=seed, VERSION=version,
              ARCH_PATH=arch_path, GENO_EPOCH=geno_epoch,
              CKPT_EVERY=max(1, epochs),     # the final checkpoint only
              DTYPE="bfloat16", EVAL_EVERY_EPOCH=False)
    cfg = _small(cfg, hsize).replace(**(overrides or {}))
    ex = VqaExecution(cfg, device)
    train_set = ex.build_dataset("train")
    train_loader = ex.make_loader(train_set, cfg.BATCH_SIZE, shuffle=True)
    net, trained = timed_train(ex, cfg, train_set, train_loader)
    eval_set = ex.build_dataset("val")
    eval_loader = ex.make_loader(eval_set, cfg.EVAL_BATCH_SIZE)
    acc = ex.eval(eval_loader, net=net, valid=True).accuracy
    return {"metric": "vqa_val_accuracy(VQAEval overall)",
            "value": None if acc is None else round(100.0 * acc, 2),
            "cfg": _knobs(cfg), **trained}


def run_vgd(data_root: str, epochs: int, hsize: int = 0,
            arch_path: str = "./arch/mcan.json", geno_epoch: int = 0,
            lr: float = 0.0,
            version: str = "rehearsal_vgd", device="cuda", seed: int = SEED):
    cfg = Cfg(TASK="vgd", DATA_ROOT=data_root, RUN_MODE="train",
              DATASET="refcoco", FEAT="vg_woref", MAX_TOKEN=14,
              BATCH_SIZE=64, EVAL_BATCH_SIZE=64, NUM_WORKERS=2,
              NET_LR_BASE=lr or 0.00014, MAX_EPOCH=epochs, SEED=seed,
              VERSION=version, ARCH_PATH=arch_path, GENO_EPOCH=geno_epoch,
              CKPT_EVERY=max(1, epochs),
              DTYPE="bfloat16",
              EVAL_EVERY_EPOCH=False)
    cfg = _small(cfg, hsize)
    ex = VgdExecution(cfg, device)
    train_set = ex.build_dataset("train")
    train_loader = ex.make_loader(train_set, cfg.BATCH_SIZE, shuffle=True)
    net, trained = timed_train(ex, cfg, train_set, train_loader)
    out = {"cfg": _knobs(cfg), **trained}
    for split in ("val", "test"):  # test -> TEST_SPLIT (default testA)
        eval_set = ex.build_dataset(split)
        eval_loader = ex.make_loader(eval_set, cfg.EVAL_BATCH_SIZE)
        acc = ex.eval(eval_loader, net=net).accuracy
        out[f"acc_iou0.5_{split}"] = None if acc is None else round(acc, 2)
    out["metric"] = "vgd_accuracy@IoU0.5"
    return out


def itm_cfg(data_root: str, epochs: int, hsize: int = 0,
            lr: float = 0.0, mine_from: int = 0,
            decay_at: int = 0, decay_r: float = 0.0,
            loss: str = "bce", semihard: bool = False, skiptop: int = 0,
            noise_q: float = 0.0,
            arch_path: str = "./arch/mcan.json", geno_epoch: int = 0,
            version: str = "rehearsal_itm", seed: int = SEED) -> Cfg:
    """The Cfg of `run_itm`'s fixed-net run."""
    # the JAX runner's schedule (tools/rehearsal.py:133-164): a low lr, whose
    # first Adam steps keep the init's representation; hard mining from 2/5
    # of the run; one lr milestone (decay_r > 1 raises the lr there)
    mine_from = mine_from or max(1, epochs * 2 // 5)
    decay_list = ((decay_at,) if decay_at
                  else (max(10, epochs * 4 // 5),))
    cfg = Cfg(TASK="itm", DATA_ROOT=data_root, RUN_MODE="train",
              DATASET="flickr", MAX_TOKEN=50, FRCNFEAT_LEN=36,
              SCORES_LOSS=loss, NET_LR_BASE=lr or 0.0005,
              NET_LR_DECAY_LIST=decay_list,
              NET_LR_DECAY_R=decay_r or 0.2,
              NEG_START_EPOCH=mine_from, NEG_NEPOCH=2,
              MINE_SEMIHARD=semihard, MINE_SKIP_TOP=skiptop,
              MINE_NOISE_Q=noise_q,
              BATCH_SIZE=64, EVAL_BATCH_SIZE=64, NUM_WORKERS=2,
              MAX_EPOCH=epochs, SEED=seed, VERSION=version,
              ARCH_PATH=arch_path, GENO_EPOCH=geno_epoch,
              CKPT_EVERY=max(1, epochs),     # the final checkpoint only
              DTYPE="bfloat16", EVAL_EVERY_EPOCH=False)
    return _small(cfg, hsize)


def run_itm(data_root: str, epochs: int, hsize: int = 0, device="cuda", overrides=None,
            **kw):
    """ITM trained on the JAX runner's schedule (`itm_cfg`'s keywords), then
    R@K on the test split; `overrides` replaces fields of the Cfg."""
    cfg = itm_cfg(data_root, epochs, hsize, **kw).replace(**(overrides or {}))
    ex = ItmExecution(cfg, device)
    train_set = ex.build_dataset("train")
    train_loader = ex.make_loader(train_set, cfg.BATCH_SIZE, shuffle=True)
    net, trained = timed_train(ex, cfg, train_set, train_loader)
    eval_set = ex.build_dataset("test")
    eval_loader = ex.make_loader(eval_set, cfg.BATCH_SIZE)
    stats = ex.eval(eval_loader, net=net).stats
    # chance floors for this corpus size (random ranking): i2t ranks
    # n_caps candidate captions with CAPS_PER_IMG relevant per image
    # (hypergeometric "any in top K"); t2i ranks n_imgs images, 1 relevant
    from math import comb
    n_caps = len(eval_set)
    cpi = eval_set.CAPS_PER_IMG
    n_imgs = n_caps // cpi
    floors = {}
    for k in (1, 5, 10):
        floors[f"i2t_r{k}_floor"] = round(
            100.0 * (1.0 - comb(n_caps - cpi, k) / comb(n_caps, k)), 2)
        floors[f"t2i_r{k}_floor"] = round(100.0 * min(1.0, k / n_imgs), 2)
    out = {"metric": "itm_R@K(test)",
           "scores_loss": cfg.SCORES_LOSS,
           "net_lr_base": cfg.NET_LR_BASE, "mine_from_epoch": cfg.NEG_START_EPOCH,
           "lr_decay_list": list(cfg.NET_LR_DECAY_LIST),
           "lr_decay_r": cfg.NET_LR_DECAY_R,
           "mine_semihard": cfg.MINE_SEMIHARD,
           "mine_skip_top": cfg.MINE_SKIP_TOP,
           "mine_noise_q": cfg.MINE_NOISE_Q,
           "chance_floors": floors,
           "cfg": _knobs(cfg), **trained}
    if stats:
        out.update({k: round(v, 2) for k, v in stats.items()})
    return out


def _compare_leg(result, runner, data_root, epochs, hsize, compare_arch,
                 version, metric_keys, genotype, **kw):
    """Train a deliberately bad fixed genotype with the identical schedule
    and record the searched-vs-bad gap (tools/rehearsal.py:201-220), and
    both genotypes' cross-modal decoder ops, each counted from its
    genotype. arch/unimodal_dec_none.json is the canonical bad arch: its
    decoder is all 'none', so the image pathway is dead."""
    bad = runner(data_root, epochs, hsize=hsize, arch_path=compare_arch,
                 geno_epoch=0, version=version, **kw)
    result["compare_arch"] = compare_arch
    for k in metric_keys:
        result[f"compare_{k}"] = bad.get(k)
        if isinstance(result.get(k), (int, float)) and isinstance(
                bad.get(k), (int, float)):
            result[f"discrimination_gap_{k}"] = round(result[k] - bad[k], 2)
    result["compare_train_loss_per_example"] = bad.get(
        "train_loss_per_example")
    result["compare_checkpoint"] = bad["checkpoint"]
    result["dec_xmodal_ops"] = dec_xmodal_count(genotype)
    result["compare_dec_xmodal_ops"] = dec_xmodal_count(load_genotype(compare_arch, 0))
    return result


def _search_cfg(scfg, hsize):
    if hsize:
        scfg = scfg.replace(HSIZE=hsize, ATTFLAT_OUT_SIZE=hsize * 2,
                            ATTFLAT_MLP_SIZE=hsize, DTYPE="float32")
    return scfg


def run_search_vqa(data_root: str, epochs: int, hsize: int = 0,
                   alpha_mode: str = "full", kpath: int = 1,
                   compare_arch: str = "", device="cuda", seed: int = SEED):
    """Bilevel supernet search on the rehearsal corpus, the per-epoch
    genotype archive in logs/arch/, then the last searched genotype trained
    through the fixed-net path and scored with VQAEval."""
    search_epochs = max(4, epochs)
    alpha_start = max(1, search_epochs // 4)  # rehearsal-scaled ALPHA_START
    scfg = SearchCfg(TASK="vqa", DATA_ROOT=data_root, RUN_MODE="train",
                     BATCH_SIZE=64, EVAL_BATCH_SIZE=64, NUM_WORKERS=2,
                     MAX_EPOCH=search_epochs, ALPHA_START=alpha_start,
                     ALPHA_BINARY_MODE=alpha_mode, KPATH=kpath,
                     CKPT_EVERY=max(1, search_epochs),
                     SEED=seed, VERSION="rehearsal_search_vqa-search",
                     ARCH_ROOT="./logs/arch/",  # keep tracked arch/ clean
                     DTYPE="bfloat16", EVAL_EVERY_EPOCH=False)
    scfg = _search_cfg(scfg, hsize)
    genotype, searched = timed_search(VqaSearchExecution(scfg, device), scfg)
    arch_json = os.path.join(scfg.ARCH_ROOT, scfg.VERSION + ".json")

    trained = run_vqa(data_root, epochs, hsize=hsize,
                      arch_path=arch_json, geno_epoch=search_epochs,
                      version="rehearsal_search_vqa-train", device=device, seed=seed)
    out = {"metric": "search->train vqa_val_accuracy(VQAEval overall)",
           "value": trained["value"],
           "alpha_mode": alpha_mode, "kpath": kpath,
           "searched_genotype": genotype,
           "genotype_json": arch_json,
           "search_epochs": search_epochs,
           "alpha_start": alpha_start,
           "search_cfg": _knobs(scfg), "train_cfg": trained["cfg"],
           "train_loss_per_example": trained["train_loss_per_example"],
           **{k: trained[k] for k in PORT_KEYS if k in trained}, **searched}
    if compare_arch:
        _compare_leg(out, run_vqa, data_root, epochs, hsize, compare_arch,
                     "rehearsal_search_vqa-compare", ("value",), genotype,
                     device=device, seed=seed)
    return out


def run_search_vgd(data_root: str, epochs: int, hsize: int = 0,
                   alpha_mode: str = "full", compare_arch: str = "",
                   device="cuda", seed: int = SEED):
    """search -> genotype -> train for VGD, as run_search_vqa, scored with
    IoU@0.5."""
    search_epochs = max(4, epochs)
    alpha_start = max(1, search_epochs // 4)
    scfg = SearchCfg(TASK="vgd", DATA_ROOT=data_root, RUN_MODE="train",
                     DATASET="refcoco", FEAT="vg_woref", MAX_TOKEN=14,
                     BATCH_SIZE=64, EVAL_BATCH_SIZE=64, NUM_WORKERS=2,
                     MAX_EPOCH=search_epochs, ALPHA_START=alpha_start,
                     ALPHA_BINARY_MODE=alpha_mode,
                     CKPT_EVERY=max(1, search_epochs),
                     SEED=seed, VERSION="rehearsal_search_vgd-search",
                     ARCH_ROOT="./logs/arch/",
                     DTYPE="bfloat16", EVAL_EVERY_EPOCH=False)
    scfg = _search_cfg(scfg, hsize)
    genotype, searched = timed_search(VgdSearchExecution(scfg, device), scfg)
    arch_json = os.path.join(scfg.ARCH_ROOT, scfg.VERSION + ".json")

    trained = run_vgd(data_root, epochs, hsize=hsize,
                      arch_path=arch_json, geno_epoch=search_epochs,
                      version="rehearsal_search_vgd-train", device=device, seed=seed)
    out = {"metric": "search->train vgd_accuracy@IoU0.5",
           "acc_iou0.5_val": trained["acc_iou0.5_val"],
           "acc_iou0.5_test": trained["acc_iou0.5_test"],
           "alpha_mode": alpha_mode,
           "searched_genotype": genotype,
           "genotype_json": arch_json,
           "search_epochs": search_epochs,
           "alpha_start": alpha_start,
           "search_cfg": _knobs(scfg), "train_cfg": trained["cfg"],
           "train_loss_per_example": trained["train_loss_per_example"],
           **{k: trained[k] for k in PORT_KEYS if k in trained}, **searched}
    if compare_arch:
        _compare_leg(out, run_vgd, data_root, epochs, hsize, compare_arch,
                     "rehearsal_search_vgd-compare",
                     ("acc_iou0.5_val", "acc_iou0.5_test"), genotype,
                     device=device, seed=seed)
    return out


def run_search_itm(data_root: str, epochs: int, hsize: int = 0,
                   alpha_mode: str = "full", lr: float = 0.0,
                   mine_from: int = 0, decay_at: int = 0,
                   decay_r: float = 0.0, loss: str = "bce",
                   semihard: bool = False, skiptop: int = 0,
                   noise_q: float = 0.0, device="cuda", seed: int = SEED):
    """search -> genotype -> train for ITM: the bilevel search with hard
    mining inside it, then the fixed net trained on run_itm's schedule and
    scored with R@K on the test split (tools/rehearsal.py:318-380)."""
    # the search leg runs until alpha moves; the train leg takes run_itm's
    # long low-lr schedule
    search_epochs = max(4, min(epochs, 16))
    alpha_start = max(1, search_epochs // 4)
    # mining inside the search from 2/5 of it, after the first arch steps
    search_mine_from = max(alpha_start + 1, search_epochs * 2 // 5)
    scfg = SearchCfg(TASK="itm", DATA_ROOT=data_root, RUN_MODE="train",
                     DATASET="flickr", MAX_TOKEN=50, FRCNFEAT_LEN=36,
                     SCORES_LOSS=loss, NET_LR_BASE=lr or 0.00003,
                     NEG_START_EPOCH=search_mine_from, NEG_NEPOCH=2,
                     MINE_SEMIHARD=semihard, MINE_SKIP_TOP=skiptop,
                     MINE_NOISE_Q=noise_q,
                     BATCH_SIZE=64, EVAL_BATCH_SIZE=64, NUM_WORKERS=2,
                     MAX_EPOCH=search_epochs, ALPHA_START=alpha_start,
                     ALPHA_BINARY_MODE=alpha_mode,
                     CKPT_EVERY=max(1, search_epochs),
                     SEED=seed, VERSION="rehearsal_search_itm-search",
                     ARCH_ROOT="./logs/arch/",
                     DTYPE="bfloat16", EVAL_EVERY_EPOCH=False)
    scfg = _search_cfg(scfg, hsize)
    genotype, searched = timed_search(ItmSearchExecution(scfg, device), scfg)
    arch_json = os.path.join(scfg.ARCH_ROOT, scfg.VERSION + ".json")

    trained = run_itm(data_root, epochs, hsize=hsize, lr=lr,
                      mine_from=mine_from, decay_at=decay_at,
                      decay_r=decay_r, loss=loss, semihard=semihard,
                      skiptop=skiptop, noise_q=noise_q,
                      arch_path=arch_json, geno_epoch=search_epochs,
                      version="rehearsal_search_itm-train", device=device, seed=seed)
    return {"metric": "search->train itm_R@K(test)",
            "alpha_mode": alpha_mode,
            "searched_genotype": genotype,
            "genotype_json": arch_json,
            "search_epochs": search_epochs,
            "alpha_start": alpha_start,
            "search_mine_from": search_mine_from,
            "search_cfg": _knobs(scfg),
            **{k: trained[k] for k in trained if k != "metric"}, **searched}


RUNNERS = {"vqa": run_vqa, "vgd": run_vgd, "itm": run_itm, "search_vqa": run_search_vqa,
           "search_vgd": run_search_vgd, "search_itm": run_search_itm}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_root", default="./data_rehearsal")
    p.add_argument("--task", default="all", choices=("all",) + TASKS)
    p.add_argument("--epochs", type=int, default=13)
    p.add_argument("--hsize", type=int, default=0,
                   help="shrink the net for wiring checks (0 = full width)")
    p.add_argument("--itm_lr", type=float, default=0.0,
                   help="ITM NET_LR_BASE (0 = the runner's default)")
    p.add_argument("--itm_mine_from", type=int, default=0,
                   help="ITM NEG_START_EPOCH (0 = 2/5 of the epochs)")
    p.add_argument("--itm_decay_at", type=int, default=0,
                   help="ITM lr milestone epoch (with --itm_decay_r > 1 it raises the lr)")
    p.add_argument("--itm_decay_r", type=float, default=0.0,
                   help="ITM lr multiplier at the milestone (0 = 0.2)")
    p.add_argument("--itm_loss", default="bce", choices=["bce", "margin"],
                   help="ITM triplet loss")
    p.add_argument("--itm_semihard", default=False, action="store_true",
                   help="MINE_SEMIHARD: drop mined negatives that tie or beat the "
                        "item's strongest own positive")
    p.add_argument("--itm_mine_skiptop", default=0, type=int,
                   help="MINE_SKIP_TOP: drop each item's k top-scored mined candidates")
    p.add_argument("--itm_noise_q", default=0.0, type=float,
                   help="MINE_NOISE_Q: the bottom q of captions by corpus-pooled "
                        "own-positive score are label-noise suspects")
    p.add_argument("--search_alpha_mode", default="full", choices=["full", "two"],
                   help="arch-step gate mode of the search tasks")
    p.add_argument("--search_kpath", type=int, default=1,
                   help="KPATH of search_vqa: K sampled paths a weight step")
    p.add_argument("--device", default="cuda",
                   help="torch device; without a card the tool raises unless given cpu")
    p.add_argument("--vgd_lr", type=float, default=0.0,
                   help="VGD NET_LR_BASE (0 = 0.00014)")
    p.add_argument("--evidence_tag", default="",
                   help="extra evidence-file suffix for variant runs")
    p.add_argument("--compare_arch", default="",
                   help="search_vqa / search_vgd: also train this fixed genotype (e.g. "
                        "arch/unimodal_dec_none.json) on the same schedule and record the "
                        "searched-vs-bad gap")
    p.add_argument("--seed", type=int, default=SEED,
                   help="SEED of every run (the JAX runners' 44); another adds _seed<N> "
                        "to the evidence name")
    p.add_argument("--arch_path", default="",
                   help="vqa / vgd / itm: the genotype to train (default ./arch/mcan.json); "
                        "adds _<its name> to the evidence name and the run's VERSION")
    return p


def runner_kwargs(task: str, args) -> dict:
    """The runner's keyword arguments from the flags (tools/rehearsal.py:466-488)."""
    itm = {"lr": args.itm_lr, "mine_from": args.itm_mine_from,
           "decay_at": args.itm_decay_at, "decay_r": args.itm_decay_r,
           "loss": args.itm_loss, "semihard": args.itm_semihard,
           "skiptop": args.itm_mine_skiptop, "noise_q": args.itm_noise_q}
    kw = {"vqa": {}, "vgd": {"lr": args.vgd_lr}, "itm": itm,
          "search_vqa": {"alpha_mode": args.search_alpha_mode, "kpath": args.search_kpath,
                         "compare_arch": args.compare_arch},
          "search_vgd": {"alpha_mode": args.search_alpha_mode,
                         "compare_arch": args.compare_arch},
          "search_itm": {"alpha_mode": args.search_alpha_mode, **itm}}[task]
    if args.arch_path and task in ("vqa", "vgd", "itm"):
        name = os.path.splitext(os.path.basename(args.arch_path))[0]
        kw.update(arch_path=args.arch_path, version=f"rehearsal_{task}_{name}")
    return kw


def evidence_tags(task: str, args, tier_tag: str):
    """(the JAX tool's file-name suffix for this run, the port's extra
    suffixes): the tier, the kpath and mining-variant tags and
    --evidence_tag as the JAX tool appends them (tools/rehearsal.py:502-514);
    then --seed, --arch_path and the CPU."""
    ktag = ("_kpath%d" % args.search_kpath
            if task == "search_vqa" and args.search_kpath > 1 else "")
    if task in ("itm", "search_itm") and args.itm_semihard:
        ktag += "_semihard"
    if task in ("itm", "search_itm") and args.itm_mine_skiptop:
        ktag += "_skiptop%d" % args.itm_mine_skiptop
    if task in ("itm", "search_itm") and args.itm_noise_q:
        ktag += "_noiseq%g" % args.itm_noise_q
    if args.evidence_tag:
        ktag += "_" + args.evidence_tag.strip("_")
    port = ""
    if args.seed != SEED:
        port += "_seed%d" % args.seed
    if args.arch_path and task in ("vqa", "vgd", "itm"):
        port += "_" + os.path.splitext(os.path.basename(args.arch_path))[0]
    if torch.device(args.device).type == "cpu":
        port += "_cpu"
    return tier_tag + ktag, port


def evidence_name(task: str, jax_tags: str, port_tags: str) -> str:
    return f"rehearsal_torch_{task}{jax_tags}{port_tags}.json"


def jax_reference(task: str, jax_tags: str):
    """The JAX package's recorded result of the same command (without the
    port's --seed and --arch_path): its evidence file's metrics, epochs and
    device, or what survives of a lost one."""
    name = f"rehearsal_{task}{jax_tags}.json"
    path = os.path.join(EVIDENCE_DIR, name)
    if not os.path.exists(path):
        return TRANSCRIPTS.get(name)
    with open(path) as f:
        ref = json.load(f)
    return {"file": os.path.relpath(path, REPO), "epochs": ref.get("epochs"),
            "device": ref.get("provenance", {}).get("device"),
            **{k: ref.get(k) for k in METRICS[task]}}


def card_line(device) -> str | None:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of the
    run's card, or None off the card."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[device.index or 0]


def provenance(device, module: str, argv) -> dict:
    """The run's date, command (`python -m <module> <argv>`), device, card
    line and versions."""
    device = torch.device(device)
    return {"date_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "command": shlex.join([os.path.basename(sys.executable), "-m", module, *argv]),
            "backend": device.type,
            "device": (torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"),
            "card": card_line(device),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def check_device(device: str) -> torch.device:
    """The run's device; a CUDA device must exist (no quiet CPU fallback)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on the GPU (pass --device cpu "
                           "for a CPU run)")
    return device


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = make_parser().parse_args(argv)
    device = check_device(args.device)
    tasks = ["vqa", "vgd", "itm"] if args.task == "all" else [args.task]
    os.makedirs(EVIDENCE_DIR, exist_ok=True)
    # the corpus tier (make_rehearsal_data.py --tier): in the evidence, and a
    # suffix of its name beyond the small tier
    meta, tier_tag = None, ""
    meta_path = os.path.join(args.data_root, "rehearsal_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("tier", "small") != "small":
            tier_tag = "_" + meta["tier"]
    written = []
    for task in tasks:
        t0 = time.time()
        result = RUNNERS[task](args.data_root, args.epochs, args.hsize, device=device,
                               seed=args.seed, **runner_kwargs(task, args))
        result["epochs"] = args.epochs
        result["wallclock_s"] = round(time.time() - t0, 1)
        if meta is not None:
            result["data_tier"] = meta
        jax_tags, port_tags = evidence_tags(task, args, tier_tag)
        result["jax_reference"] = jax_reference(task, jax_tags)
        result["provenance"] = provenance(device, "mmnas_tpu_torch.tools.rehearsal", argv)
        out = os.path.join(EVIDENCE_DIR, evidence_name(task, jax_tags, port_tags))
        with open(out, "w") as f:
            json.dump(result, f, indent=1)
            f.write("\n")
        print(f"[rehearsal] {task}: {json.dumps(result)[:400]}")
        print(f"[rehearsal] wrote {out}", flush=True)
        written.append(out)
    return written


if __name__ == "__main__":
    main()
