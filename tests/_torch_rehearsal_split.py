"""Runs that split a rehearsal result of the port by precision, by attention
implementation and by mining, on a CUDA card: the rehearsal's runners
(mmnas_tpu_torch/tools/rehearsal.py) with their `overrides` of the Cfg.
Not collected by pytest: a run takes minutes on the card.

    python tests/_torch_rehearsal_split.py train --arch_path A \\
        [--seed 44] [--dtype bfloat16|float32] [--attention kernels|plain_rsa|plain] \\
        [--hsize H] [--ckpt_every N]
    python tests/_torch_rehearsal_split.py train --task vqa --data_root D \\
        --arch_path ./arch/mcan.json --epochs 40 [--int8]
    python tests/_torch_rehearsal_split.py mine --arch_path A --ckpt P \\
        [--seed 44] [--epoch 26]

`train` runs `run_itm` with the small tier's search->ITM train-leg flags
(40 epochs, lr 3e-5, the lr raised 5x at epoch 15, hard mining from epoch
25) at full width, at --dtype, with the attention kernels, or with their
plain PyTorch version in their place for the calls with the RSA chain
(`plain_rsa`) or for every call (`plain`); the plain stand-in draws its
dropout keep mask with `torch.rand` on the step's generator; --hsize
narrows the net by the runner's own scaling. It writes
docs/evidence/rehearsal_torch_split_itm_<arch>_<dtype>_<attention>_seed<S>[_h<H>].json.
`train --task vqa` runs `run_vqa` instead (its own schedule, --epochs), and
--int8 feeds it through the whole-batch loader with DEVICE_REL and
SHIP_INT8, as the cross-modal contract's arms are fed
(mmnas_tpu_torch/tools/xmodal_contract.py arm_cfg).

`mine` loads a checkpoint of that leg and runs epoch --epoch's mining pass
as the train engine does (`engine/itm.py` `mine`), keeping every scored tile.
For every item it holds the negatives the pass stored against the top
NEG_HARDSIZE of the card's scores, as the engine's sort and as a stable
sort, and where those differ, counts the candidates tied with the
NEG_HARDSIZE-th score and within one bf16 ulp of it. Then it scores every
tile again on the card with the plain attention, and the first tile of each
sweep on the CPU (the parameters rounded to the compute dtype, computed on
in fp32), and counts the items whose top NEG_HARDSIZE differ, away from
ties (band: twice the largest score difference). It writes
docs/evidence/rehearsal_torch_split_itm_mine_<arch>_seed<S>.json.

The runs behind docs/evidence/rehearsal_torch_split_*.json, from the repo
root after `bash mmnas_tpu_torch/tools/rehearsal_runs.sh traces` (which
writes the genotypes tmp/{port,jax}_search_itm_arch.json): `train` with
--arch_path tmp/port_search_itm_arch.json at seed 44 (--ckpt_every 26, then
`mine` on its epoch-26 checkpoint), --dtype float32 and --attention
plain_rsa at seeds 44 and 45, --attention plain at seed 44, --hsize 128 and
256 at seeds 44 and 45; with --arch_path tmp/jax_search_itm_arch.json
--dtype float32 at seeds 44 and 45, --attention plain_rsa and plain at
seeds 44 and 45, --hsize 128 and 256 at seeds 44 and 45; and the VQA run
above on ./data_rehearsal_xmodal. Files whose provenance names
`-m mmnas_tpu_torch.tools.rehearsal_split` were written by this script's
earlier copy in the package, with the same arguments.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shlex
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mmnas_tpu_torch.engine import itm as ITM  # noqa: E402
from mmnas_tpu_torch.models.net import compute_dtype  # noqa: E402
from mmnas_tpu_torch.ops import attention as ATT  # noqa: E402
from mmnas_tpu_torch.ops.fused_attention import fused_attention_reference  # noqa: E402
from mmnas_tpu_torch.tools import rehearsal as RH  # noqa: E402

ITM_FLAGS = {"lr": 0.00003, "decay_at": 15, "decay_r": 5.0, "mine_from": 25}
EPOCHS = 40
SCRIPT = "tests/_torch_rehearsal_split.py"


def plain_attention(q, k, v, mask=None, log_bias=None, *, rel=None, dropout_r=0.0,
                    generator=None, head0=0, heads_total=None):
    """The kernels' plain version in their place, with attention dropout:
    the keep mask drawn by torch.rand from the call's generator."""
    keep = None
    if dropout_r > 0.0:
        total = q.shape[1] if heads_total is None else heads_total
        shape = (q.shape[0], total, q.shape[2], k.shape[2])
        keep = (torch.rand(shape, generator=generator, device=q.device)
                < 1.0 - dropout_r)[:, head0:head0 + q.shape[1]]
    return fused_attention_reference(q, k, v, mask, log_bias, rel=rel, keep=keep,
                                     dropout_r=dropout_r)


@contextlib.contextmanager
def attention(which: str):
    """`scaled_dot_attention`'s calls inside the block: `kernels` (as
    shipped), `plain_rsa` (the plain stand-in for calls with the RSA chain)
    or `plain` (for all of them)."""
    kernels = ATT.fused_attention

    def routed(q, k, v, mask=None, log_bias=None, *, rel=None, **kw):
        if which == "plain" or rel is not None:
            return plain_attention(q, k, v, mask, log_bias, rel=rel, **kw)
        return kernels(q, k, v, mask, log_bias, rel=rel, **kw)

    if which != "kernels":
        ATT.fused_attention = routed
    try:
        yield
    finally:
        ATT.fused_attention = kernels


def provenance(device) -> dict:
    """The rehearsal's provenance block, its command this script's."""
    out = RH.provenance(device, "", sys.argv[1:])
    out["command"] = shlex.join([os.path.basename(sys.executable), SCRIPT, *sys.argv[1:]])
    return out


def arch_name(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def write(name: str, result: dict) -> str:
    out = os.path.join(RH.EVIDENCE_DIR, name)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
        f.write("\n")
    print(f"[split] wrote {out}: {json.dumps(result)[:600]}", flush=True)
    return out


def train(args) -> str:
    device = RH.check_device(args.device)
    # the runner's dtype: bf16 at full width, fp32 narrowed (rehearsal._small)
    dtype = args.dtype or ("float32" if args.hsize else "bfloat16")
    over = {"DTYPE": dtype}
    if args.ckpt_every:
        over["CKPT_EVERY"] = args.ckpt_every
    if args.int8:
        over.update(DEVICE_REL=True, SHIP_INT8=True)
    name = f"{arch_name(args.arch_path)}_{dtype}_{args.attention}_seed{args.seed}"
    name += (f"_h{args.hsize}" if args.hsize else "") + ("_int8" if args.int8 else "")
    epochs = args.epochs or EPOCHS
    kw = dict(hsize=args.hsize, arch_path=args.arch_path, seed=args.seed,
              version=f"split_{args.task}_{name}", device=device, overrides=over)
    t0 = time.time()
    with attention(args.attention):
        result = (RH.run_itm(args.data_root, epochs, **kw, **ITM_FLAGS) if args.task == "itm"
                  else RH.run_vqa(args.data_root, epochs, **kw))
    meta = os.path.join(args.data_root, "rehearsal_meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            result["data_tier"] = json.load(f)
    result.update(epochs=epochs, attention=args.attention,
                  loader="whole batch, DEVICE_REL + SHIP_INT8" if args.int8 else "per item",
                  wallclock_s=round(time.time() - t0, 1),
                  provenance=provenance(device))
    return write(f"rehearsal_torch_split_{args.task}_{name}.json", result)


def top_sets_differ(ids, s_a, s_b, H, band):
    """Items whose top H by s_a leave out a candidate that s_b puts above its
    H-th score + band, or take one that s_b puts below its H-th - band."""
    bad = 0
    for item in range(len(ids)):
        order = np.argsort(-s_a[item], kind="stable")[:H]
        got = set(ids[item][order].tolist())
        s_h = np.sort(s_b[item])[::-1][H - 1]
        must = set(ids[item][s_b[item] > s_h + band].tolist())
        may = set(ids[item][s_b[item] >= s_h - band].tolist())
        bad += not (must <= got <= may)
    return bad


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 numbers at x (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(abs(x))) - 7)


def stored_vs_card(ids, card, mined, H):
    """The stored negatives of each item against the top H of the card's
    scores: by the engine's sort (`mine_sweep`'s argsort), by a stable sort,
    and for each item where the stable top differs, its ties at the H-th."""
    engine = np.take_along_axis(ids, np.argsort(-card, axis=-1)[:, :H], axis=1)
    out = {"items": len(ids),
           "mined_equal_engine_sort": int(sum(
               sorted(m) == sorted(e) for m, e in zip(mined.tolist(), engine.tolist()))),
           "mined_equal_stable_top": 0, "differ": []}
    for item in range(len(ids)):
        order = np.argsort(-card[item], kind="stable")
        if sorted(mined[item].tolist()) == sorted(ids[item][order[:H]].tolist()):
            out["mined_equal_stable_top"] += 1
            continue
        s_h = float(card[item][order[H - 1]])
        diff = set(mined[item].tolist()) ^ set(ids[item][order[:H]].tolist())
        out["differ"].append({
            "score_at_H": s_h,
            "tied_at_H": int((card[item] == s_h).sum()),
            "within_1_bf16_ulp": int((np.abs(card[item] - s_h) <= bf16_ulp(s_h)).sum()),
            "swapped_all_tied": all(
                float(card[item][ids[item] == c].max()) == s_h for c in diff)})
    out["differ_swapped_all_tied"] = sum(d["swapped_all_tied"] for d in out["differ"])
    return out


def mine(args) -> str:
    device = RH.check_device(args.device)
    cfg = RH.itm_cfg(args.data_root, EPOCHS, args.hsize, arch_path=args.arch_path,
                     seed=args.seed, **ITM_FLAGS).replace(
        DTYPE=args.dtype or ("float32" if args.hsize else "bfloat16"), CKPT_FILE_PATH=args.ckpt)
    assert not cfg.TEXT_ENC_BLOCK, "the whole encoded corpus resident, as the run had it"
    ex = ITM.Execution(cfg, device)
    dataset = ex.build_dataset("train")
    net = ex.load_masters(dataset)
    dataset.set_epoch(args.epoch)
    n_caps = len(dataset)
    n_imgs = n_caps // dataset.CAPS_PER_IMG
    R, H, group = cfg.NEG_RANDSIZE, cfg.NEG_HARDSIZE, max(1, cfg.NEG_BATCHSIZE)
    corpus = ex.device_corpus(dataset)
    tiles = []

    def encode_all(net_, cfg_, corpus_):
        enc, dec = ITM.pair_fns(net_, cfg_)
        return dec, ITM.encode_window(enc, corpus_["caps"], 0, len(corpus_["caps"]),
                                      cfg_.TEXT_ENC_CHUNK)

    # the engine's pass (`engine/itm.py` `mine`, TEXT_ENC_BLOCK unset), its tiles kept
    t0 = time.time()
    with torch.inference_mode():
        decode, text = encode_all(net, cfg, corpus)

        def scored(ii, cc):
            out = ITM.score_pairs(decode, corpus, text, ii, cc)
            tiles.append((np.asarray(ii).copy(), np.asarray(cc).copy(), out))
            return out

        ITM.run_mine_sweeps(cfg, dataset, np.random.RandomState(cfg.SEED * 97 + args.epoch),
                            group, score_pairs=scored)
    RH._sync(device)
    seconds = time.time() - t0
    per_sweep = -(-n_imgs // group)
    sweeps = [(tiles[:per_sweep], n_imgs, dataset.neg_caps_idx_tensor, True),
              (tiles[per_sweep:], n_caps, dataset.neg_imgs_idx_tensor, False)]
    # every tile again on the card with the plain attention
    with torch.inference_mode(), attention("plain"):
        decode_plain, text_plain = encode_all(net, cfg, corpus)
        plain = [np.asarray(ITM.score_pairs(decode_plain, corpus, text_plain, ii, cc))
                 for ii, cc, _ in tiles]
    # the first tile of each sweep on the CPU, fp32 on the compute dtype's parameters
    cpu_net = ex.build_net(dataset)
    cpu_net.load_state_dict({k: v.detach().cpu() for k, v in net.state_dict().items()})
    if compute_dtype(cfg) != torch.float32:
        cpu_net = cpu_net.to(compute_dtype(cfg)).float()
    cpu_cfg = cfg.replace(DTYPE="float32")
    cpu_net.cfg = cpu_cfg
    cpu_corpus = {k: (v.cpu().float() if v.is_floating_point() else v.cpu())
                  for k, v in corpus.items()}
    record = {"checkpoint": args.ckpt, "epoch": args.epoch, "dtype": cfg.DTYPE,
              "mining_s": round(seconds, 2), "tiles": len(tiles), "sweeps": []}
    start = 0
    for sweep_tiles, n_items, mined, per_img in sweeps:
        ids, card, card_plain = [], [], []
        for t, (ii, cc, dev) in enumerate(sweep_tiles):
            g = min(group, n_items - t * group)
            ids.append((cc if per_img else ii)[:g * R].reshape(g, R))
            card.append(np.asarray(dev)[:g * R].reshape(g, R))
            card_plain.append(plain[start + t][:g * R].reshape(g, R))
        ids, card, card_plain = (np.concatenate(a) for a in (ids, card, card_plain))
        sweep = stored_vs_card(ids, card, np.asarray(mined)[:n_items], H)
        sweep["card_score_range"] = [float(card.min()), float(card.max())]
        diff = float(np.abs(card - card_plain).max())
        sweep["card_plain_all_tiles"] = {
            "max_abs_diff": diff,
            "items_top_differ_beyond_band": top_sets_differ(ids, card, card_plain, H, 2 * diff),
            "items_top_differ_no_band": top_sets_differ(ids, card, card_plain, H, 0.0)}
        # the CPU on the sweep's first tile, its captions encoded once each
        ii, cc, _ = sweep_tiles[0]
        n = min(group, n_items)
        ucc = np.unique(cc[:n * R])
        with torch.inference_mode():
            enc, dec = ITM.pair_fns(cpu_net, cpu_cfg)
            x, m = enc(cpu_corpus["caps"][torch.from_numpy(ucc)])
            cpu = np.asarray(ITM.score_pairs(dec, cpu_corpus, {"x": x, "mask": m}, ii[:n * R],
                                             np.searchsorted(ucc, cc[:n * R]))).reshape(n, R)
        diff = float(np.abs(card[:n] - cpu).max())
        sweep["cpu_fp32_first_tile"] = {
            "items": n, "max_abs_diff": diff,
            "items_top_differ_beyond_band": top_sets_differ(ids[:n], card[:n], cpu, H, 2 * diff),
            "items_top_differ_no_band": top_sets_differ(ids[:n], card[:n], cpu, H, 0.0)}
        record["sweeps"].append(sweep)
        start += len(sweep_tiles)
    record["provenance"] = provenance(device)
    return write(f"rehearsal_torch_split_itm_mine_{arch_name(args.arch_path)}_seed{args.seed}"
                 ".json", record)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("train", "mine"))
    p.add_argument("--task", default="itm", choices=("itm", "vqa"),
                   help="train: run_itm with the search->ITM leg's flags, or run_vqa")
    p.add_argument("--epochs", type=int, default=0, help="train: epochs (0 = 40)")
    p.add_argument("--int8", action="store_true",
                   help="train: the whole-batch loader with DEVICE_REL and SHIP_INT8 (VQA)")
    p.add_argument("--data_root", default="./data_rehearsal")
    p.add_argument("--arch_path", required=True)
    p.add_argument("--seed", type=int, default=RH.SEED)
    p.add_argument("--dtype", default=None, choices=("bfloat16", "float32"),
                   help="the compute dtype (default: the runner's, bf16 at full width)")
    p.add_argument("--attention", default="kernels", choices=("kernels", "plain_rsa", "plain"))
    p.add_argument("--hsize", type=int, default=0,
                   help="the width (the runner's scaling; 0 = full width)")
    p.add_argument("--ckpt_every", type=int, default=0)
    p.add_argument("--ckpt", default="")
    p.add_argument("--epoch", type=int, default=26)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    return train(args) if args.what == "train" else mine(args)


if __name__ == "__main__":
    main()
