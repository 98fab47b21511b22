"""ITM (image-text matching) fixed-net execution on one device, or
data-parallel on several (counterpart of mmnas_tpu/engine/itm.py).

`Execution(cfg, device).run()` is the VQA engine's (engine/vqa.py) with the
task's dataset (Flickr30K/COCO 'precomp', or SynthItmDataset with --SYNTH),
NetFull(task="itm") and:

- the triplet train step (train_itm.py:381-397): three train-mode forwards
  (the positive pair, the hard-negative caption, the hard-negative image),
  each drawing its own dropout seeds from the step's generator, then the
  BCE or margin triplet loss (utils/itm_loss.py);
- hard-negative mining before each epoch e with e % NEG_NEPOCH == 0 and
  e >= NEG_START_EPOCH (train_itm.py:299-363); before NEG_START_EPOCH a
  fresh random draw of the negatives. The corpus (caption tokens, region
  features, boxes, relation tensors) is resident on the device at the
  compute dtype, cached per dataset; each caption is encoded once
  (`encode_window`, TEXT_ENC_CHUNK captions a call, the last chunk as it
  is); the pair scorer gathers (image, caption) pairs by index tensors on
  the device and runs `apply_decoder`. The host draws the candidates and
  keeps the top NEG_HARDSIZE of NEG_RANDSIZE with the JAX package's numpy
  code, fetching a tile's scores only after the next tile is enqueued
  (PIPELINE_DEPTH). The mining RNG is RandomState(SEED * 97 + epoch);
- the R@K eval (train_itm.py:461-546): the n_imgs x n_caps score matrix in
  caption blocks of TEXT_ENC_BLOCK (0: the whole corpus) and tiles of
  EVAL_PAIRS pairs (0: EVAL_BATCH_SIZE * 2), then i2t/t2i R@1/5/10 and the
  median and mean ranks.

Mining runs in `on_epoch_start`, before the epoch's loader starts its
thread, so no batch of an epoch is assembled from the previous epoch's
negatives. The host-side functions below are the JAX package's, unchanged
(tests/test_torch_repair.py holds them to it); `DeviceScores` lets their
`np.asarray` fetch a tile from the card.

Data parallel, every rank draws the same candidates, and the scorer splits
each tile of pairs over the ranks and gathers the scores (`score_pairs`;
the JAX package's sharded_pair_call, itm.py:52-70, and the reference's
rank-row-sharded score matrix), so every rank ends the mining with the
same negatives (each rank's loader reads those of its own items) and the
R@K sweep with the whole score matrix; the triplet step's gradients are
averaged over the ranks as the VQA engine's are. Under tensor parallelism
the pairs split over the data shards, and the model ranks of each score
its share together (engine/vqa.py).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from mmnas_tpu_torch.data.loader import Loader
from mmnas_tpu_torch.engine.vqa import Execution as VqaExecution
from mmnas_tpu_torch.models.net import (
    ITM_NEG_KEYS, NetFull, compute_call, compute_dtype, compute_params,
)
from mmnas_tpu_torch.parallel import mesh as pmesh
from mmnas_tpu_torch.utils.itm_loss import bce_triplet_loss, margin_triplet_loss

# tiles of scores enqueued ahead of the host's fetch in the corpus sweeps:
# the device scores tile i+1 while the host copies tile i and ranks it
PIPELINE_DEPTH = 2


class DeviceScores:
    """One tile's scores on the device, still being computed: `np.asarray`
    copies them to the host (waiting for the tile), fp32."""

    __slots__ = ("scores",)

    def __init__(self, scores: torch.Tensor):
        self.scores = scores

    def __array__(self, dtype=None, copy=None):
        out = self.scores.float().cpu().numpy()
        return out if dtype is None else out.astype(dtype)


def draw_candidates(n_items, n_cand_pool, per_img, caps_per_img, rng, R,
                    group):
    """Random mining candidates [n_items, R], resampling any that collide
    with the item's own image/captions (train_itm loader :44-48). Drawn in
    the same group-chunk order as the scoring loop so the blocked and
    unblocked sweeps consume one identical rng stream (parity-tested)."""
    cand = np.zeros((n_items, R), np.int64)
    for start in range(0, n_items, group):
        idxs = np.arange(start, min(start + group, n_items))

        def forbidden(c):
            if per_img:
                return (c // caps_per_img) == idxs[:, None]
            return c == (idxs[:, None] // caps_per_img)

        c = rng.randint(0, n_cand_pool, (len(idxs), R))
        bad = forbidden(c)
        while bad.any():
            c[bad] = rng.randint(0, n_cand_pool, int(bad.sum()))
            bad = forbidden(c)
        cand[idxs] = c
    return cand


def _semihard_mask(s, pos_rows):
    """Semi-hard filter (beyond reference — train_itm.py:299-363 mines
    unfiltered): candidates that tie or beat the item's strongest own
    positive are very likely mislabeled true matches, so drop them from
    the top-H pool by sinking their scores to -inf. Items whose every
    candidate is filtered fall back to their first-drawn (uniform random)
    candidates — argsort over all -inf keeps draw order."""
    s = s.astype(np.float32)
    s[s >= pos_rows] = -np.inf
    return s


def mine_sweep(score_pairs, n_items, n_cand_pool, per_img, caps_per_img,
               rng, R, H, group, pos=None, skip=0, drop=None):
    """One hard-negative mining sweep (train_itm.py:299-363): for each of
    n_items, score R random candidates and keep the top H by score.
    per_img=True: items are images, candidates captions; False: items are
    captions, candidates images. score_pairs(img_idx, cap_idx) -> device
    scores (async; fetched here with a lag-PIPELINE_DEPTH pipeline).
    Shared by the train engine and search_itm. Requires the whole
    encoded-caption table on device; see mine_sweep_blocked for the
    streamed variant at corpora where it does not fit.
    pos (optional, [n_items] float32): per-item strongest-own-positive
    scores for semi-hard filtering (MINE_SEMIHARD; see _semihard_mask).
    skip (MINE_SKIP_TOP): select candidate ranks [skip, skip+H) instead
    of the top H — under label noise false negatives rank first.
    drop (optional, [n_cand_pool] bool): candidates excluded corpus-wide
    (MINE_NOISE_Q label-noise suspects) — sunk to -inf like semihard, so
    items whose every candidate is dropped keep their draw order."""
    cand = draw_candidates(n_items, n_cand_pool, per_img, caps_per_img,
                           rng, R, group)
    out = np.zeros((n_items, H), np.int64)
    pend = deque()

    def drain():
        idxs, g, dev = pend.popleft()
        s = np.asarray(dev)[:g * R].reshape(g, R).astype(np.float32)
        if pos is not None:
            s = _semihard_mask(s, pos[idxs, None])
        if drop is not None:
            s[drop[cand[idxs]]] = -np.inf
        order = np.argsort(-s, axis=-1)[:, skip:skip + H]
        out[idxs] = np.take_along_axis(cand[idxs], order, axis=1)

    for start in range(0, n_items, group):
        idxs = np.arange(start, min(start + group, n_items))
        g = len(idxs)
        rep = np.repeat(idxs, R)
        flat = cand[idxs].reshape(-1)
        pad = group * R - g * R  # keep one compiled shape per sweep
        if pad:
            rep = np.pad(rep, (0, pad))
            flat = np.pad(flat, (0, pad))
        ii, cc = (rep, flat) if per_img else (flat, rep)
        pend.append((idxs, g, score_pairs(ii, cc)))
        if len(pend) >= PIPELINE_DEPTH:
            drain()
    while pend:
        drain()
    return out


def mine_sweep_blocked(score_pairs_win, encode_window, block, n_items,
                       n_cand_pool, per_img, caps_per_img, rng, R, H, group,
                       pos=None, skip=0, drop=None):
    """Caption-block-streamed mining sweep for reference-scale corpora
    (Flickr30K train: 145k captions -> a full encoded-text table is ~15GB
    bf16 and cannot be HBM-resident next to the image corpus; the
    reference never hits this because it re-runs the full trunk per pair,
    train_itm.py:489-498). Only `block` captions are encoded at a time:

      per_img=True  (candidates are captions): candidates are drawn up
        front, bucketed by caption block; each block is encoded once and
        its pairs scored; top-H selection happens at the end.
      per_img=False (ITEMS are captions): items stream in blocks; each
        block is encoded and its R image-candidates scored immediately.

    score_pairs_win(text_enc_block, img_idx, cap_idx_rel) -> device scores
    (async, pipelined as in mine_sweep) with cap_idx_rel relative to the
    window; encode_window(start) -> the encoded block for captions
    [start, start+block). Candidates, scores and top-H selections are
    bit-identical to mine_sweep for the same rng (shared draw_candidates,
    chunk-ordered stream; parity-tested)."""
    cand = draw_candidates(n_items, n_cand_pool, per_img, caps_per_img,
                           rng, R, group)
    out = np.zeros((n_items, H), np.int64)
    chunk = group * R
    pend = deque()
    if per_img:
        scores = np.full(n_items * R, -np.inf, np.float32)
        flat_item = np.repeat(np.arange(n_items), R)
        flat_cand = cand.reshape(-1)

        def drain():
            where, dev = pend.popleft()
            scores[where] = np.asarray(dev)[:len(where)]

        for bstart in range(0, n_cand_pool, block):
            sel = np.where((flat_cand >= bstart)
                           & (flat_cand < bstart + block))[0]
            if not len(sel):
                continue
            te = encode_window(bstart)
            for s0 in range(0, len(sel), chunk):
                where = sel[s0:s0 + chunk]
                ii = flat_item[where]
                cc = flat_cand[where] - bstart
                pad = chunk - len(where)
                if pad:
                    ii = np.pad(ii, (0, pad))
                    cc = np.pad(cc, (0, pad))
                pend.append((where, score_pairs_win(te, ii, cc)))
                if len(pend) >= PIPELINE_DEPTH:
                    drain()
        while pend:
            drain()
        scores = scores.reshape(n_items, R)
        if pos is not None:
            scores = _semihard_mask(scores, pos[:, None])
        if drop is not None:
            scores[drop[cand]] = -np.inf
        order = np.argsort(-scores, axis=-1)[:, skip:skip + H]
        return np.take_along_axis(cand, order, axis=1)

    def drain():
        idxs, g, dev = pend.popleft()
        s = np.asarray(dev)[:g * R].reshape(g, R).astype(np.float32)
        if pos is not None:
            s = _semihard_mask(s, pos[idxs, None])
        if drop is not None:
            s[drop[cand[idxs]]] = -np.inf
        order = np.argsort(-s, axis=-1)[:, skip:skip + H]
        out[idxs] = np.take_along_axis(cand[idxs], order, axis=1)

    for bstart in range(0, n_items, block):
        bend = min(bstart + block, n_items)
        te = encode_window(bstart)
        for start in range(bstart, bend, group):
            idxs = np.arange(start, min(start + group, bend))
            g = len(idxs)
            rep = np.repeat(idxs - bstart, R)  # caption idx rel to window
            flat = cand[idxs].reshape(-1)      # image candidates
            pad = chunk - g * R
            if pad:
                rep = np.pad(rep, (0, pad))
                flat = np.pad(flat, (0, pad))
            pend.append((idxs, g, score_pairs_win(te, flat, rep)))
            if len(pend) >= PIPELINE_DEPTH:
                drain()
    while pend:
        drain()
    return out


def _noise_suspects(pos_caps, q):
    """MINE_NOISE_Q: flag the floor(q*n) captions with the LOWEST own-
    positive scores, pooled over the WHOLE corpus, as label-noise suspects.
    A corrupted caption's own pair scores at stranger level, so ranking
    captions against each other separates cleanly where the per-item
    semihard threshold (compare candidates to one noisy anchor) does not —
    the falsified variant in rehearsal_itm_scaled_semihard.json."""
    flag = np.zeros(len(pos_caps), bool)
    flag[np.argsort(pos_caps, kind="stable")[:int(len(pos_caps) * q)]] = True
    return flag


def _randomize_suspect_negs(neg_imgs, suspect, n_imgs, cpi, rng):
    """Replace suspect captions' mined image negatives with uniform draws
    excluding the own image (in place): a corrupted caption's top-scored
    candidate is likely its TRUE subject image, so mining it as a hard
    negative trains against a perfect match."""
    idxs = np.where(suspect)[0]
    if not len(idxs):
        return
    own = (idxs // cpi)[:, None]
    c = rng.randint(0, n_imgs, (len(idxs), neg_imgs.shape[1]))
    bad = c == own
    while bad.any():
        c[bad] = rng.randint(0, n_imgs, int(bad.sum()))
        bad = c == own
    neg_imgs[idxs] = c


def run_mine_sweeps(cfg, dataset, rng, group, score_pairs=None,
                    blocked_ctx=None):
    """The mining pass of the train and search engines: computes the
    optional noise-filter inputs (MINE_SEMIHARD anchors / MINE_NOISE_Q
    suspect flags — mutually exclusive, config-validated), runs both sweep
    directions, and post-randomizes suspects' image negatives. Exactly one
    of score_pairs (whole encoded-text table resident) or
    blocked_ctx = (score_pairs_win, encode_window, block) must be given.
    rng consumption matches the unfiltered reference sweep exactly (the
    positive-score passes draw nothing), so filters stay rng-comparable."""
    n_caps = len(dataset)
    cpi = dataset.CAPS_PER_IMG
    n_imgs = n_caps // cpi
    R, H = cfg.NEG_RANDSIZE, cfg.NEG_HARDSIZE
    need_pos = cfg.MINE_SEMIHARD or cfg.MINE_NOISE_Q > 0
    pos_imgs = pos_caps = suspect = None
    if blocked_ctx is None:
        if need_pos:
            pos_caps = positive_scores(score_pairs, n_caps, cpi, group * R)

        def sweep(*a, **kw):
            return mine_sweep(score_pairs, *a, **kw)
    else:
        score_win, encode_window, block = blocked_ctx
        if need_pos:
            pos_caps = positive_scores_blocked(
                score_win, encode_window, block, n_caps, cpi, group * R)

        def sweep(*a, **kw):
            return mine_sweep_blocked(
                score_win, encode_window, block, *a, **kw)
    if cfg.MINE_NOISE_Q > 0:
        suspect = _noise_suspects(pos_caps, cfg.MINE_NOISE_Q)
        pos_caps = None  # corpus-pooled flags replace the per-item masks
    elif cfg.MINE_SEMIHARD:
        pos_imgs = pos_caps.reshape(n_imgs, cpi).max(axis=1)
    else:
        pos_caps = None
    dataset.neg_caps_idx_tensor = sweep(
        n_imgs, n_caps, True, cpi, rng, R, H, group,
        pos=pos_imgs, skip=cfg.MINE_SKIP_TOP, drop=suspect)
    dataset.neg_imgs_idx_tensor = sweep(
        n_caps, n_imgs, False, cpi, rng, R, H, group,
        pos=pos_caps, skip=cfg.MINE_SKIP_TOP)
    if suspect is not None:
        _randomize_suspect_negs(dataset.neg_imgs_idx_tensor, suspect,
                                n_imgs, cpi, rng)


def positive_scores(score_pairs, n_caps, caps_per_img, tile):
    """Scores of every (own image, caption) pair -> [n_caps] float32, the
    semi-hard mining anchors (MINE_SEMIHARD): caption j's positive is
    score(j // caps_per_img, j); image i's is the max over its own
    caps_per_img captions (taken by the caller). Dispatched in the mining
    sweep's group*R tile shape so no new program shape compiles."""
    pos = np.zeros(n_caps, np.float32)
    pend = deque()

    def drain():
        start, n, dev = pend.popleft()
        pos[start:start + n] = np.asarray(dev)[:n]

    for start in range(0, n_caps, tile):
        n = min(tile, n_caps - start)
        cc = np.arange(start, start + n, dtype=np.int64)
        ii = cc // caps_per_img
        if n < tile:
            ii = np.pad(ii, (0, tile - n))
            cc = np.pad(cc, (0, tile - n))
        pend.append((start, n, score_pairs(ii, cc)))
        if len(pend) >= PIPELINE_DEPTH:
            drain()
    while pend:
        drain()
    return pos


def positive_scores_blocked(score_pairs_win, encode_window, block, n_caps,
                            caps_per_img, tile):
    """positive_scores with the encoded-caption table streamed in `block`
    windows (see mine_sweep_blocked) — bit-identical scores."""
    pos = np.zeros(n_caps, np.float32)
    pend = deque()

    def drain():
        start, n, dev = pend.popleft()
        pos[start:start + n] = np.asarray(dev)[:n]

    for bstart in range(0, n_caps, block):
        bend = min(bstart + block, n_caps)
        te = encode_window(bstart)
        for start in range(bstart, bend, tile):
            n = min(tile, bend - start)
            cc = np.arange(start, start + n, dtype=np.int64)
            ii = cc // caps_per_img
            ccr = cc - bstart  # caption idx relative to the window
            if n < tile:
                ii = np.pad(ii, (0, tile - n))
                ccr = np.pad(ccr, (0, tile - n))
            pend.append((start, n, score_pairs_win(te, ii, ccr)))
            if len(pend) >= PIPELINE_DEPTH:
                drain()
    while pend:
        drain()
    return pos


def score_matrix_sweep(n_imgs, n_caps, block, bs_pairs, encode_window,
                       score_win):
    """Block-tiled [n_imgs, n_caps] score matrix shared by the train and
    search eval paths (train_itm.py:461-546): captions stream in encoded
    blocks of `block` (clamped to the corpus — a train-scale
    TEXT_ENC_BLOCK must not compile oversized windows on a small eval
    corpus), and pairs dispatch in bs_pairs tiles with a
    lag-PIPELINE_DEPTH fetch pipeline. encode_window(start, count) -> the
    encoded text block; score_win(te, img_idx, cap_idx_rel) -> async
    device scores with cap_idx_rel relative to the window."""
    block = min(block or n_caps, n_caps)
    score_mat = np.zeros((n_imgs, n_caps), np.float32)
    for bstart in range(0, n_caps, block):
        bcount = min(block, n_caps - bstart)
        te = encode_window(bstart, block)
        # all images x this caption block, caption-major so the flat
        # order matches score_mat[:, bstart:bstart+bcount].reshape(-1)
        pi, pc = np.meshgrid(np.arange(n_imgs), np.arange(bcount),
                             indexing="ij")
        pi, pc = pi.reshape(-1), pc.reshape(-1)
        sub = score_mat[:, bstart:bstart + bcount].reshape(-1)
        pend = deque()

        def drain():
            start, n, dev = pend.popleft()
            sub[start:start + n] = np.asarray(dev)[:n]

        for start in range(0, len(pi), bs_pairs):
            ii = pi[start:start + bs_pairs]
            cc = pc[start:start + bs_pairs]
            n = len(ii)
            if n < bs_pairs:
                ii = np.pad(ii, (0, bs_pairs - n))
                cc = np.pad(cc, (0, bs_pairs - n))
            pend.append((start, n, score_win(te, ii, cc)))
            if len(pend) >= PIPELINE_DEPTH:
                drain()
        while pend:  # block-local: sub folds back before the next block
            drain()
        score_mat[:, bstart:bstart + bcount] = sub.reshape(n_imgs, bcount)
    return score_mat


# ---------------------------------------------------------------------------
# the device side: the resident corpus, the text encoder, the pair scorer
# ---------------------------------------------------------------------------

def triplet_loss(cfg, s_pos, s_negc, s_negi):
    """The triplet loss of the three forwards' scores (train_itm.py:392-397)."""
    if cfg.SCORES_LOSS == "bce":
        return bce_triplet_loss(s_pos, s_negc, s_negi, double_pos=cfg.ITM_DOUBLE_POS)
    return margin_triplet_loss(s_pos, s_negc, s_negi)


def corpus_to_device(dataset, device: torch.device, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every caption's tokens and every image's region features, boxes and
    relation tensor on `device`, the float ones at `dtype` (the scorer casts
    its gathered inputs to the compute dtype anyway, so storing them there
    is the same numbers in half the memory under bf16)."""
    caps, _ = dataset.get_all_caps()
    frcn, bbox_feat, rel = dataset.get_all_imgs()
    out = {"caps": torch.from_numpy(caps).to(device)}
    for key, arr in (("frcn_feat", frcn), ("bbox_feat", bbox_feat), ("rel_img", rel)):
        out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device, dtype)
    return out


def pair_fns(net, cfg, *path, names=None):
    """(encode, decode): `net`'s encode_text and apply_decoder (with the
    supernet's `path`, its idx) computing with the compute dtype's
    parameters (of `names` only, when given), cast once here."""
    params = compute_params(net, cfg, names) if compute_dtype(cfg) != torch.float32 else None

    def encode(caps):
        return compute_call(net, cfg, (caps, *path), params=params, method="encode_text")

    def decode(x_out, x_mask, batch):
        return compute_call(net, cfg, (x_out, x_mask, batch, *path), params=params,
                            method="apply_decoder")

    return encode, decode


def encode_window(encode: Callable, caps: torch.Tensor, start: int, count: int,
                  chunk: int) -> Dict[str, torch.Tensor]:
    """The text encodings of captions [start, start + count) that exist,
    `encode(tokens)` -> (x, mask) over `chunk` captions a call:
    {'x': [n, T, HSIZE], 'mask': [n, 1, 1, T]}. The last chunk is taken as
    it is: padding it to `chunk` only fed the kernels all-pad captions."""
    end = min(start + count, caps.shape[0])
    xs, masks = [], []
    for s0 in range(start, end, chunk):
        x, mask = encode(caps[s0:min(s0 + chunk, end)])
        xs.append(x)
        masks.append(mask)
    return {"x": torch.cat(xs), "mask": torch.cat(masks)}


def score_pairs(decode: Callable, corpus: Dict[str, torch.Tensor],
                text_enc: Dict[str, torch.Tensor], img_idx, cap_idx) -> DeviceScores:
    """Scores of the pairs (img_idx[p], cap_idx[p]), host index arrays, with
    cap_idx relative to the window `text_enc`: the indices go to the
    device, the pairs' inputs are gathered there and `decode(x_out, x_mask,
    batch)` (an apply_decoder) scores them. Data parallel, each data shard
    scores its contiguous share of the pairs (the last one padded; the
    model ranks of a shard score it together) and every rank gets all the
    scores by one all_gather. Returns without waiting."""
    n, world = len(img_idx), pmesh.data_axis_size()
    if world > 1:
        share = -(-n // world)
        mine = slice(pmesh.data_rank() * share, (pmesh.data_rank() + 1) * share)
        img_idx, cap_idx = (np.pad(np.asarray(a), (0, share * world - n))[mine]
                            for a in (img_idx, cap_idx))
    dev = corpus["caps"].device
    ii, cc = (torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(dev, non_blocking=True)
              for a in (img_idx, cap_idx))
    batch = {k: corpus[k][ii] for k in ("frcn_feat", "bbox_feat", "rel_img")}
    scores = decode(text_enc["x"][cc], text_enc["mask"][cc], batch)
    return DeviceScores(pmesh.gather_tensor(scores)[:n] if world > 1 else scores)


def mine(cfg, dataset, corpus, rng, encode: Callable, decode: Callable) -> None:
    """One mining pass over `dataset` (both sweep directions, the filters of
    run_mine_sweeps), writing its negative index tensors in place: the whole
    corpus encoded once, or TEXT_ENC_BLOCK captions at a time."""
    n_caps, group = len(dataset), max(1, cfg.NEG_BATCHSIZE)
    block, chunk = cfg.TEXT_ENC_BLOCK, cfg.TEXT_ENC_CHUNK

    def score(te, ii, cc):
        return score_pairs(decode, corpus, te, ii, cc)

    if not block or block >= n_caps:
        te = encode_window(encode, corpus["caps"], 0, n_caps, chunk)
        run_mine_sweeps(cfg, dataset, rng, group, score_pairs=lambda ii, cc: score(te, ii, cc))
        return
    run_mine_sweeps(cfg, dataset, rng, group, blocked_ctx=(
        score, lambda start: encode_window(encode, corpus["caps"], start, block, chunk), block))


def recall_scores(cfg, dataset, corpus, encode: Callable, decode: Callable) -> np.ndarray:
    """The [n_imgs, n_caps] score matrix of `dataset`'s corpus."""
    n_caps = len(dataset)
    bs_pairs = cfg.EVAL_PAIRS or cfg.EVAL_BATCH_SIZE * 2
    return score_matrix_sweep(
        n_caps // dataset.CAPS_PER_IMG, n_caps, cfg.TEXT_ENC_BLOCK, bs_pairs,
        lambda start, count: encode_window(encode, corpus["caps"], start, count,
                                           cfg.TEXT_ENC_CHUNK),
        lambda te, ii, cc: score_pairs(decode, corpus, te, ii, cc))


def recall_lines(stats: Dict[str, float]):
    """The i2t and t2i lines of the eval's log (train_itm.py:540-546)."""
    return [f"{d} results: %.02f %.02f %.02f %.02f %.02f" % tuple(
        stats[f"{d}_{k}"] for k in ("r1", "r5", "r10", "medr", "meanr")) for d in ("i2t", "t2i")]


class TripletTask:
    """What the ITM engines, fixed net and search, put in the VQA ones'
    place: the dataset, the triplet loss hook and the resident corpus."""
    TASK = "itm"
    TARGET_KEYS = ITM_NEG_KEYS

    def build_dataset(self, run_mode: str = "train"):
        cfg = self.cfg
        if cfg.SYNTH:
            from mmnas_tpu_torch.data.synth import SynthItmDataset
            return SynthItmDataset(cfg, size=cfg.SYNTH_SIZE, seed=cfg.SEED, run_mode=run_mode)
        from mmnas_tpu_torch.data.itm import ItmDataset
        return ItmDataset(cfg, run_mode)

    def forward_loss(self, run, batch):
        """The positive pair, the hard-negative caption and the hard-negative
        image, three forwards (train_itm.py:381-397)."""
        negc = dict(batch, ques_ix=batch["neg_ques_ix"])
        negi = dict(batch, frcn_feat=batch["neg_frcn_feat"], bbox_feat=batch["neg_bbox_feat"],
                    rel_img=batch["neg_rel_img"])
        return triplet_loss(self.cfg, run(batch), run(negc), run(negi))

    def device_corpus(self, dataset) -> Dict[str, torch.Tensor]:
        """`corpus_to_device` at the compute dtype, once per dataset."""
        cache = self.__dict__.setdefault("_corpus_cache", {})
        hit = cache.get(id(dataset))
        if hit is None or hit[0] is not dataset:
            hit = cache[id(dataset)] = (dataset, corpus_to_device(dataset, self.device,
                                                                  compute_dtype(self.cfg)))
        return hit[1]

    def mining_epoch(self, dataset, epoch: int) -> bool:
        """set_epoch, then: True where the epoch mines; before
        NEG_START_EPOCH a fresh random draw of the negatives."""
        cfg = self.cfg
        dataset.set_epoch(epoch)     # fresh per-epoch negative draws
        if epoch % cfg.NEG_NEPOCH == 0 and epoch >= cfg.NEG_START_EPOCH:
            return True
        if epoch < cfg.NEG_START_EPOCH:
            dataset.shuffle_neg_idx()
        return False


@dataclass
class RecallResult:
    stats: Dict[str, float]     # i2t/t2i R@1/5/10 (percent), median and mean rank
    scores: np.ndarray          # [n_imgs, n_caps] score matrix
    seconds: float              # wall time of the sweep, text encoding included


class Execution(TripletTask, VqaExecution):

    def mine_hard_negatives(self, net: NetFull, dataset, epoch: int) -> None:
        """For each image NEG_RANDSIZE random captions (none of its own),
        the top NEG_HARDSIZE by score kept; the same for each caption over
        images (train_itm.py:299-363). Writes the dataset's negative index
        tensors in place."""
        rng = np.random.RandomState(self.cfg.SEED * 97 + epoch)
        with torch.inference_mode():
            mine(self.cfg, dataset, self.device_corpus(dataset), rng, *pair_fns(net, self.cfg))

    def on_epoch_start(self, net: NetFull, dataset, epoch: int) -> None:
        if self.mining_epoch(dataset, epoch):
            t0 = time.time()
            self.mine_hard_negatives(net, dataset, epoch)
            print(f"hard-negative mining: {time.time() - t0:.1f}s")

    def eval(self, eval_loader: Loader, net: Optional[NetFull] = None,
             valid: bool = False) -> RecallResult:
        """The full score matrix of the loader's dataset and its R@K
        (train_itm.py:461-546)."""
        dataset = eval_loader.dataset
        if net is None:
            net = self.load_net(dataset)
        t0 = time.perf_counter()
        with torch.inference_mode():
            scores = recall_scores(self.cfg, dataset, self.device_corpus(dataset),
                                   *pair_fns(net, self.cfg))
        seconds = time.perf_counter() - t0
        stats = recall_metrics(scores)
        for line in recall_lines(stats):
            print(line)
            self.logger.write(line)
        return RecallResult(stats, scores, seconds)


def recall_metrics(score_matrix: np.ndarray) -> Dict[str, float]:
    """i2t / t2i R@1/5/10 + median/mean rank; ground truth = captions
    [5i, 5i+5) for image i (train_itm.py:506-546).

    Vectorized: each element's descending rank is (n-1) - its ascending
    position, and the ascending positions of a whole axis come from one
    double argsort — two O(n log n) sorts replace the per-row/per-column
    argsort loops (which were minutes of single-threaded numpy at the
    29k x 1k Flickr30K eval size)."""
    npts, n_caps = score_matrix.shape
    # i2t: rank of the best-placed of image i's 5 captions
    asc = np.argsort(np.argsort(score_matrix, axis=1, kind="stable"),
                     axis=1, kind="stable")
    desc = (n_caps - 1) - asc                       # [n_imgs, n_caps]
    gt_cols = 5 * np.arange(npts)[:, None] + np.arange(5)[None, :]
    ranks_i = desc[np.arange(npts)[:, None], gt_cols].min(axis=1).astype(
        np.float64)
    # t2i: rank of caption c's ground-truth image c//5 in column c
    asc_t = np.argsort(np.argsort(score_matrix, axis=0, kind="stable"),
                       axis=0, kind="stable")
    desc_t = (npts - 1) - asc_t                     # [n_imgs, n_caps]
    cols = np.arange(n_caps)
    ranks_c = desc_t[cols // 5, cols].astype(np.float64)

    def stats(r):
        return (100.0 * np.mean(r < 1), 100.0 * np.mean(r < 5),
                100.0 * np.mean(r < 10), float(np.floor(np.median(r)) + 1),
                float(r.mean() + 1))

    i2t = stats(ranks_i)
    t2i = stats(ranks_c)
    return {
        "i2t_r1": i2t[0], "i2t_r5": i2t[1], "i2t_r10": i2t[2],
        "i2t_medr": i2t[3], "i2t_meanr": i2t[4],
        "t2i_r1": t2i[0], "t2i_r5": t2i[1], "t2i_r10": t2i[2],
        "t2i_medr": t2i[3], "t2i_meanr": t2i[4],
    }
