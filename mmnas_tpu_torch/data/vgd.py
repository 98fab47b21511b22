"""VGD (RefCOCO-family visual grounding) data pipeline.

Rebuild of mmnas/loader/load_data_vgd.py: per-item supervision is built
online from the 100 proposal boxes vs the referred gt box —
  - KLD target distribution over proposals with IoU >= 0.5 (normalized
    overlaps, load_data_vgd.py:256-263), or stepped BCE scores (:226-236);
  - SmoothL1 regression targets from Fast-R-CNN deltas, mean/std-normalized
    (:274-279);
  - masks: scores_mask [1] (any proposal hit) and bbox_mask [100] (hits).

IoU runs through the native C++ kernel (utils/bbox.py), replacing the
reference's Cython bbox.pyx at the same call site.

Item dict (shapes fixed; reference 12-tuple at load_data_vgd.py:175-186):
  frcn_feat [100,2048]  bbox_feat [100,5]  rel_img [100,100,4]
  ques_ix [15] int      rel_ques [14,14,3]
  scores [100]  scores_mask [1]  transformed_bbox [100,4]  bbox_mask [100,1]
  gt_bbox [1,4]  bbox [100,4]  img_shape [2]

Quirks preserved: query length is max_token+1 = 15 with the 15th slot
always PAD (load_data_vgd.py:190); OOV tokens map to UNK — the reference
maps them to a nonexistent 'NOTFOUND' key and would crash on real OOV
(load_data_vgd.py:196, SURVEY.md §7 bug list) — fixed here, documented.

The port's own copy of mmnas_tpu/data/vgd.py: the port imports nothing of
the JAX package.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict

import numpy as np

from mmnas_tpu_torch.data.relations import relation_embedding, semantic_embedding
from mmnas_tpu_torch.utils.bbox import bbox_overlaps
from mmnas_tpu_torch.utils.bbox_transform import bbox_transform


def get_sigmoid_score(overlap: float, threshold: float) -> float:
    """Stepped BCE scores (load_data_vgd.py:226-236)."""
    if overlap < threshold:
        return 0.0
    if overlap < 0.6:
        return 0.8
    if overlap < 0.7:
        return 0.9
    return 1.0


def proc_bbox_label(cfg, gt_bbox_xyxy: np.ndarray, proposal_bbox: np.ndarray,
                    n_pad: int = 100):
    """Build (scores, scores_mask, transformed_bbox, bbox_mask) for one item
    (load_data_vgd.py:239-283)."""
    overlaps = bbox_overlaps(
        np.ascontiguousarray(proposal_bbox, np.float64),
        np.ascontiguousarray(gt_bbox_xyxy.reshape(1, 4), np.float64))[:, 0]

    scores = np.zeros(n_pad, np.float32)
    scores_mask = np.zeros(1, np.float32)
    bbox_mask = np.zeros(n_pad, np.float32)
    hit = overlaps >= cfg.OVERLAP_THRESHOLD
    if overlaps.max(initial=0.0) >= cfg.OVERLAP_THRESHOLD:
        scores_mask[0] = 1
        ix = np.where(hit)[0]
        if cfg.SCORES_LOSS == "kld":
            scores[ix] = overlaps[ix]
            scores = scores / (scores.sum() + 1e-8)
        elif cfg.SCORES_LOSS == "bce":
            for i in ix:
                scores[i] = get_sigmoid_score(float(overlaps[i]),
                                              cfg.OVERLAP_THRESHOLD)
        else:
            raise ValueError(f"unknown SCORES_LOSS {cfg.SCORES_LOSS}")
        bbox_mask[ix] = 1

    tb = bbox_transform(proposal_bbox, gt_bbox_xyxy.reshape(1, 4))
    if cfg.BBOX_NORM:
        tb = (tb - np.array(cfg.BBOX_NORM_MEANS)) / np.array(cfg.BBOX_NORM_STDS)
    transformed = np.zeros((n_pad, 4), np.float32)
    k = min(tb.shape[0], n_pad)
    transformed[:k] = tb[:k]
    return scores, scores_mask, transformed, bbox_mask[:, None]


def pad_feat(feat: np.ndarray, n: int) -> np.ndarray:
    """Truncate/zero-pad leading axis to n (load_data_vgd.py:203-214)."""
    feat = feat[:n]
    out = np.zeros((n,) + feat.shape[1:], feat.dtype)
    out[:feat.shape[0]] = feat
    return out


def norm_bbox_feat(bbox: np.ndarray, img_h: float, img_w: float) -> np.ndarray:
    """5-d normalized box features (load_data_vgd.py:217-224)."""
    out = np.zeros((bbox.shape[0], 5), np.float32)
    out[:, 0] = bbox[:, 0] / img_w
    out[:, 1] = bbox[:, 1] / img_h
    out[:, 2] = bbox[:, 2] / img_w
    out[:, 3] = bbox[:, 3] / img_h
    out[:, 4] = (bbox[:, 2] - bbox[:, 0]) * (bbox[:, 3] - bbox[:, 1]) / (img_h * img_w)
    return out


class VgdDataset:
    """RefCOCO/RefCOCO+/RefCOCOg referring expressions over preprocessed
    per-split JSONs (made by tools/ref_process*.py) + npz region features."""

    def __init__(self, cfg, run_mode: str):
        self.cfg = cfg
        self.run_mode = run_mode
        from mmnas_tpu_torch.data.paths import VgdPaths
        paths = VgdPaths(cfg.DATA_ROOT, cfg.DATASET, cfg.FEAT)

        frcn_paths = []
        for d in paths.imgfeat_dirs():
            frcn_paths += glob.glob(os.path.join(d, "*.npz"))
        self.iid_to_path = paths.iid_map(frcn_paths)
        self.features = None
        if cfg.FEAT != "coco_mrcn":  # packed store covers the 'x' layout
            from mmnas_tpu_torch.data.packed import FeatureSource
            self.features = FeatureSource(self.iid_to_path, paths.imgfeat_dirs())

        stat_refs = []
        for p in paths.ref_jsons().values():
            with open(p) as f:
                stat_refs += json.load(f)

        split_map = {"train": cfg.TRAIN_SPLIT, "val": "val",
                     "test": getattr(cfg, "TEST_SPLIT", "testA")}
        self.refs_list = []
        for split in split_map[run_mode].split("+"):
            with open(paths.ref_jsons()[split]) as f:
                self.refs_list += json.load(f)
        self.data_size = len(self.refs_list)

        from mmnas_tpu_torch.data.vocab import build_vocab_from_token_lists
        self.token_to_ix, self.pretrained_emb = build_vocab_from_token_lists(
            (r["tokens"] for r in stat_refs), cfg)
        self.token_size = len(self.token_to_ix)
        self.ans_size = 1

    def __len__(self):
        return self.data_size

    def proc_query(self, tokens, max_token: int = 14) -> np.ndarray:
        query_ix = np.zeros(max_token + 1, np.int64)
        for ix, word in enumerate(tokens):
            query_ix[ix] = self.token_to_ix.get(word, self.token_to_ix["UNK"])
            if ix + 1 == max_token:
                break
        return query_ix

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        refs = self.refs_list[idx]
        ques_ix = self.proc_query(refs["tokens"])

        rel_ques = semantic_embedding(len(refs["tokens"]), ques_ix,
                                      self.pretrained_emb, 14)

        if self.features is not None:
            feat = self.features.get(str(refs["image_id"]))
            fx, bbox = feat["x"], feat["bbox"]
            img_h, img_w = feat["image_h"], feat["image_w"]
        else:  # coco_mrcn: concat fc7+pool5 (load_data_vgd.py:143-147)
            feat = np.load(self.iid_to_path[str(refs["image_id"])])
            fx = np.concatenate((feat["fc7"], feat["pool5"]), axis=-1)
            img_h, img_w = float(feat["image_h"]), float(feat["image_w"])
            bbox = feat["bbox"].astype(np.float32)
        frcn = pad_feat(fx.astype(np.float32), cfg.FRCNFEAT_LEN)
        bbox_feat = pad_feat(norm_bbox_feat(bbox, img_h, img_w), cfg.FRCNFEAT_LEN)
        bbox_pad = pad_feat(bbox, cfg.FRCNFEAT_LEN)

        gt = np.array(refs["bbox"], np.float32)  # xywh -> xyxy
        gt_xyxy = np.array([gt[0], gt[1], gt[0] + gt[2], gt[1] + gt[3]], np.float32)

        item = {
            "frcn_feat": frcn,
            "bbox_feat": bbox_feat,
            "ques_ix": ques_ix,
            "rel_ques": rel_ques,
            "gt_bbox": gt_xyxy.reshape(1, 4),
            "bbox": bbox_pad,
            "img_shape": np.array([img_h, img_w], np.float32),
        }
        if getattr(cfg, "DEVICE_REL", False):
            item["bbox_raw"] = bbox_pad
        else:
            rel_img = np.zeros((cfg.FRCNFEAT_LEN, cfg.FRCNFEAT_LEN, 4), np.float32)
            k = min(bbox.shape[0], cfg.FRCNFEAT_LEN)
            rel_img[:k, :k] = relation_embedding(bbox[:k])
            item["rel_img"] = rel_img
        if self.run_mode == "train":
            s, sm, tb, bm = proc_bbox_label(cfg, gt_xyxy, bbox, cfg.FRCNFEAT_LEN)
        else:
            s = np.zeros(cfg.FRCNFEAT_LEN, np.float32)
            sm = np.zeros(1, np.float32)
            tb = np.zeros((cfg.FRCNFEAT_LEN, 4), np.float32)
            bm = np.zeros((cfg.FRCNFEAT_LEN, 1), np.float32)
        item.update({"scores": s, "scores_mask": sm,
                     "transformed_bbox": tb, "bbox_mask": bm})
        return item
