"""Synthetic fixed-shape datasets (no files on disk required).

The reference has no test data story at all (SURVEY.md §4); these datasets
generate batches with exactly the reference data contracts (shapes, padding
conventions, relation tensors computed by the REAL feature-engineering code
in data/relations.py) so that train/search/eval loops, benchmarks and
tests run end-to-end without VQA-v2/RefCOCO/Flickr30K on disk.

Every item is deterministic in (seed, index).

The port's own copy of SynthVqaDataset, SynthVgdDataset and SynthItmDataset
from mmnas_tpu/data/synth.py.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from mmnas_tpu_torch.data.relations import relation_embedding, semantic_embedding


class SynthVqaDataset:
    """Mirrors load_data_vqa.DataSet item contract (load_data_vqa.py:241-246):
    frcn_feat [100,2048], bbox_feat [100,5], rel_img [100,100,4],
    ques_ix [14] int, ans [ans_size] soft scores, rel_ques [14,14,3]."""

    def __init__(self, cfg, size: int = 512, token_size: int = 128,
                 ans_size: int = 32, seed: int = 0):
        self.cfg = cfg
        self.size = size
        self.token_size = token_size
        self.ans_size = ans_size
        self.seed = seed
        self.max_token = cfg.MAX_TOKEN
        self.frcn_len = cfg.FRCNFEAT_LEN
        self.frcn_size = cfg.FRCNFEAT_SIZE
        # small random "GloVe" table so semantic_embedding runs for real
        g = np.random.RandomState(seed + 7777)
        self.pretrained_emb = g.randn(token_size, cfg.WORD_EMBED_SIZE).astype(np.float32)
        self.ix_to_ans = {i: f"ans_{i}" for i in range(ans_size)}

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        r = np.random.RandomState((self.seed * 1_000_003 + idx) % 2**32)
        T, K, F = self.max_token, self.frcn_len, self.frcn_size

        n_words = int(r.randint(3, T + 1))
        ques_ix = np.zeros((T,), np.int64)
        ques_ix[:n_words] = r.randint(3, self.token_size, size=n_words)

        n_obj = int(r.randint(min(10, K), K + 1))
        frcn = np.zeros((K, F), np.float32)
        frcn[:n_obj] = r.randn(n_obj, F).astype(np.float32) * 0.5 + 1e-3

        img_h, img_w = 480.0, 640.0
        x1 = r.uniform(0, img_w * 0.8, n_obj)
        y1 = r.uniform(0, img_h * 0.8, n_obj)
        bbox = np.stack([x1, y1,
                         x1 + r.uniform(8, img_w * 0.2, n_obj),
                         y1 + r.uniform(8, img_h * 0.2, n_obj)], axis=1).astype(np.float32)

        bbox_feat = np.zeros((K, 5), np.float32)
        bbox_feat[:n_obj, 0] = bbox[:, 0] / img_w
        bbox_feat[:n_obj, 1] = bbox[:, 1] / img_h
        bbox_feat[:n_obj, 2] = bbox[:, 2] / img_w
        bbox_feat[:n_obj, 3] = bbox[:, 3] / img_h
        bbox_feat[:n_obj, 4] = ((bbox[:, 2] - bbox[:, 0]) * (bbox[:, 3] - bbox[:, 1])
                                / (img_h * img_w))

        bbox_pad = np.zeros((K, 4), np.float32)
        bbox_pad[:n_obj] = bbox
        if not getattr(self.cfg, "DEVICE_REL", False):
            rel_img = np.zeros((K, K, 4), np.float32)
            rel_img[:n_obj, :n_obj] = relation_embedding(bbox)

        rel_ques = semantic_embedding(n_words, ques_ix, self.pretrained_emb, T)

        ans = np.zeros((self.ans_size,), np.float32)
        ans[r.randint(0, self.ans_size)] = 1.0
        if r.rand() < 0.3:
            ans[r.randint(0, self.ans_size)] = 0.3

        item = {
            "frcn_feat": frcn,
            "bbox_feat": bbox_feat,
            "ques_ix": ques_ix,
            "ans": ans,
            "rel_ques": rel_ques.astype(np.float32),
        }
        if getattr(self.cfg, "DEVICE_REL", False):
            item["bbox_raw"] = bbox_pad
        else:
            item["rel_img"] = rel_img
        return item


class SynthVgdDataset:
    """Synthetic RefCOCO-style items; supervision is built by the REAL label
    pipeline (mmnas_tpu_torch.data.vgd.proc_bbox_label with the native IoU kernel),
    so VGD training/eval runs end-to-end without data on disk."""

    def __init__(self, cfg, size: int = 512, token_size: int = 128, seed: int = 0):
        self.cfg = cfg
        self.size = size
        self.token_size = token_size
        self.ans_size = 1
        self.seed = seed
        g = np.random.RandomState(seed + 8888)
        self.pretrained_emb = g.randn(token_size, cfg.WORD_EMBED_SIZE).astype(np.float32)

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int):
        from mmnas_tpu_torch.data.vgd import norm_bbox_feat, proc_bbox_label
        cfg = self.cfg
        r = np.random.RandomState((self.seed * 999_983 + idx) % 2**32)
        T, K, F = cfg.MAX_TOKEN, cfg.FRCNFEAT_LEN, cfg.FRCNFEAT_SIZE

        n_words = int(r.randint(2, T + 1))
        ques_ix = np.zeros((T + 1,), np.int64)  # query len = max_token+1
        ques_ix[:n_words] = r.randint(3, self.token_size, size=n_words)
        rel_ques = semantic_embedding(n_words, ques_ix, self.pretrained_emb, T)

        img_h, img_w = 480.0, 640.0
        n_obj = int(r.randint(min(10, K), K + 1))
        frcn = np.zeros((K, F), np.float32)
        frcn[:n_obj] = r.randn(n_obj, F).astype(np.float32) * 0.5 + 1e-3
        x1 = r.uniform(0, img_w * 0.7, n_obj)
        y1 = r.uniform(0, img_h * 0.7, n_obj)
        bbox = np.stack([x1, y1,
                         x1 + r.uniform(12, img_w * 0.3, n_obj),
                         y1 + r.uniform(12, img_h * 0.3, n_obj)], 1).astype(np.float32)
        # gt = jittered copy of a random proposal (ensures IoU>=.5 hits exist)
        src = bbox[r.randint(0, n_obj)]
        jit = r.uniform(-4, 4, 4).astype(np.float32)
        gt = np.array([src[0] + jit[0], src[1] + jit[1],
                       src[2] + jit[2], src[3] + jit[3]], np.float32)

        scores, scores_mask, transformed, bbox_mask = proc_bbox_label(
            cfg, gt, bbox, K)

        bbox_feat = np.zeros((K, 5), np.float32)
        bbox_feat[:n_obj] = norm_bbox_feat(bbox, img_h, img_w)
        bbox_pad = np.zeros((K, 4), np.float32)
        bbox_pad[:n_obj] = bbox
        if getattr(cfg, "DEVICE_REL", False):
            rel_item = {"bbox_raw": bbox_pad}
        else:
            rel_img = np.zeros((K, K, 4), np.float32)
            rel_img[:n_obj, :n_obj] = relation_embedding(bbox)
            rel_item = {"rel_img": rel_img}

        return {
            "frcn_feat": frcn,
            "bbox_feat": bbox_feat,
            **rel_item,
            "ques_ix": ques_ix,
            "rel_ques": rel_ques.astype(np.float32),
            "scores": scores,
            "scores_mask": scores_mask,
            "transformed_bbox": transformed,
            "bbox_mask": bbox_mask,
            "gt_bbox": gt.reshape(1, 4),
            "bbox": bbox_pad,
            "img_shape": np.array([img_h, img_w], np.float32),
        }


class SynthItmDataset:
    """Synthetic Flickr30K-style corpus: n_imgs images x 5 captions each
    (SCAN 'precomp' structure, load_data_itm.py:57-74). Mirrors the mutable
    hard-negative index tensors the trainer overwrites after mining
    (load_data_itm.py:100-106) and the whole-corpus materialization used by
    mining/eval (get_all_caps / get_all_imgs, :154-198).

    ITM quirk kept: the caption relation tensor is ALWAYS zeros
    (load_data_itm.py:163, :207)."""

    CAPS_PER_IMG = 5

    def __init__(self, cfg, size: int = 200, token_size: int = 128,
                 seed: int = 0, run_mode: str = "train"):
        assert size % self.CAPS_PER_IMG == 0
        self.cfg = cfg
        self.run_mode = run_mode
        self.data_size = size                       # caption count
        self.n_imgs = size // self.CAPS_PER_IMG
        self.token_size = token_size
        self.ans_size = 1
        self.seed = seed
        self.max_token = cfg.MAX_TOKEN
        g = np.random.RandomState(seed + 5555)
        self.pretrained_emb = g.randn(token_size, cfg.WORD_EMBED_SIZE).astype(np.float32)
        self.epoch = 0
        self.shuffle_neg_idx()

    def set_epoch(self, epoch: int) -> None:
        # see ItmDataset.set_epoch: fold the epoch into the negative RNGs
        self.epoch = int(epoch)

    def shuffle_neg_idx(self):
        g = np.random.RandomState(
            (self.seed + 31337 + self.epoch * 131) % 2**32)
        self.neg_caps_idx_tensor = g.randint(
            0, self.data_size, (self.n_imgs, self.cfg.NEG_HARDSIZE)).astype(np.int64)
        self.neg_imgs_idx_tensor = g.randint(
            0, self.n_imgs, (self.data_size, self.cfg.NEG_HARDSIZE)).astype(np.int64)

    def __len__(self):
        return self.data_size

    # -- raw pieces ---------------------------------------------------------
    def _cap(self, cap_idx: int) -> np.ndarray:
        r = np.random.RandomState((self.seed * 7_777_777 + cap_idx) % 2**32)
        T = self.max_token
        n = int(r.randint(3, min(T, 12) + 1))
        cap = np.zeros((T,), np.int64)
        cap[:n] = r.randint(3, self.token_size, n)
        return cap

    def _img(self, img_idx: int):
        cfg = self.cfg
        r = np.random.RandomState((self.seed * 3_333_331 + img_idx) % 2**32)
        K, F = cfg.FRCNFEAT_LEN, cfg.FRCNFEAT_SIZE
        img_h, img_w = 480.0, 640.0
        n_obj = int(r.randint(8, K + 1))
        frcn = np.zeros((K, F), np.float32)
        frcn[:n_obj] = r.randn(n_obj, F).astype(np.float32) * 0.5 + 1e-3
        x1 = r.uniform(0, img_w * 0.8, n_obj)
        y1 = r.uniform(0, img_h * 0.8, n_obj)
        bbox = np.stack([x1, y1, x1 + r.uniform(8, 120, n_obj),
                         y1 + r.uniform(8, 90, n_obj)], 1).astype(np.float32)
        bbox_feat = np.zeros((K, 5), np.float32)
        bbox_feat[:n_obj, 0] = bbox[:, 0] / img_w
        bbox_feat[:n_obj, 1] = bbox[:, 1] / img_h
        bbox_feat[:n_obj, 2] = bbox[:, 2] / img_w
        bbox_feat[:n_obj, 3] = bbox[:, 3] / img_h
        bbox_feat[:n_obj, 4] = ((bbox[:, 2] - bbox[:, 0]) * (bbox[:, 3] - bbox[:, 1])
                                / (img_h * img_w))
        rel = np.zeros((K, K, 4), np.float32)
        rel[:n_obj, :n_obj] = relation_embedding(bbox)
        return frcn, bbox_feat, rel

    # -- corpus materialization (mining / eval) -----------------------------
    def get_all_caps(self):
        caps = np.stack([self._cap(i) for i in range(self.data_size)])
        rel = np.zeros((self.data_size, self.max_token, self.max_token, 3), np.float32)
        return caps, rel

    def get_all_imgs(self):
        out = [self._img(i) for i in range(self.n_imgs)]
        return (np.stack([o[0] for o in out]),
                np.stack([o[1] for o in out]),
                np.stack([o[2] for o in out]))

    # -- train items --------------------------------------------------------
    def __getitem__(self, idx: int):
        cfg = self.cfg
        img_idx = idx // self.CAPS_PER_IMG
        frcn, bbox_feat, rel = self._img(img_idx)
        T = self.max_token
        item = {
            "frcn_feat": frcn,
            "bbox_feat": bbox_feat,
            "rel_img": rel,
            "ques_ix": self._cap(idx),
            "rel_ques": np.zeros((T, T, 3), np.float32),
        }
        if self.run_mode == "train":
            r = np.random.RandomState(
                (self.seed * 13 + idx * 7 + 1
                 + self.epoch * 1_000_003) % 2**32)
            neg_cap_idx = int(self.neg_caps_idx_tensor[
                img_idx, r.randint(0, cfg.NEG_HARDSIZE)])
            neg_img_idx = int(self.neg_imgs_idx_tensor[
                idx, r.randint(0, cfg.NEG_HARDSIZE)])
            nfrcn, nbb, nrel = self._img(neg_img_idx)
            item.update({
                "neg_ques_ix": self._cap(neg_cap_idx),
                "neg_rel_ques": np.zeros((T, T, 3), np.float32),
                "neg_frcn_feat": nfrcn,
                "neg_bbox_feat": nbb,
                "neg_rel_img": nrel,
            })
        return item
