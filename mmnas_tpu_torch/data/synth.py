"""Synthetic fixed-shape datasets (no files on disk required).

The reference has no test data story at all (SURVEY.md §4); these datasets
generate batches with exactly the reference data contracts (shapes, padding
conventions, relation tensors computed by the REAL feature-engineering code
in data/relations.py) so that train/search/eval loops, benchmarks and
tests run end-to-end without VQA-v2/RefCOCO/Flickr30K on disk.

Every item is deterministic in (seed, index).

The port's own copy of SynthVqaDataset and SynthVgdDataset from
mmnas_tpu/data/synth.py; the ITM synthetic dataset is ported with its task.
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
