"""ITM (Flickr30K / COCO 'precomp') dataset (rebuild of
mmnas/loader/load_data_itm.py DataSet).

Layout: SCAN-precomp caption/id text files, 5 captions per image
(feat_ids_div=5, load_data_itm.py:57); 36x2048 npz region features keyed
through the dataset_flickr30k.json filename -> imgid map (:77-87).

Mutable mining state: `neg_caps_idx_tensor` [n_imgs, NEG_HARDSIZE] and
`neg_imgs_idx_tensor` [n_caps, NEG_HARDSIZE], initialized random and
overwritten by the trainer after each mining sweep (:100-106). The
reference's DataSet_Neg (64-candidate mining batches, :322-545) has no
class here: mining batches are assembled on DEVICE from the resident
corpus (engine/itm.py), which is the TPU-native replacement.

ITM quirk kept: caption relation tensors are always zeros (:163, :207).

The port's own copy of mmnas_tpu/data/itm.py: the port imports nothing of the
JAX package.
"""

from __future__ import annotations

import glob
import json
import os
import threading
from collections import OrderedDict
from typing import Dict

import numpy as np

from mmnas_tpu_torch.data.relations import relation_embedding
from mmnas_tpu_torch.data.vgd import norm_bbox_feat, pad_feat
from mmnas_tpu_torch.data.vocab import build_vocab_from_questions, tokenize_question


class ItmDataset:
    CAPS_PER_IMG = 5

    def __init__(self, cfg, run_mode: str):
        self.cfg = cfg
        self.run_mode = run_mode
        from mmnas_tpu_torch.data.paths import ItmPaths
        paths = ItmPaths(cfg.DATA_ROOT, cfg.DATASET or "flickr")
        cap_paths = paths.caption_paths()

        stat_caps = []
        for k, p in cap_paths.items():
            if "caps" in k and os.path.exists(p):
                with open(p) as f:
                    stat_caps += [ln.strip() for ln in f]

        split_map = {"train": cfg.TRAIN_SPLIT, "val": "dev", "test": "test"}
        self.caps_list, self.feat_ids_list = [], []
        for split in split_map[run_mode].split("+"):
            with open(cap_paths[f"{split}-caps"]) as f:
                split_caps = [ln.strip() for ln in f]
            with open(cap_paths[f"{split}-ids"]) as f:
                ids = [ln.strip() for ln in f]
            # SCAN precomp ids come one-per-caption (each image id repeated
            # 5x); normalize to one-per-IMAGE so caption c pairs with image
            # c // 5. (The reference keeps the raw per-caption list for the
            # train split, load_data_itm.py:64-71, which only lines up
            # because of the repetition; this normalization handles both
            # per-caption and per-image id files.)
            if len(ids) == len(split_caps):
                ids = ids[::self.CAPS_PER_IMG]
            assert len(ids) * self.CAPS_PER_IMG == len(split_caps), (
                f"{split}: {len(split_caps)} captions vs {len(ids)} image ids")
            self.caps_list += split_caps
            self.feat_ids_list += ids
        self.data_size = len(self.caps_list)

        id_map = None
        if (cfg.DATASET or "flickr") == "flickr":
            with open(cap_paths["orin"]) as f:
                orin = json.load(f)
            id_map = {img["filename"].split(".")[0]: str(img["imgid"])
                      for img in orin["images"]}

        frcn_paths = []
        for d in paths.imgfeat_dirs():
            frcn_paths += glob.glob(os.path.join(d, "*.npz"))
        self.iid_to_path = {}
        for p in frcn_paths:
            iid = str(int(os.path.basename(p).split("_")[-1].split(".")[0]))
            if id_map is not None:
                if iid not in id_map:
                    continue
                iid = id_map[iid]
            self.iid_to_path[iid] = p
        from mmnas_tpu_torch.data.packed import FeatureSource
        self.features = FeatureSource(self.iid_to_path, paths.imgfeat_dirs())

        self.token_to_ix, self.pretrained_emb = build_vocab_from_questions(
            stat_caps, cfg, cache_name="itm")
        self.token_size = len(self.token_to_ix)
        self.max_token = cfg.MAX_TOKEN
        self.ans_size = 1
        self.n_imgs = len(self.feat_ids_list)
        # per-instance bounded LRU of decoded image tuples (an lru_cache on
        # the method would key on `self` and pin every instance's corpus for
        # the process lifetime — ~2x residency with train+eval datasets)
        self._img_cache: OrderedDict = OrderedDict()
        self._img_cache_max = 4096
        # the threaded Loader calls __getitem__ concurrently; guard the
        # get/move_to_end/evict sequence (lru_cache was implicitly locked)
        self._img_cache_lock = threading.Lock()
        self.epoch = 0
        self.shuffle_neg_idx()

    def set_epoch(self, epoch: int) -> None:
        """Reference parity: DataSet draws FRESH random negatives each epoch
        (torch.randint per shuffle call, random.randint per item access,
        load_data_itm.py:100-106,201-273). Our RNGs are seeded for run
        determinism, so the epoch must be folded in — otherwise every
        pre-mining reshuffle regenerates identical tensors and every item
        picks the same 1-of-H hard-negative slot all run."""
        self.epoch = int(epoch)

    def shuffle_neg_idx(self):
        g = np.random.RandomState(
            (self.cfg.SEED + 31337 + self.epoch * 131) % 2**32)
        self.neg_caps_idx_tensor = g.randint(
            0, self.data_size, (self.n_imgs, self.cfg.NEG_HARDSIZE)).astype(np.int64)
        self.neg_imgs_idx_tensor = g.randint(
            0, self.n_imgs, (self.data_size, self.cfg.NEG_HARDSIZE)).astype(np.int64)

    def __len__(self):
        return self.data_size

    def proc_cap(self, cap: str) -> np.ndarray:
        out = np.zeros(self.max_token, np.int64)
        for ix, w in enumerate(tokenize_question(cap)):
            out[ix] = self.token_to_ix.get(w, self.token_to_ix["UNK"])
            if ix + 1 == self.max_token:
                break
        return out

    def _img(self, img_idx: int):
        with self._img_cache_lock:
            cached = self._img_cache.get(img_idx)
            if cached is not None:
                self._img_cache.move_to_end(img_idx)
                return cached
        cfg = self.cfg
        feat = self.features.get(self.feat_ids_list[img_idx])
        frcn = pad_feat(feat["x"], cfg.FRCNFEAT_LEN)
        img_h, img_w = feat["image_h"], feat["image_w"]
        bbox = feat["bbox"]
        bbox_feat = pad_feat(norm_bbox_feat(bbox, img_h, img_w), cfg.FRCNFEAT_LEN)
        rel = np.zeros((cfg.FRCNFEAT_LEN, cfg.FRCNFEAT_LEN, 4), np.float32)
        k = min(bbox.shape[0], cfg.FRCNFEAT_LEN)
        rel[:k, :k] = relation_embedding(bbox[:k])
        out = (frcn, bbox_feat, rel)
        with self._img_cache_lock:
            self._img_cache[img_idx] = out
            if len(self._img_cache) > self._img_cache_max:
                self._img_cache.popitem(last=False)
        return out

    def get_all_caps(self):
        caps = np.stack([self.proc_cap(c) for c in self.caps_list])
        rel = np.zeros((self.data_size, self.max_token, self.max_token, 3),
                       np.float32)
        return caps, rel

    def get_all_imgs(self):
        out = [self._img(i) for i in range(self.n_imgs)]
        return (np.stack([o[0] for o in out]),
                np.stack([o[1] for o in out]),
                np.stack([o[2] for o in out]))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        T = self.max_token
        img_idx = idx // self.CAPS_PER_IMG
        frcn, bbox_feat, rel = self._img(img_idx)
        item = {
            "frcn_feat": frcn,
            "bbox_feat": bbox_feat,
            "rel_img": rel,
            "ques_ix": self.proc_cap(self.caps_list[idx]),
            "rel_ques": np.zeros((T, T, 3), np.float32),
        }
        if self.run_mode == "train":
            r = np.random.RandomState(
                (cfg.SEED * 13 + idx * 7 + 1
                 + self.epoch * 1_000_003) % 2**32)
            neg_cap_idx = int(self.neg_caps_idx_tensor[
                img_idx, r.randint(0, cfg.NEG_HARDSIZE)])
            neg_img_idx = int(self.neg_imgs_idx_tensor[
                idx, r.randint(0, cfg.NEG_HARDSIZE)])
            nfrcn, nbb, nrel = self._img(neg_img_idx)
            item.update({
                "neg_ques_ix": self.proc_cap(self.caps_list[neg_cap_idx]),
                "neg_rel_ques": np.zeros((T, T, 3), np.float32),
                "neg_frcn_feat": nfrcn,
                "neg_bbox_feat": nbb,
                "neg_rel_img": nrel,
            })
        return item
