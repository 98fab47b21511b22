"""Dataset path registry (rebuild of mmnas/loader/filepath_{vqa,vgd,itm}.py).

Same on-disk layouts as the reference, parameterized by DATA_ROOT instead of
hardcoded './data' constants. Layouts:

  vqa: <root>/vqa/annotations/*.json + <root>/vqa/bua-r101-max100/{train2014,
       val2014,test2015}/*.npz                       (filepath_vqa.py:1-28)
  vgd: <root>/vgd/{refcoco,refcoco+,refcocog}/<split>.json +
       <root>/vgd/bua-r101-fix100/*.npz (vg_woref) or
       <root>/vgd/vgd_coco/fix100/<dataset>_*/*.npz (coco_mrcn)
                                                     (filepath_vgd.py:9-38)
  itm: <root>/itm/{f30k,coco}_precomp/{split}_caps.txt,{split}_ids.txt +
       <root>/itm/flickr_bua-r101-fix36/*.npz        (filepath_itm.py:9-38)

The port's own copy of mmnas_tpu/data/paths.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import os
from typing import Dict, List


class VqaPaths:
    def __init__(self, data_root: str):
        self.anno = os.path.join(data_root, "vqa", "annotations")
        self.feat = os.path.join(data_root, "vqa", "bua-r101-max100")

    def imgfeat_dirs(self) -> Dict[str, str]:
        return {
            "train": os.path.join(self.feat, "train2014"),
            "val": os.path.join(self.feat, "val2014"),
            "test": os.path.join(self.feat, "test2015"),
        }

    def question_paths(self) -> Dict[str, str]:
        a = self.anno
        return {
            "train": os.path.join(a, "v2_OpenEnded_mscoco_train2014_questions.json"),
            "train-anno": os.path.join(a, "v2_mscoco_train2014_annotations.json"),
            "val": os.path.join(a, "v2_OpenEnded_mscoco_val2014_questions.json"),
            "val-anno": os.path.join(a, "v2_mscoco_val2014_annotations.json"),
            "vg": os.path.join(a, "VG_questions.json"),
            "vg-anno": os.path.join(a, "VG_annotations.json"),
            "test": os.path.join(a, "v2_OpenEnded_mscoco_test2015_questions.json"),
        }


class VgdPaths:
    def __init__(self, data_root: str, dataset: str, feat_mode: str):
        self.root = os.path.join(data_root, "vgd")
        self.dataset = dataset
        self.feat_mode = feat_mode

    def imgfeat_dirs(self) -> List[str]:
        if self.feat_mode == "coco_mrcn":
            sub = {"refcoco": "refcoco_unc", "refcoco+": "refcoco+_unc",
                   "refcocog": "refcocog_umd"}[self.dataset]
            return [os.path.join(self.root, "vgd_coco", "fix100", sub)]
        return [os.path.join(self.root, "bua-r101-fix100")]

    def iid_map(self, path_list: List[str]) -> Dict[str, str]:
        """image id -> npz path (load_data_vgd.py:99-108)."""
        out = {}
        for p in path_list:
            stem = os.path.basename(p).split(".")[0]
            if self.feat_mode == "coco_mrcn":
                out[stem] = p
            else:
                out[str(int(stem.split("_")[-1]))] = p
        return out

    def ref_jsons(self) -> Dict[str, str]:
        d = os.path.join(self.root, self.dataset)
        splits = (["train", "val", "test"] if self.dataset == "refcocog"
                  else ["train", "val", "testA", "testB"])
        return {s: os.path.join(d, f"{s}.json") for s in splits}


class ItmPaths:
    def __init__(self, data_root: str, dataset: str = "flickr"):
        self.root = os.path.join(data_root, "itm")
        self.dataset = dataset
        self.precomp = os.path.join(
            self.root, "f30k_precomp" if dataset == "flickr" else "coco_precomp")

    def caption_paths(self) -> Dict[str, str]:
        out = {}
        splits = (["train", "dev", "test"] if self.dataset == "flickr"
                  else ["train", "dev", "test", "testall"])
        for s in splits:
            out[f"{s}-caps"] = os.path.join(self.precomp, f"{s}_caps.txt")
            out[f"{s}-ids"] = os.path.join(self.precomp, f"{s}_ids.txt")
        if self.dataset == "flickr":
            out["orin"] = os.path.join(self.root, "dataset_flickr30k.json")
        return out

    def imgfeat_dirs(self) -> List[str]:
        if self.dataset == "flickr":
            return [os.path.join(self.root, "flickr_bua-r101-fix36")]
        return [os.path.join(self.root, "bua-r101-fix36", "train2014"),
                os.path.join(self.root, "bua-r101-fix36", "val2014")]
