"""Packed region-feature store: memory-mapped arrays replacing per-item npz.

At measured TPU step rates (~2.6k examples/s/chip fixed-arch train,
bench.py) the bottleneck on real data is the host loader: the reference
decompresses one ~1MB npz per item per epoch in DataLoader workers
(SURVEY.md §3 hot loop 4) — measured at ~81-92 items/s with 4-8 reader
threads vs ~360-550 items/s from the packed store (4.4-5.9x,
`tools/bench_loader.py --synth 300`, reference-shape 100x2048 features).
`tools/pack_features.py` converts an npz directory ONCE into

    <dir>.packed/feats.npy   [N, L, F] float16 memmap (zero-padded)
    <dir>.packed/bbox.npy    [N, L, 4] float32 memmap
    <dir>.packed/meta.json   {"iids": [...], "lens": [...], "hw": [[h,w]..]}

and `FeatureSource` serves items from the memmaps (OS page cache does the
rest) — falling back to npz transparently when no pack exists, so datasets
work unchanged either way.

The port's own copy of mmnas_tpu/data/packed.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np


class PackedFeatures:
    def __init__(self, packed_dir: str):
        with open(os.path.join(packed_dir, "meta.json")) as f:
            meta = json.load(f)
        self.iid_to_row = {iid: i for i, iid in enumerate(meta["iids"])}
        self.lens = np.asarray(meta["lens"], np.int32)
        self.hw = np.asarray(meta["hw"], np.float32)           # [N, 2] (h, w)
        self.feats = np.load(os.path.join(packed_dir, "feats.npy"),
                             mmap_mode="r")
        self.bbox = np.load(os.path.join(packed_dir, "bbox.npy"),
                            mmap_mode="r")

    def __contains__(self, iid: str) -> bool:
        return iid in self.iid_to_row

    def get(self, iid: str) -> Dict:
        row = self.iid_to_row[iid]
        k = int(self.lens[row])
        h, w = self.hw[row]
        return {
            "x": np.asarray(self.feats[row, :k], np.float32),   # [k, F]
            "bbox": np.asarray(self.bbox[row, :k], np.float32),
            "image_h": float(h),
            "image_w": float(w),
        }

    def get_rows(self, rows: np.ndarray) -> Dict:
        """Batched gather: one fancy-index read per array instead of
        per-item python calls (the whole point of the packed layout — the
        rows are already zero-padded to the store's max_len, so the gather
        IS the padded batch). Features come back in the STORAGE dtype
        (float16 by default): shipping half-width to the device halves the
        hottest host copy + H2D transfer; models cast to the compute dtype
        on device (models/net.py cast_for_compute)."""
        rows = np.asarray(rows)
        return {
            "x": self.feats[rows],          # [B, Lp, F] storage dtype
            "bbox": self.bbox[rows],        # [B, Lp, 4] float32
            "hw": self.hw[rows],            # [B, 2]
            "lens": self.lens[rows],        # [B]
        }


class FeatureSource:
    """iid -> region features, from the packed store when present
    (<npz_dir>.packed) else from the per-image npz files.

    npz convention (reference): x stored [F, k] -> transposed here;
    packed convention: already [k, F]."""

    def __init__(self, iid_to_npz_path: Dict[str, str],
                 npz_dirs: Optional[list] = None,
                 feat_key: str = "x"):
        self.iid_to_path = iid_to_npz_path
        self.feat_key = feat_key
        self.packed: Optional[PackedFeatures] = None
        for d in (npz_dirs or []):
            pdir = d.rstrip("/") + ".packed"
            if os.path.exists(os.path.join(pdir, "meta.json")):
                self.packed = PackedFeatures(pdir)
                break

    def get(self, iid: str) -> Dict:
        if self.packed is not None and iid in self.packed:
            return self.packed.get(iid)
        feat = np.load(self.iid_to_path[iid])
        return {
            "x": feat[self.feat_key].transpose((1, 0)).astype(np.float32),
            "bbox": feat["bbox"].astype(np.float32),
            "image_h": float(feat["image_h"]),
            "image_w": float(feat["image_w"]),
        }
