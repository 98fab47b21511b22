"""Region-feature helpers of the VGD pipeline that the VQA dataset uses.

The port's own copy of `pad_feat` and `norm_bbox_feat` from
mmnas_tpu/data/vgd.py; the VGD dataset itself is ported with its task.
"""

from __future__ import annotations

import numpy as np


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
