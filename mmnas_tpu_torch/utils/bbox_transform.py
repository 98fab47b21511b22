"""Fast-R-CNN box delta encode/decode/clip.

The port's own copy of mmnas_tpu/utils/bbox_transform.py: the numpy
versions for the host data path and, in place of the jnp versions, torch
versions for the device-side VGD eval (engine/vgd.py decodes, clips and
takes the IoU on the device).

Conventions: boxes (x1,y1,x2,y2); +1 width/height; deltas
(dx, dy, dlog_w, dlog_h) relative to the proposal box.
"""

from __future__ import annotations

import numpy as np


def _whctrs(rois):
    w = rois[:, 2] - rois[:, 0] + 1.0
    h = rois[:, 3] - rois[:, 1] + 1.0
    cx = rois[:, 0] + 0.5 * w
    cy = rois[:, 1] + 0.5 * h
    return w, h, cx, cy


def bbox_transform(ex_rois: np.ndarray, gt_rois: np.ndarray) -> np.ndarray:
    """Encode gt boxes as deltas wrt proposals; [N,4]x[N or 1,4]->[N,4]."""
    ew, eh, ecx, ecy = _whctrs(np.asarray(ex_rois, np.float64))
    gw, gh, gcx, gcy = _whctrs(np.asarray(gt_rois, np.float64))
    return np.stack([(gcx - ecx) / ew, (gcy - ecy) / eh,
                     np.log(gw / ew), np.log(gh / eh)], axis=1)


def bbox_transform_inv(boxes: np.ndarray, deltas: np.ndarray) -> np.ndarray:
    """Decode deltas into boxes; [N,4]x[N,4]->[N,4]."""
    boxes = np.asarray(boxes, np.float64)
    if boxes.shape[0] == 0:
        return np.zeros_like(np.asarray(deltas))
    w, h, cx, cy = _whctrs(boxes)
    dx, dy, dw, dh = [deltas[:, i] for i in range(4)]
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = np.exp(dw) * w
    ph = np.exp(dh) * h
    return np.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                     pcx + 0.5 * pw, pcy + 0.5 * ph], axis=1)


def clip_boxes(boxes: np.ndarray, im_shape) -> np.ndarray:
    """Clamp boxes into [0, W-1] x [0, H-1]; im_shape = (H, W)."""
    out = np.array(boxes, copy=True)
    out[:, 0] = np.clip(out[:, 0], 0, im_shape[1] - 1)
    out[:, 1] = np.clip(out[:, 1], 0, im_shape[0] - 1)
    out[:, 2] = np.clip(out[:, 2], 0, im_shape[1] - 1)
    out[:, 3] = np.clip(out[:, 3], 0, im_shape[0] - 1)
    return out


# -- torch variants, for the device-side eval ---------------------------------

def bbox_transform_inv_torch(boxes, deltas):
    """[.., N, 4] x [.., N, 4] -> [.., N, 4] decode on the device, the twin
    of the JAX package's bbox_transform_inv_jnp."""
    import torch
    w = boxes[..., 2] - boxes[..., 0] + 1.0
    h = boxes[..., 3] - boxes[..., 1] + 1.0
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(deltas[..., 2]) * w
    ph = torch.exp(deltas[..., 3]) * h
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def clip_boxes_torch(boxes, im_shape):
    """boxes [.., N, 4]; im_shape [.., 2] = (H, W), batch dims matching
    boxes' (the box axis N broadcasts): the twin of clip_boxes_jnp."""
    import torch
    h = im_shape[..., 0][..., None] - 1   # [.., 1] vs boxes[.., N]
    w = im_shape[..., 1][..., None] - 1
    zero = torch.zeros_like(h)
    x1 = torch.clamp(boxes[..., 0], zero, w)
    y1 = torch.clamp(boxes[..., 1], zero, h)
    x2 = torch.clamp(boxes[..., 2], zero, w)
    y2 = torch.clamp(boxes[..., 3], zero, h)
    return torch.stack([x1, y1, x2, y2], dim=-1)
