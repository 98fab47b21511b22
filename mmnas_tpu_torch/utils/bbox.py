"""Pairwise box IoU: the native C++ kernel, its numpy twin and a torch
version for the device.

The port's own copy of mmnas_tpu/utils/bbox.py: `bbox_overlaps` (the C++
IoU of native/bbox.cpp through ctypes, numpy when the toolchain is
missing), `bbox_overlaps_np` and `bbox_overlaps_batch`, and, in place of
the jnp version, `bbox_overlaps_torch` for the VGD eval on the device.
All use the Fast R-CNN +1 pixel-area convention (bbox.pyx:33-55).
"""

from __future__ import annotations

import ctypes
import warnings

import numpy as np

_lib = None


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    try:
        from mmnas_tpu_torch.native.build import build
        path = build()
        lib = ctypes.CDLL(path)
        lib.bbox_overlaps.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double)]
        lib.bbox_overlaps_batch_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float)]
        _lib = lib
    except Exception as e:  # pragma: no cover - toolchain missing
        warnings.warn(f"native bbox kernel unavailable ({e}); using numpy")
        _lib = False
    return _lib


def bbox_overlaps_np(boxes: np.ndarray, query_boxes: np.ndarray) -> np.ndarray:
    """Vectorized numpy IoU, [N,4] x [K,4] -> [N,K]."""
    boxes = np.asarray(boxes, np.float64)
    query = np.asarray(query_boxes, np.float64)
    iw = (np.minimum(boxes[:, None, 2], query[None, :, 2])
          - np.maximum(boxes[:, None, 0], query[None, :, 0]) + 1.0)
    ih = (np.minimum(boxes[:, None, 3], query[None, :, 3])
          - np.maximum(boxes[:, None, 1], query[None, :, 1]) + 1.0)
    inter = np.maximum(iw, 0.0) * np.maximum(ih, 0.0)
    b_area = (boxes[:, 2] - boxes[:, 0] + 1.0) * (boxes[:, 3] - boxes[:, 1] + 1.0)
    q_area = (query[:, 2] - query[:, 0] + 1.0) * (query[:, 3] - query[:, 1] + 1.0)
    union = b_area[:, None] + q_area[None, :] - inter
    out = np.where(inter > 0, inter / union, 0.0)
    return out


def bbox_overlaps(boxes: np.ndarray, query_boxes: np.ndarray) -> np.ndarray:
    """[N,4] x [K,4] -> [N,K] IoU via the C++ kernel (numpy fallback)."""
    lib = _load_lib()
    if not lib:
        return bbox_overlaps_np(boxes, query_boxes)
    boxes = np.ascontiguousarray(boxes, np.float64)
    query = np.ascontiguousarray(query_boxes, np.float64)
    n, k = boxes.shape[0], query.shape[0]
    out = np.zeros((n, k), np.float64)
    lib.bbox_overlaps(
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        query.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), k,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def bbox_overlaps_batch(boxes: np.ndarray, query: np.ndarray) -> np.ndarray:
    """Batched [B,N,4] x [B,1,4] -> [B,N] float32 IoU (loader hot path)."""
    lib = _load_lib()
    boxes = np.ascontiguousarray(boxes, np.float32)
    query = np.ascontiguousarray(query, np.float32).reshape(boxes.shape[0], 4)
    if not lib:
        return np.stack([
            bbox_overlaps_np(boxes[i], query[i:i + 1])[:, 0]
            for i in range(boxes.shape[0])]).astype(np.float32)
    b, n = boxes.shape[0], boxes.shape[1]
    out = np.zeros((b, n), np.float32)
    lib.bbox_overlaps_batch_f32(
        boxes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), b, n,
        query.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def bbox_overlaps_torch(boxes, query_boxes):
    """Torch IoU for the device-side eval, the twin of the JAX package's
    bbox_overlaps_jnp: [..,N,4] x [..,K,4] -> [..,N,K], in the boxes' dtype
    and on their device."""
    import torch
    iw = (torch.minimum(boxes[..., :, None, 2], query_boxes[..., None, :, 2])
          - torch.maximum(boxes[..., :, None, 0], query_boxes[..., None, :, 0]) + 1.0)
    ih = (torch.minimum(boxes[..., :, None, 3], query_boxes[..., None, :, 3])
          - torch.maximum(boxes[..., :, None, 1], query_boxes[..., None, :, 1]) + 1.0)
    inter = torch.clamp(iw, min=0.0) * torch.clamp(ih, min=0.0)
    b_area = ((boxes[..., 2] - boxes[..., 0] + 1.0)
              * (boxes[..., 3] - boxes[..., 1] + 1.0))
    q_area = ((query_boxes[..., 2] - query_boxes[..., 0] + 1.0)
              * (query_boxes[..., 3] - query_boxes[..., 1] + 1.0))
    union = b_area[..., :, None] + q_area[..., None, :] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))
