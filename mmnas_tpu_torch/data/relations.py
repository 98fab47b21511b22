"""Host-side relation-tensor feature engineering (numpy).

Rebuild of the reference's per-item relation features
(mmnas/loader/load_data_vqa.py:7-58), computed in the data loader exactly as
there — including the two documented quirks that the trained weights depend
on: the 1e-3 clamp *before* log in the geometry embedding, and the
sqrt-of-L2-norm normalizer in the GloVe cosine (load_data_vqa.py:49-50).

The port's own copy of the numpy functions of mmnas_tpu/data/relations.py,
with `relation_embedding_torch` in place of the device-side
relation_embedding_jnp.
"""

from __future__ import annotations

import numpy as np


def relation_embedding(bbox: np.ndarray) -> np.ndarray:
    """Box-geometry relation tensor.

    bbox: [K, 4] (x_min, y_min, x_max, y_max) -> [K, K, 4] of
    (log|dcx/w_i|, log|dcy/h_i|, log(w_i/w_j), log(h_i/h_j))
    (load_data_vqa.py:7-33).
    """
    bbox = np.asarray(bbox, np.float32)
    x_min, y_min, x_max, y_max = [bbox[:, i] for i in range(4)]
    cx = (x_min + x_max) * 0.5
    cy = (y_min + y_max) * 0.5
    w = (x_max - x_min) + 1.0
    h = (y_max - y_min) + 1.0

    delta_x = np.log(np.maximum(np.abs((cx[:, None] - cx[None, :]) / w[:, None]), 1e-3))
    delta_y = np.log(np.maximum(np.abs((cy[:, None] - cy[None, :]) / h[:, None]), 1e-3))
    delta_w = np.log(w[:, None] / w[None, :])
    delta_h = np.log(h[:, None] / h[None, :])
    return np.stack((delta_x, delta_y, delta_w, delta_h), axis=-1).astype(np.float32)


def relation_embedding_torch(bbox, valid_mask=None):
    """Device-side batched twin of relation_embedding: [B, K, 4] boxes ->
    [B, K, K, 4] in the boxes' dtype. With cfg.DEVICE_REL the loaders ship
    the raw 4-float boxes and the nets' stem runs this on the device
    instead of per item in the host workers. Entries touching padded boxes
    ([B, K] bool valid_mask, True = real box) are exactly 0, as in the
    host's zero-padded tensor (load_data_vqa.py:241-244)."""
    import torch

    x_min, y_min, x_max, y_max = bbox.unbind(-1)
    cx = (x_min + x_max) * 0.5
    cy = (y_min + y_max) * 0.5
    w = (x_max - x_min) + 1.0
    h = (y_max - y_min) + 1.0
    dx = torch.log(torch.clamp(
        torch.abs((cx[..., :, None] - cx[..., None, :]) / w[..., :, None]), min=1e-3))
    dy = torch.log(torch.clamp(
        torch.abs((cy[..., :, None] - cy[..., None, :]) / h[..., :, None]), min=1e-3))
    dw = torch.log(w[..., :, None] / w[..., None, :])
    dh = torch.log(h[..., :, None] / h[..., None, :])
    rel = torch.stack((dx, dy, dw, dh), dim=-1)
    if valid_mask is not None:
        pair = valid_mask[..., :, None] & valid_mask[..., None, :]
        rel = torch.where(pair[..., None], rel, torch.zeros((), dtype=rel.dtype,
                                                             device=rel.device))
    return rel


def semantic_embedding_batch(ques_ix: np.ndarray, n_words: np.ndarray,
                             pretrained_emb: np.ndarray,
                             max_token: int = 14) -> np.ndarray:
    """Batched twin of semantic_embedding: [B, T] token ids + [B] true word
    counts -> [B, T, T, 3], entries outside min(n_words, T) zeroed like the
    per-item version's zero-padding. Vectorized numpy — this is the hot
    per-item compute of the reference's loader workers collapsed into one
    call per batch (data/vqa.py get_batch)."""
    B, T = ques_ix.shape
    assert T == max_token
    ques_ix = np.asarray(ques_ix, np.int64)
    size = np.minimum(np.asarray(n_words, np.int64), max_token)  # [B]
    g = pretrained_emb[ques_ix].astype(np.float32)

    # ||a-b||^2 = ||a||^2 + ||b||^2 - 2ab: [B,T,T] instead of the
    # [B,T,T,300] diff tensor (the diff-based norm was ~100x the rest of
    # the batch assembly). Identical-token pairs are forced to the exact
    # 0.0 the diff form produces (the formula leaves ~1e-3 cancellation
    # residue there); other entries agree to ~1e-4.
    dot = np.einsum("bik,bjk->bij", g, g)
    sq = np.einsum("btk,btk->bt", g, g)
    l2sq = np.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * dot, 0.0)
    glove_l2 = np.sqrt(l2sq)
    same_tok = ques_ix[:, :, None] == ques_ix[:, None, :]
    glove_l2 = np.where(same_tok, 0.0, glove_l2)

    mod = np.sqrt(np.sqrt(sq))                  # sqrt(||g||): quirk kept
    glove_cos = dot / (mod[:, :, None] * mod[:, None, :] + 1e-6)

    pos = np.arange(T, dtype=np.float32)
    sub_pos = (np.abs(pos[:, None] - pos[None, :])[None]
               / np.maximum(size, 1).astype(np.float32)[:, None, None])

    out = np.stack((glove_l2, glove_cos, sub_pos), axis=-1)
    valid = pos[None, :] < size[:, None].astype(np.float32)     # [B, T]
    pair = (valid[:, :, None] & valid[:, None, :])[..., None]
    return np.where(pair, out, 0.0).astype(np.float32)


def semantic_embedding(n_words: int, ques_ix: np.ndarray,
                       pretrained_emb: np.ndarray, max_token: int = 14) -> np.ndarray:
    """Question semantic relation tensor, zero-padded to [max_token]^2.

    n_words: true (untruncated) word count of the question; the effective
    size is min(n_words, max_token) (load_data_vqa.py:40). Channels:
    (GloVe L2 distance, GloVe 'cosine' with sqrt-norm normalizer,
    |i-j|/size relative position) (load_data_vqa.py:42-57).
    """
    size = min(int(n_words), max_token)
    out = np.zeros((max_token, max_token, 3), np.float32)
    if size == 0:
        return out
    g = pretrained_emb[np.asarray(ques_ix[:size], np.int64)].astype(np.float32)  # [S,300]

    diff = g[:, None, :] - g[None, :, :]
    glove_l2 = np.linalg.norm(diff, axis=-1)

    dot = g @ g.T
    mod = np.sqrt(np.linalg.norm(g, axis=-1))          # sqrt(||g||): quirk kept
    glove_cos = dot / (mod[:, None] * mod[None, :] + 1e-6)

    pos = np.arange(size, dtype=np.float32)
    sub_pos = np.abs(pos[:, None] - pos[None, :]) / size

    out[:size, :size, 0] = glove_l2
    out[:size, :size, 1] = glove_cos
    out[:size, :size, 2] = sub_pos
    return out
