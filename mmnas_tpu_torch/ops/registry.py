"""Op registry + search spaces (counterpart of mmnas_tpu/ops/registry.py).

`OPS` maps each of the reference's 41 candidate-op names to a factory
`(cfg, norm, residual) -> nn.Module` (ops_adapter.py:24-73); `Used_OPS`
defines the active search spaces (ops_adapter.py:7-22):
    enc_safe = [self_att_64, feed_forward]
    dec_safe = [self_att_64, rel_self_att_64, guided_att_64, feed_forward]
with 'none' appended for the non-safe variants.
"""

from __future__ import annotations

from functools import partial

from torch import nn

from mmnas_tpu_torch.ops import modules as M
from mmnas_tpu_torch.ops.modules import OpCfg


def _build_ops():
    ops = {"none": M.zero}
    for name in ("skip_connect", "relu", "gelu", "leakyrelu"):
        ops[name] = partial(M.elementwise, name=name)
    for base in (16, 32, 64, 128, 256):
        ops[f"self_att_{base}"] = partial(M.self_att, base=base)
        ops[f"rel_self_att_{base}"] = partial(M.rel_self_att, base=base)
        ops[f"guided_att_{base}"] = partial(M.guided_att, base=base)
    ops["self_att_64_2"] = partial(M.self_att, base=64, hsize_k=2)
    ops["guided_att_64_2"] = partial(M.guided_att, base=64, hsize_k=2)
    for base in (32, 64, 128):
        ops[f"uniimg_att_{base}"] = partial(M.uniimg_att, base=base)
    for k in (3, 5, 7, 11):
        ops[f"sep_conv_{k}"] = partial(M.sep_conv, k=k)
        ops[f"std_conv_{k}"] = partial(M.std_conv, k=k)
    ops["feed_forward"] = M.feed_forward
    for mid_k in (2, 8, 16, 32):
        ops[f"feed_forward_{mid_k}"] = partial(M.feed_forward, mid_k=mid_k)
    ops["feed_forward_deep"] = M.feed_forward_deep
    ops["gated_linear_1"] = partial(M.glu, layers=1)
    ops["gated_linear_2"] = partial(M.glu, layers=2)
    return ops


OPS = _build_ops()

Used_OPS = {
    "enc_safe": ["self_att_64", "feed_forward"],
    "dec_safe": ["self_att_64", "rel_self_att_64", "guided_att_64", "feed_forward"],
}
Used_OPS["enc"] = Used_OPS["enc_safe"] + ["none"]
Used_OPS["dec"] = Used_OPS["dec_safe"] + ["none"]


def make_op(name: str, cfg: OpCfg, norm: bool, residual: bool) -> nn.Module:
    """Instantiate a named candidate op with the reference factory contract
    (ops_adapter.py:24-73); an unknown name raises KeyError."""
    return OPS[name](cfg, norm, residual)
