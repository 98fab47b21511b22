"""Fixed-architecture nets for VQA, VGD and ITM (counterpart of
mmnas_tpu/models/net.py).

GloVe embedding -> LSTM text encoder, image-feature projection, the
geometry-relation stem, genotype-defined encoder/decoder cells, and a task
head (the tasks share the whole trunk, full_vgd.py:76-114):

  vqa: AttFlat(x) + AttFlat(y) -> LN -> proj[ans_size] logits
       (full_vqa.py:85-111);
  vgd: AttFlat(x)[:, None] + attfc_y(y) -> LN -> per region proj_scores[1]
       (log_softmax over all FRCNFEAT_LEN regions, pads included, when
       SCORES_LOSS is 'kld') and proj_reg[4] box deltas (full_vgd.py:104-114);
  itm: AttFlat(x) + AttFlat(y) -> LN -> proj[1] -> sigmoid in fp32, the
       match probability [B] (full_itm.py:111).

The encoder side (text stem + enc cells) never sees the image, so the net
splits into `encode_text` and `apply_decoder` (the image stem, dec cells and
head against a text encoding); `forward` is the two in a row. ITM's mining
and R@K sweeps encode each caption once and score every (image, caption)
pair with `apply_decoder` alone (mmnas_tpu/models/net.py:305-357).

Module and parameter names mirror the JAX pytree, so models/convert.py
moves weights between the two packages by name. The stem
and the head are shared with the search supernet (models/supernet.py):
`init_stem`/`apply_stem` and `init_heads`/`apply_heads` register and run
them on the net itself, so their parameters sit at the root of the net, as
in the JAX pytree.

Precision: under --DTYPE bfloat16 the eval path casts the whole net once
(`net.to(bfloat16)`); training keeps fp32 master parameters and runs each
step on `compute_params(net, cfg)`, their bf16 casts, through
`torch.func.functional_call` (`compute_call`), so the gradients arrive in
fp32 on the masters (the JAX package's `cast_for_compute`, net.py:44-63). LN
statistics and the attention softmax stay fp32 either way, and the heads'
outputs leave in fp32 (ITM's sigmoid is taken in fp32: a bf16 sigmoid
rounds every logit above ~5.5 to exactly 1.0).

REMAT: the JAX flag (`OpCfg.remat`) rematerializes the RSA bias
[B, H, L, L] of a relation op, on its projected-relation and head-last
paths (mmnas_tpu/ops/modules.py:216-227); its raw-geometry path always
checkpoints the chain. The port has neither of the first two paths: its
RSA chain runs from the raw tensor inside the attention kernel (relation
ops here, ops/fused_attention.py), which keeps no bias for the backward
but the chain's `pre`, as the JAX raw path does. So the fixed net takes
--REMAT and computes exactly what it computes without it. The search
supernet's REMAT, each candidate op of the 'full' program checkpointed,
is in models/supernet.py.

Batch dict keys (fixed shapes, as the JAX package's loaders give them):
  frcn_feat [B, FRCNFEAT_LEN, FRCNFEAT_SIZE]  region features
  bbox_feat [B, FRCNFEAT_LEN, 5]              boxes (with BBOX_FEATURE)
  rel_img   [B, L_img, L_img, 4]              geometry relation tensor
  ques_ix   [B, MAX_TOKEN] int64              token ids (0 = PAD); VGD's
                                              query is MAX_TOKEN + 1 = 15 long
                                              (load_data_vgd.py:190)
With SHIP_INT8 (VQA's whole-batch loader) frcn_feat arrives as int8
`frcn_feat_q` [B, L, F] and fp32 `frcn_scale` [B, L]; with DEVICE_REL
(VQA, VGD) rel_img as the raw boxes `bbox_raw` [B, L, 4] (image_stem).
VGD batches also carry the supervision and eval keys of `VGD_KEYS`, ITM
train batches the hard negatives of `ITM_NEG_KEYS`.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
from torch import nn
from torch.func import functional_call

from mmnas_tpu_torch.data.relations import relation_embedding_torch
from mmnas_tpu_torch.genotype import Genotype
from mmnas_tpu_torch.ops import primitives as P
from mmnas_tpu_torch.ops.modules import AttFlat, OpCfg
from mmnas_tpu_torch.ops.registry import make_op

# the model inputs a batch may carry: SHIP_INT8 batches hold frcn_feat_q and
# frcn_scale in place of frcn_feat, DEVICE_REL batches bbox_raw in place of
# rel_img (image_stem)
INPUT_KEYS = ("frcn_feat", "bbox_feat", "rel_img", "ques_ix", "frcn_feat_q", "frcn_scale",
              "bbox_raw")
# a VGD batch's targets and eval inputs (mmnas_tpu/data/vgd.py): score and
# box-delta targets with their masks, the ground-truth box, the proposals
# and the image's (H, W)
VGD_KEYS = ("scores", "scores_mask", "transformed_bbox", "bbox_mask", "gt_bbox", "bbox",
            "img_shape")
# an ITM train batch's hard-negative caption and image (mmnas_tpu/data/itm.py);
# their text relation is always zeros and read by no op
ITM_NEG_KEYS = ("neg_ques_ix", "neg_frcn_feat", "neg_bbox_feat", "neg_rel_img")
TASKS = ("vqa", "vgd", "itm")
_FLOAT_INPUTS = ("frcn_feat", "bbox_feat", "rel_img")


def compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.DTYPE == "bfloat16" else torch.float32


def cast_for_compute(cfg, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Cast the float model inputs to the compute dtype (bf16 under
    --DTYPE bfloat16; fp16 region features are lifted to fp32 otherwise).
    The parameters are cast by the caller: `net.to(...)` or
    `compute_params`."""
    dt = compute_dtype(cfg)
    return {k: (v.to(dt) if k in _FLOAT_INPUTS and v.is_floating_point() else v)
            for k, v in batch.items()}


def compute_params(module: nn.Module, cfg, names: Optional[Iterable[str]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Parameter name -> the tensor a step computes with, for
    `torch.func.functional_call(module, ...)`: the fp32 master parameter
    itself under float32, its differentiable bf16 cast under bfloat16, so
    gradients reach the masters in fp32 (mmnas_tpu/models/net.py:44-63).
    `names` limits the dict to those parameters (a sampled step casts only
    the branches it runs; the others keep their masters and are not run).
    Callers pass `tie_weights=False`: the nets tie no weights, and the
    search for tied ones walks every submodule on each call."""
    params = dict(module.named_parameters())
    if names is not None:
        params = {n: params[n] for n in names}
    dt = compute_dtype(cfg)
    if dt == torch.float32:
        return params
    return {n: p.to(dt) if p.is_floating_point() else p for n, p in params.items()}


class _Method(nn.Module):
    """`inner.<method>(...)` as a module's forward, so that `functional_call`
    runs a method other than forward on substituted parameters (their names
    gain the prefix `inner.`)."""

    def __init__(self, inner: nn.Module, method: str):
        super().__init__()
        self.inner = inner
        self.method = method

    def forward(self, *args, **kwargs):
        return getattr(self.inner, self.method)(*args, **kwargs)


def compute_call(module: nn.Module, cfg, args, kwargs=None,
                 params: Optional[Dict[str, torch.Tensor]] = None, method: str = "forward"):
    """`module.<method>(*args, **kwargs)` (its forward by default) computing
    with `compute_params(module, cfg)`, or with `params`, taken from it once
    by a caller that calls more than once. Under float32 those are the
    module's own parameters, so this is the plain call; under bfloat16 it
    runs `functional_call` on the casts, so the gradients reach the fp32
    masters."""
    kwargs = kwargs or {}
    if compute_dtype(cfg) == torch.float32:
        return getattr(module, method)(*args, **kwargs)
    if params is None:
        params = compute_params(module, cfg)
    if method == "forward":
        return functional_call(module, params, args, kwargs, tie_weights=False)
    return functional_call(_Method(module, method), {f"inner.{n}": p for n, p in params.items()},
                           args, kwargs, tie_weights=False)


def cast_output(cfg, out):
    """Heads leave in fp32 (net.py:66-71): the VQA logits, both of the VGD
    head's (scores, reg), the ITM probabilities (fp32 already)."""
    if cfg.DTYPE != "bfloat16":
        return out
    if isinstance(out, tuple):
        return tuple(o.float() for o in out)
    return out.float()


def op_cfg_from(cfg) -> OpCfg:
    return OpCfg(
        hsize=cfg.HSIZE,
        dropout_r=cfg.DROPOUT_R,
        rel_size=cfg.REL_SIZE,
        attflat_glimpses=cfg.ATTFLAT_GLIMPSES,
        attflat_out_size=cfg.ATTFLAT_OUT_SIZE,
        attflat_mlp_size=cfg.ATTFLAT_MLP_SIZE,
    )


def rel_pack(linear: nn.Linear, raw) -> Dict:
    """Relation bundle for RSA ops: the raw tensor plus the stem weights;
    each RSA op runs the bias chain inside its attention kernel."""
    return {"raw": raw, "w1": linear.weight, "b1": linear.bias}


# ---------------------------------------------------------------------------
# shared stem / heads (net.py:90-185), registered on and run by the net
# ---------------------------------------------------------------------------

def init_stem(net: nn.Module, cfg, token_size: int, with_x_rel: bool) -> None:
    """GloVe embedding, LSTM, the image linear (after the box embedding with
    BBOX_FEATURE), the 4 -> REL_SIZE geometry stem and, for search nets, the
    3 -> REL_SIZE text-relation stem (hygr_vqa.py:83). No op of the ported
    search spaces reads the text relation, but the parameter is in the JAX
    pytree, so checkpoints carry it."""
    net.embedding = nn.Embedding(token_size, cfg.WORD_EMBED_SIZE)
    net.lstm = P.LSTM(cfg.WORD_EMBED_SIZE, cfg.HSIZE)
    imgfeat_in = cfg.FRCNFEAT_SIZE
    if cfg.BBOX_FEATURE:
        net.bboxfeat_linear = nn.Linear(5, cfg.BBOXFEAT_EMB_SIZE)
        imgfeat_in += cfg.BBOXFEAT_EMB_SIZE
    net.imgfeat_linear = nn.Linear(imgfeat_in, cfg.HSIZE)
    net.linear_y_rel = nn.Linear(4, cfg.REL_SIZE)
    if with_x_rel:
        net.linear_x_rel = nn.Linear(3, cfg.REL_SIZE)


def text_stem(net: nn.Module, ques_ix):
    """The text mask and the LSTM over the embedded tokens (full_vqa.py:88-95):
    (x, x_mask)."""
    x_mask = P.make_mask(ques_ix.unsqueeze(2).float())
    return net.lstm(net.embedding(ques_ix)), x_mask


def image_stem(net: nn.Module, cfg, batch):
    """The region mask (all-zero feature rows are pads), the image linear
    (after the box embedding with BBOX_FEATURE) and the relation bundle
    (full_vqa.py:96-103): (y, y_mask, y_rel). In the JAX package's order
    (mmnas_tpu/models/net.py:114-135): SHIP_INT8 batches carry int8
    `frcn_feat_q` and a per-region fp32 `frcn_scale`, dequantized in fp32
    and cast to the parameters' compute dtype; DEVICE_REL batches carry raw
    boxes `bbox_raw` in place of `rel_img`, whose relation tensor is
    computed here in fp32 (pairs touching a pad region 0) and cast to the
    features' dtype."""
    if "frcn_feat_q" in batch:
        frcn_feat = (batch["frcn_feat_q"].float() * batch["frcn_scale"].float()[..., None]
                     ).to(net.imgfeat_linear.weight.dtype)
    else:
        frcn_feat = batch["frcn_feat"]
    y_mask = P.make_mask(frcn_feat)
    rel_img = batch.get("rel_img")
    if rel_img is None and "bbox_raw" in batch:
        rel_img = relation_embedding_torch(batch["bbox_raw"].float(),
                                           ~y_mask[:, 0, 0, :]).to(frcn_feat.dtype)
    if cfg.BBOX_FEATURE:
        bb = net.bboxfeat_linear(batch["bbox_feat"])
        frcn_feat = torch.cat((frcn_feat, bb), dim=-1)
    y = net.imgfeat_linear(frcn_feat)
    return y, y_mask, rel_pack(net.linear_y_rel, rel_img)


def apply_stem(net: nn.Module, cfg, batch):
    """Masks + text/image/relation stems (full_vqa.py:88-103).
    Returns (x, y, x_mask, y_mask, y_rel); the encoders take no relation."""
    x, x_mask = text_stem(net, batch["ques_ix"])
    y, y_mask, y_rel = image_stem(net, cfg, batch)
    return x, y, x_mask, y_mask, y_rel


def check_task(task: str, what: str) -> None:
    """Raise for a task the port has no head for."""
    if task not in TASKS:
        raise ValueError(f"task '{task}': the {what} has no such task (one of {TASKS})")


def init_heads(net: nn.Module, cfg, ocfg: OpCfg, ans_size: int, task: str = "vqa") -> None:
    """The task's head (net.py:162-176): VQA's AttFlat pair and proj, VGD's
    AttFlat(x), attfc_y and the per-region proj_scores and proj_reg, or
    ITM's AttFlat pair and a proj with one output."""
    net.attflat_x = AttFlat(ocfg)
    if task == "vgd":      # per-region resolution on the image side (full_vgd.py:77)
        net.attfc_y = nn.Linear(cfg.HSIZE, cfg.ATTFLAT_OUT_SIZE)
    else:
        net.attflat_y = AttFlat(ocfg)
    net.proj_norm = P.LayerNorm(cfg.ATTFLAT_OUT_SIZE)
    if task == "vgd":
        net.proj_scores = nn.Linear(cfg.ATTFLAT_OUT_SIZE, 1)
        net.proj_reg = nn.Linear(cfg.ATTFLAT_OUT_SIZE, 4)
    else:
        net.proj = nn.Linear(cfg.ATTFLAT_OUT_SIZE, ans_size if task == "vqa" else 1)


def apply_heads(net: nn.Module, x, y, x_mask, y_mask, train: bool = False,
                generator: Optional[torch.Generator] = None):
    """The head of `net.task`. VQA: AttFlat(x) + AttFlat(y) -> LN -> proj,
    the logits [B, ans_size]. VGD: AttFlat(x)[:, None] + attfc_y(y) -> LN ->
    (scores [B, L], reg [B, L, 4]), the scores log-softmaxed over all L
    regions under SCORES_LOSS 'kld' (net.py:179-193). ITM: as VQA with one
    logit, its sigmoid taken in fp32, the probabilities [B] (net.py:194-201)."""
    xf = net.attflat_x(x, x_mask, train, generator)
    if net.task == "vgd":
        xy = net.proj_norm(xf[:, None, :] + net.attfc_y(y))
        scores = net.proj_scores(xy)[..., 0]
        if net.cfg.SCORES_LOSS == "kld":
            scores = torch.log_softmax(scores, dim=-1)
        return scores, net.proj_reg(xy)
    yf = net.attflat_y(y, y_mask, train, generator)
    out = net.proj(net.proj_norm(xf + yf))
    if net.task == "itm":
        return torch.sigmoid(out[..., 0].float())
    return out


def run_cell(cell, s, pre, s_mask, pre_mask, rel, train, generator):
    """A genotype cell: the ops of a node are summed (full_vqa.py:24-28)."""
    for node in cell:
        s = sum(op(s, pre, s_mask, pre_mask, rel, train, generator) for op in node)
    return s


class NetFull(nn.Module):
    """Genotype-defined multimodal encoder-decoder net, task 'vqa', 'vgd' or
    'itm'."""

    def __init__(self, cfg, genotype: Genotype, init_dict: Dict, task: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        task = task or cfg.TASK
        check_task(task, "head")
        # the full net feeds the raw [B,T,T,3] text relation to the encoder
        # (full_vqa.py:85-104 has no x-rel projection): no rel op there
        for node in genotype["enc"]:
            for name in node:
                if name.startswith("rel_"):
                    raise ValueError(
                        f"'{name}' in enc genotype: fixed-arch nets have no "
                        "text-relation projection (reference parity)")
        self.cfg = cfg
        self.task = task
        self.genotype = genotype
        self.ocfg = op_cfg_from(cfg)
        self.pretrained_emb = init_dict.get("pretrained_emb", None)

        init_stem(self, cfg, init_dict["token_size"], with_x_rel=False)
        # LAYERS identical cells per side (full_vqa.py:31-44)
        self.enc = nn.ModuleList(self.build_cell("enc") for _ in range(cfg.LAYERS))
        self.dec = nn.ModuleList(self.build_cell("dec") for _ in range(cfg.LAYERS))
        init_heads(self, cfg, self.ocfg, init_dict.get("ans_size", 1), task)
        self.reset_parameters(generator or torch.Generator().manual_seed(cfg.SEED))

    def build_cell(self, cell_type: str) -> nn.ModuleList:
        return nn.ModuleList(
            nn.ModuleList(make_op(name, self.ocfg, self.cfg.OPS_NORM, self.cfg.OPS_RESIDUAL)
                          for name in node)
            for node in self.genotype[cell_type])

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        P.init_parameters(self, generator)
        if self.pretrained_emb is not None:
            self.embedding.weight.copy_(torch.as_tensor(self.pretrained_emb))

    # -- forward ------------------------------------------------------------

    def encode_text(self, ques_ix, train: bool = False,
                    generator: Optional[torch.Generator] = None):
        """Text stem + enc cells: (x_out [B, T, HSIZE], x_mask [B, 1, 1, T]).
        The encoder has no rel op (checked above), so it gets no relation."""
        x, x_mask = text_stem(self, ques_ix)
        for cell in self.enc:
            x = run_cell(cell, x, None, x_mask, None, None, train, generator)
        return x, x_mask

    def apply_decoder(self, x_out, x_mask, batch, train: bool = False,
                      generator: Optional[torch.Generator] = None):
        """Image stem + dec cells + head against the text encoding (x_out,
        x_mask) of `encode_text`: with the encoding of batch["ques_ix"],
        `forward`'s output."""
        batch = cast_for_compute(self.cfg, batch)
        y, y_mask, y_rel = image_stem(self, self.cfg, batch)
        for cell in self.dec:
            y = run_cell(cell, y, x_out, y_mask, x_mask, y_rel, train, generator)
        out = apply_heads(self, x_out, y, x_mask, y_mask, train, generator)
        return cast_output(self.cfg, out)

    def forward(self, batch, train: bool = False, generator: Optional[torch.Generator] = None):
        x_out, x_mask = self.encode_text(batch["ques_ix"], train, generator)
        return self.apply_decoder(x_out, x_mask, batch, train, generator)
