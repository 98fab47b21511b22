"""Weight-sharing search supernet for VQA, VGD and ITM (counterpart of
mmnas_tpu/models/supernet.py).

Every node of the 12-node encoder and the 18-node decoder holds one op of
each candidate in its search space (enc_safe, dec_safe), so `enc[node][op]`
and `dec[node][op]` mirror the JAX pytree, and the stem and the task's
head are those of the fixed net (models/net.py). The architecture weights alpha
are one [n_nodes, n_choices] fp32 tensor per cell type, held by the caller
(the search engine), not by this module.

The JAX package samples the path on the device and branches with
`lax.switch`. Here the branch is Python control flow, so the indices live
on the host: `sample_indices`, `sample_indices_two` and `chosen_indices`
take a host copy of alpha and return numpy arrays, and `forward` takes
them. The draws are split in two: the uniforms, which depend only on the
generator (`draw_uniforms`, `draw_uniforms_two`), and the inversion of
softmax(alpha)'s CDF (`indices_from_uniforms`, `indices_two_from_uniforms`),
on tensors of any device, so the search's step programs (engine/search.py,
SCAN_STEPS) draw the uniforms ahead on the host and sample on the device
against the device alpha, to the host loop's indices.
Forward modes:

- "sampled": only the indexed op of each node runs (weight step, eval);
- "full": every op runs, combined with straight-through gates
  g = onehot(idx) + softmax(alpha) - stop_grad(softmax(alpha)), the
  inactive branches detached (mixed.py:60-68), so the forward equals the
  sampled path and d(loss)/d(alpha) is the ProxylessNAS softmax-Jacobian
  sum_j b_j p_j (delta_ij - p_i) (mixed.py:171-198). With host indices the
  inactive outputs are detached in Python; with device indices (integer
  tensors, a step captured in a CUDA graph) by `torch.where` on the one-hot,
  so their ops run a backward of zeros. Under REMAT each op runs under
  `primitives.remat` (the JAX package's `jax.checkpoint` of each candidate,
  supernet.py:216-242): its activations are recomputed in the backward, with
  the first pass's dropout masks;
- "two": the two indexed ops ([n, 2]: active, inactive) under gates built
  from the softmax over the pair's logits (mixed.py:136-148);
- "unified": the sampled path's math with no branch on the index
  (supernet.py:187-211): the indices go to the device as integer tensors;
  each encoder node runs self_att_64 and feed_forward and keeps one by
  `torch.where`, each decoder node runs `unified_att_node` (the three
  attention candidates as one program, ops/modules.py) and feed_forward and
  keeps one the same way. The outputs and the parameters' gradients are the
  sampled path's; an unsampled candidate's gradient is 0;
- "hybrid": the unified encoder and the sampled decoder.

As the fixed net, the sampled path splits into `encode_text` and
`apply_decoder` for ITM's mining and R@K sweeps (supernet.py:333-378).
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from mmnas_tpu_torch.models.net import (
    apply_heads, apply_stem, cast_for_compute, cast_output, check_task, image_stem, init_heads,
    init_stem, op_cfg_from, text_stem,
)
from mmnas_tpu_torch.ops import primitives as P
from mmnas_tpu_torch.ops.modules import unified_att_node
from mmnas_tpu_torch.ops.registry import Used_OPS, make_op

# the safe search spaces (mmnas_tpu/ops/registry.py:48-51)
SPACES = {"enc": Used_OPS["enc_safe"], "dec": Used_OPS["dec_safe"]}
# MCAN-like biased alpha init (hygr_vqa.py:139-156): +1 on the hand-picked
# op, -1 elsewhere. The reference's dec pattern has 21 entries for 18 nodes;
# zip truncates, reproduced by cycling then slicing (supernet.py:45-50).
_INIT_ENC = ["self_att_64", "feed_forward"]
_INIT_DEC = ["rel_self_att_64", "guided_att_64", "feed_forward"]
CELLS = ("enc", "dec")
# the unified nodes are written for these spaces (supernet.py:198, :206-207)
assert SPACES == {"enc": ["self_att_64", "feed_forward"],
                  "dec": ["self_att_64", "rel_self_att_64", "guided_att_64", "feed_forward"]}


def _softmax(a) -> np.ndarray:
    """Row softmax of a host array, in float64."""
    a = np.asarray(a, np.float64)
    e = np.exp(a - a.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def _uniform(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniforms in [0, 1), float64, from the CPU generator."""
    return torch.rand(tuple(shape), generator=generator, dtype=torch.float64)


# exp by + - * and a power of two (`_exp`): fdlibm's split of ln 2, 1/n!
_LN2_HI, _LN2_LO, _INV_LN2 = 6.93147180369123816490e-01, 1.90821492927058770002e-10, \
    1.44269504088896338700e+00
_EXP_TERMS = [1.0 / math.factorial(n) for n in range(14)]


def _exp(x: torch.Tensor) -> torch.Tensor:
    """exp(x) of float64 x <= 0, clamped at -700: x = k ln2 + r with
    |r| <= ln2 / 2, exp(r) by its Taylor series to r^13 (Horner), times 2^k
    built from its bits. Only IEEE + - * / and exact scalings, so the CPU
    and the card give the same bits (their own exp functions differ in the
    last bit)."""
    x = x.clamp(min=-700.0)
    k = torch.floor(x * _INV_LN2 + 0.5)
    r = (x - k * _LN2_HI) - k * _LN2_LO
    p = _EXP_TERMS[-1] * r + _EXP_TERMS[-2]
    for c in reversed(_EXP_TERMS[:-2]):
        p = p * r + c
    return p * ((k.to(torch.int64) + 1023) << 52).view(torch.float64)


def _softmax_cdf(a: torch.Tensor) -> List[torch.Tensor]:
    """softmax(a)'s CDF over the last axis of float64 `a`, one tensor a
    choice, summed column by column in a fixed order, so that the CPU and
    the card round it alike."""
    cols = a.unbind(-1)
    m = cols[0]
    for c in cols[1:]:
        m = torch.maximum(m, c)
    e = _exp(a - m.unsqueeze(-1)).unbind(-1)
    total = e[0]
    for x in e[1:]:
        total = total + x
    cdf = [e[0] / total]
    for x in e[1:]:
        cdf.append(cdf[-1] + x / total)
    return cdf


class NetSearch(nn.Module):
    def __init__(self, cfg, init_dict: Dict, task: str = "vqa",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_task(task, "search net")
        if cfg.LAYERS != 1:
            raise ValueError("the search supernet has one cell per side: LAYERS must be 1 "
                             "(reference parity)")
        self.cfg = cfg
        self.task = task
        self.ocfg = op_cfg_from(cfg)
        self.spaces = SPACES
        self.n_nodes = dict(cfg.NODES)
        self.pretrained_emb = init_dict.get("pretrained_emb", None)

        init_stem(self, cfg, init_dict["token_size"], with_x_rel=True)
        self.enc = self.build_nodes("enc")
        self.dec = self.build_nodes("dec")
        init_heads(self, cfg, self.ocfg, init_dict.get("ans_size", 1), task)
        self.reset_parameters(generator or torch.Generator().manual_seed(cfg.SEED))
        # every parameter's name -> (cell type, node, op) for the candidate
        # ops' parameters, None for the others (update_mask runs per path)
        self._op_of = {}
        for n, _ in self.named_parameters():
            head, *rest = n.split(".")
            self._op_of[n] = (head, int(rest[0]), int(rest[1])) if head in CELLS else None

    def build_nodes(self, cell_type: str) -> nn.ModuleList:
        return nn.ModuleList(
            nn.ModuleList(make_op(name, self.ocfg, self.cfg.OPS_NORM, self.cfg.OPS_RESIDUAL)
                          for name in self.spaces[cell_type])
            for _ in range(self.n_nodes[cell_type]))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        P.init_parameters(self, generator)
        if self.pretrained_emb is not None:
            self.embedding.weight.copy_(torch.as_tensor(self.pretrained_emb))

    # -- architecture weights -------------------------------------------------

    def init_alpha(self) -> Dict[str, torch.Tensor]:
        """The biased init toward the MCAN-like genotype (hygr_vqa.py:139-156),
        fp32 on the CPU."""
        alpha = {}
        for cell_type, pattern in (("enc", _INIT_ENC), ("dec", _INIT_DEC)):
            space, n = self.spaces[cell_type], self.n_nodes[cell_type]
            flat = (pattern * ((n + len(pattern) - 1) // len(pattern)))[:n]
            a = np.full((n, len(space)), -1.0, np.float32)
            for i, name in enumerate(flat):
                a[i, space.index(name)] = 1.0
            alpha[cell_type] = torch.from_numpy(a)
        return alpha

    # -- sampling ------------------------------------------------------------------

    # One implementation on tensors: the host loop calls it on CPU float64
    # tensors made from alpha's host copy, a search step captured in a CUDA
    # graph on the device alpha.

    @staticmethod
    def draw_uniforms(generator: torch.Generator, n_nodes: Mapping[str, int]
                      ) -> Dict[str, torch.Tensor]:
        """The uniforms of one `sample_indices` draw: [n] per cell type, in
        the order it draws them."""
        return {c: _uniform(generator, (n_nodes[c],)) for c in CELLS}

    @staticmethod
    def indices_from_uniforms(alpha: Mapping[str, torch.Tensor],
                              u: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One op per node, the inverse of softmax(alpha)'s CDF at the
        uniforms `u` (mixed.py:150-158): [n] int64 per cell type, on alpha's
        device. alpha in any float type, u float64; the CPU and the card
        give the same indices for the same inputs (`_softmax_cdf`)."""
        out = {}
        for c in CELLS:
            cdf = _softmax_cdf(alpha[c].to(torch.float64))
            x = u[c] * cdf[-1]
            idx = (cdf[0] <= x).long()
            for col in cdf[1:]:
                idx = idx + (col <= x).long()
            out[c] = idx.clamp(max=len(cdf) - 1)
        return out

    @classmethod
    def sample_indices(cls, alpha: Mapping, generator: torch.Generator) -> Dict[str, np.ndarray]:
        """One op per node drawn from softmax(alpha) (mixed.py:150-158), from
        a host copy of alpha and a CPU generator, by the inverse of the
        softmax's CDF: [n] per cell type."""
        u = cls.draw_uniforms(generator, {c: len(alpha[c]) for c in CELLS})
        idx = cls.indices_from_uniforms({c: torch.from_numpy(np.asarray(alpha[c]))
                                         for c in CELLS}, u)
        return {c: i.numpy() for c, i in idx.items()}

    @staticmethod
    def chosen_indices(alpha: Mapping) -> Dict[str, np.ndarray]:
        """The argmax path, for search-time eval (mixed.py:121-129)."""
        return {c: np.asarray(alpha[c]).argmax(axis=-1) for c in CELLS}

    @staticmethod
    def draw_uniforms_two(generator: torch.Generator, shapes: Mapping[str, tuple]) -> Dict:
        """The draws of one `sample_indices_two`, in its order: per cell type
        the Gumbel noise log(-log(u)) [n, k] of the pair and the uniforms [n]
        that choose the active op of the pair."""
        out = {}
        for c in CELLS:
            u = _uniform(generator, shapes[c]).clamp(min=torch.finfo(torch.float64).tiny)
            out[c] = (torch.log(-torch.log(u)), _uniform(generator, shapes[c][:1]))
        return out

    @staticmethod
    def indices_two_from_uniforms(alpha: Mapping[str, torch.Tensor], draws: Mapping) -> Dict:
        """Two-path sampling (mixed.py:136-148) from `draw_uniforms_two`'s
        draws: per node the two ops of least gumbel - alpha (Gumbel top-2,
        i.e. two distinct ops from softmax(alpha), ties to the lower index),
        then the active one from softmax over the pair's logits. [n, 2] int64
        per cell type: column 0 active, column 1 inactive."""
        out = {}
        for c in CELLS:
            gumbel, u = draws[c]
            a = alpha[c].to(torch.float64)
            keys = gumbel - a
            first = keys.argmin(dim=-1, keepdim=True)     # the first least value
            second = keys.scatter(-1, first, math.inf).argmin(dim=-1, keepdim=True)
            pair = torch.cat([first, second], dim=-1)
            p_first = _softmax_cdf(a.gather(-1, pair))[0]
            out[c] = torch.where((u >= p_first).unsqueeze(-1), pair.flip(-1), pair)
        return out

    @classmethod
    def sample_indices_two(cls, alpha: Mapping, generator: torch.Generator
                           ) -> Dict[str, np.ndarray]:
        """Two-path sampling (mixed.py:136-148): per node two distinct ops
        from softmax(alpha) (Gumbel top-2, i.e. without replacement), then
        the active one from softmax(alpha[pair]). [n, 2] per cell type:
        column 0 active, column 1 inactive."""
        draws = cls.draw_uniforms_two(generator, {c: np.shape(alpha[c]) for c in CELLS})
        idx = cls.indices_two_from_uniforms({c: torch.from_numpy(np.asarray(alpha[c]))
                                             for c in CELLS}, draws)
        return {c: i.numpy() for c, i in idx.items()}

    @staticmethod
    @torch.no_grad()
    def rescale_alpha(alpha_old: Mapping[str, torch.Tensor], alpha: Dict[str, torch.Tensor],
                      idx: Mapping[str, np.ndarray]) -> None:
        """rescale_updated_arch_param (mixed.py:200-208), in place on
        `alpha`: after the 'two'-mode update, shift each pair's two logits
        so their logsumexp is what it was before the update."""
        for c in CELLS:
            pair = torch.as_tensor(idx[c], device=alpha[c].device)
            old = torch.gather(alpha_old[c], 1, pair)
            new = torch.gather(alpha[c], 1, pair)
            offset = torch.logsumexp(new, dim=1) - torch.logsumexp(old, dim=1)
            n_choices = alpha[c].shape[-1]
            involved = (nn.functional.one_hot(pair[:, 0], n_choices)
                        + nn.functional.one_hot(pair[:, 1], n_choices)).to(alpha[c].dtype)
            alpha[c].sub_(offset[:, None] * involved)

    # -- forward ------------------------------------------------------------------

    def forward(self, batch, alpha: Optional[Mapping[str, torch.Tensor]],
                idx: Mapping[str, np.ndarray], mode: str = "sampled", train: bool = False,
                generator: Optional[torch.Generator] = None):
        """The head's output in fp32: VQA logits [B, ans_size], VGD (scores
        [B, L], reg [B, L, 4]), ITM probabilities [B]. idx: host indices, [n] per cell type
        ('sampled', 'full', 'unified', 'hybrid') or [n, 2] ('two'); 'unified' also
        takes integer tensors; alpha: fp32 device tensors, read by 'full' and 'two'."""
        modes = {"sampled": (self._run_sampled, self._run_sampled),
                 "full": (self._run_full, self._run_full), "two": (self._run_two, self._run_two),
                 "unified": (self._run_unified, self._run_unified),
                 "hybrid": (self._run_unified, self._run_sampled)}
        if mode not in modes:
            raise ValueError(f"unknown mode {mode!r}")
        run_enc, run_dec = modes[mode]
        batch = cast_for_compute(self.cfg, batch)
        x, y, x_mask, y_mask, y_rel = apply_stem(self, self.cfg, batch)
        a = alpha or {c: None for c in CELLS}
        x = run_enc(self.enc, idx["enc"], a["enc"], x, None, x_mask, None, None, train, generator)
        y = run_dec(self.dec, idx["dec"], a["dec"], y, x, y_mask, x_mask, y_rel, train, generator)
        return cast_output(self.cfg, apply_heads(self, x, y, x_mask, y_mask, train, generator))

    # -- split application (ITM pair scoring), the sampled path -------------------

    def encode_text(self, ques_ix, idx: Mapping[str, np.ndarray], train: bool = False,
                    generator: Optional[torch.Generator] = None):
        """Text stem + the sampled enc path: (x_out [B, T, HSIZE], x_mask)."""
        x, x_mask = text_stem(self, ques_ix)
        x = self._run_sampled(self.enc, idx["enc"], None, x, None, x_mask, None, None, train,
                              generator)
        return x, x_mask

    def apply_decoder(self, x_out, x_mask, batch, idx: Mapping[str, np.ndarray],
                      train: bool = False, generator: Optional[torch.Generator] = None):
        """Image stem + the sampled dec path + head against the text encoding
        of `encode_text`: `forward(batch, None, idx)`'s output."""
        batch = cast_for_compute(self.cfg, batch)
        y, y_mask, y_rel = image_stem(self, self.cfg, batch)
        y = self._run_sampled(self.dec, idx["dec"], None, y, x_out, y_mask, x_mask, y_rel, train,
                              generator)
        return cast_output(self.cfg, apply_heads(self, x_out, y, x_mask, y_mask, train, generator))

    @staticmethod
    def _run_sampled(nodes, idx, alpha, s, pre, s_mask, pre_mask, rel, train, generator):
        """One op per node (MODE=None, mixed.py:104)."""
        for node, i in zip(nodes, idx):
            s = node[int(i)](s, pre, s_mask, pre_mask, rel, train, generator)
        return s

    @staticmethod
    def _run_unified(nodes, idx, alpha, s, pre, s_mask, pre_mask, rel, train, generator):
        """The sampled path with no branch on the index (supernet.py:187-211):
        an encoder node (pre None) runs both of its ops, a decoder node
        `unified_att_node` and feed_forward, and `torch.where` on the device
        index keeps the sampled output."""
        idx = torch.as_tensor(idx, device=s.device)
        for ni, node in enumerate(nodes):
            if pre is None:     # an encoder node
                att = node[0](s, pre, s_mask, pre_mask, rel, train, generator)
            else:
                att = unified_att_node(node, idx[ni], s, pre, s_mask, pre_mask, rel, train,
                                       generator)
            ff = node[-1](s, pre, s_mask, pre_mask, rel, train, generator)
            s = torch.where(idx[ni] == len(node) - 1, ff, att)
        return s

    def _run_full(self, nodes, idx, alpha, s, pre, s_mask, pre_mask, rel, train, generator):
        """Every op, straight-through one-hot gates (MODE='full'); idx on the
        host or on the device. Under REMAT with a gradient to take, each op
        is rematerialized (`primitives.remat`)."""
        p_soft = torch.softmax(alpha, dim=-1)
        onehot = nn.functional.one_hot(torch.as_tensor(idx, device=alpha.device),
                                       alpha.shape[-1]).to(p_soft.dtype)
        gates = onehot + p_soft - p_soft.detach()
        remat = self.cfg.REMAT and torch.is_grad_enabled()

        def run(op):
            if not remat:
                return op(s, pre, s_mask, pre_mask, rel, train, generator)
            # the op's parameters as they are now (functional_call's, which
            # the backward's recompute would no longer see), passed in
            return P.remat(lambda params, x, g: functional_call(
                op, params, (x, pre, s_mask, pre_mask, rel, train, g), tie_weights=False),
                generator, dict(op.named_parameters()), s)

        for ni, node in enumerate(nodes):
            outs = [run(op) for op in node]
            # inactive-branch detach (mixed.py:66-68): net-weight gradients flow
            # through the sampled branch only; alpha's see every branch
            if isinstance(idx, torch.Tensor):
                outs = [torch.where(onehot[ni, j] > 0, o, o.detach()) for j, o in enumerate(outs)]
            else:
                outs = [o if j == idx[ni] else o.detach() for j, o in enumerate(outs)]
            g = gates[ni].to(outs[0].dtype)
            s = sum(g[j] * outs[j] for j in range(len(outs)))
        return s

    @staticmethod
    def _run_two(nodes, idx, alpha, s, pre, s_mask, pre_mask, rel, train, generator):
        """The active and the inactive op of each node's pair, under gates
        (1, 0) + p_pair - stop_grad(p_pair) (mixed.py:60-68, MODE='two')."""
        base = torch.tensor([1.0, 0.0], device=alpha.device)
        for ni, node in enumerate(nodes):
            ia, ib = int(idx[ni][0]), int(idx[ni][1])
            p_pair = torch.softmax(torch.stack([alpha[ni, ia], alpha[ni, ib]]), dim=0)
            gates = base + p_pair - p_pair.detach()
            out_a = node[ia](s, pre, s_mask, pre_mask, rel, train, generator)
            out_b = node[ib](s, pre, s_mask, pre_mask, rel, train, generator)
            gates = gates.to(out_a.dtype)
            s = gates[0] * out_a + gates[1] * out_b.detach()
        return s

    # -- optimizer mask -------------------------------------------------------------

    def update_mask(self, idx: Mapping[str, np.ndarray]) -> Dict[str, float]:
        """Parameter name -> 1.0 or 0.0 for the net optimizer: a candidate op's
        parameters get their node's sampled indicator, every other parameter
        1 (the reference's torch Adam skips the cleared grads of unsampled
        ops, mixed.py:160-163)."""
        return {n: 1.0 if op is None else float(int(idx[op[0]][op[1]]) == op[2])
                for n, op in self._op_of.items()}

    def update_mask_device(self, idx: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """`update_mask` of device indices, on the device: fp32 [n_params] in
        the order of `named_parameters`."""
        dev = idx["enc"].device
        at = self.__dict__.get("_mask_at")
        if at is None or at.device != dev:
            # each parameter's node in cat(idx['enc'], idx['dec']) and op (-1: no
            # op), kept on the device: a step captured in a CUDA graph copies
            # nothing from the host
            start = {"enc": 0, "dec": self.n_nodes["enc"]}
            at = [(-1, -1) if op is None else (start[op[0]] + op[1], op[2])
                  for op in self._op_of.values()]
            self._mask_at = at = torch.tensor(at, dtype=torch.int64).t().contiguous().to(dev)
        node, op = at
        flat = torch.cat([idx[c].reshape(-1) for c in CELLS])
        return ((op < 0) | (flat[node.clamp(min=0)] == op)).float()

    # -- genotype -----------------------------------------------------------------------

    def genotype(self, alpha: Mapping) -> Dict[str, List[List[str]]]:
        """argmax per node -> the reference JSON schema (hygr_vqa.py:242-273)."""
        return {c: [[self.spaces[c][int(i)]] for i in idx]
                for c, idx in self.chosen_indices(alpha).items()}

    @staticmethod
    def genotype_weights(alpha: Mapping) -> Dict[str, List]:
        """softmax(alpha) per node, for the log."""
        return {"w_enc": _softmax(alpha["enc"]).tolist(), "w_dec": _softmax(alpha["dec"]).tolist()}

