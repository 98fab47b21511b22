"""The port's whole op library against mmnas_tpu.ops: the registry's 41
names, each of the 36 ops outside the search spaces against its JAX op
(forward and parameter gradients, weights carried across by
from_jax_params), and a tiny NetFull whose genotype names all 41 ops
against the JAX net (logits, one train step's loss and gradient, the loss
after that step). fp32, dropout off, the JAX attention on its plain jnp
path (USE_PALLAS off); tolerance 1e-5, gradients norm-wise over the
op's (the net's) whole gradient."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.config import Cfg
from mmnas_tpu.data.loader import _stack
from mmnas_tpu.data.synth import SynthVqaDataset
from mmnas_tpu.engine.vqa import bce_with_logits_sum as jax_bce
from mmnas_tpu.models.net import NetFull as JaxNetFull
from mmnas_tpu.ops import modules as JM
from mmnas_tpu.ops import primitives as JP
from mmnas_tpu.ops.registry import OPS_ADAPTER
from mmnas_tpu.ops.registry import make_op as jax_make_op
from mmnas_tpu_torch.engine.vqa import bce_with_logits_sum
from mmnas_tpu_torch.models.convert import from_jax_params, to_jax_params
from mmnas_tpu_torch.models.net import NetFull
from mmnas_tpu_torch.ops import modules as TM
from mmnas_tpu_torch.ops.primitives import init_parameters
from mmnas_tpu_torch.ops.registry import OPS, Used_OPS, make_op

TOL = 1e-5
BATCH, K, T, REL = 2, 7, 5, 8
# tests/test_torch_modules.py holds these five against JAX
SEARCH_SPACE_OPS = {"none", "self_att_64", "rel_self_att_64", "guided_att_64", "feed_forward"}
NEW_OPS = sorted(set(OPS_ADAPTER.OPS) - SEARCH_SPACE_OPS)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _hsize(name):
    """HSIZE 256 for the ops of 128- and 256-wide heads, 64 for the rest."""
    return 256 if name.endswith(("_128", "_256")) else 64


def test_registry_has_the_jax_packages_names_and_spaces():
    assert sorted(OPS) == sorted(OPS_ADAPTER.OPS) and len(OPS) == 41
    assert Used_OPS == OPS_ADAPTER.Used_OPS
    assert len(NEW_OPS) == 36
    with pytest.raises(KeyError):
        make_op("sep_conv_9", TM.OpCfg(hsize=64), True, True)


@pytest.mark.parametrize("name", NEW_OPS)
def test_new_op_matches_jax(name):
    """Forward and the gradient of <out, g> in every parameter, port vs JAX,
    on the decoder's inputs (x 7 regions, y 5 tokens, one padded region and
    two padded tokens, the raw geometry)."""
    hs = _hsize(name)
    r = np.random.RandomState(sum(map(ord, name)))
    x = r.randn(BATCH, K, hs).astype(np.float32)
    y = r.randn(BATCH, T, hs).astype(np.float32)
    xm = np.zeros((BATCH, 1, 1, K), bool)
    xm[0, ..., 6:] = True
    ym = np.zeros((BATCH, 1, 1, T), bool)
    ym[1, ..., 3:] = True
    raw = r.randn(BATCH, K, K, 4).astype(np.float32)
    w1 = (r.randn(4, REL) * 0.5).astype(np.float32)
    b1 = (r.randn(REL) * 0.5).astype(np.float32)
    cot = r.randn(BATCH, K, hs).astype(np.float32)

    jcfg = JM.OpCfg(hsize=hs, dropout_r=0.0, rel_size=REL)
    jop = jax_make_op(name, jcfg, True, True)
    op = make_op(name, TM.OpCfg(hsize=hs, dropout_r=0.0, rel_size=REL), True, True)
    init_parameters(op, torch.Generator().manual_seed(7))
    params = to_jax_params(op)        # the port's seeded init in the JAX op's pytree
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(jax.eval_shape(jop.init, jax.random.PRNGKey(0))))
    jrel = {"raw": jnp.asarray(raw), "w1": jnp.asarray(w1), "b1": jnp.asarray(b1)}

    def japply(p):
        return jop.apply(p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xm), jnp.asarray(ym),
                         jrel, False, JP.RngGen(None))

    def out_and_grads(p, c):
        out, vjp = jax.vjp(japply, p)
        return out, vjp(c)[0]

    want, want_grads = jax.jit(out_and_grads)(params, jnp.asarray(cot))
    want_grads = from_jax_params(_host(want_grads))

    t = torch.from_numpy
    got = op(t(x), t(y), t(xm), t(ym), {"raw": t(raw), "w1": t(w1.T.copy()), "b1": t(b1)})
    assert got.shape == (BATCH, K, hs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)

    named = dict(op.named_parameters())
    assert sorted(named) == sorted(want_grads)
    if not named:                                 # the parameter-free ops
        return
    grads = dict(zip(named, torch.autograd.grad(got, list(named.values()), t(cot))))
    # norm-wise over the op's whole gradient, as the net test below: the RSA
    # ops' wr gradient goes through dpre = ds / pre, which grows fp32
    # rounding near the 1e-6 clamp in single elements
    diff = sum(float(((grads[n] - want_grads[n]) ** 2).sum()) for n in named) ** 0.5
    norm = sum(float((want_grads[n] ** 2).sum()) for n in named) ** 0.5
    assert diff <= TOL * norm, f"{name}: gradient {diff:.3e} off the JAX one's norm {norm:.3e}"


# a genotype that names every op once: the encoder takes those that read no
# y and no relation, the decoder the relation, guided and uni-image ops and
# self_att_256
ENC_NODES = [["none", "skip_connect", "relu", "gelu", "leakyrelu", "self_att_16"],
             ["self_att_32", "self_att_64", "self_att_128", "self_att_64_2",
              "sep_conv_3", "sep_conv_5", "sep_conv_7"],
             ["sep_conv_11", "std_conv_3", "std_conv_5", "std_conv_7", "std_conv_11"],
             ["feed_forward", "feed_forward_2", "feed_forward_8", "feed_forward_16",
              "feed_forward_32", "feed_forward_deep", "gated_linear_1", "gated_linear_2"]]
DEC_NODES = [["self_att_256", "rel_self_att_16", "rel_self_att_32", "rel_self_att_64",
              "rel_self_att_128", "rel_self_att_256"],
             ["guided_att_16", "guided_att_32", "guided_att_64", "guided_att_128",
              "guided_att_256", "guided_att_64_2"],
             ["uniimg_att_32", "uniimg_att_64", "uniimg_att_128"]]
GENE = {"enc": ENC_NODES, "dec": DEC_NODES}
HS, F, V, A = 256, 16, 24, 5
CFG = Cfg(TASK="vqa", SYNTH=True, HSIZE=HS, ATTFLAT_OUT_SIZE=2 * HS, ATTFLAT_MLP_SIZE=32,
          REL_SIZE=REL, FRCNFEAT_LEN=K, FRCNFEAT_SIZE=F, WORD_EMBED_SIZE=12, MAX_TOKEN=T,
          DROPOUT_R=0.0)


def test_all_ops_netfull_matches_jax():
    """NetFull over the 41-op genotype: logits, the summed BCE loss and its
    gradient (whole-net norm), then the loss after one SGD step of the
    same size on both sides."""
    names = [n for cell in GENE.values() for node in cell for n in node]
    assert sorted(names) == sorted(OPS_ADAPTER.OPS)
    ds = SynthVqaDataset(CFG, size=3, token_size=V, ans_size=A, seed=3)
    init_dict = {"token_size": V, "ans_size": A, "pretrained_emb": ds.pretrained_emb}
    jnet = JaxNetFull(CFG, GENE, init_dict, "vqa")
    net = NetFull(CFG, GENE, init_dict, "vqa")
    # the port's seeded init in the JAX pytree (compiling the JAX init would
    # double this test's time; tests/test_torch_net.py holds the two inits'
    # structures alike)
    params = to_jax_params(net)
    batch = _stack([ds[i] for i in range(3)])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        logits = jnet.apply(p, jb)
        return jax_bce(logits, jb["ans"]), logits

    loss_and_grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (want_loss, want_logits), want_grads = loss_and_grads(params)
    lr = 1e-3
    stepped = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, want_grads)
    (want_loss1, _), _ = loss_and_grads(stepped)
    want_loss1 = float(want_loss1)

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = net(tb)
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, rtol=TOL, atol=TOL)
    loss = bce_with_logits_sum(logits, tb["ans"])
    assert abs(loss.item() - float(want_loss)) <= TOL * abs(float(want_loss))
    masters = dict(net.named_parameters())
    grads = dict(zip(masters, torch.autograd.grad(loss, list(masters.values()))))
    want_sd = from_jax_params(_host(want_grads))
    diff = sum(float(((grads[n] - want_sd[n]) ** 2).sum()) for n in masters) ** 0.5
    norm = sum(float((want_sd[n] ** 2).sum()) for n in masters) ** 0.5
    assert diff <= TOL * norm, f"gradient {diff:.3e} off the JAX one's norm {norm:.3e}"
    with torch.no_grad():
        for n, p in masters.items():
            p.sub_(lr * grads[n])
        loss1 = float(bce_with_logits_sum(net(tb), tb["ans"]))
    assert abs(loss1 - want_loss1) <= TOL * abs(want_loss1)
