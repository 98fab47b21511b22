"""PyTorch port ops vs mmnas_tpu.ops: the five candidate ops of the first
slices and AttFlat (tests/test_torch_op_library.py holds the other 36), each against its JAX op with the JAX params converted by
from_jax_params. Same numpy inputs, fp32, dropout off, tolerance 1e-5.
HSIZE 128 with head size 64 gives two heads."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.ops import modules as JM
from mmnas_tpu.ops import primitives as JP
from mmnas_tpu.ops.registry import make_op as jax_make_op
from mmnas_tpu_torch.models.convert import from_jax_params
from mmnas_tpu_torch.ops import modules as TM
from mmnas_tpu_torch.ops.registry import make_op

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5
BATCH, K, T, HS, REL = 2, 8, 6, 128, 8
JCFG = JM.OpCfg(hsize=HS, dropout_r=0.0, rel_size=REL, attflat_out_size=2 * HS,
                attflat_mlp_size=32)
TCFG = TM.OpCfg(hsize=HS, dropout_r=0.0, rel_size=REL, attflat_out_size=2 * HS,
                attflat_mlp_size=32)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def make_inputs(seed=0):
    """Decoder-side inputs: x = K regions, y = T tokens, raw geometry."""
    r = np.random.RandomState(seed)
    x = r.randn(BATCH, K, HS).astype(np.float32)
    y = r.randn(BATCH, T, HS).astype(np.float32)
    x_mask = np.zeros((BATCH, 1, 1, K), bool)
    x_mask[0, ..., 6:] = True
    y_mask = np.zeros((BATCH, 1, 1, T), bool)
    y_mask[1, ..., 4:] = True
    raw = r.randn(BATCH, K, K, 4).astype(np.float32)
    w1 = (r.randn(4, REL) * 0.5).astype(np.float32)
    b1 = (r.randn(REL) * 0.5).astype(np.float32)
    return x, y, x_mask, y_mask, raw, w1, b1


@pytest.mark.parametrize("name", ["self_att_64", "rel_self_att_64", "guided_att_64",
                                  "feed_forward", "none"])
def test_op_matches_jax(name):
    x, y, xm, ym, raw, w1, b1 = make_inputs()
    jop = jax_make_op(name, JCFG, True, True)
    params = _host(jop.init(jax.random.PRNGKey(3)))
    jrel = {"raw": jnp.asarray(raw), "w1": jnp.asarray(w1), "b1": jnp.asarray(b1)}
    want = np.asarray(jop.apply(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xm),
                                jnp.asarray(ym), jrel, False, JP.RngGen(None)))

    op = make_op(name, TCFG, True, True)
    op.load_state_dict(from_jax_params(params), strict=True)
    t = torch.from_numpy
    trel = {"raw": t(raw), "w1": t(w1.T.copy()), "b1": t(b1)}
    got = op(t(x), t(y), t(xm), t(ym), trel).detach().numpy()
    assert got.shape == (BATCH, K, HS)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_attflat_matches_jax():
    x, _, xm, _, _, _, _ = make_inputs(seed=1)
    params = _host(JM.attflat_init(jax.random.PRNGKey(4), JCFG))
    want = np.asarray(JM.attflat(params, JCFG, jnp.asarray(x), jnp.asarray(xm), False,
                                 JP.RngGen(None)))
    m = TM.AttFlat(TCFG)
    m.load_state_dict(from_jax_params(params), strict=True)
    got = m(torch.from_numpy(x), torch.from_numpy(xm)).detach().numpy()
    assert got.shape == (BATCH, 2 * HS)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_unported_op_names_its_roadmap_item():
    """Every op of the reference is ported: make_op builds one outside the
    search spaces and, like the JAX registry, raises KeyError only on a
    name that is no op."""
    assert make_op("sep_conv_3", TCFG, True, True) is not None
    with pytest.raises(KeyError, match="sep_conv_9"):
        make_op("sep_conv_9", TCFG, True, True)


@pytest.mark.parametrize("name", ["self_att_64", "rel_self_att_64", "guided_att_64"])
def test_attention_ops_draw_attention_dropout_from_the_generator(name):
    """In train mode each attention core drops attention weights with a mask
    drawn from the caller's generator (MHAtt.attend passes it on): the same
    seed gives the same output, another seed another, eval mode none."""
    x, y, xm, ym, raw, w1, b1 = make_inputs(seed=2)
    cfg = TM.OpCfg(hsize=HS, dropout_r=0.1, rel_size=REL, attflat_out_size=2 * HS,
                   attflat_mlp_size=32)
    op = make_op(name, cfg, True, True)
    t = torch.from_numpy
    args = (t(x), t(y), t(xm), t(ym), {"raw": t(raw), "w1": t(w1.T.copy()), "b1": t(b1)})

    def core(seed, train=True):
        with torch.no_grad():
            return op.core(*args, train, torch.Generator().manual_seed(seed))

    torch.testing.assert_close(core(1), core(1), rtol=0, atol=0)
    assert not torch.equal(core(1), core(2))
    assert not torch.equal(core(1), core(1, train=False))
