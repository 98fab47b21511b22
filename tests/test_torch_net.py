"""PyTorch port NetFull vs the JAX NetFull (jnp path) with the same weights
(converted by from_jax_params) on the same synthetic batch, fp32, tolerance
2e-4 (as tests/test_fullnet_torch_oracle.py). The genotype has SA/FF in the
encoder and SA/RSA/GA/FF in the decoder; HSIZE 128 with head size 64 gives
two heads."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.config import Cfg
from mmnas_tpu.data.loader import _stack
from mmnas_tpu.data.synth import SynthVqaDataset
from mmnas_tpu.models.net import NetFull as JaxNetFull
from mmnas_tpu_torch.models.convert import from_jax_params, to_jax_params
from mmnas_tpu_torch.models.net import NetFull

GENE = {
    "enc": [["self_att_64"], ["feed_forward"]],
    "dec": [["self_att_64"], ["rel_self_att_64"], ["guided_att_64"], ["feed_forward"]],
}
HS, T, K, F, V, A = 128, 6, 8, 16, 24, 5
CFG = Cfg(TASK="vqa", SYNTH=True, HSIZE=HS, ATTFLAT_OUT_SIZE=2 * HS, ATTFLAT_MLP_SIZE=32,
          REL_SIZE=8, FRCNFEAT_LEN=K, FRCNFEAT_SIZE=F, WORD_EMBED_SIZE=12, MAX_TOKEN=T,
          DROPOUT_R=0.0)


@pytest.fixture(scope="module")
def setup():
    ds = SynthVqaDataset(CFG, size=4, token_size=V, ans_size=A, seed=3)
    init_dict = {"token_size": V, "ans_size": A, "pretrained_emb": ds.pretrained_emb}
    jnet = JaxNetFull(CFG, GENE, init_dict, "vqa")
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    batch = _stack([ds[i] for i in range(4)])
    return jnet, params, batch, init_dict


def test_netfull_matches_jax(setup):
    jnet, params, batch, init_dict = setup
    want = np.asarray(jax.jit(jnet.apply)(params, {k: jnp.asarray(v) for k, v in batch.items()}))
    net = NetFull(CFG, GENE, init_dict, "vqa")
    net.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        got = net({k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert got.shape == (4, A)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_params_round_trip(setup):
    _, params, _, init_dict = setup
    net = NetFull(CFG, GENE, init_dict, "vqa", generator=torch.Generator().manual_seed(5))
    net.load_state_dict(from_jax_params(params), strict=True)
    back = to_jax_params(net)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_conversion_rejects_extra_and_missing_leaves(setup):
    _, params, _, init_dict = setup
    net = NetFull(CFG, GENE, init_dict, "vqa")
    with pytest.raises(ValueError, match="no place"):
        from_jax_params(dict(params, stray=np.zeros(3, np.float32)))
    short = dict(params)
    del short["proj_norm"]
    with pytest.raises(RuntimeError, match="Missing key"):
        net.load_state_dict(from_jax_params(short), strict=True)


def test_optimizer_state_converts_to_the_jax_pytree_and_back(setup):
    """net_optim moves between the packages with the params' per-leaf rules:
    moments transposed like their parameters, step counts as ints."""
    from mmnas_tpu.train.optimizer import WarmupAdam as JaxWarmupAdam
    from mmnas_tpu_torch.models.convert import optim_state_from_jax, optim_state_to_jax
    from mmnas_tpu_torch.train.optimizer import WarmupAdam

    _, params, _, init_dict = setup
    r = np.random.RandomState(0)
    tree_map = jax.tree_util.tree_map
    jstate = tree_map(np.asarray, JaxWarmupAdam(1e-3).init(params))
    jstate.update(m=tree_map(lambda p: r.randn(*p.shape).astype(np.float32), params),
                  t=tree_map(lambda p: np.asarray(r.randint(1, 9), np.int32), params),
                  step=np.asarray(5, np.int32))
    net = NetFull(CFG, GENE, init_dict, "vqa")
    port = optim_state_from_jax(jstate)
    for name, p in net.named_parameters():
        assert port["m"][name].shape == p.shape and port["v"][name].shape == p.shape
        assert isinstance(port["t"][name], int)
    assert port["step"] == 5 and port["lr_base"] == np.float32(1e-3)
    back = optim_state_to_jax(port, net)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jstate)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    fresh = optim_state_to_jax(WarmupAdam(1e-3).init(dict(net.named_parameters())), net)
    assert jax.tree_util.tree_structure(fresh) == jax.tree_util.tree_structure(jstate)


def test_train_mode_forward_matches_jax_without_dropout(setup):
    """The train-mode forward (generator passed down to every dropout site)
    at DROPOUT_R 0 is the JAX train-mode apply; with DROPOUT_R 0.1 it
    follows the generator's seed."""
    jnet, params, batch, init_dict = setup
    want = np.asarray(jax.jit(lambda p, b, k: jnet.apply(p, b, train=True, rng=k))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(1)))
    net = NetFull(CFG, GENE, init_dict, "vqa")
    net.load_state_dict(from_jax_params(params), strict=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = net(tb, train=True, generator=torch.Generator().manual_seed(0)).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
        drop = NetFull(CFG.replace(DROPOUT_R=0.1), GENE, init_dict, "vqa")
        drop.load_state_dict(net.state_dict(), strict=True)

        def run(seed):
            return drop(tb, train=True, generator=torch.Generator().manual_seed(seed))

        torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
        assert not torch.equal(run(3), run(4))


def test_bf16_train_step_gradient_matches_jax(setup):
    """--DTYPE bfloat16 training: the forward runs on bf16 casts of the fp32
    masters (`compute_params`), so the gradient arrives in fp32 on the
    masters, as in the JAX package's step (net.py:44-63). Leaf by leaf the
    gradient of the summed BCE is within 5e-2 of each leaf's norm of the
    JAX package's bf16 gradient: both round every activation to bf16 (unit
    roundoff 2^-8), in other places, and the port's attention runs the RSA
    chain, scores and softmax in fp32 where the JAX plain path runs the chain
    in bf16 (ROADMAP.md queue 3, deliberate difference (b)). A leaf whose
    JAX bf16 gradient is itself farther than that from the fp32 gradient
    passes if the port's is no farther from it: the text AttFlat's glimpse
    MLP, whose gradient comes only through the softmax backward over 6
    tokens, p (g - <p, g>), which cancels (measured: JAX 13-19% from fp32,
    the port 6-8%, the two 12-16% apart). The AttFlat glimpse biases, whose
    true gradient is 0 (rounding noise in both), are left out. One
    `Execution.train_step` then keeps the masters and Adam's moments fp32."""
    from torch.func import functional_call

    from mmnas_tpu.engine.vqa import bce_with_logits_sum as jax_bce
    from mmnas_tpu_torch.engine.vqa import Execution, bce_with_logits_sum
    from mmnas_tpu_torch.models.net import compute_params
    from mmnas_tpu_torch.train.optimizer import WarmupAdam

    _, params, batch, init_dict = setup
    cfg = CFG.replace(DTYPE="bfloat16")
    jnet = JaxNetFull(cfg, GENE, init_dict, "vqa")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = from_jax_params(jax.jit(jax.grad(
        lambda p: jax_bce(jnet.apply(p, jb), jb["ans"])))(params))

    jax_fp32 = from_jax_params(jax.jit(jax.grad(
        lambda p: jax_bce(JaxNetFull(CFG, GENE, init_dict, "vqa").apply(p, jb), jb["ans"])))(
            params))
    net = NetFull(cfg, GENE, init_dict, "vqa")
    net.load_state_dict(from_jax_params(params), strict=True)
    masters = dict(net.named_parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    computed = compute_params(net, cfg)
    assert all(t.dtype == torch.bfloat16 for t in computed.values())
    loss = bce_with_logits_sum(functional_call(net, computed, (tb,)), tb["ans"])
    grads = dict(zip(masters, torch.autograd.grad(loss, list(masters.values()))))
    by_second_clause = []
    for n, g in grads.items():
        assert g.dtype == torch.float32, n
        if n.startswith(("attflat_x.mlp.linear.bias", "attflat_y.mlp.linear.bias")):
            continue
        norm = float(want[n].norm())
        if float((g - want[n]).norm()) > 5e-2 * norm:
            assert float((g - jax_fp32[n]).norm()) <= float((want[n] - jax_fp32[n]).norm()), n
            by_second_clause.append(n)
    assert all(n.startswith("attflat_x.mlp.fc.") for n in by_second_clause), by_second_clause

    optim = WarmupAdam(1e-4, epoch_steps=1)
    state = optim.init(masters)
    loss, _ = Execution(cfg, torch.device("cpu")).train_step(
        net, optim, state, masters, dict(tb, ans=tb["ans"].float()), torch.Generator())
    assert torch.isfinite(loss) and loss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(m.dtype == torch.float32 for m in state["m"].values())
