"""The PyTorch port's search supernet against the JAX NetSearch, on the CPU,
with the same weights (the port's seeded init, moved into the JAX pytree by
models/convert.py), the same alpha and the same injected indices (the two
packages' samplers are not meant to agree).

- the 'sampled', 'full' and 'two' forwards equal the JAX apply (2e-4, as
  NetFull: fp32 sums in other orders over a 7-node net);
- the 'full'-mode alpha gradient equals JAX's and the explicit
  softmax-Jacobian sum_j b_j p_j (delta_ij - p_i) (mixed.py:171-198), with
  b_j the gradient of a free gate at the one-hot point; the 'two'-mode
  gradient equals JAX's and the 2x2 pair Jacobian, and is 0 off the pair:
  1e-5 of the largest entry (fp32 through the same net);
- `rescale_alpha` equals JAX's and keeps each pair's logsumexp;
- `update_mask`, `genotype`, `genotype_weights` and `init_alpha` (bit for
  bit) equal JAX's; a weight step on two paths moves exactly the union of
  their masks.
HSIZE 128 with head size 64 gives two heads; NODES enc 3 / dec 4 as the JAX
package's tiny_cfg (tests/test_supernet.py:29-35)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.config import SearchCfg
from mmnas_tpu.data.loader import _stack
from mmnas_tpu.data.synth import SynthVqaDataset
from mmnas_tpu.models.supernet import NetSearch as JaxNetSearch
from mmnas_tpu_torch.config import SearchCfg as PortSearchCfg
from mmnas_tpu_torch.models.convert import from_jax_params, to_jax_params
from mmnas_tpu_torch.models.net import apply_heads, apply_stem
from mmnas_tpu_torch.models.supernet import NetSearch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

HS, V, A = 128, 24, 6
TINY = dict(TASK="vqa", HSIZE=HS, ATTFLAT_OUT_SIZE=2 * HS, ATTFLAT_MLP_SIZE=16, REL_SIZE=8,
            FRCNFEAT_LEN=12, FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=10, MAX_TOKEN=6,
            NODES=(("enc", 3), ("dec", 4)), DROPOUT_R=0.0, SYNTH=True)
# every op of both spaces at least once; pairs: (active, inactive)
IDX = {"enc": np.array([0, 1, 0]), "dec": np.array([1, 2, 0, 3])}
IDX2 = {"enc": np.array([[0, 1], [1, 0], [0, 1]]),
        "dec": np.array([[1, 3], [2, 0], [0, 1], [3, 2]])}
FWD_TOL = 2e-4
GRAD_TOL = 1e-5


def jnp_idx(idx):
    return {c: jnp.asarray(v, jnp.int32) for c, v in idx.items()}


@pytest.fixture(scope="module")
def setup():
    cfg = SearchCfg(**TINY)
    ds = SynthVqaDataset(cfg, size=4, token_size=V, ans_size=A, seed=3)
    init_dict = {"token_size": V, "ans_size": A, "pretrained_emb": ds.pretrained_emb}
    jnet = JaxNetSearch(cfg, init_dict)
    # the port's seeded init in the JAX pytree: compiling the JAX init would
    # take most of this file's time; its structure and shapes are checked
    # against the JAX init's (test_supernet_params_round_trip)
    net = NetSearch(PortSearchCfg(**TINY), init_dict)
    params = to_jax_params(net)
    r = np.random.RandomState(1)
    alpha = {c: r.randn(*np.shape(a)).astype(np.float32)
             for c, a in jnet.init_alpha().items()}
    batch = _stack([ds[i] for i in range(4)])
    return SimpleNamespace(jnet=jnet, params=params, alpha=alpha, batch=batch, net=net,
                           tb={k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.fixture(scope="module")
def jax_out(setup):
    """Per mode, the JAX logits and (for the gated modes) the alpha gradient
    of sum(logits^2), one jitted program each."""
    s = setup
    jb = {k: jnp.asarray(v) for k, v in s.batch.items()}
    alpha = {c: jnp.asarray(a) for c, a in s.alpha.items()}
    out = {"sampled": (np.asarray(jax.jit(lambda a, i: s.jnet.apply(
        s.params, a, jb, i, mode="sampled"))(alpha, jnp_idx(IDX))), None)}
    for mode, idx in (("full", IDX), ("two", IDX2)):
        def loss(a, i, mode=mode):
            pred = s.jnet.apply(s.params, a, jb, i, mode=mode)
            return jnp.sum(jnp.square(pred)), pred
        (_, pred), grad = jax.jit(jax.value_and_grad(loss, has_aux=True))(alpha, jnp_idx(idx))
        out[mode] = (np.asarray(pred), {c: np.asarray(g) for c, g in grad.items()})
    return out


def port_out(s, mode, idx):
    leaves = {c: torch.from_numpy(a).requires_grad_() for c, a in s.alpha.items()}
    pred = s.net(s.tb, leaves, idx, mode=mode)
    if mode == "sampled":                # alpha does not enter the sampled path
        return pred.detach().numpy(), None
    grads = torch.autograd.grad((pred ** 2).sum(), [leaves["enc"], leaves["dec"]])
    return pred.detach().numpy(), {c: g.numpy() for c, g in zip(("enc", "dec"), grads)}


def assert_grad_close(got, want):
    scale = max(float(np.abs(w).max()) for w in want.values())
    for c in ("enc", "dec"):
        np.testing.assert_allclose(got[c], want[c], rtol=0, atol=GRAD_TOL * scale, err_msg=c)


@pytest.mark.parametrize("mode", ["sampled", "full", "two"])
def test_forward_matches_jax(setup, jax_out, mode):
    got, _ = port_out(setup, mode, IDX2 if mode == "two" else IDX)
    want = jax_out[mode][0]
    assert got.shape == (4, A)
    np.testing.assert_allclose(got, want, rtol=FWD_TOL, atol=FWD_TOL)
    if mode != "sampled":  # straight-through gates: the forward is the active path
        np.testing.assert_allclose(got, jax_out["sampled" if mode == "full" else "two"][0],
                                   rtol=FWD_TOL, atol=FWD_TOL)


def gate_grads(s, branches):
    """b = d sum(logits^2) / d gates for free gates over `branches` (per
    node, the ops summed), at the one-hot point of each node's first branch."""
    gates = {c: torch.zeros(len(branches[c]), len(branches[c][0])) for c in ("enc", "dec")}
    for g in gates.values():
        g[:, 0] = 1.0
        g.requires_grad_()
    x, y, xm, ym, yrel = apply_stem(s.net, s.net.cfg, s.tb)

    def run(nodes, g, br, v, pre, vm, pm, rel):
        for ni, node in enumerate(nodes):
            v = sum(g[ni, k] * node[int(j)](v, pre, vm, pm, rel) for k, j in enumerate(br[ni]))
        return v

    x = run(s.net.enc, gates["enc"], branches["enc"], x, None, xm, None, None)
    y = run(s.net.dec, gates["dec"], branches["dec"], y, x, ym, xm, yrel)
    loss = (apply_heads(s.net, x, y, xm, ym) ** 2).sum()
    return dict(zip(("enc", "dec"), (g.detach().numpy() for g in torch.autograd.grad(
        loss, [gates["enc"], gates["dec"]]))))


def softmax(a):
    e = np.exp(a - a.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


def test_full_mode_alpha_grad_matches_jax_and_softmax_jacobian(setup, jax_out):
    s = setup
    _, got = port_out(s, "full", IDX)
    assert_grad_close(got, jax_out["full"][1])
    # branches ordered with the sampled op first, so the free gates sit at
    # the one-hot point; b is then put back in op order
    order = {c: np.array([[i] + [j for j in range(a.shape[1]) if j != i] for i in IDX[c]])
             for c, a in s.alpha.items()}
    b_ordered = gate_grads(s, order)
    explicit = {}
    for c, a in s.alpha.items():
        b = np.zeros_like(a)
        np.put_along_axis(b, order[c], b_ordered[c], axis=1)
        p = softmax(a)
        explicit[c] = p * b - p * np.sum(b * p, axis=-1, keepdims=True)  # mixed.py:193-197
    assert_grad_close(got, explicit)


def test_two_mode_alpha_grad_matches_jax_and_pair_jacobian(setup, jax_out):
    s = setup
    _, got = port_out(s, "two", IDX2)
    assert_grad_close(got, jax_out["two"][1])
    b = gate_grads(s, IDX2)
    explicit = {}
    for c, a in s.alpha.items():
        e = np.zeros_like(a)
        for n, (ia, ib) in enumerate(IDX2[c]):
            p0, p1 = softmax(np.array([a[n, ia], a[n, ib]]))
            b0, b1 = b[c][n]
            e[n, ia] = b0 * p0 * (1 - p0) - b1 * p1 * p0       # mixed.py:179-186
            e[n, ib] = -b0 * p0 * p1 + b1 * p1 * (1 - p1)
        explicit[c] = e
        off_pair = np.ones_like(a, bool)
        np.put_along_axis(off_pair, IDX2[c], False, axis=1)
        assert (got[c][off_pair] == 0).all()
    assert_grad_close(got, explicit)


def test_rescale_alpha_matches_jax_and_keeps_pair_logsumexp(setup):
    s = setup
    r = np.random.RandomState(2)
    new = {c: a + r.randn(*a.shape).astype(np.float32) for c, a in s.alpha.items()}
    want = s.jnet.rescale_alpha({c: jnp.asarray(a) for c, a in s.alpha.items()},
                                {c: jnp.asarray(a) for c, a in new.items()}, jnp_idx(IDX2))
    got = {c: torch.from_numpy(a.copy()) for c, a in new.items()}
    NetSearch.rescale_alpha({c: torch.from_numpy(a) for c, a in s.alpha.items()}, got, IDX2)
    for c, a in s.alpha.items():
        np.testing.assert_allclose(got[c].numpy(), np.asarray(want[c]), rtol=1e-6, atol=1e-6)
        lse = lambda x: np.log(np.exp(np.take_along_axis(x, IDX2[c], axis=1)).sum(axis=1))
        np.testing.assert_allclose(lse(got[c].numpy()), lse(a), rtol=1e-6, atol=1e-6)
        untouched = np.ones_like(a, bool)
        np.put_along_axis(untouched, IDX2[c], False, axis=1)
        np.testing.assert_array_equal(got[c].numpy()[untouched], new[c][untouched])


def test_update_mask_matches_jax(setup):
    s = setup
    want = from_jax_params(s.jnet.update_mask(s.params, jnp_idx(IDX)))
    got = s.net.update_mask(IDX)
    assert set(got) == set(want) == set(dict(s.net.named_parameters()))
    assert got == {n: float(t) for n, t in want.items()}
    assert got["linear_x_rel.weight"] == 1.0 and got["dec.0.1.core.wr.weight"] == 1.0
    assert got["dec.0.0.core.wq.weight"] == 0.0


def test_weight_step_on_two_paths_moves_their_union(setup, tmp_path):
    """KPATH 2: one Adam step under the union of the two paths' masks; every
    other parameter keeps its value, its moments and its step count."""
    from mmnas_tpu_torch.engine.search import SearchExecution
    from mmnas_tpu_torch.train.optimizer import WarmupAdam

    s = setup
    cfg = PortSearchCfg(**dict(TINY, KPATH=2, BATCH_SIZE=4, LOG_ROOT=str(tmp_path)))
    net = NetSearch(cfg, {"token_size": V, "ans_size": A})
    net.load_state_dict(s.net.state_dict())
    masters = dict(net.named_parameters())
    before = {n: p.detach().clone() for n, p in masters.items()}
    optim = WarmupAdam(1e-3, epoch_steps=1)
    state = optim.init(masters)
    other = {"enc": np.array([1, 1, 0]), "dec": np.array([0, 2, 3, 1])}
    tb = dict(s.tb, ans=torch.from_numpy(s.batch["ans"]))
    SearchExecution(cfg, torch.device("cpu")).weight_step(
        net, optim, state, masters, tb, [IDX, other], torch.Generator())
    m1, m2 = net.update_mask(IDX), net.update_mask(other)
    union = {n: max(m1[n], m2[n]) for n in m1}
    assert 0 < sum(union.values()) < len(union)
    moved = {n: not torch.equal(p.detach(), before[n]) for n, p in masters.items()}
    for n in masters:
        assert state["t"][n] == int(union[n]), n
        # a parameter moves exactly when its first moment is not 0: in the
        # union unless the loss does not reach it (the text-relation stem)
        assert moved[n] == bool(state["m"][n].any()), n
        assert moved[n] or not union[n] and not state["v"][n].any() or n.startswith(
            "linear_x_rel."), n
    assert sum(moved.values()) == sum(union.values()) - 2


def test_genotype_and_weights_match_jax(setup):
    s = setup
    assert s.net.genotype(s.alpha) == s.jnet.genotype(s.alpha)
    np.testing.assert_allclose(np.concatenate([np.ravel(v) for v in
                                               s.net.genotype_weights(s.alpha).values()]),
                               np.concatenate([np.ravel(v) for v in
                                               s.jnet.genotype_weights(s.alpha).values()]),
                               rtol=1e-6)
    assert list(s.net.genotype_weights(s.alpha)) == ["w_enc", "w_dec"]


def test_init_alpha_matches_jax_bit_for_bit():
    cfg = SearchCfg(TASK="vqa")          # 12 / 18 nodes: the 21-entry pattern is cut
    init_dict = {"token_size": 5, "ans_size": 3}
    want = JaxNetSearch(cfg, init_dict).init_alpha()
    got = NetSearch(PortSearchCfg(TASK="vqa", HSIZE=64, ATTFLAT_OUT_SIZE=128),
                    init_dict).init_alpha()
    for c in ("enc", "dec"):
        assert got[c].dtype == torch.float32
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))


def test_supernet_params_round_trip(setup):
    """The port's parameters in the JAX pytree have the structure, shapes and
    dtypes of the JAX init (jax.eval_shape: nothing is compiled), and come
    back through from_jax_params unchanged, every leaf consumed once."""
    s = setup
    want = jax.eval_shape(s.jnet.init, jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(s.params) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(s.params), jax.tree_util.tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype
    net = NetSearch(PortSearchCfg(**dict(TINY, SEED=7)), {"token_size": V, "ans_size": A})
    net.load_state_dict(from_jax_params(s.params), strict=True)
    for a, b in zip(jax.tree_util.tree_leaves(to_jax_params(net)),
                    jax.tree_util.tree_leaves(s.params)):
        np.testing.assert_array_equal(a, b)


def test_host_sampling(setup):
    s = setup
    alpha = {c: torch.from_numpy(a) for c, a in s.alpha.items()}
    g = torch.Generator().manual_seed(0)
    draws = [NetSearch.sample_indices(alpha, g)["dec"] for _ in range(4000)]
    freq = np.stack([np.bincount(d, minlength=4) for d in np.stack(draws).T]) / 4000
    np.testing.assert_allclose(freq, softmax(s.alpha["dec"]), atol=0.03)   # > 4 sd
    a, b = (NetSearch.sample_indices(alpha, torch.Generator().manual_seed(9)) for _ in range(2))
    assert all(np.array_equal(a[c], b[c]) for c in a)
    for seed in range(5):
        pairs = NetSearch.sample_indices_two(alpha, torch.Generator().manual_seed(seed))
        for c, p in pairs.items():
            assert p.shape == (len(s.alpha[c]), 2) and (p[:, 0] != p[:, 1]).all()
    chosen = NetSearch.chosen_indices(alpha)
    assert all(np.array_equal(chosen[c], s.alpha[c].argmax(-1)) for c in chosen)


def test_unported_modes_and_options_raise(setup):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        setup.net(setup.tb, None, IDX, mode="unified")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NetSearch(PortSearchCfg(**dict(TINY, REMAT=True)), {"token_size": V})
    with pytest.raises(ValueError, match="LAYERS"):
        NetSearch(PortSearchCfg(**dict(TINY, LAYERS=2)), {"token_size": V})
