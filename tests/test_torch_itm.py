"""The port's ITM slice, module by module, against the JAX package on the CPU.

Same inputs, made from a numpy seed, through the JAX function and the port's:
- bce_triplet_loss (with and without the doubled positive) and
  margin_triplet_loss against the JAX functions, 1e-6, and their gradients;
  at scores saturated to exactly 0 and 1 the value and gradient stay finite
  and equal the JAX package's (tests/test_itm.py:49);
- recall_metrics, draw_candidates and run_mine_sweeps (unfiltered,
  MINE_SEMIHARD, MINE_SKIP_TOP, MINE_NOISE_Q; whole table and caption blocks)
  on fixed inputs against the JAX package's, exactly: the port's scorer hands
  the sweeps device tensors (DeviceScores), the JAX one numpy arrays;
- NetFull(task="itm") of arch/mmnas_itm.json at HSIZE 64 (12 regions, some
  of them pads; 10-token captions, some of them short): the probabilities
  against the JAX NetFull.apply, 2e-4, and encode_text + apply_decoder
  against the port's forward (exactly) and the JAX split methods (2e-4);
  under bf16 the probabilities leave in fp32 and off the 1.0 rail;
- NetSearch(task="itm"): the sampled path's forward and split trunk
  against the JAX supernet's, 2e-4;
- one triplet step's loss and gradient (three forwards, the BCE triplet)
  against jax.value_and_grad of the JAX package's composition, 1e-5;
- the ITM head's leaves (attflat_y, a one-output proj) through the
  conversion and back, for the fixed net and the supernet."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.config import Cfg, SearchCfg
from mmnas_tpu.data.loader import _stack
from mmnas_tpu.data.synth import SynthItmDataset
from mmnas_tpu.engine import itm as JI
from mmnas_tpu.genotype import load_genotype
from mmnas_tpu.models.net import NetFull as JaxNetFull
from mmnas_tpu.models.supernet import NetSearch as JaxNetSearch
from mmnas_tpu.utils import itm_loss as JL
from mmnas_tpu_torch.config import Cfg as PortCfg
from mmnas_tpu_torch.config import SearchCfg as PortSearchCfg
from mmnas_tpu_torch.engine import itm as PI
from mmnas_tpu_torch.models.convert import from_jax_params, to_jax_params
from mmnas_tpu_torch.models.net import NetFull
from mmnas_tpu_torch.models.supernet import NetSearch
from mmnas_tpu_torch.utils import itm_loss as PL

ARCH = "arch/mmnas_itm.json"
# tests/test_itm.py's tiny sizes, with 12 regions so that some images have
# pad regions (the synthetic images hold 8 to FRCNFEAT_LEN objects)
SMALL = dict(TASK="itm", SYNTH=True, HSIZE=64, ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=32,
             REL_SIZE=16, FRCNFEAT_LEN=12, FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=12, MAX_TOKEN=10,
             SCORES_LOSS="bce", NEG_RANDSIZE=6, NEG_HARDSIZE=2, NEG_BATCHSIZE=4, DROPOUT_R=0.0,
             LAYERS=1)
BATCH = 6
NET_TOL = 2e-4          # the VQA nets' tolerance (tests/test_torch_net.py)
# one fp32 step's gradient: the same forwards and backward in both packages,
# with sums in other orders
GRAD_TOL = 1e-5
# the AttFlat glimpse biases: a softmax over the positions cancels a bias
# shared by all of them, so their true gradient is 0 and both packages get
# rounding noise, held to GRAD_TOL of the whole gradient's largest entry
INVARIANT = ("attflat_x.mlp.linear.bias", "attflat_y.mlp.linear.bias")


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def triplet(seed, n=8, lo=0.01, hi=0.99):
    r = np.random.RandomState(seed)
    return [r.uniform(lo, hi, n).astype(np.float32) for _ in range(3)]


SATURATED = [np.array([0.0, 0.5, 1.0], np.float32), np.array([1.0, 0.5, 0.0], np.float32),
             np.array([0.5, 1.0, 0.5], np.float32)]


@pytest.mark.parametrize("loss", ["bce_double", "bce_single", "margin"])
@pytest.mark.parametrize("inputs", ["interior", "saturated"])
def test_triplet_losses_and_gradients_match_jax(loss, inputs):
    scores = triplet(0) if inputs == "interior" else SATURATED
    port_fn, jax_fn = {
        "bce_double": (lambda *s: PL.bce_triplet_loss(*s, double_pos=True),
                       lambda *s: JL.bce_triplet_loss(*s, double_pos=True)),
        "bce_single": (lambda *s: PL.bce_triplet_loss(*s, double_pos=False),
                       lambda *s: JL.bce_triplet_loss(*s, double_pos=False)),
        "margin": (PL.margin_triplet_loss, JL.margin_triplet_loss)}[loss]
    leaves = [torch.from_numpy(s).requires_grad_() for s in scores]
    got = port_fn(*leaves)
    got_grads = torch.autograd.grad(got, leaves)
    want, want_grads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2))(
        *[jnp.asarray(s) for s in scores])
    assert got.dtype == torch.float32 and np.isfinite(got.item())
    assert got.item() == pytest.approx(float(want), rel=1e-6)
    for g, w in zip(got_grads, want_grads):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)
    if loss == "bce_double" and inputs == "saturated":
        # the rail pushes back toward the interior with a bounded force
        assert got_grads[0][0] < 0 and abs(got_grads[0][0]) <= 2.1e7


def test_bce_triplet_loss_is_not_torch_bce_on_the_rail():
    """BCELoss clamps the log at -100; the port keeps log(p + 1e-7), as the
    JAX package: 16.1 per saturated term, not 100."""
    pos = torch.tensor([0.0])
    zero = torch.tensor([0.5])
    got = PL.bce_triplet_loss(pos, zero, zero, double_pos=False)
    assert got.item() == pytest.approx(-np.log(1e-7) - 2 * np.log(0.5), rel=1e-6)
    bce = torch.nn.BCELoss(reduction="sum")(pos, torch.ones(1))
    assert bce.item() == pytest.approx(100.0)


# ---------------------------------------------------------------------------
# recall and mining helpers, on fixed inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ties", [False, True])
def test_recall_metrics_match_jax(ties):
    m = np.random.RandomState(11).randn(23, 115).astype(np.float32)
    if ties:
        m = np.round(m)          # many equal scores: the stable sorts decide
    assert PI.recall_metrics(m) == JI.recall_metrics(m)


def test_draw_candidates_match_jax():
    for per_img in (True, False):
        args = (30, 40 if per_img else 8, per_img, 5)
        got = PI.draw_candidates(*args, np.random.RandomState(3), 6, 4)
        want = JI.draw_candidates(*args, np.random.RandomState(3), 6, 4)
        np.testing.assert_array_equal(got, want)


class Corpus:
    """A dataset's mining surface: 8 images of 5 captions."""
    CAPS_PER_IMG = 5

    def __len__(self):
        return 40


def planted(ii, cc):
    """A fixed score table over (image, caption): distinct values, and each
    caption's own image scored high."""
    ii, cc = np.asarray(ii, np.int64), np.asarray(cc, np.int64)
    return (np.sin(ii * 1.37 + cc * 0.71) + 2.0 * (cc // 5 == ii)).astype(np.float32)


@pytest.mark.parametrize("blocked", [False, True])
@pytest.mark.parametrize("mode", [{}, {"MINE_SEMIHARD": True}, {"MINE_SKIP_TOP": 1},
                                  {"MINE_NOISE_Q": 0.2}])
def test_mining_sweeps_match_jax(mode, blocked):
    """The port's sweeps, fed device tensors, against the JAX package's fed
    numpy arrays, from one RNG seed: the same negatives, bit for bit."""
    kw = dict(SMALL, NEG_RANDSIZE=6, NEG_HARDSIZE=2, NEG_BATCHSIZE=3, **mode)
    out = {}
    for name, cfg, mod, wrap in (("port", PortCfg(**kw), PI, lambda s: PI.DeviceScores(
            torch.from_numpy(s))), ("jax", Cfg(**kw), JI, lambda s: s)):
        ds = Corpus()
        if blocked:      # 7 captions a block, which does not divide 40
            ctx = dict(blocked_ctx=(lambda te, ii, cc: wrap(planted(ii, np.asarray(cc) + te)),
                                    lambda start: start, 7))
        else:
            ctx = dict(score_pairs=lambda ii, cc: wrap(planted(ii, cc)))
        mod.run_mine_sweeps(cfg, ds, np.random.RandomState(9), cfg.NEG_BATCHSIZE, **ctx)
        out[name] = (ds.neg_caps_idx_tensor, ds.neg_imgs_idx_tensor)
    for got, want in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(got, want)
    caps, imgs = out["port"]
    assert caps.shape == (8, 2) and imgs.shape == (40, 2)
    assert not (caps // 5 == np.arange(8)[:, None]).any()          # no own caption
    assert not (imgs == (np.arange(40) // 5)[:, None]).any()       # no own image


def test_score_matrix_sweep_matches_jax():
    """Caption blocks of 7 and tiles of 9 pairs, port (device tensors) vs
    JAX (numpy): the same matrix, and the planted table's own pairs."""
    got = PI.score_matrix_sweep(8, 40, 7, 9, lambda s, c: s, lambda te, ii, cc: PI.DeviceScores(
        torch.from_numpy(planted(ii, np.asarray(cc) + te))))
    want = JI.score_matrix_sweep(8, 40, 7, 9, lambda s, c: s,
                                 lambda te, ii, cc: planted(ii, np.asarray(cc) + te))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, planted(*np.meshgrid(np.arange(8), np.arange(40),
                                                            indexing="ij")))


def test_encode_window_takes_the_last_chunk_as_it_is():
    caps = torch.arange(23)[:, None].repeat(1, 3)
    seen = []

    def encode(chunk):
        seen.append(chunk.shape[0])
        return chunk.float(), chunk[:, None, None, :] == 0

    te = PI.encode_window(encode, caps, 5, 100, 8)
    assert seen == [8, 8, 2] and te["x"].shape == (18, 3)
    np.testing.assert_array_equal(te["x"][:, 0].numpy(), np.arange(5, 23))


# ---------------------------------------------------------------------------
# the nets, the split trunk and one step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = Cfg(**SMALL)
    ds = SynthItmDataset(cfg, size=BATCH * 5, token_size=32, seed=5)
    init_dict = {"token_size": ds.token_size, "ans_size": 1, "pretrained_emb": ds.pretrained_emb}
    genotype = load_genotype(ARCH)
    jnet = JaxNetFull(cfg, genotype, init_dict, "itm")
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    batch = _stack([ds[i * 5 + i % 5] for i in range(BATCH)])
    pads = (np.abs(batch["frcn_feat"]).sum(-1) == 0).sum(-1)
    assert pads.min() == 0 < pads.max() and (batch["ques_ix"] == 0).any()
    net = NetFull(PortCfg(**SMALL), genotype, init_dict, "itm")
    net.load_state_dict(from_jax_params(params), strict=True)
    return cfg, jnet, params, batch, net, init_dict, genotype


def test_netfull_itm_and_split_trunk_match_jax(setup):
    cfg, jnet, params, batch, net, _, _ = setup
    jb = to_jax(batch)
    want = np.asarray(jax.jit(jnet.apply)(params, jb))
    x, m = jax.jit(jnet.encode_text)(params, jb["ques_ix"], jb["rel_ques"])
    want_split = np.asarray(jax.jit(jnet.apply_decoder)(params, x, m, jb))
    tb = to_torch(batch)
    with torch.no_grad():
        got = net(tb)
        x_out, x_mask = net.encode_text(tb["ques_ix"])
        split = net.apply_decoder(x_out, x_mask, tb)
    assert got.shape == (BATCH,) and got.dtype == torch.float32
    assert ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=NET_TOL, atol=NET_TOL)
    np.testing.assert_allclose(x_out.numpy(), np.asarray(x), rtol=NET_TOL, atol=NET_TOL)
    np.testing.assert_array_equal(x_mask.numpy(), np.asarray(m))
    torch.testing.assert_close(split, got, rtol=0, atol=0)
    np.testing.assert_allclose(split.numpy(), want_split, rtol=NET_TOL, atol=NET_TOL)


def test_bf16_itm_probabilities_leave_in_fp32_off_the_rail(setup):
    """A logit of 7: its fp32 sigmoid is 0.99909, a bf16 sigmoid rounds to 1.0."""
    _, _, params, batch, _, init_dict, genotype = setup
    net = NetFull(PortCfg(**dict(SMALL, DTYPE="bfloat16")), genotype, init_dict, "itm")
    net.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        net.proj.weight.zero_()
        net.proj.bias.fill_(7.0)
        p = net.to(torch.bfloat16)(to_torch(batch))
    assert p.dtype == torch.float32
    np.testing.assert_allclose(p.numpy(), 1.0 / (1.0 + np.exp(-7.0)), rtol=1e-6)
    assert torch.sigmoid(torch.tensor(7.0, dtype=torch.bfloat16)).item() == 1.0


def test_triplet_step_loss_and_gradient_match_jax(setup, tmp_path):
    """Execution.forward_loss (three forwards, the doubled-positive BCE
    triplet) against jax.value_and_grad of the JAX package's step loss
    (engine/itm.py:461-476)."""
    cfg, jnet, params, batch, net, _, _ = setup
    jb = to_jax(batch)

    def loss_fn(p):
        pos = {k: jb[k] for k in ("frcn_feat", "bbox_feat", "rel_img", "ques_ix", "rel_ques")}
        negc = dict(pos, ques_ix=jb["neg_ques_ix"], rel_ques=jb["neg_rel_ques"])
        negi = dict(pos, frcn_feat=jb["neg_frcn_feat"], bbox_feat=jb["neg_bbox_feat"],
                    rel_img=jb["neg_rel_img"])
        scores = [jnet.apply(p, b, train=True, rng=jax.random.PRNGKey(1))
                  for b in (pos, negc, negi)]
        return JL.bce_triplet_loss(*scores, double_pos=cfg.ITM_DOUBLE_POS)

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    exe = PI.Execution(PortCfg(**dict(SMALL, LOG_ROOT=str(tmp_path))), torch.device("cpu"))
    masters = dict(net.named_parameters())
    gen = torch.Generator().manual_seed(0)
    loss = exe.forward_loss(lambda b: net(b, train=True, generator=gen), to_torch(batch))
    grads = dict(zip(masters, torch.autograd.grad(loss, list(masters.values()),
                                                  allow_unused=True)))
    assert loss.item() == pytest.approx(float(want_loss), rel=GRAD_TOL)
    want = from_jax_params(want)
    scale = max(float(g.abs().max()) for g in want.values())
    assert set(grads) == set(want)
    for n, g in grads.items():
        g = torch.zeros_like(want[n]) if g is None else g
        atol = GRAD_TOL * scale if n in INVARIANT else GRAD_TOL
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=GRAD_TOL, atol=atol,
                                   err_msg=n)
    assert grads["proj.weight"].abs().max() > 0 and grads["attflat_y.merge.weight"].abs().max() > 0


def test_itm_params_round_trip(setup):
    _, _, params, _, _, init_dict, genotype = setup
    net = NetFull(PortCfg(**SMALL), genotype, init_dict, "itm",
                  generator=torch.Generator().manual_seed(5))
    assert net.proj.weight.shape == (1, SMALL["ATTFLAT_OUT_SIZE"])
    net.load_state_dict(from_jax_params(params), strict=True)
    back = to_jax_params(net)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    assert {"attflat_y", "proj"} <= set(back) and back["proj"]["w"].shape == (128, 1)


@pytest.fixture(scope="module")
def search_setup(setup):
    _, _, _, batch, _, init_dict, _ = setup
    kw = dict(SMALL, NODES=(("enc", 2), ("dec", 4)))
    net = NetSearch(PortSearchCfg(**kw), init_dict, task="itm")
    jnet = JaxNetSearch(SearchCfg(**kw), init_dict, "itm")
    params = to_jax_params(net)
    idx = {"enc": np.array([0, 1]), "dec": np.array([0, 1, 2, 3])}
    return net, jnet, params, batch, idx


def test_netsearch_itm_sampled_path_and_split_trunk_match_jax(search_setup):
    net, jnet, params, batch, idx = search_setup
    jb = to_jax(batch)
    jidx = {c: jnp.asarray(v, jnp.int32) for c, v in idx.items()}
    alpha = {c: jnp.asarray(a.numpy()) for c, a in net.init_alpha().items()}
    want = np.asarray(jax.jit(lambda p, b, i: jnet.apply(p, alpha, b, i, mode="sampled"))(
        params, jb, jidx))
    x, m = jax.jit(lambda p, q, r, i: jnet.encode_text(p, alpha, q, r, i))(
        params, jb["ques_ix"], jb["rel_ques"], jidx)
    want_split = np.asarray(jax.jit(lambda p, x, m, b, i: jnet.apply_decoder(p, alpha, x, m, b, i))(
        params, x, m, jb, jidx))
    tb = to_torch(batch)
    with torch.no_grad():
        got = net(tb, None, idx)
        x_out, x_mask = net.encode_text(tb["ques_ix"], idx)
        split = net.apply_decoder(x_out, x_mask, tb, idx)
    assert got.shape == (BATCH,)
    np.testing.assert_allclose(got.numpy(), want, rtol=NET_TOL, atol=NET_TOL)
    torch.testing.assert_close(split, got, rtol=0, atol=0)
    np.testing.assert_allclose(split.numpy(), want_split, rtol=NET_TOL, atol=NET_TOL)
    np.testing.assert_allclose(x_out.numpy(), np.asarray(x), rtol=NET_TOL, atol=NET_TOL)


def test_itm_supernet_head_leaves_match_jax(search_setup):
    net, jnet, params, _, _ = search_setup
    jparams = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(jparams)):
        assert a.shape == b.shape
    assert {"attflat_y", "proj"} <= set(params) and params["proj"]["w"].shape == (128, 1)
    net2 = NetSearch(net.cfg, {"token_size": net.embedding.num_embeddings}, task="itm")
    net2.load_state_dict(from_jax_params(params), strict=True)
    for (n, a), b in zip(net2.state_dict().items(), net.state_dict().values()):
        assert torch.equal(a, b), n
