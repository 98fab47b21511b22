"""The port's VGD slice, module by module, against the JAX package on the CPU.

Same inputs, made from a numpy seed, through the JAX function and the port's:
- the torch twins of the box helpers (bbox_overlaps_torch, the decode and
  the clip) against the jnp and numpy versions, fp32, 1e-6 relative;
- kld_sum, smooth_l1_sum and vgd_loss (kld and bce, LOSS_AVG on and off)
  and fold_bbox_norm against the JAX functions, 1e-6;
- NetFull(task="vgd") of arch/mmnas_vgd.json at LAYERS 1, HSIZE 64, on the
  reference shapes (15 query tokens, a 14x14 text relation, 100 regions):
  scores and box deltas against the JAX NetFull.apply on the same weights,
  2e-4 (as the VQA nets); its bf16 outputs leave in fp32;
- one train step's loss and gradient, leaf by leaf, against
  jax.value_and_grad, 1e-5;
- the eval's per-item hits against the JAX package's make_eval_step, equal
  except where the IoU is within 1e-6 of the threshold, and the device-side
  grounding step against its jnp composition on outputs that hit;
- a VGD param tree through the conversion and back, and the supernet's VGD
  head's leaves against the JAX NetSearch init."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.config import Cfg
from mmnas_tpu.data.loader import _stack
from mmnas_tpu.data.synth import SynthVgdDataset
from mmnas_tpu.engine import vgd as JV
from mmnas_tpu.genotype import load_genotype
from mmnas_tpu.models.net import NetFull as JaxNetFull
from mmnas_tpu.utils.bbox import bbox_overlaps_jnp, bbox_overlaps_np
from mmnas_tpu.utils.bbox_transform import (
    bbox_transform_inv, bbox_transform_inv_jnp, clip_boxes, clip_boxes_jnp,
)
from mmnas_tpu_torch.config import Cfg as PortCfg
from mmnas_tpu_torch.engine import vgd as PV
from mmnas_tpu_torch.models.convert import from_jax_params, to_jax_params
from mmnas_tpu_torch.models.net import NetFull
from mmnas_tpu_torch.utils.bbox import bbox_overlaps_torch
from mmnas_tpu_torch.utils.bbox_transform import bbox_transform_inv_torch, clip_boxes_torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "arch/mmnas_vgd.json"
SMALL = dict(TASK="vgd", SYNTH=True, HSIZE=64, ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=32,
             REL_SIZE=8, FRCNFEAT_SIZE=32, WORD_EMBED_SIZE=12, LAYERS=1, DROPOUT_R=0.0)
BATCH = 6
NET_TOL = 2e-4          # the VQA nets' tolerance (tests/test_torch_net.py)
# one fp32 step's gradient: the same forward and backward in both
# packages, with sums in other orders
GRAD_TOL = 1e-5
# the AttFlat glimpse bias: a softmax over the tokens cancels a bias shared
# by all of them, so its true gradient is 0 and both packages get rounding
# noise, held to GRAD_TOL of the whole gradient's largest entry instead
INVARIANT = "attflat_x.mlp.linear.bias"


def boxes(r, shape, scale=100.0):
    x1, y1 = r.uniform(0, scale, shape), r.uniform(0, scale, shape)
    return np.stack([x1, y1, x1 + r.uniform(1, scale, shape), y1 + r.uniform(1, scale, shape)],
                    -1).astype(np.float32)


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_close_rel(got, want, rtol=1e-6):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------------------
# box helpers and losses
# ---------------------------------------------------------------------------

def test_box_helpers_match_the_jnp_and_numpy_versions():
    r = np.random.RandomState(0)
    b, q = boxes(r, (3, 20)), boxes(r, (3, 2))
    want = np.asarray(bbox_overlaps_jnp(jnp.asarray(b), jnp.asarray(q)))
    got = bbox_overlaps_torch(torch.from_numpy(b), torch.from_numpy(q)).numpy()
    assert got.dtype == np.float32 and got.shape == (3, 20, 2)
    assert_close_rel(got, want)
    assert_close_rel(got[1], bbox_overlaps_np(b[1], q[1]))
    assert (got == 0).any() and (got > 0.1).any()         # disjoint and overlapping pairs

    deltas = (r.randn(3, 20, 4) * 0.3).astype(np.float32)
    want = np.asarray(bbox_transform_inv_jnp(jnp.asarray(b), jnp.asarray(deltas)))
    got = bbox_transform_inv_torch(torch.from_numpy(b), torch.from_numpy(deltas)).numpy()
    assert_close_rel(got, want)
    assert_close_rel(got[2], bbox_transform_inv(b[2], deltas[2]))

    shape = np.array([[90.0, 120.0], [150.0, 60.0], [40.0, 40.0]], np.float32)   # (H, W)
    want = np.asarray(clip_boxes_jnp(jnp.asarray(got), jnp.asarray(shape)))
    clipped = clip_boxes_torch(torch.from_numpy(got), torch.from_numpy(shape)).numpy()
    np.testing.assert_array_equal(clipped, want)
    np.testing.assert_array_equal(clipped[0], clip_boxes(got[0], shape[0]).astype(np.float32))
    assert (clipped != got).any()


def loss_inputs(seed=1, B=4, L=100):
    r = np.random.RandomState(seed)
    logits = r.randn(B, L).astype(np.float32)
    logprob = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    target = np.where(r.rand(B, L) < 0.05, r.rand(B, L), 0.0).astype(np.float32)
    target /= target.sum(-1, keepdims=True) + 1e-8
    scores_mask = (target.sum(-1, keepdims=True) > 0).astype(np.float32)
    scores_mask[0] = 0.0
    bbox_mask = (target > 0).astype(np.float32)[..., None]
    return {"logits": logits, "logprob": logprob.astype(np.float32),
            "reg": (r.randn(B, L, 4) * 1.5).astype(np.float32),
            "batch": {"scores": target, "scores_mask": scores_mask,
                      "transformed_bbox": (r.randn(B, L, 4) * 1.5).astype(np.float32),
                      "bbox_mask": bbox_mask}}


def test_loss_terms_match_jax():
    x = loss_inputs()
    t, p = x["batch"]["scores"], x["logprob"]
    assert_close_rel(PV.kld_sum(torch.from_numpy(p), torch.from_numpy(t)).item(),
                     float(JV.kld_sum(jnp.asarray(p), jnp.asarray(t))))
    a, b = x["reg"], x["batch"]["transformed_bbox"]
    d = np.abs(a - b)
    assert (d < 1).any() and (d >= 1).any()                  # both branches of SmoothL1
    assert_close_rel(PV.smooth_l1_sum(torch.from_numpy(a), torch.from_numpy(b)).item(),
                     float(JV.smooth_l1_sum(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("scores_loss", ["kld", "bce"])
@pytest.mark.parametrize("loss_avg", [True, False])
def test_vgd_loss_matches_jax(scores_loss, loss_avg):
    cfg = Cfg(SCORES_LOSS=scores_loss, LOSS_AVG=loss_avg)
    x = loss_inputs(2)
    pred = x["logprob"] if scores_loss == "kld" else x["logits"]
    want = float(JV.vgd_loss(cfg, jnp.asarray(pred), jnp.asarray(x["reg"]), to_jax(x["batch"])))
    got = PV.vgd_loss(PortCfg(SCORES_LOSS=scores_loss, LOSS_AVG=loss_avg),
                      torch.from_numpy(pred), torch.from_numpy(x["reg"]), to_torch(x["batch"]))
    assert got.dtype == torch.float32
    assert_close_rel(got.item(), want)


@pytest.mark.parametrize("bbox_norm", [True, False])
def test_fold_bbox_norm_matches_jax(bbox_norm):
    r = np.random.RandomState(3)
    w, b = r.randn(16, 4).astype(np.float32), r.randn(4).astype(np.float32)
    cfg = dict(BBOX_NORM=bbox_norm, BBOX_NORM_MEANS=(0.1, -0.2, 0.0, 0.3))
    want = JV.fold_bbox_norm(Cfg(**cfg), {"proj_reg": {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                          "other": jnp.ones(2)})
    params = {"proj_reg.weight": torch.from_numpy(w.T.copy()),
              "proj_reg.bias": torch.from_numpy(b), "other": torch.ones(2)}
    got = PV.fold_bbox_norm(PortCfg(**cfg), params)
    assert_close_rel(got["proj_reg.weight"].numpy().T, want["proj_reg"]["w"])
    assert_close_rel(got["proj_reg.bias"].numpy(), want["proj_reg"]["b"])
    assert got["other"] is params["other"]
    np.testing.assert_array_equal(params["proj_reg.weight"].numpy(), w.T)   # not changed


# ---------------------------------------------------------------------------
# the net, a train step and the eval
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = Cfg(**SMALL)
    ds = SynthVgdDataset(cfg, size=BATCH, seed=5)
    init_dict = {"token_size": ds.token_size, "ans_size": 1, "pretrained_emb": ds.pretrained_emb}
    genotype = load_genotype(ARCH)
    jnet = JaxNetFull(cfg, genotype, init_dict, "vgd")
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    batch = _stack([ds[i] for i in range(BATCH)])
    assert batch["ques_ix"].shape == (BATCH, 15) and batch["rel_ques"].shape == (BATCH, 14, 14, 3)
    assert batch["frcn_feat"].shape == (BATCH, 100, 32)
    net = NetFull(PortCfg(**SMALL), genotype, init_dict, "vgd")
    net.load_state_dict(from_jax_params(params), strict=True)
    return cfg, jnet, params, batch, net, init_dict, genotype


def test_netfull_vgd_matches_jax(setup):
    cfg, jnet, params, batch, net, _, _ = setup
    want_s, want_r = jax.jit(jnet.apply)(params, to_jax(batch))
    with torch.no_grad():
        got_s, got_r = net(to_torch(batch))
    assert got_s.shape == (BATCH, 100) and got_r.shape == (BATCH, 100, 4)
    # log_softmax over all 100 regions, the pads included
    np.testing.assert_allclose(torch.logsumexp(got_s, -1).numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=NET_TOL, atol=NET_TOL)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), rtol=NET_TOL, atol=NET_TOL)


def test_bf16_vgd_head_leaves_in_fp32(setup):
    _, _, params, batch, _, init_dict, genotype = setup
    net = NetFull(PortCfg(**dict(SMALL, DTYPE="bfloat16", SCORES_LOSS="bce")), genotype,
                  init_dict, "vgd")
    net.load_state_dict(from_jax_params(params), strict=True)
    with torch.no_grad():
        scores, reg = net.to(torch.bfloat16)(to_torch(batch))
    assert scores.dtype == reg.dtype == torch.float32
    assert torch.isfinite(scores).all() and torch.isfinite(reg).all()


def test_train_step_loss_and_gradient_match_jax(setup):
    cfg, jnet, params, batch, net, _, _ = setup
    jb = to_jax(batch)

    def loss_fn(p):
        scores, reg = jnet.apply(p, jb, train=True, rng=jax.random.PRNGKey(1))
        return JV.vgd_loss(cfg, scores, reg, jb)

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params)
    masters = dict(net.named_parameters())
    scores, reg = net(to_torch(batch), train=True, generator=torch.Generator().manual_seed(0))
    loss = PV.vgd_loss(net.cfg, scores, reg, to_torch(batch))
    grads = dict(zip(masters, torch.autograd.grad(loss, list(masters.values()),
                                                  allow_unused=True)))
    assert loss.item() == pytest.approx(float(want_loss), rel=GRAD_TOL)
    want = from_jax_params(want)
    scale = max(float(g.abs().max()) for g in want.values())
    assert set(grads) == set(want)
    for n, g in grads.items():
        g = torch.zeros_like(want[n]) if g is None else g
        atol = GRAD_TOL * scale if n == INVARIANT else GRAD_TOL
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), rtol=GRAD_TOL, atol=atol,
                                   err_msg=n)


def test_eval_hits_match_the_jax_eval_step(setup, tmp_path):
    """The port's Execution.eval (BBOX_NORM folded, decode, clip, IoU on the
    device) against the JAX package's make_eval_step on the same weights."""
    from mmnas_tpu.engine.vgd import Execution as JaxExecution
    from mmnas_tpu_torch.data.loader import Loader
    from mmnas_tpu_torch.data.sampler import SubsetShardSampler
    from mmnas_tpu_torch.data.synth import SynthVgdDataset as PortSynthVgdDataset

    cfg, jnet, params, _, net, _, _ = setup
    size = 10
    jcfg = cfg.replace(N_DEVICES=1, LOG_ROOT=str(tmp_path))
    ds = SynthVgdDataset(jcfg, size=size, seed=8)
    step = JaxExecution(jcfg).make_eval_step(jnet)
    folded = JV.fold_bbox_norm(jcfg, params)
    want = np.concatenate([np.asarray(step(folded, to_jax(_stack(
        [ds[i % size] for i in range(s, s + 4)])))) for s in range(0, size, 4)])[:size]

    pcfg = PortCfg(**dict(SMALL, LOG_ROOT=str(tmp_path), VERSION="vgd-eval"))
    pds = PortSynthVgdDataset(pcfg, size=size, seed=8)
    loader = Loader(pds, 4, sampler=SubsetShardSampler(size, shuffle=False), num_workers=1)
    got = PV.Execution(pcfg, torch.device("cpu")).eval(loader, net=net)
    assert got.hits.shape == got.ious.shape == (size,)
    near = np.abs(got.ious - cfg.OVERLAP_THRESHOLD) < 1e-6
    np.testing.assert_array_equal(got.hits[~near], want[~near])
    assert got.accuracy == pytest.approx(100.0 * want.sum() / size)


def test_grounding_step_matches_its_jnp_composition():
    """grounding_hits on outputs that pick a hitting proposal for about half
    the items: IoUs within 1e-6 of the jnp decode-clip-IoU, hits equal."""
    cfg = PortCfg()
    r = np.random.RandomState(4)
    B, L = 16, 100
    bbox = boxes(r, (B, L), scale=300.0)
    gt = np.stack([bbox[i, r.randint(L)] + r.uniform(-6, 6, 4) for i in range(B)])[:, None]
    gt = gt.astype(np.float32)
    img_shape = np.tile(np.array([[480.0, 640.0]], np.float32), (B, 1))
    scores = r.randn(B, L).astype(np.float32)
    overlaps = bbox_overlaps_np(bbox.reshape(-1, 4), gt.reshape(-1, 4)).reshape(B, L, B)
    for i in range(0, B, 2):             # the best proposal of every other item wins
        scores[i, overlaps[i, :, i].argmax()] += 10.0
    reg = (r.randn(B, L, 4) * 0.05).astype(np.float32)
    batch = {"bbox": bbox, "img_shape": img_shape, "gt_bbox": gt}
    hits, iou = PV.grounding_hits(cfg, torch.from_numpy(scores), torch.from_numpy(reg),
                                  to_torch(batch))
    clipped = clip_boxes_jnp(bbox_transform_inv_jnp(jnp.asarray(bbox), jnp.asarray(reg)),
                             jnp.asarray(img_shape))
    picked = clipped[jnp.arange(B), jnp.argmax(jnp.asarray(scores), -1)]
    want_iou = np.asarray(bbox_overlaps_jnp(picked[:, None, :], jnp.asarray(gt))[:, 0, 0])
    assert_close_rel(iou.numpy(), want_iou)
    np.testing.assert_array_equal(hits.numpy(), (want_iou >= cfg.OVERLAP_THRESHOLD))
    assert 4 <= int(hits.sum()) < B


def test_vgd_params_round_trip(setup):
    _, _, params, _, _, init_dict, genotype = setup
    net = NetFull(PortCfg(**SMALL), genotype, init_dict, "vgd",
                  generator=torch.Generator().manual_seed(5))
    assert {"attfc_y.weight", "proj_scores.weight", "proj_reg.bias"} <= set(
        dict(net.named_parameters()))
    net.load_state_dict(from_jax_params(params), strict=True)
    back = to_jax_params(net)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_vgd_supernet_head_leaves_match_jax():
    """NetSearch(task="vgd") carries the JAX supernet's VGD head, leaf for
    leaf (the supernet parity of the whole search runs in
    tests/test_torch_vgd_engine.py)."""
    from mmnas_tpu.config import SearchCfg
    from mmnas_tpu.models.supernet import NetSearch as JaxNetSearch
    from mmnas_tpu_torch.config import SearchCfg as PortSearchCfg
    from mmnas_tpu_torch.models.supernet import NetSearch

    kw = dict(SMALL, NODES=(("enc", 1), ("dec", 2)))
    init_dict = {"token_size": 20}
    jparams = jax.eval_shape(lambda: JaxNetSearch(SearchCfg(**kw), init_dict, "vgd").init(
        jax.random.PRNGKey(0)))
    back = to_jax_params(NetSearch(PortSearchCfg(**kw), init_dict, task="vgd"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(jparams)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        assert a.shape == b.shape
    assert {"attfc_y", "proj_scores", "proj_reg"} <= set(back) and "attflat_y" not in back
