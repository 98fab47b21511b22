"""The SHIP_INT8 / DEVICE_REL input path of the port against the JAX
package, and --PROFILE.

- `relation_embedding_torch` equals `relation_embedding_jnp` on the same
  boxes (1e-5), with every pair that touches a padded box exactly 0;
- on a small packed VQA corpus (tools/pack_features.py, as
  tests/test_batch_pipeline.py:148-226 builds it) the port's whole-batch
  loader (DEVICE_REL, with and without SHIP_INT8) gives the batch that the
  JAX package's gives, and the port's NetFull and NetSearch (sampled path)
  on it give the JAX nets' outputs on the same weights (1e-5): the int8
  features are dequantized and the relation tensor is computed from the
  raw boxes in the stem; VGD's fixed and search nets too, on the
  synthetic loader's raw boxes;
- the flags are refused where no path reads them (SHIP_INT8 outside the
  whole-batch VQA loader, DEVICE_REL for ITM), where the JAX package
  accepts them and ships what it would without them;
- a train epoch with --PROFILE writes a trace under
  LOG_ROOT/profile_<VERSION>/."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mmnas_tpu.config import Cfg, SearchCfg
from mmnas_tpu.data.loader import _stack
from mmnas_tpu.data.relations import relation_embedding_jnp
from mmnas_tpu.data.vqa import VqaDataset as JaxVqaDataset
from mmnas_tpu.models.net import NetFull as JaxNetFull
from mmnas_tpu.models.supernet import NetSearch as JaxNetSearch
from mmnas_tpu_torch.config import Cfg as PortCfg
from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser
from mmnas_tpu_torch.config import SearchCfg as PortSearchCfg
from mmnas_tpu_torch.data.loader import Loader
from mmnas_tpu_torch.data.relations import relation_embedding_torch
from mmnas_tpu_torch.data.sampler import SubsetShardSampler
from mmnas_tpu_torch.data.synth import SynthVgdDataset, SynthVqaDataset
from mmnas_tpu_torch.data.vqa import VqaDataset
from mmnas_tpu_torch.engine.vqa import Execution
from mmnas_tpu_torch.models.convert import to_jax_params
from mmnas_tpu_torch.models.net import NetFull
from mmnas_tpu_torch.models.supernet import NetSearch

from test_batch_pipeline import vqa_root  # noqa: F401  (the packed corpus fixture)

TOL = 1e-5
GENE = {"enc": [["self_att_64"], ["feed_forward"]],
        "dec": [["rel_self_att_64"], ["guided_att_64"], ["feed_forward"]]}


def test_relation_twin_matches_jnp():
    r = np.random.RandomState(0)
    B, K = 3, 9
    x1, y1 = r.uniform(0, 300, (B, K)), r.uniform(0, 300, (B, K))
    bbox = np.stack([x1, y1, x1 + r.uniform(1, 120, (B, K)), y1 + r.uniform(1, 120, (B, K))],
                    -1).astype(np.float32)
    bbox[0, 2] = bbox[0, 5]                  # coincident centres: the 1e-3 clamp
    valid = np.ones((B, K), bool)
    valid[1, 6:] = False
    valid[2, 1:] = False
    bbox[~valid] = 0.0                       # pad rows, as the loaders ship them
    want = np.asarray(relation_embedding_jnp(jnp.asarray(bbox), jnp.asarray(valid)))
    got = relation_embedding_torch(torch.from_numpy(bbox), torch.from_numpy(valid)).numpy()
    assert got.shape == (B, K, K, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    pair = valid[:, :, None] & valid[:, None, :]
    assert (got[~pair] == 0.0).all()
    np.testing.assert_allclose(relation_embedding_torch(torch.from_numpy(bbox)).numpy(),
                               np.asarray(relation_embedding_jnp(jnp.asarray(bbox))),
                               rtol=TOL, atol=TOL)


def _cfgs(root, int8):
    return dict(TASK="vqa", DATA_ROOT=root, FRCNFEAT_LEN=10, FRCNFEAT_SIZE=64,
                GLOVE_FEATURE=False, WORD_EMBED_SIZE=16, HSIZE=64, REL_SIZE=4,
                ATTFLAT_MLP_SIZE=16, ATTFLAT_OUT_SIZE=64, BBOXFEAT_EMB_SIZE=8, DROPOUT_R=0.0,
                DEVICE_REL=True, SHIP_INT8=int8)


@pytest.mark.parametrize("int8", [False, True], ids=["fp16", "int8"])
def test_whole_batch_forward_matches_jax(vqa_root, int8):  # noqa: F811
    base = _cfgs(vqa_root, int8)
    idx = np.asarray([0, 5, 9, 13])
    ds = VqaDataset(PortCfg(**base), "train")
    batch = ds.get_batch(idx)
    jax_batch = JaxVqaDataset(Cfg(**base), "train").get_batch(idx)
    assert batch.keys() == jax_batch.keys() and "rel_img" not in batch
    assert ("frcn_feat_q" in batch) == int8 and ("frcn_feat" in batch) != int8
    for k in batch:
        np.testing.assert_array_equal(batch[k], jax_batch[k])
    # the port's loader takes the whole-batch path by itself
    loader = Loader(ds, 4, sampler=SubsetShardSampler(len(ds), shuffle=False), num_workers=1)
    first = next(iter(loader))
    assert first.keys() == batch.keys()
    init_dict = {"token_size": ds.token_size, "ans_size": ds.ans_size,
                 "pretrained_emb": ds.pretrained_emb}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    net = NetFull(PortCfg(**base), GENE, init_dict, "vqa")
    params = to_jax_params(net)
    want = np.asarray(jax.jit(JaxNetFull(Cfg(**base), GENE, init_dict, "vqa").apply)(params, jb))
    with torch.no_grad():
        got = net(tb).numpy()
    assert got.shape == (4, ds.ans_size) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    search = dict(base, NODES=(("enc", 2), ("dec", 3)))
    snet = NetSearch(PortSearchCfg(**search), init_dict)
    sidx = {"enc": np.array([0, 1]), "dec": np.array([1, 2, 3])}
    jnet = JaxNetSearch(SearchCfg(**search), init_dict)
    want = np.asarray(jax.jit(lambda p, i: jnet.apply(p, None, jb, i))(
        to_jax_params(snet), {c: jnp.asarray(v, jnp.int32) for c, v in sidx.items()}))
    with torch.no_grad():
        got = snet(tb, None, sidx).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_vgd_device_rel_forward_matches_jax():
    """VGD with DEVICE_REL: the synthetic loader ships raw boxes, and the
    port's NetFull and NetSearch (sampled path) give the JAX nets' scores
    and box deltas on the same weights (1e-5)."""
    base = dict(TASK="vgd", HSIZE=64, ATTFLAT_OUT_SIZE=64, ATTFLAT_MLP_SIZE=16, REL_SIZE=4,
                FRCNFEAT_LEN=12, FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=8, MAX_TOKEN=5,
                DROPOUT_R=0.0, DEVICE_REL=True)
    ds = SynthVgdDataset(PortCfg(**base), size=3, seed=2)
    batch = _stack([ds[i] for i in range(3)])
    assert "bbox_raw" in batch and "rel_img" not in batch
    init_dict = {"token_size": ds.token_size, "ans_size": 1, "pretrained_emb": ds.pretrained_emb}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    net = NetFull(PortCfg(**base), GENE, init_dict, "vgd")
    want = jax.jit(JaxNetFull(Cfg(**base), GENE, init_dict, "vgd").apply)(to_jax_params(net), jb)
    search = dict(base, NODES=(("enc", 2), ("dec", 3)))
    snet = NetSearch(PortSearchCfg(**search), init_dict, task="vgd")
    sidx = {"enc": np.array([0, 1]), "dec": np.array([1, 2, 3])}
    jnet = JaxNetSearch(SearchCfg(**search), init_dict, task="vgd")
    swant = jax.jit(lambda p, i: jnet.apply(p, None, jb, i))(
        to_jax_params(snet), {c: jnp.asarray(v, jnp.int32) for c, v in sidx.items()})
    with torch.no_grad():
        for got, w in ((net(tb), want), (snet(tb, None, sidx), swant)):
            for g, x in zip(got, w):
                np.testing.assert_allclose(g.numpy(), np.asarray(x), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("task, flags, refused", [
    ("vqa", ["--DEVICE_REL", "--SHIP_INT8"], None),
    ("vqa", ["--SHIP_INT8"], "SHIP_INT8"),
    ("vqa", ["--SYNTH", "--DEVICE_REL", "--SHIP_INT8"], "SHIP_INT8"),
    ("vgd", ["--DEVICE_REL", "--SHIP_INT8"], "SHIP_INT8"),
    ("itm", ["--DEVICE_REL"], "DEVICE_REL"),
], ids=["vqa-whole-batch", "vqa-int8-alone", "vqa-synth-int8", "vgd-int8", "itm-device-rel"])
def test_flags_refused_where_nothing_reads_them(task, flags, refused):
    args = make_arg_parser(task).parse_args(["--RUN", "train", "--SEED", "0", *flags])
    if refused is None:
        cfg = cfg_from_args(task, args)
        assert cfg.SHIP_INT8 and cfg.DEVICE_REL
        # a dataset without the whole-batch path (here the synthetic one) is refused
        small = PortCfg(FRCNFEAT_LEN=6, FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=8, MAX_TOKEN=5,
                        DEVICE_REL=True, SHIP_INT8=True)
        with pytest.raises(ValueError, match="whole-batch VQA loader"):
            Execution(small, torch.device("cpu")).make_loader(
                SynthVqaDataset(small, size=2, seed=0), 2)
    else:
        with pytest.raises(ValueError, match=refused):
            cfg_from_args(task, args)


def test_profile_writes_a_trace(tmp_path):
    cfg = PortCfg(TASK="vqa", SYNTH=True, SYNTH_SIZE=4, HSIZE=64, ATTFLAT_OUT_SIZE=64,
                  ATTFLAT_MLP_SIZE=16, REL_SIZE=4, FRCNFEAT_LEN=6, FRCNFEAT_SIZE=16,
                  WORD_EMBED_SIZE=8, MAX_TOKEN=5, BATCH_SIZE=2, NUM_WORKERS=1, MAX_EPOCH=1,
                  RUN_MODE="train", PROFILE=True, VERSION="prof", DEVICE_REL=True,
                  ARCH_PATH=str(tmp_path / "arch.json"), LOG_ROOT=str(tmp_path / "log"),
                  CKPT_ROOT=str(tmp_path / "ck"))
    (tmp_path / "arch.json").write_text(json.dumps({"epoch0": GENE}))
    Execution(cfg, torch.device("cpu")).run()
    trace = tmp_path / "log" / "profile_prof" / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("fused_attention" in str(ev.get("name", "")) or "aten::" in str(ev.get("name", ""))
               for ev in events)
