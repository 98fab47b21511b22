"""--REMAT in the port, on the CPU: rematerializing changes nothing that a
step computes.

The JAX package checkpoints each candidate op of the 'full' program
(mmnas_tpu/models/supernet.py:216-242), and its recompute replays the
first pass's dropout keys. The port's `primitives.remat` wraps each
candidate op of NetSearch's 'full' program in torch.utils.checkpoint; the
recompute draws the first pass's masks from a generator of its own set to
the caller's state at the op's entry (eagerly) or from the first pass's
kept draws (`DrawTape`, under CUDA-graph capture, where a generator's state
cannot be read). The 'full' alpha and parameter gradients under REMAT are
held to the JAX package's in tests/test_torch_supernet.py and
tests/test_torch_weight_programs.py; here, at DROPOUT_R 0.1:

- the --DENSE_WEIGHT weight step's and the 'full' arch step's loss, every
  gradient and the generator's state after the step are those without
  REMAT, to the bit, on both of the recompute's draw sources;
- a search epoch with REMAT is the one without: paths, params, optimizer
  states and alpha to the bit, the genotype archive's bytes;
- the fixed net takes REMAT and computes what it computes without, outputs
  and gradients to the bit (its RSA chain runs in the attention kernel
  from the raw geometry: nothing is left to rematerialize);
- every engine, fixed net and search for each task, builds its net under
  REMAT."""

import numpy as np
import pytest
import torch

from mmnas_tpu_torch.config import Cfg, SearchCfg
from mmnas_tpu_torch.data.loader import _stack
from mmnas_tpu_torch.data.synth import SynthVgdDataset, SynthVqaDataset
from mmnas_tpu_torch.engine import itm, search, search_itm, search_vgd, vgd, vqa
from mmnas_tpu_torch.engine.vqa import batch_to_device
from mmnas_tpu_torch.models.net import NetFull
from mmnas_tpu_torch.models.supernet import CELLS, NetSearch
from mmnas_tpu_torch.ops import primitives as P

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

WIDTHS = dict(HSIZE=64, ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=16, REL_SIZE=8, FRCNFEAT_LEN=8,
              FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=10, MAX_TOKEN=6, DROPOUT_R=0.1, SYNTH=True,
              SEED=7)
SEARCH = dict(WIDTHS, TASK="vqa", NODES=(("enc", 2), ("dec", 3)))
GENOTYPE = {"enc": [["self_att_64"], ["feed_forward"]],
            "dec": [["rel_self_att_64"], ["guided_att_64"], ["feed_forward"]]}


def step(remat: bool, kind: str):
    """(loss, {name: gradient}, the generator's state after) of one 'full'
    step in train mode: the weight step's parameter gradients or the arch
    step's alpha gradients."""
    cfg = SearchCfg(**dict(SEARCH, REMAT=remat))
    ds = SynthVqaDataset(cfg, size=4, seed=1)
    net = NetSearch(cfg, {"token_size": ds.token_size, "ans_size": ds.ans_size})
    batch = batch_to_device(_stack([ds[i] for i in range(4)]), torch.device("cpu"),
                            ("ques_ix", "frcn_feat", "bbox_feat", "rel_img", "rel_ques"))
    r = np.random.RandomState(2)
    alpha = {c: torch.from_numpy(r.randn(*a.shape).astype(np.float32))
             for c, a in net.init_alpha().items()}
    idx = {"enc": np.array([0, 1]), "dec": np.array([1, 2, 3])}
    g = torch.Generator().manual_seed(11)
    if kind == "arch":
        leaves = {c: a.requires_grad_() for c, a in alpha.items()}
        out = net(batch, leaves, idx, mode="full", train=True, generator=g)
        names, wrt = list(CELLS), [leaves[c] for c in CELLS]
    else:
        out = net(batch, alpha, idx, mode="full", train=True, generator=g)
        names, wrt = zip(*net.named_parameters())
    loss = (out ** 2).sum()
    grads = torch.autograd.grad(loss, wrt, allow_unused=True)
    return loss, dict(zip(names, grads)), g.get_state()


@pytest.mark.parametrize("kind", ["weight", "arch"])
@pytest.mark.parametrize("draws", ["generator_state", "kept_draws"])
def test_remat_step_is_the_plain_step_to_the_bit(kind, draws, monkeypatch):
    want = step(False, kind)
    if draws == "kept_draws":   # the path taken under CUDA-graph capture
        monkeypatch.setattr(P, "_capturing", lambda generator: True)
    got = step(True, kind)
    assert torch.equal(got[0], want[0])
    assert list(got[1]) == list(want[1])
    for n, g in got[1].items():
        assert (g is None) == (want[1][n] is None), n
        if g is not None:
            assert torch.equal(g, want[1][n]), n
    assert torch.equal(got[2], want[2])        # the generator is where one pass leaves it


def test_recompute_draws_the_first_pass_masks_and_spares_the_caller():
    """A checkpointed dropout: the recompute's mask is the first pass's (the
    gradient is the mask), and the caller's generator advances once."""
    x = torch.ones(1000, requires_grad=True)
    g = torch.Generator().manual_seed(4)
    out = P.remat(lambda t, gen: P.dropout(t, 0.5, True, gen) * 3.0, g, x)
    after = g.get_state()
    (grad,) = torch.autograd.grad(out.sum(), [x])
    torch.testing.assert_close(grad, out.detach())         # 6 where kept, 0 where dropped
    assert 0 < int((grad == 0).sum()) < 1000
    assert torch.equal(g.get_state(), after)
    plain = P.dropout(x, 0.5, True, torch.Generator().manual_seed(4)) * 3.0
    assert torch.equal(out, plain)


def test_search_epoch_with_remat_is_the_epoch_without(tmp_path):
    runs = {}
    for remat in (False, True):
        d = str(tmp_path / str(remat))
        cfg = SearchCfg(**dict(SEARCH, SYNTH_SIZE=40, BATCH_SIZE=8, MAX_EPOCH=1, ALPHA_START=0,
                               ALPHA_EVERY=2, DENSE_WEIGHT_STEP=True, REMAT=remat,
                               EVAL_EVERY_EPOCH=False, NUM_WORKERS=1, VERSION="remat",
                               CKPT_ROOT=d, ARCH_ROOT=d, LOG_ROOT=d))
        result = search.SearchExecution(cfg, torch.device("cpu")).run()
        runs[remat] = (result, (tmp_path / str(remat) / "remat.json").read_bytes())
    (want, want_archive), (got, got_archive) = runs[False], runs[True]
    assert repr(got.paths) == repr(want.paths) and len(got.paths) == 6
    assert got_archive == want_archive
    for (n, p), q in zip(got.net.named_parameters(), want.net.parameters()):
        assert torch.equal(p, q), n
    for key in ("m", "v"):
        for n, t in got.opt_state[key].items():
            assert torch.equal(t, want.opt_state[key][n]), n
        for c in CELLS:
            assert torch.equal(got.alpha_state[key][c], want.alpha_state[key][c])
    for c in CELLS:
        assert torch.equal(got.alpha[c], want.alpha[c])
    assert got.step_losses == want.step_losses


@pytest.mark.parametrize("task", ["vqa", "vgd", "itm"])
def test_fixed_net_under_remat_is_the_net_without(task):
    extra = {"MAX_TOKEN": 8} if task == "itm" else {}
    outs = {}
    for remat in (False, True):
        cfg = Cfg(**dict(WIDTHS, TASK=task, REMAT=remat, **extra))
        ds = (SynthVgdDataset if task == "vgd" else SynthVqaDataset)(cfg, size=4, seed=1)
        net = NetFull(cfg, GENOTYPE, {"token_size": ds.token_size, "ans_size": ds.ans_size},
                      task=task)
        batch = {k: torch.from_numpy(v) for k, v in _stack([ds[i] for i in range(4)]).items()}
        g = torch.Generator().manual_seed(5)
        out = net(batch, train=True, generator=g)
        out = torch.cat([o.reshape(-1) for o in (out if isinstance(out, tuple) else (out,))])
        names, leaves = zip(*net.named_parameters())
        grads = torch.autograd.grad((out ** 2).sum(), leaves, allow_unused=True)
        outs[remat] = (out, dict(zip(names, grads)), g.get_state())
    (out, grads, state), (r_out, r_grads, r_state) = outs[False], outs[True]
    assert torch.equal(r_out, out) and torch.equal(r_state, state)
    for n, g in grads.items():
        assert (g is None) == (r_grads[n] is None), n
        if g is not None:
            assert torch.equal(r_grads[n], g), n


@pytest.mark.parametrize("engine", [vqa.Execution, vgd.Execution, itm.Execution,
                                    search.SearchExecution, search_vgd.SearchExecution,
                                    search_itm.SearchExecution],
                         ids=["vqa", "vgd", "itm", "search_vqa", "search_vgd", "search_itm"])
def test_every_engine_builds_its_net_under_remat(engine, tmp_path):
    searching = issubclass(engine, search.SearchExecution)
    task = engine.TASK
    extra = {"MAX_TOKEN": 8, "SYNTH_SIZE": 10} if task == "itm" else {"SYNTH_SIZE": 8}
    if searching:
        cfg = SearchCfg(**dict(SEARCH, TASK=task, REMAT=True, LOG_ROOT=str(tmp_path), **extra))
    else:
        cfg = Cfg(**dict(WIDTHS, TASK=task, REMAT=True, LOG_ROOT=str(tmp_path),
                         ARCH_PATH=f"./arch/mmnas_{task}.json", **extra))
    ex = engine(cfg, torch.device("cpu"))
    dataset = ex.build_dataset() if searching else ex.build_dataset("train")
    net = ex.build_net(dataset)
    assert net.cfg.REMAT
