"""The search's switch-free weight-step programs in the port (--DENSE_WEIGHT,
--UNIFIED_WEIGHT, --HYBRID_WEIGHT: NetSearch modes 'full', 'unified',
'hybrid'; ops/modules.py `unified_att_node`) against the JAX package, on the
CPU.

(a) The nets, on tests/test_unified.py's tiny config (HSIZE 64, encoder 3 and
decoder 4 nodes, 12 regions, 6 tokens, batch 4, DROPOUT_R 0) with the JAX
init's weights (`from_jax_params`): the port's 'unified' and 'hybrid'
forwards equal the JAX package's same modes and the port's 'sampled' one on
the five forced index sets of tests/test_unified.py and three draws (1e-5);
their gradients at enc [0, 1, 0], dec [1, 2, 3, 0] equal JAX's leaf by leaf
(1e-4), and an unsampled candidate's are exactly 0.
(b) The engine: one short VQA search epoch a flag (4 weight steps, 2 'full'
arch steps) from tests/test_torch_search_engine.py's start, the JAX engine
replaying the port's paths; params, net_optim, alpha and alpha_optim agree
to 1e-5 (the AttFlat glimpse biases to Adam's step, as there). KPATH 2 with
a flag raises. Under bfloat16 every kernel call and every Linear of each
program runs in bf16, on contiguous operands.
(c) VGD and ITM: a --UNIFIED_WEIGHT weight step equals the sampled one (the
loss and Adam's first moments, the clipped gradient), port with port.
(d) torch.export of a unified decoder node, its index an input tensor, is
one program with one attention op that gives each candidate's eager output
at indices 0-3: the node reads no index on the host.
(e) The native IoU builds once when a loader's threads reach it together
(native/build.py), as the VGD search's do."""

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
from mmnas_tpu_torch.engine.search import SearchExecution
from mmnas_tpu_torch.engine.search_itm import SearchExecution as ItmSearchExecution
from mmnas_tpu_torch.engine.search_vgd import SearchExecution as VgdSearchExecution
from mmnas_tpu_torch.engine.vqa import batch_to_device
from mmnas_tpu_torch.models.convert import from_jax_params, to_jax_params
from mmnas_tpu_torch.models.net import INPUT_KEYS, apply_stem
from mmnas_tpu_torch.models.supernet import NetSearch
from mmnas_tpu_torch.ops import attention as ATT
from mmnas_tpu_torch.ops import modules as M
from mmnas_tpu_torch.train.optimizer import build_net_optimizer
from mmnas_tpu_torch.tools.export_serving import attention_nodes

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_search_engine import SMALL, load_pickle, run_jax_replaying
from test_torch_search_engine import assert_checkpoints_agree

TINY = dict(TASK="vqa", HSIZE=64, ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=16, REL_SIZE=8,
            FRCNFEAT_LEN=12, FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=10, MAX_TOKEN=6,
            NODES=(("enc", 3), ("dec", 4)), DROPOUT_R=0.0, SYNTH=True)
V, A = 30, 8
# tests/test_unified.py's index sets: every op of both spaces, alone and mixed
FORCED = [("all_self", [0, 0, 0], [0, 0, 0, 0]), ("all_ff", [1, 1, 1], [3, 3, 3, 3]),
          ("all_rel", [0, 1, 0], [1, 1, 1, 1]), ("all_guided", [1, 0, 1], [2, 2, 2, 2]),
          ("mixed", [0, 1, 0], [0, 1, 2, 3])]
GRAD_IDX = {"enc": np.array([0, 1, 0]), "dec": np.array([1, 2, 3, 0])}
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
FLAGS = {"DENSE_WEIGHT_STEP": "full", "UNIFIED_WEIGHT_STEP": "unified",
         "HYBRID_WEIGHT_STEP": "hybrid"}


def jnp_idx(idx):
    return {c: jnp.asarray(v, jnp.int32) for c, v in idx.items()}


def index_sets():
    """The forced sets and three uniform draws, by name."""
    sets = {name: {"enc": np.array(e), "dec": np.array(d)} for name, e, d in FORCED}
    r = np.random.RandomState(11)
    for k in range(3):
        sets[f"draw{k}"] = {"enc": r.randint(0, 2, size=3), "dec": r.randint(0, 4, size=4)}
    return sets


INDEX_SETS = index_sets()


# ------------------------------------------------------------------ (a) nets
@pytest.fixture(scope="module")
def nets():
    cfg = SearchCfg(**TINY)
    ds = SynthVqaDataset(cfg, size=8, token_size=V, ans_size=A, seed=0)
    init_dict = {"token_size": V, "ans_size": A, "pretrained_emb": ds.pretrained_emb}
    jnet = JaxNetSearch(cfg, init_dict)
    params = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0)))
    net = NetSearch(PortSearchCfg(**TINY), init_dict)
    net.load_state_dict(from_jax_params(params), strict=True)
    batch = _stack([ds[i] for i in range(4)])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    alpha = jnet.init_alpha()
    modes = ("unified", "hybrid")
    # one program for both modes' forwards, one for both gradients
    apply = jax.jit(lambda i: [jnet.apply(params, alpha, jb, i, mode=m) for m in modes])
    want = {}
    for name, idx in INDEX_SETS.items():
        for mode, out in zip(modes, apply(jnp_idx(idx))):
            want[(mode, name)] = np.asarray(out)

    def loss(p, mode):
        return jnp.sum(jnp.square(jnet.apply(p, alpha, jb, jnp_idx(GRAD_IDX), mode=mode)))

    grads = jax.jit(lambda p: [jax.grad(loss)(p, m) for m in modes])(params)
    grads = dict(zip(modes, jax.tree_util.tree_map(np.asarray, grads)))
    return net, {k: torch.from_numpy(v) for k, v in batch.items()}, want, grads


@pytest.mark.parametrize("name", list(INDEX_SETS))
def test_unified_and_hybrid_forwards_match_jax_and_the_sampled_path(nets, name):
    net, batch, want, _ = nets
    idx = INDEX_SETS[name]
    with torch.no_grad():
        sampled = net(batch, None, idx, mode="sampled").numpy()
        for mode in ("unified", "hybrid"):
            got = net(batch, None, idx, mode=mode).numpy()
            assert got.shape == (4, A)
            np.testing.assert_allclose(got, want[(mode, name)], rtol=FWD_TOL, atol=FWD_TOL,
                                       err_msg=mode)
            np.testing.assert_allclose(got, sampled, rtol=FWD_TOL, atol=FWD_TOL, err_msg=mode)


@pytest.mark.parametrize("mode", ["unified", "hybrid", "full"])
def test_gradients_match_jax_leaf_by_leaf_and_unsampled_ops_get_zero(nets, mode):
    """'full' runs under REMAT (every candidate op rematerialized): its
    parameter gradients are the sampled path's, which the JAX 'unified'
    gradients are, and its detached inactive branches get none."""
    net, batch, _, jax_grads = nets
    names, leaves = zip(*net.named_parameters())
    if mode == "full":
        alpha = {c: torch.randn(len(i), 2 if c == "enc" else 4, generator=torch.Generator()
                                .manual_seed(3)) for c, i in GRAD_IDX.items()}
        net.cfg = PortSearchCfg(**dict(TINY, REMAT=True))
        try:
            out = net(batch, alpha, GRAD_IDX, mode=mode)
        finally:
            net.cfg = PortSearchCfg(**TINY)
    else:
        out = net(batch, None, GRAD_IDX, mode=mode)
    grads = torch.autograd.grad((out ** 2).sum(), leaves, allow_unused=True)
    got = {n: torch.zeros_like(p) if g is None else g for n, p, g in zip(names, leaves, grads)}
    want = jax_grads["unified" if mode == "full" else mode]
    tree = to_jax_params(net, got)
    paths = jax.tree_util.tree_leaves_with_path(tree)
    assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want)
    for (path, a), b in zip(paths, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, b, rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    # an unsampled candidate's gradient is exactly 0: the decoder's in
    # 'unified' and 'full', the encoder's in all (node 0 of each cell shown
    # by name)
    unsampled = [("enc", ni, 1 - int(i)) for ni, i in enumerate(GRAD_IDX["enc"])]
    if mode != "hybrid":
        unsampled += [("dec", ni, j) for ni, i in enumerate(GRAD_IDX["dec"]) for j in range(4)
                      if j != i]
    for cell, ni, j in unsampled:
        for n, g in got.items():
            if n.startswith(f"{cell}.{ni}.{j}."):
                assert float(g.abs().max()) == 0.0, n


# ---------------------------------------------------------------- (b) engine
@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """tests/test_torch_search_engine.py's epoch-0 start, saved by the JAX
    package: a seeded port init, a perturbed alpha, both optimizers' states."""
    from mmnas_tpu.train.checkpoint import save_checkpoint
    from mmnas_tpu.train.optimizer import build_net_optimizer as jax_net_optimizer
    from mmnas_tpu.train.optimizer import plain_adam

    tmp = tmp_path_factory.mktemp("weight_programs")
    jcfg = SearchCfg(**SMALL)
    ds = SynthVqaDataset(jcfg, size=jcfg.SYNTH_SIZE, seed=jcfg.SEED)
    init_dict = {"token_size": ds.token_size, "ans_size": ds.ans_size,
                 "pretrained_emb": ds.pretrained_emb}
    params = to_jax_params(NetSearch(PortSearchCfg(**dict(SMALL, SEED=5)), init_dict))
    r = np.random.RandomState(6)
    alpha = {c: np.asarray(a) + r.randn(*np.shape(a)).astype(np.float32) * 0.5
             for c, a in JaxNetSearch(jcfg, init_dict).init_alpha().items()}
    aoptim = plain_adam(jcfg.ALPHA_LR_BASE, jcfg.ALPHA_OPT_BETAS, eps=1e-8)
    save_checkpoint(str(tmp / "epoch0.pkl"), {
        "state_dict": params, "net_optim": jax_net_optimizer(jcfg, 4).init(params),
        "alpha": alpha, "alpha_optim": aoptim.init(alpha), "epoch": 0})
    return tmp


@pytest.mark.parametrize("flag", list(FLAGS))
def test_search_epoch_matches_jax(start, flag):
    tmp = start

    def dirs(pkg):
        return dict(SMALL, **{flag: True}, MAX_EPOCH=1, KPATH=1, ALPHA_BINARY_MODE="full",
                    EVAL_EVERY_EPOCH=False, RESUME=True, CKPT_FILE_PATH=str(tmp / "epoch0.pkl"),
                    CKPT_ROOT=str(tmp / flag / pkg), ARCH_ROOT=str(tmp / flag / pkg / "arch"),
                    LOG_ROOT=str(tmp / flag / pkg / "log"))

    port = SearchExecution(PortSearchCfg(**dirs("port")), torch.device("cpu")).run()
    assert [k for k, _, _ in port.paths] == ["weight", "weight", "arch"] * 2
    with pytest.MonkeyPatch.context() as m:
        run_jax_replaying(SearchCfg(**dirs("jax")), port.paths, m)
    name = "parity-search_epoch1.pkl"
    got, want = load_pickle(tmp / flag / "port" / name), load_pickle(tmp / flag / "jax" / name)
    assert_checkpoints_agree(got, want)
    assert int(got["net_optim"]["step"]) == 4 and int(got["alpha_optim"]["step"]) == 2


@pytest.mark.parametrize("flag", list(FLAGS))
def test_kpath_above_one_needs_the_sampled_program(flag):
    with pytest.raises(ValueError, match="KPATH > 1 requires the sampled weight step"):
        SearchExecution(PortSearchCfg(**dict(SMALL, **{flag: True}, KPATH=2)), "cpu")


def test_orbax_still_raises_naming_the_roadmap(tmp_path):
    """The orbax checkpoint backend is still to port: the search and the
    checkpoint reader refuse it. REMAT and SCAN_STEPS, refused before, are
    taken."""
    from mmnas_tpu_torch.train.checkpoint import load_checkpoint

    NetSearch(PortSearchCfg(**dict(TINY, REMAT=True)), {"token_size": V})
    SearchExecution(PortSearchCfg(**dict(SMALL, SCAN_STEPS=2)), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        SearchExecution(PortSearchCfg(**dict(SMALL, CKPT_BACKEND="orbax")), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        load_checkpoint(str(tmp_path / "epoch1.orbax"))


@pytest.mark.parametrize("flag", list(FLAGS))
def test_bf16_programs_compute_every_branch_in_bf16(flag, monkeypatch):
    # two heads, so that a [B,H,L,L] operand's layout shows in is_contiguous()
    cfg = PortSearchCfg(**dict(SMALL, **{flag: True}, DTYPE="bfloat16", DROPOUT_R=0.1,
                               HSIZE=128))
    exe = SearchExecution(cfg, torch.device("cpu"))
    ds = exe.build_dataset()
    net = exe.build_net(ds)
    seen, laid_out = [], []
    attention = ATT.fused_attention

    def recording(q, k, v, mask=None, log_bias=None, **kw):
        seen.append(("attention", q.dtype, k.dtype, v.dtype,
                     None if log_bias is None else log_bias.dtype))
        # the kernels take contiguous operands only
        laid_out.append(all(t is None or t.is_contiguous() for t in (q, k, v, mask, log_bias)))
        return attention(q, k, v, mask, log_bias, **kw)

    monkeypatch.setattr(ATT, "fused_attention", recording)
    hooks = [mod.register_forward_pre_hook(
        lambda mod, args: seen.append(("linear", args[0].dtype, mod.weight.dtype)))
        for mod in net.modules() if isinstance(mod, torch.nn.Linear)]
    masters = dict(net.named_parameters())
    optim = build_net_optimizer(cfg, 4)
    batch = batch_to_device(next(iter(exe.make_loader(ds, list(range(4))))), "cpu",
                            INPUT_KEYS + ("ans",))
    # every op of both spaces on the path; 'full' runs the others too
    idx = {"enc": np.array([1]), "dec": np.array([1, 2])}
    loss, _ = exe.weight_step(net, optim, optim.init(masters), masters, batch, [idx],
                              torch.Generator().manual_seed(0), net.init_alpha())
    for h in hooks:
        h.remove()
    assert torch.isfinite(loss)
    n_att = sum(1 for s in seen if s[0] == "attention")
    # attention calls: 'full' every op's (1 + 2 x 3), 'unified' one a node
    # (1 + 2), 'hybrid' the encoder's and the path's decoder ops (1 + 2)
    assert n_att == (7 if FLAGS[flag] == "full" else 3)
    assert {dt for s in seen for dt in s[1:] if dt is not None} == {torch.bfloat16}, seen
    assert all(laid_out)
    assert all(p.dtype == torch.float32 for p in net.parameters())


# ------------------------------------------------------------- (c) VGD, ITM
@pytest.mark.parametrize("task", ["vgd", "itm"])
def test_vgd_and_itm_unified_step_is_the_sampled_step(task):
    engine = {"vgd": VgdSearchExecution, "itm": ItmSearchExecution}[task]
    # one batch of 4 (ITM's corpus: 5 captions an image)
    kw = dict(SMALL, TASK=task, SYNTH_SIZE=5 if task == "itm" else 4, DROPOUT_R=0.0)
    steps = {}
    for flag in ("UNIFIED_WEIGHT_STEP", None):
        cfg = PortSearchCfg(**dict(kw, **({flag: True} if flag else {})))
        exe = engine(cfg, torch.device("cpu"))
        ds = exe.build_dataset()
        net = exe.build_net(ds)
        masters = dict(net.named_parameters())
        optim = build_net_optimizer(cfg, 1)
        state = optim.init(masters)
        host = next(iter(exe.make_loader(ds, list(range(4)))))
        batch = batch_to_device(host, "cpu", INPUT_KEYS + exe.TARGET_KEYS)
        idx = {"enc": np.array([0]), "dec": np.array([1, 2])}
        loss, _ = exe.weight_step(net, optim, state, masters, batch, [idx],
                                  torch.Generator().manual_seed(0), net.init_alpha())
        steps[flag] = (float(loss), {n: m.clone() for n, m in state["m"].items()})
    (loss_u, m_u), (loss_s, m_s) = steps["UNIFIED_WEIGHT_STEP"], steps[None]
    assert loss_u == pytest.approx(loss_s, rel=1e-5)
    scale = max(float(m.abs().max()) for m in m_s.values())
    for n in m_s:
        torch.testing.assert_close(m_u[n], m_s[n], rtol=1e-4, atol=1e-4 * scale, msg=n)


# --------------------------------------------------------------- (d) export
class DecoderNode(torch.nn.Module):
    """One decoder node of the 'unified' program (`NetSearch._run_unified`)
    with its index as an input tensor."""

    def __init__(self, net):
        super().__init__()
        self.node, self.stem = net.dec[0], net.linear_y_rel

    def forward(self, idx, s, pre, s_mask, pre_mask, raw):
        rel = {"raw": raw, "w1": self.stem.weight, "b1": self.stem.bias}
        att = M.unified_att_node(self.node, idx, s, pre, s_mask, pre_mask, rel)
        ff = self.node[3](s, pre, s_mask, pre_mask, rel)
        return torch.where(idx == 3, ff, att)


def test_export_of_the_unified_node_is_one_program_for_every_index(nets):
    net, batch, _, _ = nets
    with torch.no_grad():
        x, y, x_mask, y_mask, y_rel = apply_stem(net, net.cfg, batch)
        args = (y, x, y_mask, x_mask, y_rel["raw"])
        node = DecoderNode(net).eval()
        program = torch.export.export(node, (torch.tensor(0),) + args)
        assert attention_nodes(program) == 1
        served = program.module()
        for i in range(4):
            want = net.dec[0][i](y, x, y_mask, x_mask, y_rel)
            got = served(torch.tensor(i), *args)
            torch.testing.assert_close(got, want, rtol=FWD_TOL, atol=FWD_TOL, msg=str(i))


# ------------------------------------------------------ (e) the native IoU
def test_native_iou_builds_once_under_concurrent_first_use(tmp_path, monkeypatch):
    """The VGD search's loader threads reach the IoU's first use together:
    each gets the built library, none a failure (which `utils/bbox.py`
    would keep, sending the process to the numpy path)."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from mmnas_tpu_torch.native import build as NB

    monkeypatch.setattr(NB, "LIB", tmp_path / "libbbox.so")
    start = threading.Barrier(8)

    def first_use(_):
        start.wait(timeout=60)
        return NB.build()

    with ThreadPoolExecutor(8) as pool:
        paths = list(pool.map(first_use, range(8), timeout=300))
    assert paths == [str(tmp_path / "libbbox.so")] * 8
    assert sorted(p.name for p in tmp_path.iterdir()) == ["libbbox.so"]
