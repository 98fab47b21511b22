"""The port's accuracy rehearsal (mmnas_tpu_torch/tools/rehearsal.py,
xmodal_contract.py, make_glove_cache.py) against the JAX package's tools.

(a) For each runner and each flag that changes a runner's configuration,
the port's tool builds the same `Cfg` / `SearchCfg` sequence as the JAX
tool for the same arguments, field for field: both packages' engines are
replaced by stand-ins that record the configuration they receive and return
fixed results. The xmodal contract's search and arm configurations equal
those of tools/debug/_xmodal_k1_search_only.py and
_xmodal_k1_train_contract.py.
(b) `run_vqa` at HSIZE 64, fp32, one epoch, DROPOUT_R 0, on a reduced
corpus (make_rehearsal_data.gen_vqa, 128 train / 32 val questions), from the
JAX runner's initial parameters (carried across by models/convert.py):
the epoch's loss to 1e-5 and the VQAEval value equal. HSIZE 64 is the least
width at which arch/mcan.json's 64-wide heads exist in either package.
(c) The evidence writer: with the same stand-ins, each task's file has the
JAX tool's keys and the port's stated extras, under the JAX file's name with
`rehearsal_` made `rehearsal_torch_` (so `_cpu` on the CPU); no JAX name is
written; the cross-modal decoder ops are counted from the genotypes.
(d) In a fresh interpreter, the tool's CPU run of vqa (one epoch, HSIZE 64)
on the reduced corpus loads no module of jax or of the JAX package.
(e) The port's copy of the GloVe stub writes the JAX tool's files bit for
bit.
(f) `rsa_conditioning --ckpt --data_root` reads a checkpoint's RSA chains
and a corpus's relation inputs."""

import dataclasses
import importlib.util
import json
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import mmnas_tpu.engine.itm as jax_itm
import mmnas_tpu.engine.search as jax_search
import mmnas_tpu.engine.search_itm as jax_search_itm
import mmnas_tpu.engine.search_vgd as jax_search_vgd
import mmnas_tpu.engine.vgd as jax_vgd
import mmnas_tpu.engine.vqa as jax_vqa
from mmnas_tpu.models.net import NetFull as JaxNetFull
from mmnas_tpu_torch.genotype import load_genotype
from mmnas_tpu_torch.tools import make_glove_cache as port_glove
from mmnas_tpu_torch.tools import rehearsal as RH
from mmnas_tpu_torch.tools import xmodal_contract as XC
from mmnas_tpu_torch.train.checkpoint import load_params

from _torch_threads import one_thread_env, one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]


def load_tool(rel):
    """A script of tools/ as a module (they are not a package)."""
    spec = importlib.util.spec_from_file_location(Path(rel).stem.lstrip("_"), ROOT / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_RH = load_tool("tools/rehearsal.py")
MAKE_DATA = load_tool("tools/make_rehearsal_data.py")

GENO = {"enc": [["self_att_64"], ["feed_forward"]],
        "dec": [["guided_att_64"], ["rel_self_att_64"], ["guided_att_64"], ["feed_forward"]]}
STATS = {f"{d}_{k}": 50.0 for d in ("i2t", "t2i") for k in ("r1", "r5", "r10", "medr", "meanr")}


class FakeData(list):
    CAPS_PER_IMG = 5


class FakeNet:
    def genotype(self, alpha):
        return GENO


def fake_engines(record, port):
    """(Execution, SearchExecution) stand-ins that append ("train" |
    "search", asdict(cfg)) to `record` and return fixed results in the
    package's own types."""
    class Execution:
        def __init__(self, cfg, device=None):
            record.append(("train", dataclasses.asdict(cfg)))
            self.cfg, self.device = cfg, torch.device("cpu")

        def build_dataset(self, split):
            return FakeData(range(20))

        def make_loader(self, dataset, *args, **kw):
            return dataset

        def train(self, loader):
            losses = [2.0, 1.0]
            return SimpleNamespace(net=None, epoch_losses=losses) if port else (None, None, losses)

        def eval(self, loader, net=None, params=None, valid=False):
            acc = {"vqa": 0.5, "vgd": 50.0, "itm": None}[self.cfg.TASK]
            return SimpleNamespace(accuracy=acc, stats=dict(STATS)) if port else (
                acc if self.cfg.TASK != "itm" else dict(STATS))

    class SearchExecution:
        def __init__(self, cfg, device=None):
            record.append(("search", dataclasses.asdict(cfg)))
            self.device = torch.device("cpu")

        def run(self):
            if port:
                return SimpleNamespace(net=FakeNet(), alpha_host=None, step_losses=[1.0] * 4,
                                       epoch_losses=[2.0, 1.0])
            return None, None, FakeNet()

    return Execution, SearchExecution


def run_both(monkeypatch, tmp_path, argv):
    """Both tools' main(argv) on the stand-ins: (the JAX configs, the port's,
    the JAX evidence file, the port's, the files each wrote)."""
    monkeypatch.chdir(ROOT)
    jax_record, port_record = [], []
    jx, js = fake_engines(jax_record, port=False)
    px, ps = fake_engines(port_record, port=True)
    for module in (jax_vqa, jax_vgd, jax_itm):
        monkeypatch.setattr(module, "Execution", jx)
    for module in (jax_search, jax_search_vgd, jax_search_itm):
        monkeypatch.setattr(module, "SearchExecution", js)
    for name in ("VqaExecution", "VgdExecution", "ItmExecution"):
        monkeypatch.setattr(RH, name, px)
    for name in ("VqaSearchExecution", "VgdSearchExecution", "ItmSearchExecution"):
        monkeypatch.setattr(RH, name, ps)
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    monkeypatch.setattr(JAX_RH, "EVIDENCE_DIR", str(jax_dir))
    monkeypatch.setattr(RH, "EVIDENCE_DIR", str(port_dir))
    monkeypatch.setattr(sys, "argv", ["tools/rehearsal.py", *argv])
    JAX_RH.main()
    RH.main([*argv, "--device", "cpu"])
    jax_files, port_files = sorted(jax_dir.iterdir()), sorted(port_dir.iterdir())
    return jax_record, port_record, jax_files, port_files


ITM_FLAGS = ["--itm_lr", "0.00003", "--itm_decay_at", "15", "--itm_decay_r", "5",
             "--itm_mine_from", "25"]
CASES = {
    "vqa": ["--task", "vqa", "--epochs", "20"],
    "vqa_hsize": ["--task", "vqa", "--epochs", "1", "--hsize", "64"],
    "vgd": ["--task", "vgd", "--epochs", "8", "--scaled"],
    "vgd_lr_tag": ["--task", "vgd", "--epochs", "16", "--vgd_lr", "0.0003",
                   "--evidence_tag", "ep16"],
    "itm_defaults": ["--task", "itm", "--epochs", "30"],
    "itm": ["--task", "itm", "--epochs", "40", *ITM_FLAGS],
    "itm_noise_q": ["--task", "itm", "--epochs", "30", *ITM_FLAGS, "--itm_noise_q", "0.3",
                    "--scaled"],
    "itm_skiptop": ["--task", "itm", "--epochs", "30", *ITM_FLAGS, "--itm_mine_skiptop", "1"],
    "itm_margin_semihard": ["--task", "itm", "--epochs", "6", "--itm_loss", "margin",
                            "--itm_semihard"],
    "search_vqa": ["--task", "search_vqa", "--epochs", "13"],
    "search_vqa_kpath8": ["--task", "search_vqa", "--epochs", "13", "--search_kpath", "8"],
    "search_vqa_compare": ["--task", "search_vqa", "--epochs", "2", "--search_alpha_mode",
                           "two", "--compare_arch", "./arch/unimodal_dec_none.json",
                           "--hsize", "64"],
    "search_vgd": ["--task", "search_vgd", "--epochs", "13", "--compare_arch",
                   "./arch/unimodal_dec_none.json"],
    "search_itm": ["--task", "search_itm", "--epochs", "40", *ITM_FLAGS],
    "search_itm_variants": ["--task", "search_itm", "--epochs", "20", "--search_alpha_mode",
                            "two", "--itm_mine_skiptop", "2", "--itm_loss", "margin"],
    "search_itm_noise_q": ["--task", "search_itm", "--epochs", "3", "--itm_noise_q", "0.3"],
    "all": ["--task", "all", "--epochs", "3"],
}


def case_argv(tmp_path, name):
    """The case's flags, with --scaled standing for a --data_root whose
    rehearsal_meta.json names the scaled tier."""
    argv = list(CASES[name])
    root = tmp_path / "data"
    root.mkdir()
    if "--scaled" in argv:
        argv.remove("--scaled")
        (root / "rehearsal_meta.json").write_text(json.dumps({"tier": "scaled"}))
    return argv + ["--data_root", str(root)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_runner_configs_equal_the_jax_tools(monkeypatch, tmp_path, case):
    jax_record, port_record, _, _ = run_both(monkeypatch, tmp_path, case_argv(tmp_path, case))
    assert jax_record and len(jax_record) == len(port_record)
    for (jkind, jcfg), (pkind, pcfg) in zip(jax_record, port_record):
        assert jkind == pkind
        assert pcfg == jcfg


@pytest.mark.parametrize("task", ["vqa", "itm"])
def test_runner_overrides_replace_cfg_fields(monkeypatch, tmp_path, task):
    """A runner's `overrides` (how tests/_torch_rehearsal_split.py reaches
    the runners) replace those fields of its Cfg and leave every other;
    `itm_cfg` is run_itm's Cfg."""
    record = []
    execution, _ = fake_engines(record, port=True)
    monkeypatch.setattr(RH, {"vqa": "VqaExecution", "itm": "ItmExecution"}[task], execution)
    runner = {"vqa": RH.run_vqa, "itm": RH.run_itm}[task]
    over = {"DTYPE": "float32", "CKPT_EVERY": 26}
    runner(str(tmp_path), 40, device="cpu")
    runner(str(tmp_path), 40, device="cpu", overrides=over)
    (_, plain), (_, got) = record
    assert plain["DTYPE"] == "bfloat16" and plain["CKPT_EVERY"] == 40
    assert got == dict(plain, **over)
    if task == "itm":
        assert dataclasses.asdict(RH.itm_cfg(str(tmp_path), 40)) == plain


@pytest.mark.parametrize("case", ["vqa", "vgd_lr_tag", "itm_noise_q", "search_vqa_compare",
                                  "search_vgd", "search_itm", "all"])
def test_evidence_has_the_jax_keys_under_a_port_name(monkeypatch, tmp_path, case):
    _, _, jax_files, port_files = run_both(monkeypatch, tmp_path, case_argv(tmp_path, case))
    assert [p.name for p in port_files] == sorted(
        "rehearsal_torch_" + p.name[len("rehearsal_"):] for p in jax_files)
    assert all(p.name.endswith("_cpu.json") for p in port_files)
    for jax_file in jax_files:
        port_file = port_files[0].parent / ("rehearsal_torch_" + jax_file.name[len("rehearsal_"):])
        want, got = json.loads(jax_file.read_text()), json.loads(port_file.read_text())
        extras = set(RH.PORT_KEYS)
        if "search_cfg" in want:
            extras |= set(RH.SEARCH_KEYS)
        if "compare_arch" in want:
            extras |= set(RH.COMPARE_KEYS)
        assert set(got) == set(want) | extras
        for key in set(want) - {"wallclock_s", "provenance", "cfg", "search_cfg", "train_cfg"}:
            assert got[key] == want[key], key
        assert got["provenance"]["backend"] == "cpu" and got["provenance"]["card"] is None
        if "compare_arch" in want:
            assert got["dec_xmodal_ops"] == 2 and got["compare_dec_xmodal_ops"] == 0


def test_evidence_names_and_cross_modal_counts():
    args = RH.make_parser().parse_args(["--task", "itm", "--itm_noise_q", "0.3"])
    jax_tags, port_tags = RH.evidence_tags("itm", args, "_scaled")
    assert RH.evidence_name("itm", jax_tags, port_tags) == "rehearsal_torch_itm_scaled_noiseq0.3.json"
    assert RH.jax_reference("itm", jax_tags)["t2i_r1"] == 46.32     # the lost file's transcript
    ref = RH.jax_reference("vgd", "_scaled")
    assert ref["file"] == "docs/evidence/rehearsal_vgd_scaled.json" and ref["acc_iou0.5_val"] == 81.2
    for argv in (["--device", "cpu"], ["--seed", "45"], ["--arch_path", "arch/mmnas_vqa.json"]):
        args = RH.make_parser().parse_args(["--task", "vqa", *argv])
        name = RH.evidence_name("vqa", *RH.evidence_tags("vqa", args, ""))
        assert name.startswith("rehearsal_torch_vqa") and name != "rehearsal_vqa.json"
    assert RH.evidence_name("vqa", *RH.evidence_tags(
        "vqa", RH.make_parser().parse_args(["--seed", "45", "--device", "cpu"]), "")
    ) == "rehearsal_torch_vqa_seed45_cpu.json"
    assert XC.evidence_path("cpu").endswith(
        "docs/evidence/rehearsal_torch_search_vqa_scaled_xmodal_cpu.json")
    assert RH.dec_xmodal_count(load_genotype(str(ROOT / "arch/unimodal_dec_none.json"))) == 0
    mmnas = load_genotype(str(ROOT / "arch/mmnas_vqa.json"))
    assert RH.dec_xmodal_count(mmnas) == sum(op == "guided_att_64" for node in mmnas["dec"]
                                             for op in node) == 6


def test_tools_refuse_to_run_without_a_card(monkeypatch):
    """No quiet CPU fallback: without a card the tools run only when asked
    for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RH.main(["--task", "vqa"])
    with pytest.raises(RuntimeError, match="CUDA"):
        XC.main([])


def test_xmodal_configs_equal_the_jax_scripts(monkeypatch, tmp_path):
    monkeypatch.chdir(ROOT)
    search_only = load_tool("tools/debug/_xmodal_k1_search_only.py")
    contract = load_tool("tools/debug/_xmodal_k1_train_contract.py")
    record = []

    class Stop(Exception):
        pass

    def stop(cfg):
        record.append(dataclasses.asdict(cfg))
        raise Stop

    monkeypatch.setattr(jax_search, "SearchExecution", stop)
    monkeypatch.setattr(jax_vqa, "Execution", stop)
    with pytest.raises(Stop):
        search_only.main()
    for arm in XC.ARMS:
        monkeypatch.setattr(sys, "argv", ["_xmodal_k1_train_contract.py", "--arm", arm])
        with pytest.raises(Stop):
            contract.main()
    assert record == [dataclasses.asdict(XC.search_cfg(XC.DATA_ROOT))] + [
        dataclasses.asdict(XC.arm_cfg(XC.DATA_ROOT, arch, XC.EPOCHS if searched else 0, version))
        for arch, searched, version in XC.ARMS.values()]


# --------------------------------------------------------------- the runs
@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A reduced rehearsal corpus (VQA 128 train / 32 val questions; small
    VGD and ITM for the GloVe check) with the port's stub GloVe caches."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(7)
    MAKE_DATA.gen_vqa(str(root), rng, n_train=128, n_val=32, n_imgs=16)
    MAKE_DATA.gen_vgd(str(root), rng, n_train=40, n_eval=10, n_imgs=12)
    MAKE_DATA.gen_itm(str(root), rng, n_imgs=40)
    for task in ("vqa", "vgd", "itm"):
        glove(port_glove, task, root)
    return root


def glove(module, task, root):
    argv = sys.argv
    sys.argv = ["make_glove_cache.py", "--task", task, "--data_root", str(root), "--stub"]
    try:
        module.main()
    finally:
        sys.argv = argv


def test_glove_stub_copy_writes_the_jax_tools_files(corpus, tmp_path):
    jax_glove = load_tool("tools/make_glove_cache.py")
    for task in ("vqa", "vgd", "itm"):
        jax_root = tmp_path / task
        (jax_root / "glove").mkdir(parents=True)
        for entry in corpus.iterdir():
            if entry.name != "glove":
                (jax_root / entry.name).symlink_to(entry)
        glove(jax_glove, task, jax_root)
        for suffix in (".vocab.json", ".npy"):
            got = (corpus / "glove" / f"{task}{suffix}").read_bytes()
            assert got == (jax_root / "glove" / f"{task}{suffix}").read_bytes(), task + suffix
    assert len(json.loads((corpus / "glove" / "itm.vocab.json").read_text())) > 3


def zero_dropout(small, one_device):
    """`_small` of a runner module that also sets DROPOUT_R 0 (and N_DEVICES 1
    for the JAX engine on the tests' 8 virtual devices)."""
    def wrapped(cfg, hsize):
        extra = {"N_DEVICES": 1} if one_device else {}
        return small(cfg, hsize).replace(DROPOUT_R=0.0, **extra)
    return wrapped


def test_run_vqa_epoch_matches_the_jax_runner(monkeypatch, corpus, tmp_path):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "arch").symlink_to(ROOT / "arch")
    inits = []
    real_init = JaxNetFull.init

    def recording_init(self, key):
        params = real_init(self, key)
        # a host copy: the train step donates the parameters' device buffers
        inits.append(jax.tree_util.tree_map(np.array, params))
        return params

    monkeypatch.setattr(JaxNetFull, "init", recording_init)
    monkeypatch.setattr(JAX_RH, "_small", zero_dropout(JAX_RH._small, True))
    monkeypatch.setattr(RH, "_small", zero_dropout(RH._small, False))
    want = JAX_RH.run_vqa(str(corpus), 1, hsize=64)
    assert len(inits) == 1

    real_build = RH.VqaExecution.build_net

    def from_jax_init(self, dataset):
        net = real_build(self, dataset)
        load_params(net, inits[0])
        return net

    monkeypatch.setattr(RH.VqaExecution, "build_net", from_jax_init)
    got = RH.run_vqa(str(corpus), 1, hsize=64, device="cpu")
    assert got["cfg"] == want["cfg"]
    assert got["train_loss_per_example"] == pytest.approx(want["train_loss_per_example"], rel=1e-5)
    assert got["value"] == want["value"]
    assert Path(got["checkpoint"]).exists()


def test_cpu_rehearsal_never_loads_jax(corpus, tmp_path):
    (tmp_path / "arch").symlink_to(ROOT / "arch")
    script = textwrap.dedent(f"""
        import json
        import sys
        from mmnas_tpu_torch.tools import rehearsal as RH
        RH.EVIDENCE_DIR = {str(tmp_path / 'evidence')!r}
        [path] = RH.main(["--device", "cpu", "--task", "vqa", "--hsize", "64", "--epochs", "1",
                          "--data_root", {str(corpus)!r}])
        with open(path) as f:
            result = json.load(f)
        assert path.endswith("rehearsal_torch_vqa_cpu.json"), path
        assert result["value"] is not None and len(result["train_loss_per_example"]) == 1
        loaded = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "mmnas_tpu"))
        assert not loaded, loaded
        print("OK")
    """)
    env = dict(one_thread_env(), PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, timeout=120, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().endswith("OK")


def test_rsa_conditioning_reads_a_checkpoint_and_corpus(corpus, tmp_path):
    """`rsa_conditioning --ckpt --data_root`: one row per RSA op of the
    checkpoint, its chain's weights and the corpus's relation inputs (on the
    CPU the kernel's place is the plain version, so the two agree exactly)."""
    from mmnas_tpu_torch.config import Cfg
    from mmnas_tpu_torch.engine.vqa import Execution
    from mmnas_tpu_torch.models.convert import to_jax_params
    from mmnas_tpu_torch.tools import rsa_conditioning
    from mmnas_tpu_torch.train.checkpoint import save_checkpoint

    arch = tmp_path / "arch.json"
    arch.write_text(json.dumps({"epoch0": {"enc": [["self_att_64"]],
                                           "dec": [["rel_self_att_64"], ["guided_att_64"],
                                                   ["rel_self_att_64"]]}}))
    cfg = Cfg(TASK="vqa", DATA_ROOT=str(corpus), ARCH_PATH=str(arch), HSIZE=64,
              ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=64, LOG_ROOT=str(tmp_path / "log"))
    exe = Execution(cfg, torch.device("cpu"))
    net = exe.build_net(exe.build_dataset("val"))
    ckpt = str(tmp_path / "rsa.pkl")
    save_checkpoint(ckpt, {"state_dict": to_jax_params(net), "net_optim": None, "epoch": 1})
    rows = rsa_conditioning.main(["--device", "cpu", "--B", "3", "--ckpt", ckpt,
                                  "--data_root", str(corpus)])
    assert [r["op"] for r in rows] == ["dec.0.0.0.core.wr", "dec.0.2.0.core.wr"]
    want_wr = dict(net.named_parameters())["dec.0.0.0.core.wr.weight"]
    assert all(r["B"] == 3 and r["H"] == want_wr.shape[0] and r["L"] == cfg.FRCNFEAT_LEN
               for r in rows)
    for r in rows:
        assert r["kernel_vs_plain"] == 0.0 and r["plain_vs_fp64"] < 1e-4
        assert 0.0 <= r["pre_below_1e-5_share"] <= 1.0
