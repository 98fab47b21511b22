"""The port stands alone: it imports nothing of the JAX package, and its
copies of the JAX package's numpy-only modules have not drifted.

(a) An AST scan of every module of mmnas_tpu_torch/ and of chip_smoke.py
finds no import of `mmnas_tpu`, `mmnas_tpu.*` or `jax`.
(c) Every function and class the port copied (config, genotype, data,
utils, and the host-side mining and recall functions of the ITM engine,
these up to their docstrings) is the same code as its namesake in the JAX
package, up to the package name in imports and the module docstring; the
one deliberate difference is
`cfg_from_args`, which leaves --MULTIHOST to the port's launcher (the JAX
package initializes jax.distributed there) and refuses a --MODEL_AXIS that
does not divide the world there, as the JAX package's `get_mesh` does.
`eval_dataset_order` of parallel/mesh.py is the JAX package's with the world
size an argument in place of jax.process_count(). The tensor-parallel
rules of parallel/sharding.py (`spec_for_path`, scanned here) are held to
the JAX package's `_spec_for_path` leaf by leaf, on every net, in
tests/test_torch_tensor_parallel.py. The
box helpers' jnp versions are torch twins in the port (held to them in
tests/test_torch_vgd.py), and the native C++ IoU is the same file byte for
byte. The two `Cfg`s agree field for field, and the two packages'
`SynthVqaDataset`s, `SynthVgdDataset`s and `SynthItmDataset`s give
identical items for one seed (ITM's train items with their negatives, after
the epoch's draw). The port's tools copy scripts of tools/: all of
make_glove_cache.py, and the rehearsal's knob and scaling helpers and the
cross-modal op count (tools/rehearsal.py, tools/debug/_xmodal_k1_search_only.py);
each is held to its script. Exact comparisons: these are copies."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import mmnas_tpu.config as jax_config
from mmnas_tpu.data.synth import SynthItmDataset as JaxSynthItmDataset
from mmnas_tpu.data.synth import SynthVgdDataset as JaxSynthVgdDataset
from mmnas_tpu.data.synth import SynthVqaDataset as JaxSynthVqaDataset
import mmnas_tpu_torch.config as port_config
from mmnas_tpu_torch.data.synth import SynthItmDataset, SynthVgdDataset, SynthVqaDataset

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "mmnas_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

COPIES = ["config.py", "genotype.py", "data/sampler.py", "data/loader.py", "data/synth.py",
          "data/vqa.py", "data/vocab.py", "data/paths.py", "data/packed.py",
          "data/relations.py", "data/vgd.py", "data/itm.py", "utils/answer_norm.py",
          "utils/vqa_eval.py", "utils/bbox.py", "utils/bbox_transform.py"]
# modules of which the port copied some functions, beside its own code
PARTIAL_COPIES = {"engine/itm.py": [
    "draw_candidates", "_semihard_mask", "mine_sweep", "mine_sweep_blocked", "_noise_suspects",
    "_randomize_suspect_negs", "run_mine_sweeps", "positive_scores", "positive_scores_blocked",
    "score_matrix_sweep", "recall_metrics"]}
CHANGED = {("config.py", "cfg_from_args")}
# functions copied with a value the JAX package reads from jax made an
# argument: (module, name) -> (the JAX package's expression, the argument)
PARAMETERISED = {("parallel/mesh.py", "eval_dataset_order"): ("jax.process_count()", "world")}
# the port's torch versions in place of the JAX package's jnp ones
TWINS = {("utils/bbox.py", "bbox_overlaps_torch"): "bbox_overlaps_jnp",
         ("utils/bbox_transform.py", "bbox_transform_inv_torch"): "bbox_transform_inv_jnp",
         ("utils/bbox_transform.py", "clip_boxes_torch"): "clip_boxes_jnp",
         ("data/relations.py", "relation_embedding_torch"): "relation_embedding_jnp"}


# scripts of tools/ the port's tools copied: (port module, script, the
# top-level functions and constants copied; None: every function)
TOOL_COPIES = [("tools/make_glove_cache.py", "tools/make_glove_cache.py", None),
               ("tools/rehearsal.py", "tools/rehearsal.py", ["_knobs", "_small"]),
               ("tools/rehearsal.py", "tools/debug/_xmodal_k1_search_only.py",
                ["XMODAL_OPS", "dec_xmodal_count"])]


def imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_the_jax_package():
    assert len(PORT_FILES) > 30
    bad = [(str(p.relative_to(ROOT)), m) for p in PORT_FILES for m in imported_modules(p)
           if m.split(".")[0] in ("mmnas_tpu", "jax", "jaxlib")]
    assert bad == []


def top_level_defs(path):
    tree = ast.parse(path.read_text())
    return {n.name: ast.dump(n).replace("mmnas_tpu_torch", "mmnas_tpu") for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("rel", COPIES)
def test_copied_code_has_not_drifted(rel):
    port = top_level_defs(ROOT / "mmnas_tpu_torch" / rel)
    ref = top_level_defs(ROOT / "mmnas_tpu" / rel)
    assert port, rel
    twins = {name: jnp_name for (r, name), jnp_name in TWINS.items() if r == rel}
    assert all(name in port and name not in ref and jnp_name in ref and jnp_name not in port
               for name, jnp_name in twins.items()), rel
    for name, code in port.items():
        if (rel, name) in CHANGED:
            assert code != ref[name]
        elif name not in twins:
            assert code == ref.get(name), f"{rel}: {name} differs from the JAX package's"


def code_without_docstrings(path):
    """Top-level function name -> its AST dump with every docstring removed."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.FunctionDef, ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return {n.name: ast.dump(n) for n in tree.body if isinstance(n, ast.FunctionDef)}


def top_level_code(path):
    """Top-level function, class and single-name assignment -> its AST dump,
    the port's package name made the JAX package's."""
    out = {}
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            out[n.name] = n
        elif isinstance(n, ast.Assign) and len(n.targets) == 1 and isinstance(n.targets[0],
                                                                              ast.Name):
            out[n.targets[0].id] = n
    return {k: ast.dump(n).replace("mmnas_tpu_torch", "mmnas_tpu") for k, n in out.items()}


@pytest.mark.parametrize("rel,script,names", TOOL_COPIES)
def test_copied_tool_code_has_not_drifted(rel, script, names):
    port = top_level_code(ROOT / "mmnas_tpu_torch" / rel)
    ref = top_level_code(ROOT / script)
    if names is None:
        names = [n for n in ref if n in top_level_defs(ROOT / script)]
        assert sorted(names) == sorted(top_level_defs(ROOT / "mmnas_tpu_torch" / rel))
    for name in names:
        assert name in port and port[name] == ref[name], f"{rel}: {name} differs from {script}"


@pytest.mark.parametrize("rel", sorted(PARTIAL_COPIES))
def test_partly_copied_code_has_not_drifted(rel):
    """The code of each copied function is its original's (its docstring
    may say where it sits in the port)."""
    port = code_without_docstrings(ROOT / "mmnas_tpu_torch" / rel)
    ref = code_without_docstrings(ROOT / "mmnas_tpu" / rel)
    for name in PARTIAL_COPIES[rel]:
        assert name in port and port[name] == ref[name], f"{rel}: {name} differs"


@pytest.mark.parametrize("rel,name", sorted(PARAMETERISED))
def test_parameterised_copies_have_not_drifted(rel, name):
    """The port's function is its original with the expression replaced by
    the argument, which the port adds last."""
    expr, arg = PARAMETERISED[(rel, name)]

    class Substitute(ast.NodeTransformer):
        def visit_Call(self, node):
            if ast.unparse(node) == expr:
                return ast.copy_location(ast.Name(id=arg, ctx=ast.Load()), node)
            return self.generic_visit(node)

    def function(path):
        tree = ast.parse(path.read_text())
        fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
        fn.body = fn.body[1:]      # the docstring
        return fn

    port, ref = function(ROOT / "mmnas_tpu_torch" / rel), function(ROOT / "mmnas_tpu" / rel)
    assert [a.arg for a in port.args.args] == [a.arg for a in ref.args.args] + [arg]
    port.args.args.pop()
    ref = Substitute().visit(ref)
    assert ast.dump(port) == ast.dump(ref)


def test_native_iou_source_is_the_jax_packages():
    assert ((ROOT / "mmnas_tpu_torch" / "native" / "bbox.cpp").read_bytes()
            == (ROOT / "mmnas_tpu" / "native" / "bbox.cpp").read_bytes())


def test_cfg_and_synthetic_data_match_the_jax_package():
    for cls in ("Cfg", "SearchCfg"):
        assert (dataclasses.asdict(getattr(port_config, cls)())
                == dataclasses.asdict(getattr(jax_config, cls)()))
    argv = ["--RUN", "train", "--SYNTH", "--SEED", "3", "--BS", "8"]
    for task in ("vqa", "vgd", "itm"):
        want = jax_config.cfg_from_args(task, jax_config.make_arg_parser(task).parse_args(argv))
        got = port_config.cfg_from_args(task, port_config.make_arg_parser(task).parse_args(argv))
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    # --MULTIHOST joins torchrun's group in the launcher, not here;
    # tensor parallelism is taken where the model axis divides the world,
    # refused with the JAX package's words where it does not
    assert port_config.cfg_from_args(
        "vqa", port_config.make_arg_parser("vqa").parse_args(argv + ["--MULTIHOST"])).MULTIHOST
    tp = argv + ["--NDEV", "4", "--MODEL_AXIS", "2"]
    want = jax_config.cfg_from_args("vqa", jax_config.make_arg_parser("vqa").parse_args(tp))
    got = port_config.cfg_from_args("vqa", port_config.make_arg_parser("vqa").parse_args(tp))
    assert dataclasses.asdict(got) == dataclasses.asdict(want) and got.MODEL_AXIS == 2
    for bad in (["--MODEL_AXIS", "2"], ["--NDEV", "3", "--MODEL_AXIS", "2"]):
        with pytest.raises(ValueError, match="not divisible by model_axis 2"):
            port_config.cfg_from_args(
                "vqa", port_config.make_arg_parser("vqa").parse_args(argv + bad))

    cfg = port_config.Cfg(FRCNFEAT_LEN=12, FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=8, MAX_TOKEN=6)
    for port_cls, jax_cls in ((SynthVqaDataset, JaxSynthVqaDataset),
                              (SynthVgdDataset, JaxSynthVgdDataset),
                              (SynthItmDataset, JaxSynthItmDataset)):
        port_ds, jax_ds = port_cls(cfg, size=5, seed=7), jax_cls(cfg, size=5, seed=7)
        if port_cls is SynthItmDataset:
            for ds in (port_ds, jax_ds):     # the epoch folds into the negatives' draw
                ds.set_epoch(2)
                ds.shuffle_neg_idx()
            np.testing.assert_array_equal(port_ds.neg_imgs_idx_tensor, jax_ds.neg_imgs_idx_tensor)
            for got, want in zip(port_ds.get_all_imgs(), jax_ds.get_all_imgs()):
                np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(port_ds.pretrained_emb, jax_ds.pretrained_emb)
        for i in range(len(port_ds)):
            a, b = port_ds[i], jax_ds[i]
            assert a.keys() == b.keys()
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("rel", ["models/supernet.py", "engine/search.py", "search_vqa.py",
                                 "tools/probes.py", "engine/vgd.py", "engine/search_vgd.py",
                                 "train_vgd.py", "search_vgd.py", "native/build.py",
                                 "engine/itm.py", "engine/search_itm.py", "train_itm.py",
                                 "search_itm.py", "utils/itm_loss.py", "data/itm.py",
                                 "parallel/mesh.py", "parallel/__init__.py",
                                 "parallel/sharding.py", "tools/rehearsal.py",
                                 "tools/xmodal_contract.py", "tools/make_glove_cache.py",
                                 "tools/export_serving.py"])
def test_search_and_probe_modules_are_scanned(rel):
    """The search, probe, VGD, ITM and data-parallel slices' modules are
    among the scanned files and import neither package of JAX."""
    path = ROOT / "mmnas_tpu_torch" / rel
    assert path in PORT_FILES
    assert not [m for m in imported_modules(path) if m.split(".")[0] in ("mmnas_tpu", "jax")]


def test_search_space_constants_match_the_jax_package():
    """The supernet's search spaces and alpha init patterns are the JAX
    package's (registry.py:48-51, supernet.py:48-49)."""
    import mmnas_tpu.models.supernet as jax_supernet
    from mmnas_tpu.ops.registry import OPS_ADAPTER
    import mmnas_tpu_torch.models.supernet as port_supernet

    assert port_supernet.SPACES == {"enc": OPS_ADAPTER.Used_OPS["enc_safe"],
                                    "dec": OPS_ADAPTER.Used_OPS["dec_safe"]}
    assert port_supernet._INIT_ENC == jax_supernet._INIT_ENC
    assert port_supernet._INIT_DEC == jax_supernet._INIT_DEC
