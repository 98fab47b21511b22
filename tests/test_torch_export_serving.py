"""Serving export of the port (mmnas_tpu_torch/tools/export_serving.py): the
fixed VQA net's eval forward through torch.export, saved, loaded back and
called, bit for bit the in-process forward, with a static and a symbolic
batch; every attention op one node of the custom op
`mmnas_tpu_torch::fused_attention_fwd`; a second set of weights loaded into
the reloaded module; and the reloaded artifact against the JAX tool's
forward (tools/export_serving.py build_eval_fwd) on the same weights,
converted by from_jax_params, fp32, rtol = atol = 2e-4 (the fp32 eval
tolerance of tests/test_torch_net.py). The mcan genotype at the default
width (HSIZE 512) and batch 4, as tests/test_export_serving.py; on the CPU
the op runs the kernels' plain version. About 55 s on one CPU thread."""

import io

import numpy as np
import pytest
import torch

import jax

from mmnas_tpu_torch.genotype import load_genotype
from mmnas_tpu_torch.models.convert import from_jax_params
from mmnas_tpu_torch.tools import export_serving as ES

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

ARCH = "./arch/mcan.json"


@pytest.fixture(scope="module")
def built():
    return ES.build_eval_fwd("vqa", ARCH, "", 4)


@pytest.fixture(scope="module")
def symbolic(built):
    net, example = built
    return ES.export_artifact(net, example, True)


def roundtrip(program):
    buf = io.BytesIO()
    torch.export.save(program, buf)
    buf.seek(0)
    return torch.export.load(buf).module()


def test_export_roundtrip_static(built):
    net, example = built
    served = roundtrip(ES.export_artifact(net, example, False))
    with torch.no_grad():
        assert torch.equal(served(example), net(example))


def test_export_symbolic_batch(built, symbolic):
    net, example = built
    served = roundtrip(symbolic)
    with torch.no_grad():
        for bs in (2, 4):
            sub = ES.sub_batch(example, bs)
            got = served(sub)
            assert got.shape[0] == bs
            assert torch.equal(got, net(sub))


def test_graph_calls_the_attention_op_once_per_attention_op(symbolic):
    genotype = load_genotype(ARCH)
    n_att = sum(1 for side in ("enc", "dec") for node in genotype[side] for op in node
                if "att" in op)
    assert n_att == 18
    assert ES.attention_nodes(symbolic) == n_att
    # the only softmaxes left are the two AttFlat heads' (over tokens, over regions)
    softmax = [n for n in symbolic.graph.nodes
               if n.op == "call_function" and "softmax" in str(n.target)]
    assert len(softmax) == 2


def test_reloaded_module_takes_a_second_set_of_weights(built, symbolic):
    _, example = built
    other, _ = ES.build_eval_fwd("vqa", ARCH, "", 4, seed=1)
    served = roundtrip(symbolic)
    served.load_state_dict(other.state_dict())
    with torch.no_grad():
        assert torch.equal(served(example), other(example))


def test_reloaded_artifact_matches_the_jax_tool(built, symbolic):
    from tools.export_serving import build_eval_fwd as jax_build_eval_fwd

    fwd, params, jexample = jax_build_eval_fwd("vqa", ARCH, "", 4)
    want = np.asarray(jax.jit(fwd)(params, jexample))
    _, example = built
    served = roundtrip(symbolic)
    served.load_state_dict(from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    # the same synthetic batch (the JAX one with 32-bit token ids)
    batch = {k: torch.from_numpy(np.array(v)).to(example[k].dtype) for k, v in jexample.items()}
    for k in batch:
        assert torch.equal(batch[k], example[k])
    with torch.no_grad():
        got = served(batch).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("task", ["vgd", "itm"])
def test_other_tasks_are_not_exported(task):
    with pytest.raises(NotImplementedError, match="vqa is the flagship"):
        ES.build_eval_fwd(task, ARCH, "", 4)


def test_cli_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ES.main(["--out", str(tmp_path / "m.pt2")])
