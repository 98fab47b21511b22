"""The CUDA fused attention kernels against their plain PyTorch versions, on
the card, at shapes the smoke run does not reach: ragged and tiny lengths,
keys past a warp's width, D 32/128, the 3-channel text relation and the
largest channel count, odd batch and head counts, bf16; plus the wrappers'
input checks and launch counters.

- forward (no dropout) against `fused_attention_reference`;
- forward with dropout: its keep mask equals the Philox bits of
  `keep_mask_reference` for the seed, and its output equals the plain
  version on that mask; the key read by pointer from a tensor drawn on the
  card (`draw_key`), or copied from a Python int;
- backward and relation pass: every gradient equals autograd through the
  plain version on the same keep mask, and two runs give the same bits;
- `FusedAttentionFn`: autograd through the kernels, launch counts;
- the tiles' edges: query lengths around the 16-row warp tile, key lengths
  around the 16-key chunk (and not multiples of 4, the keys one Philox call
  serves), a fully padded row, D 32 and 128, the search's B 32 H 4 with the
  relation chain and its `pre` residual against the plain chain;
- the VGD net's shapes (B 64, H 8: SA 15x15, GA 100x15);
- the ITM net's shapes (text SA 50x50, region SA and RSA 36x36, GA 36x50,
  each row's keys a valid prefix and a pad tail, as the loaders give them)
  at the train step's B 64 H 8, the eval scorer's 256 pairs (forward only)
  and the search's B 128 H 4;
- the relation pass on random inputs at the search's B 128, H 4 (100x100)
  and at the ITM shapes' (36x36), with the live-mask flips between the
  kernel and the plain version counted and their contribution bounded;
- a search in chunks replayed from CUDA graphs (SCAN_STEPS) against the
  same search step by step;
- the probe kernels (`tools/probes.py`): the bias probes at their fixed
  and generic instances, against the plain version, each other and the
  RSA attention forward's pre.

Needs a CUDA GPU and nvcc; skipped elsewhere. This file imports no JAX, so
on a machine without it run it as
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_kernel.py -q
Tolerances as in chip_smoke.py: forward fp32 1e-4 (1e-3 with the relation
chain, whose log amplifies fp32 rounding near the 1e-6 clamp), bf16 5e-2;
gradients as a share of the largest reference gradient: fp32 1e-4 (1e-3
with the relation chain), bf16 2e-2 (the kernel rounds ds and the
dropped-out probabilities to bf16 before its products, bf16's unit roundoff
2^-8 relative each,
where the plain version runs in fp32 on the same bf16 inputs)."""

import pytest
import torch

from mmnas_tpu_torch.ops import fused_attention as FA
from mmnas_tpu_torch.ops.primitives import draw_key

pytestmark = pytest.mark.cuda

RATE = 0.1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def make(B, H, Lq, Lk, D, kind, Rr=4, R=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=g) for L in (Lq, Lk, Lk))
    mask = torch.rand(B, 1, 1, Lk, generator=g) > 0.6
    mask[..., 0] = False
    bias = torch.randn(B, H, Lq, Lk, generator=g) if "bias" in kind else None
    rel = None
    if "rel" in kind:
        rel = (torch.randn(B, Lq, Lk, Rr, generator=g) * 2,
               (torch.rand(R, Rr, generator=g) * 2 - 1) * 0.5,
               (torch.rand(R, generator=g) * 2 - 1) * 0.5,
               (torch.rand(H, R, generator=g) * 2 - 1) / R ** 0.5,
               (torch.rand(H, generator=g) * 2 - 1) / R ** 0.5)
    return q, k, v, (mask if "mask" in kind else None), bias, rel


def on(dev, dt, q, k, v, mask, bias, rel):
    args = [t.to(dev, dt) for t in (q, k, v)]
    m = None if mask is None else mask.to(dev)
    b = None if bias is None else bias.to(dev, dt)
    r = None if rel is None else tuple(t.to(dev, dt) for t in rel)
    return args, m, b, r


def f32(t):
    return None if t is None else t.float()


CASES = [  # B, H, Lq, Lk, D, operands, Rr, dtype
    (1, 1, 1, 1, 64, "plain", 4, torch.float32),
    (3, 3, 17, 33, 32, "mask", 4, torch.float32),
    (2, 8, 5, 200, 64, "mask+bias", 4, torch.float32),
    (2, 2, 33, 33, 128, "mask+rel", 3, torch.float32),
    (2, 8, 16, 16, 64, "rel", 8, torch.float32),
    (3, 8, 100, 14, 64, "mask", 4, torch.bfloat16),
    (2, 8, 100, 100, 64, "mask+rel", 4, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,Lq,Lk,D,kind,Rr,dt", CASES)
def test_kernel_matches_plain_version(dev, B, H, Lq, Lk, D, kind, Rr, dt):
    (args, m, b, r) = on(dev, dt, *make(B, H, Lq, Lk, D, kind, Rr))
    before = dict(FA.LAUNCHES)
    got = FA.fused_attention(*args, m, b, rel=r)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["fused_attention_fwd"] == before["fused_attention_fwd"] + 1
    assert got.dtype == dt and got.shape == (B, H, Lq, D)
    want = FA.fused_attention_reference(*[t.float() for t in args], m, f32(b),
                                        rel=None if r is None else tuple(map(f32, r)))
    tol = 5e-2 if dt == torch.bfloat16 else (1e-3 if r is not None else 1e-4)
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("B,H,Lq,Lk,D,kind,Rr,dt", CASES)
def test_dropout_forward_draws_philox_mask_and_matches_plain(dev, B, H, Lq, Lk, D, kind, Rr, dt):
    (args, m, b, r) = on(dev, dt, *make(B, H, Lq, Lk, D, kind, Rr, seed=1))
    seed = 0x1234_5678_9ABC_DEF0 + B
    before = dict(FA.LAUNCHES)
    out, keep, _ = FA.attention_fwd(*args, m, b, r, dropout_r=RATE, seed=seed)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["fused_attention_fwd_dropout"] == before["fused_attention_fwd_dropout"] + 1
    assert keep.dtype == torch.uint8 and keep.shape == (B, H, Lq, Lk)
    want_keep = FA.keep_mask_reference(seed, B, H, Lq, Lk, RATE)
    assert torch.equal(keep.cpu().bool(), want_keep)
    want = FA.fused_attention_reference(*[t.float() for t in args], m, f32(b),
                                        rel=None if r is None else tuple(map(f32, r)),
                                        keep=keep, dropout_r=RATE)
    tol = 5e-2 if dt == torch.bfloat16 else (1e-3 if r is not None else 1e-4)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=tol)


BWD_CASES = [  # B, H, Lq, Lk, D, operands, Rr, dtype, dropout
    (1, 1, 1, 1, 64, "plain", 4, torch.float32, False),
    (3, 3, 17, 33, 32, "mask", 4, torch.float32, True),
    (2, 8, 5, 128, 64, "mask+bias", 4, torch.float32, True),
    (2, 2, 33, 33, 128, "mask+rel", 3, torch.float32, True),
    (2, 8, 16, 16, 64, "rel", 8, torch.float32, False),
    (3, 8, 100, 14, 64, "mask", 4, torch.bfloat16, True),
    (2, 8, 100, 100, 64, "mask+rel", 4, torch.bfloat16, True),
    (2, 8, 100, 100, 64, "mask+bias", 4, torch.bfloat16, False),
]


def plain_grads(args, m, b, r, keep, rate, do):
    """Autograd through the plain version, in fp32, on the same inputs."""
    leaves = [t.float().requires_grad_() for t in args]
    bl = None if b is None else b.float().requires_grad_()
    rl = None if r is None else [t.float().requires_grad_() for t in r]
    out = FA.fused_attention_reference(*leaves, m, bl, rel=rl, keep=keep, dropout_r=rate)
    wrt = leaves + ([bl] if bl is not None else []) + (rl if rl is not None else [])
    return torch.autograd.grad(out, wrt, do.float())


@pytest.mark.parametrize("B,H,Lq,Lk,D,kind,Rr,dt,drop", BWD_CASES)
def test_backward_matches_plain_autograd(dev, B, H, Lq, Lk, D, kind, Rr, dt, drop):
    (args, m, b, r) = on(dev, dt, *make(B, H, Lq, Lk, D, kind, Rr, seed=2))
    do = torch.randn(B, H, Lq, D, generator=torch.Generator().manual_seed(3)).to(dev, dt)
    rate = RATE if drop else 0.0
    _, keep, pre = FA.attention_fwd(*args, m, b, r, dropout_r=rate, seed=99,
                                    want_pre=r is not None)
    before = dict(FA.LAUNCHES)
    dq, dk, dv, dbias, drel = FA.attention_bwd(*args, m, b, r, keep, rate, do,
                                               need_draw=r is not None, pre=pre)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["fused_attention_bwd"] == before["fused_attention_bwd"] + 1
    assert (FA.LAUNCHES["fused_attention_bwd_rel"]
            == before["fused_attention_bwd_rel"] + (r is not None))
    got = [dq, dk, dv] + ([dbias] if b is not None else []) + (list(drel) if r is not None else [])
    want = plain_grads(args, m, b, r, keep, rate, do)
    tol = 2e-2 if dt == torch.bfloat16 else (1e-3 if r is not None else 1e-4)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        err = (g.float() - w).abs().max().item() / max(w.abs().max().item(), 1e-6)
        assert err <= tol, (i, err)

    again = FA.attention_bwd(*args, m, b, r, keep, rate, do, need_draw=r is not None, pre=pre)
    flat = [t for t in again[:4] if t is not None] + ([t for t in again[4]] if r is not None else [])
    for x, y in zip([t for t in got if t is not None], flat):
        assert torch.equal(x, y)                 # no atomics: the same bits every run


HEAD_BLOCK_CASES = [  # B, H of heads_total, Lq, Lk, operands, dtype
    (2, 4, 8, 100, 100, "mask+rel", torch.float32),
    (3, 4, 8, 100, 14, "mask", torch.float32),
    (2, 2, 4, 36, 36, "mask+rel", torch.bfloat16),
    (2, 1, 2, 33, 17, "mask", torch.bfloat16),
]


@pytest.mark.parametrize("B,H,heads_total,Lq,Lk,kind,dt", HEAD_BLOCK_CASES)
def test_a_model_ranks_head_block_draws_the_whole_calls_mask_and_gradients(
        dev, B, H, heads_total, Lq, Lk, kind, dt):
    """Tensor parallelism: heads [head0, head0 + H) of heads_total, with the
    relation chain on the block of Wr's rows and br. The dropout forward at
    head0 draws the whole call's keep mask for its heads (and the Philox
    bits of keep_mask_reference at head0); its output and its backward,
    relation pass included, equal the plain version on that block; the
    blocks' dWr, dbr rows and their dW1, db1 summed are the whole call's."""
    (args, m, _, r) = on(dev, dt, *make(B, heads_total, Lq, Lk, 64, kind, R=16, seed=5))
    do = torch.randn(B, heads_total, Lq, 64, generator=torch.Generator().manual_seed(6)
                     ).to(dev, dt)
    _, keep_all, pre_all = FA.attention_fwd(*args, m, None, r, dropout_r=RATE, seed=77,
                                            want_pre=r is not None)
    whole = FA.attention_bwd(*args, m, None, r, keep_all, RATE, do, pre=pre_all)[4]
    tol = 2e-2 if dt == torch.bfloat16 else (1e-3 if r is not None else 1e-4)
    fwd_tol = 5e-2 if dt == torch.bfloat16 else (1e-3 if r is not None else 1e-4)
    blocks = []
    for head0 in range(0, heads_total, H):
        sl = slice(head0, head0 + H)
        part = [t[:, sl].contiguous() for t in args]
        rb = None if r is None else (*r[:3], r[3][sl].contiguous(), r[4][sl].contiguous())
        dop = do[:, sl].contiguous()
        out, keep, pre = FA.attention_fwd(*part, m, None, rb, dropout_r=RATE, seed=77,
                                          want_pre=rb is not None, head0=head0,
                                          heads_total=heads_total)
        torch.cuda.synchronize()
        assert torch.equal(keep, keep_all[:, sl])
        assert torch.equal(keep.cpu().bool(), FA.keep_mask_reference(
            77, B, H, Lq, Lk, RATE, head0, heads_total))
        want = FA.fused_attention_reference(*[t.float() for t in part], m,
                                            rel=None if rb is None else tuple(map(f32, rb)),
                                            keep=keep, dropout_r=RATE)
        torch.testing.assert_close(out.float(), want, rtol=0, atol=fwd_tol)
        dq, dk, dv, _, drel = FA.attention_bwd(*part, m, None, rb, keep, RATE, dop, pre=pre)
        got = [dq, dk, dv] + ([] if rb is None else list(drel[1:]))
        wants = plain_grads(part, m, None, rb, keep, RATE, dop)
        wants = list(wants[:3]) + ([] if rb is None else list(wants[4:]))
        for i, (g, w) in enumerate(zip(got, wants)):
            err = (g.float() - w).abs().max().item() / max(w.abs().max().item(), 1e-6)
            assert err <= tol, (head0, i, err)
        blocks.append(drel)
    if r is not None:
        for i, by_rows in ((1, False), (2, False), (3, True), (4, True)):
            got = torch.cat([b[i] for b in blocks]) if by_rows else sum(b[i] for b in blocks)
            err = (got.float() - whole[i].float()).abs().max().item() / max(
                whole[i].abs().max().item(), 1e-6)
            assert err <= tol, (i, err)


def test_wrapper_refuses_heads_outside_the_whole_call(dev):
    (args, m, _, _) = on(dev, torch.float32, *make(2, 4, 8, 8, 64, "mask"))
    with pytest.raises(ValueError, match="not within"):
        FA.fused_attention(*args, m, dropout_r=RATE, generator=torch.Generator(dev),
                           head0=2, heads_total=5)


def test_autograd_function_runs_the_kernels(dev):
    (args, m, _, r) = on(dev, torch.float32, *make(2, 8, 100, 100, 64, "mask+rel", 4, R=64))
    leaves = [t.clone().requires_grad_() for t in args]
    rl = [r[0]] + [t.clone().requires_grad_() for t in r[1:]]       # raw is input data
    before = dict(FA.LAUNCHES)
    out = FA.FusedAttentionFn.apply(*leaves, m, None, *rl, RATE, 7)
    do = torch.randn_like(out)
    grads = torch.autograd.grad(out, leaves + rl[1:], do)
    torch.cuda.synchronize()
    delta = {n: FA.LAUNCHES[n] - before[n] for n in before}
    assert delta == {"fused_attention_fwd": 0, "fused_attention_fwd_dropout": 1,
                     "fused_attention_bwd": 1, "fused_attention_bwd_rel": 1}
    keep = FA.keep_mask_reference(7, 2, 8, 100, 100, RATE).to(dev)
    want = plain_grads(args, m, None, r, keep, RATE, do)
    want = want[:3] + want[4:]                   # no raw gradient on the kernel side
    for g, w in zip(grads, want):
        assert (g - w).abs().max().item() <= 1e-3 * w.abs().max().item()


@pytest.mark.parametrize("kind", ["mask", "mask+rel", "bias"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_custom_op_is_the_forward_kernel(dev, kind, dt):
    """`mmnas_tpu_torch::fused_attention_fwd` on CUDA tensors: attention_fwd's
    output bit for bit, one launch counted, as `fused_attention`'s eager
    no-gradient call through the autograd Function."""
    (args, m, b, r) = on(dev, dt, *make(2, 8, 36, 50 if kind == "mask" else 36, 64, kind, R=64))
    want = FA.attention_fwd(*args, m, b, r)[0]
    rel = r if r is not None else (None,) * 5
    for call in (lambda: torch.ops.mmnas_tpu_torch.fused_attention_fwd(*args, m, b, *rel),
                 lambda: FA.fused_attention(*args, m, b, rel=r)):
        before = dict(FA.LAUNCHES)
        got = call()
        torch.cuda.synchronize()
        assert {n: FA.LAUNCHES[n] - before[n] for n in before} == {
            "fused_attention_fwd": 1, "fused_attention_fwd_dropout": 0,
            "fused_attention_bwd": 0, "fused_attention_bwd_rel": 0}
        assert torch.equal(got, want)


def test_wrapper_rejects_what_the_kernel_does_not_take(dev):
    q, k, v, mask, _, rel = make(2, 2, 8, 8, 64, "mask+rel", Rr=9)
    q, k, v = (t.to(dev) for t in (q, k, v))
    rel = tuple(t.to(dev) for t in rel)
    with pytest.raises(ValueError, match="channels"):
        FA.fused_attention(q, k, v, rel=rel)
    with pytest.raises(ValueError, match="contiguous"):
        FA.fused_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(TypeError):
        FA.fused_attention(q, k.half(), v)
    with pytest.raises(TypeError):
        FA.fused_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="mask"):
        FA.fused_attention(q, k, v, mask.to(dev).float())
    with pytest.raises(ValueError, match="mask"):
        FA.fused_attention(q, k, v, mask)                  # on the CPU, q on the card
    with pytest.raises(ValueError, match="generator"):
        FA.fused_attention(q, k, v, dropout_r=RATE)
    with pytest.raises(ValueError, match="keep mask"):
        FA.attention_bwd(q, k, v, None, None, None, None, RATE, torch.randn_like(q))
    # K, V, dK, dV of 200 keys at D 128 exceed a block's shared memory: refused, not run
    big = [torch.randn(1, 1, 4, 128, device=dev)] + [torch.randn(1, 1, 200, 128, device=dev)] * 2
    with pytest.raises(RuntimeError, match="CUDA error"):
        FA.attention_bwd(*big, None, None, None, None, 0.0, torch.randn_like(big[0]))


def test_cuda_generator_seeds_differ_per_call_and_repeat_per_seed(dev):
    """The dropout key is drawn on the card from the generator (an int64 [1]
    tensor the kernel reads there)."""
    g = torch.Generator(dev).manual_seed(5)
    k1, k2 = draw_key(g, dev), draw_key(g, dev)
    assert k1.device.type == "cuda" and k1.dtype == torch.int64 and k1.shape == (1,)
    g.manual_seed(5)
    assert FA.key_value(k1) != FA.key_value(k2)
    assert FA.key_value(draw_key(g, dev)) == FA.key_value(k1)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["mask", "mask+rel", "mask+bias"])
def test_dropout_key_read_by_pointer_draws_the_reference_mask(dev, dt, kind):
    """The key by pointer: the kernel's mask is `keep_mask_reference` at the
    key read back, bit for bit, and a Python int key gives the same mask as
    the tensor holding its bits."""
    (args, m, b, r) = on(dev, dt, *make(2, 4, 100, 100, 64, kind, R=64, seed=31))
    g = torch.Generator(dev).manual_seed(9)
    key = draw_key(g, dev)
    out, keep, _ = FA.attention_fwd(*args, m, b, r, dropout_r=RATE, seed=key)
    ref = FA.keep_mask_reference(FA.key_value(key), 2, 4, 100, 100, RATE)
    assert torch.equal(keep.bool().cpu(), ref)
    _, keep_int, _ = FA.attention_fwd(*args, m, b, r, dropout_r=RATE, seed=FA.key_value(key))
    assert torch.equal(keep_int, keep)


def test_replayed_chunk_is_the_per_step_run(dev, tmp_path):
    """A --UNIFIED_WEIGHT search in chunks of 4 steps, replayed from CUDA
    graphs, against the same search step by step: the same paths and, to
    the bit, the same params and alpha; every attention launch of the
    replays comes from the capture."""
    from mmnas_tpu_torch.config import SearchCfg
    from mmnas_tpu_torch.engine.search import SearchExecution

    runs = {}
    for scan in (1, 4):
        d = str(tmp_path / str(scan))
        cfg = SearchCfg(TASK="vqa", SYNTH=True, SYNTH_SIZE=40, BATCH_SIZE=4, HSIZE=64,
                        ATTFLAT_OUT_SIZE=128, ATTFLAT_MLP_SIZE=16, REL_SIZE=8, FRCNFEAT_LEN=8,
                        FRCNFEAT_SIZE=16, WORD_EMBED_SIZE=10, MAX_TOKEN=6,
                        NODES=(("enc", 1), ("dec", 2)), DROPOUT_R=0.1, ALPHA_START=1,
                        ALPHA_EVERY=2, SEED=13, NUM_WORKERS=1, MAX_EPOCH=2,
                        UNIFIED_WEIGHT_STEP=True, SCAN_STEPS=scan, EVAL_EVERY_EPOCH=False,
                        VERSION="replay", CKPT_ROOT=d, ARCH_ROOT=d, LOG_ROOT=d)
        ex = SearchExecution(cfg, dev)
        runs[scan] = (ex, ex.run())
    (_, want), (ex, got) = runs[1], runs[4]
    assert ex.chunk_log["dispatch"] == "graph"
    assert ex.chunk_log["weight"]["replays"] == 16 and ex.chunk_log["arch"]["replays"] == 4
    assert not any(ex.chunk_log["eager_launches"].values())
    assert repr(got.paths) == repr(want.paths)
    for (n, p), q in zip(got.net.named_parameters(), want.net.parameters()):
        assert torch.equal(p, q), n
    for c in got.alpha:
        assert torch.equal(got.alpha[c], want.alpha[c])


def make_rel(B, H, Lq, Lk, Rr, R, dt, dev, exact=True, seed=4):
    """Relation inputs and a cotangent dpre. exact: raw, W1 and b1 on grids
    of binary fractions (raw k/8 with |k| <= 16, W1 and b1 k/64 with |k| <=
    32; exact in bf16 too), so u = raw W1^T + b1 is exact in fp32 in any
    order of summation. Otherwise an element whose u lies within rounding of
    0 (one in about 10^7 at these scales) may be live in one of two correct
    fp32 computations (the kernel's FMA chain, the plain version's matmul)
    and dead in the other, and moves a sum by its whole du."""
    g = torch.Generator().manual_seed(seed)
    if exact:
        raw = torch.randint(-16, 17, (B, Lq, Lk, Rr), generator=g) / 8
        w1 = torch.randint(-32, 33, (R, Rr), generator=g) / 64
        b1 = torch.randint(-32, 33, (R,), generator=g) / 64
        rel = (raw, w1, b1, (torch.rand(H, R, generator=g) * 2 - 1) / R ** 0.5,
               (torch.rand(H, generator=g) * 2 - 1) / R ** 0.5)
    else:
        rel = make(B, H, Lq, Lk, 64, "rel", Rr=Rr, R=R, seed=seed)[5]
    dpre = (torch.randn(B, H, Lq, Lk, generator=torch.Generator().manual_seed(seed + 1)) * 0.1)
    return tuple(t.to(dev, dt) for t in rel), dpre.to(dev)


REL_CASES = [  # B, H, Lq, Lk, Rr, R, need_draw, exact inputs, dtype
    (3, 8, 37, 37, 4, 64, True, False, torch.float32),
    (3, 8, 37, 37, 4, 64, True, False, torch.bfloat16),
    (2, 1, 14, 14, 1, 16, True, True, torch.float32),
    (2, 4, 37, 37, 4, 64, False, True, torch.bfloat16),
    (3, 8, 100, 14, 4, 64, True, True, torch.float32),
    (3, 4, 100, 14, 8, 64, False, True, torch.bfloat16),
    (2, 16, 100, 100, 8, 64, False, True, torch.float32),
    (2, 8, 100, 100, 4, 64, True, True, torch.bfloat16),
    (2, 4, 128, 128, 4, 80, True, True, torch.float32),
    (2, 16, 128, 128, 1, 64, True, True, torch.bfloat16),
    (2, 1, 128, 128, 8, 64, False, True, torch.float32),
    (2, 16, 14, 14, 8, 130, True, True, torch.bfloat16),
    (5, 8, 14, 14, 4, 64, False, True, torch.float32),
    (4, 4, 100, 100, 1, 16, False, True, torch.bfloat16),
]


@pytest.mark.parametrize("B,H,Lq,Lk,Rr,R,need_draw,exact,dt", REL_CASES)
def test_relation_pass_matches_plain_autograd(dev, B, H, Lq, Lk, Rr, R, need_draw, exact, dt):
    """Element counts that are no multiple of the kernel's 256-element tile
    or 16-element runs, 1 to 16 heads (each register shape), 1 to 8 raw
    channels, feature counts past one block's 64, draw on and off."""
    rel, dpre = make_rel(B, H, Lq, Lk, Rr, R, dt, dev, exact=exact)
    before = FA.LAUNCHES["fused_attention_bwd_rel"]
    got = FA.relation_bwd(*rel, dpre, need_draw=need_draw)
    want = FA.relation_bwd_reference(*rel, dpre, need_draw=need_draw)
    torch.cuda.synchronize()
    assert FA.LAUNCHES["fused_attention_bwd_rel"] == before + 1
    assert (got[0] is None) == (not need_draw)
    # fp32 sums in both: 1e-4 of the largest; bf16 results are rounded to bf16, whose
    # unit roundoff 2^-8 (3.9e-3) of the largest bounds it, plus the fp32 noise
    tol = 1e-4 if dt == torch.float32 else 4e-3
    for g, w in zip(got, want):
        if w is None:
            continue
        assert g.shape == w.shape and g.dtype == dt
        assert (g.float() - w).abs().max().item() <= tol * w.abs().max().item()


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_relation_pass_gives_the_same_bits_every_call(dev, dt):
    """No atomics: the partial rows are summed in a fixed order."""
    rel, dpre = make_rel(16, 8, 100, 100, 4, 64, dt, dev, exact=False)
    first = FA.relation_bwd(*rel, dpre, need_draw=True)
    for _ in range(2):
        again = FA.relation_bwd(*rel, dpre, need_draw=True)
        assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_relation_pass_sums_at_the_search_shape_against_fp64(dev):
    """B 128, H 4, (100, 100), R 64, fp32: db1 and dbr sum 1.28M values that
    cancel. The kernel sums them in fp32 over at most 16 elements a thread,
    then in fp64, and rounds to fp32 once; the plain version sums in fp32.
    Both compute the same per-element terms (u exact on these inputs, du
    from H = 4 products), so the kernel may be no further from the fp64
    truth than the plain version within a factor 2 (the per-element du
    rounds in another order in each), plus half an fp32 ulp of the result
    for its final rounding (the largest value times 2^-24)."""
    rel, dpre = make_rel(128, 4, 100, 100, 4, 64, torch.float32, dev, seed=7)
    got = FA.relation_bwd(*rel, dpre)
    plain = FA.relation_bwd_reference(*rel, dpre)
    leaves = [t.double().requires_grad_() for t in rel]
    x, w1, b1, wr, br = leaves
    pre = torch.matmul(torch.relu(torch.matmul(x, w1.t()) + b1), wr.t()) + br
    truth = torch.autograd.grad(pre.permute(0, 3, 1, 2), leaves[1:], dpre.double())
    for i, name in ((2, "db1"), (4, "dbr")):
        want = truth[i - 1]
        scale = want.abs().max().item()
        err_kernel = (got[i].double() - want).abs().max().item()
        err_plain = (plain[i].double() - want).abs().max().item()
        assert err_kernel <= 2 * err_plain + scale * 2.0 ** -24, (name, err_kernel, err_plain)


def test_train_step_gradient_against_fp64(dev, monkeypatch, capsys):
    """One train step's gradient of the searched net at full width (16
    examples, DROPOUT_R 0): the card with the port's kernels, the card with
    the plain versions in their place, and the CPU, each against an fp64
    CPU run. The kernels must not be what separates the card from the
    truth: kernels vs plain on the card within 2e-5 in relative norm, and
    the two equally far from fp64 (within 20%)."""
    import math

    import mmnas_tpu_torch.models.net as NET
    import mmnas_tpu_torch.ops.attention as ATT
    from mmnas_tpu_torch.config import Cfg
    from mmnas_tpu_torch.engine.vqa import Execution, batch_to_device, bce_with_logits_sum
    from mmnas_tpu_torch.ops.primitives import mask_scores

    torch.backends.cudnn.allow_tf32 = False
    cfg = Cfg(RUN_MODE="train", SYNTH=True, ARCH_PATH="arch/mmnas_vqa.json", SEED=0,
              DROPOUT_R=0.0, NUM_WORKERS=2)
    exe = Execution(cfg, torch.device("cpu"))
    ds = exe.build_dataset("train")
    host = {k: v[:16] for k, v in list(exe.make_loader(ds, 16))[0].items()}

    def attention_fp64(q, k, v, mask=None, log_bias=None, *, rel=None, **_):
        if rel is not None:
            raw, w1, b1, wr, br = rel
            r = torch.relu(torch.matmul(torch.relu(torch.matmul(raw, w1.t()) + b1), wr.t()) + br)
            log_bias = torch.log(torch.clamp(r, min=1e-6)).permute(0, 3, 1, 2)
        s = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        s = s if log_bias is None else s + log_bias
        return torch.matmul(torch.softmax(mask_scores(s, mask), dim=-1), v)

    def plain(q, k, v, mask=None, log_bias=None, *, rel=None, **_):
        return FA.fused_attention_reference(q, k, v, mask, log_bias, rel=rel)

    def grads(device, attention=None, dtype=torch.float32):
        with monkeypatch.context() as m:
            if attention is not None:
                m.setattr(ATT, "fused_attention", attention)
            m.setattr(NET, "compute_dtype", lambda cfg: dtype)
            net = exe.build_net(ds).to(device, dtype)
            b = batch_to_device(host, torch.device(device), NET.INPUT_KEYS + ("ans",))
            b["ans"] = b["ans"].to(dtype)
            loss = bce_with_logits_sum(net(b, train=True, generator=torch.Generator(device)),
                                       b["ans"])
            ps = list(net.parameters())
            gs = torch.autograd.grad(loss, ps, allow_unused=True)
        return [torch.zeros(p.shape, dtype=torch.float64) if g is None else g.cpu().double()
                for p, g in zip(ps, gs)]

    truth = grads("cpu", attention_fp64, torch.float64)
    norm = math.sqrt(sum(float((g ** 2).sum()) for g in truth))

    def dist(a, b):
        return math.sqrt(sum(float(((x - y) ** 2).sum()) for x, y in zip(a, b))) / norm

    kernels, card_plain, cpu = grads("cuda"), grads("cuda", plain), grads("cpu", plain)
    d = {"card kernels vs fp64": dist(kernels, truth), "card plain vs fp64": dist(card_plain, truth),
         "cpu plain vs fp64": dist(cpu, truth), "card kernels vs card plain": dist(kernels, card_plain),
         "card kernels vs cpu plain": dist(kernels, cpu)}
    with capsys.disabled():
        print("\ngradient relative norm differences, one train step:",
              {k: f"{v:.3e}" for k, v in d.items()})
    assert d["card kernels vs card plain"] <= 2e-5
    assert d["card kernels vs fp64"] <= 1.2 * d["card plain vs fp64"]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_backward_without_relation_gradients_skips_the_relation_pass(dev, dt):
    """When no relation input needs a gradient (the search's arch step), the
    backward writes no dpre and no relation pass runs; dq, dk, dv are the
    bits of the full backward."""
    (args, m, _, r) = on(dev, dt, *make(2, 4, 100, 100, 64, "mask+rel", 4, R=64, seed=6))
    do = torch.randn(2, 4, 100, 64, generator=torch.Generator().manual_seed(7)).to(dev, dt)
    _, keep, pre = FA.attention_fwd(*args, m, None, r, dropout_r=RATE, seed=11, want_pre=True)
    full = FA.attention_bwd(*args, m, None, r, keep, RATE, do, pre=pre)
    before = dict(FA.LAUNCHES)
    lean = FA.attention_bwd(*args, m, None, r, keep, RATE, do, need_rel=False, pre=pre)
    torch.cuda.synchronize()
    assert lean[4] is None and full[4] is not None
    assert {n: FA.LAUNCHES[n] - before[n] for n in before}["fused_attention_bwd_rel"] == 0
    for a, b in zip(full[:3], lean[:3]):
        assert torch.equal(a, b)
    # through autograd: weights that need no gradient launch no relation pass
    leaves = [t.detach().requires_grad_() for t in args]
    before = dict(FA.LAUNCHES)
    out = FA.FusedAttentionFn.apply(*leaves, m, None, *r, RATE, 11)
    torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    delta = {n: FA.LAUNCHES[n] - before[n] for n in before}
    assert delta == {"fused_attention_fwd": 0, "fused_attention_fwd_dropout": 1,
                     "fused_attention_bwd": 1, "fused_attention_bwd_rel": 0}


def test_probe_kernels_match_their_plain_versions(dev):
    """The five probe kernels (csrc/probes.cu) on the probes' own inputs:
    the two bias kernels give equal bits and match the plain version (1e-5
    where pre > 0.1, and in exp(bias) = max(pre, 1e-6)), which is itself
    within 1e-5 of the fp64 chain and the same bits on one CPU thread;
    slice, outer and wrblock are exact."""
    from mmnas_tpu_torch.tools import probes as PR

    before = dict(PR.LAUNCHES)
    args = [torch.from_numpy(a) for a in PR.bias_inputs()]
    once = PR.probe_bias(*(a.to(dev) for a in args))
    fresh = PR.probe_bias(*(a.to(dev) for a in args), fresh=True)
    torch.cuda.synchronize()
    assert torch.equal(once, fresh)
    want = PR.bias_reference(*args)
    # the plain version on the CPU: the same bits on one thread as on all of
    # them, and within the tolerance of the fp64 chain, so that a failure
    # below shows which side moved
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert torch.equal(PR.bias_reference(*args), want)
    finally:
        torch.set_num_threads(threads)
    fp64 = torch.from_numpy(PR.bias_fp64(*PR.bias_inputs()))
    torch.testing.assert_close(want.double().exp(), fp64.exp(), rtol=0, atol=1e-5)
    print(f"probe bias plain version: the same bits on 1 and {threads} CPU threads; max "
          f"|exp(bias) - exp(fp64 chain)| {(want.double().exp() - fp64.exp()).abs().max():.3e}")
    torch.testing.assert_close(once.exp().cpu(), want.exp(), rtol=0, atol=1e-5)
    away = want.exp() > 0.1
    torch.testing.assert_close(once.cpu()[away], want[away], rtol=0, atol=1e-5)
    for dt, plane in PR.slice_inputs().items():
        assert torch.equal(PR.probe_slice(plane.to(dev)).cpu(), PR.slice_reference(plane))
    for dt, (plane, w, b1) in PR.outer_inputs().items():
        got = PR.probe_outer(plane.to(dev), w.to(dev), b1.to(dev)).cpu()
        assert torch.equal(got, PR.outer_reference(plane, w, b1))
    wr = PR.wrblock_inputs()
    for variant in ("a", "b"):
        assert torch.equal(PR.probe_wrblock(wr.to(dev), variant).cpu(), PR.wrblock_reference(wr))
    assert {n: PR.LAUNCHES[n] - before[n] for n in before} == {
        "probe_bias": 1, "probe_bias2": 1, "probe_slice": 2, "probe_outer": 2,
        "probe_wrblock_a": 1, "probe_wrblock_b": 1}
    # off the probes' shapes: a plane whose chunks end mid-part, and R not a
    # multiple of 4 (the outer kernel's one-column stores)
    g = torch.Generator().manual_seed(4)
    for dt in (torch.float32, torch.bfloat16):
        plane = torch.randn(1, 37, 37, generator=g).to(dt)
        assert torch.equal(PR.probe_slice(plane.to(dev), chunks=3).cpu(),
                           PR.slice_reference(plane))
        ops = [torch.randn(*shape, generator=g).to(dt) for shape in ((7, 9), (5,), (5,))]
        assert torch.equal(PR.probe_outer(*(t.to(dev) for t in ops)).cpu(),
                           PR.outer_reference(*ops))
    # one chunk of more parts (512 elements each) than a grid's second
    # dimension holds (65535): each block takes several
    plane = torch.randn(1, 6000, 6000, generator=torch.Generator(dev).manual_seed(5), device=dev)
    assert torch.equal(PR.probe_slice(plane, chunks=1), PR.slice_reference(plane))
    with pytest.raises(ValueError, match="heads"):
        PR.probe_bias(*(a.to(dev) for a in args[:3]), torch.zeros(17, 64, device=dev),
                      torch.zeros(17, device=dev))


@pytest.mark.parametrize("B,H,L,Rr,R", [(2, 4, 100, 4, 64), (2, 8, 100, 4, 64),
                                         (3, 5, 37, 3, 40)])
def test_bias_kernel_instances_match_plain_and_attention_pre(dev, B, H, L, Rr, R):
    """The bias kernels' instances fixed at Rr 4 R 64 (H 4, H 8) and the
    generic one at an odd shape (Rr 3, H 5, R 40, L 37), inputs drawn with
    numpy as the probes draw theirs: each within the plain version's
    tolerances (1e-5 on exp(bias), and on bias where pre > 0.1); probe_bias
    and probe_bias2 equal bit for bit, also with raw off a 16-byte boundary
    (the generic instance); both equal bit for bit to
    log(max(pre, 1e-6)) of the pre the RSA attention forward writes for the
    same raw and weights (q, k, v random, D 64)."""
    import numpy as np

    from mmnas_tpu_torch.tools import probes as PR

    r = np.random.RandomState(B * 100 + H)
    host = [torch.from_numpy(a) for a in (
        np.abs(r.randn(B, L, L, Rr)).astype(np.float32), (r.randn(R, Rr) * 0.5).astype(np.float32),
        (r.randn(R) * 0.1).astype(np.float32), (r.randn(H, R) * 0.3).astype(np.float32),
        (r.randn(H) * 0.1).astype(np.float32))]
    args = [a.to(dev) for a in host]
    once = PR.probe_bias(*args)
    want = PR.bias_reference(*host)
    torch.testing.assert_close(once.exp().cpu(), want.exp(), rtol=0, atol=1e-5)
    away = want.exp() > 0.1
    torch.testing.assert_close(once.cpu()[away], want[away], rtol=0, atol=1e-5)
    assert torch.equal(PR.probe_bias(*args, fresh=True), once)
    shifted = torch.empty(args[0].numel() + 1, device=dev)[1:].view(args[0].shape)
    shifted.copy_(args[0])
    for fresh in (False, True):
        assert torch.equal(PR.probe_bias(shifted, *args[1:], fresh=fresh), once)
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(B, H, L, 64, generator=g).to(dev) for _ in range(3))
    _, _, pre = FA.attention_fwd(q, k, v, None, None, tuple(args), want_pre=True)
    assert torch.equal(once, torch.log(torch.clamp(pre, min=1e-6)))


def test_kpath_weight_step_on_the_card_matches_the_cpu(dev, tmp_path):
    """A KPATH 2 weight step in fp32: each path's stride slice of the batch
    reaches the kernels as a contiguous tensor, every sampled attention op
    launches its dropout-free forward and its backward, and the step's loss
    equals the CPU's (plain versions), 1e-5 relative."""
    import numpy as np

    from mmnas_tpu_torch.config import SearchCfg
    from mmnas_tpu_torch.engine.search import SearchExecution
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    cfg = SearchCfg(TASK="vqa", SYNTH=True, SYNTH_SIZE=8, BATCH_SIZE=8, KPATH=2, HSIZE=128,
                    ATTFLAT_OUT_SIZE=256, NODES=(("enc", 2), ("dec", 4)), DROPOUT_R=0.0,
                    SEED=3, NUM_WORKERS=1, LOG_ROOT=str(tmp_path))
    idxs = [{"enc": np.array([0, 1]), "dec": np.array([1, 2, 0, 3])},
            {"enc": np.array([1, 0]), "dec": np.array([0, 1, 2, 1])}]
    losses = {}
    for d in (torch.device("cpu"), dev):
        exe = SearchExecution(cfg, d)
        dataset = exe.build_dataset()
        net = exe.build_net(dataset)
        masters = dict(net.named_parameters())
        optim = build_net_optimizer(cfg, 1)
        host = list(exe.make_loader(dataset, list(range(8))))[0]
        before = dict(FA.LAUNCHES)
        loss, _ = exe.weight_step(net, optim, optim.init(masters), masters,
                                  batch_to_device(host, d, INPUT_KEYS + ("ans",)), idxs,
                                  torch.Generator(d), net.init_alpha())
        losses[d.type] = float(loss)
    torch.cuda.synchronize()
    assert {n: FA.LAUNCHES[n] - before[n] for n in before} == {
        "fused_attention_fwd": 9, "fused_attention_fwd_dropout": 0, "fused_attention_bwd": 9,
        "fused_attention_bwd_rel": 3}
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])


# The kernels' tiles: a warp owns 16 query rows, keys are padded to a
# multiple of 16 (a padded key has probability exactly 0), and with the
# relation chain a block runs every head of one 16-row tile. Lengths at and
# around those edges, at tolerances as above.
EDGE_LQ = (1, 15, 16, 17, 100, 128)
EDGE_LK = (1, 14, 100, 112, 113, 128, 200)


def bwd_fits(Lq, Lk, D, dt):
    """Whether the backward kernel takes the shape: keys up to 128, and q,
    k, v, do and the two probability tiles within 227 KB of shared memory,
    or else (the sliced kernel) queries up to 128 and the probability tiles
    with a window of 64, 32 or 16 of the D columns of q, k, v, do within it
    (csrc/fused_attention_bwd.cu, `launch_bwd_shape`, `launch_bwd_sliced`)."""
    es = 2 if dt == torch.bfloat16 else 4
    pad, LqP, LkP = 16 // es, -(-Lq // 16) * 16, -(-Lk // 16) * 16
    tiles = 2 * LqP * (LkP + pad)
    staged = D <= 128 and ((2 * LkP + 2 * LqP) * (D + pad) + tiles) * es <= 232448
    sliced = LqP <= 128 and any(D % w == 0 and ((2 * LkP + 2 * LqP) * (w + pad) + tiles) * es
                                <= 232448 for w in (64, 32, 16))
    return Lk <= 128 and (staged or sliced)


def check_backward(args, m, b, r, keep, pre, rate, do, dt):
    """The backward against autograd through the plain version, or, past
    the kernel's limits, a refusal that names them."""
    B, H, Lq, D = args[0].shape
    if not bwd_fits(Lq, args[1].shape[2], D, dt):
        with pytest.raises(RuntimeError, match="shared memory"):
            FA.attention_bwd(*args, m, b, r, keep, rate, do, pre=pre)
        return
    got = FA.attention_bwd(*args, m, b, r, keep, rate, do, pre=pre)
    got = [t for t in got[:4] if t is not None] + (list(got[4][1:]) if r is not None else [])
    want = plain_grads(args, m, b, r, keep, rate, do)
    want = want[:-5] + want[-4:] if r is not None else want   # no raw gradient asked for
    tol = 2e-2 if dt == torch.bfloat16 else (1e-3 if r is not None else 1e-4)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        err = (g.float() - w).abs().max().item() / max(w.abs().max().item(), 1e-6)
        assert err <= tol, (i, err)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq", EDGE_LQ)
def test_tile_edges_match_plain_version(dev, Lq, dt):
    """For every key length of EDGE_LK: the forward (twice, the same bits),
    the dropout forward (its mask equal to the Philox bits of
    `keep_mask_reference` bit for bit, most lengths not a multiple of 4) and
    the backward on that mask, against the plain version."""
    tol = 5e-2 if dt == torch.bfloat16 else 1e-4
    for Lk in EDGE_LK:
        args, m, b, r = on(dev, dt, *make(2, 3, Lq, Lk, 64, "mask", seed=Lq + Lk))
        got = FA.fused_attention(*args, m)
        assert torch.equal(got, FA.fused_attention(*args, m))
        want = FA.fused_attention_reference(*[t.float() for t in args], m)
        torch.testing.assert_close(got.float(), want, rtol=0, atol=tol, msg=f"Lk {Lk}")
        seed = 1000 + Lk
        out, keep, _ = FA.attention_fwd(*args, m, dropout_r=RATE, seed=seed)
        assert torch.equal(keep.cpu().bool(), FA.keep_mask_reference(seed, 2, 3, Lq, Lk, RATE))
        want = FA.fused_attention_reference(*[t.float() for t in args], m, keep=keep,
                                            dropout_r=RATE)
        torch.testing.assert_close(out.float(), want, rtol=0, atol=tol, msg=f"Lk {Lk}")
        do = torch.randn(2, 3, Lq, 64, generator=torch.Generator().manual_seed(Lk)).to(dev, dt)
        check_backward(args, m, None, None, keep, None, RATE, do, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_fully_padded_row_is_uniform_over_its_keys(dev, dt):
    """A batch row whose every key is padded: each key gets -1e9 added, so
    the row's attention is uniform over its Lk keys (the padding up to a
    multiple of 16 gets none), as in the plain version; with the relation
    chain too. Its gradients are those of that additive row: the kernels add
    -1e9 where the plain version replaces a masked score (ROADMAP queue 3,
    difference (c)), so the backward is held to autograd through the plain
    version with the pad row added to an additive bias. (With the relation
    chain a padded row's dpre = ds / pre is not damped by a small
    probability where pre nears the 1e-6 clamp, so its relation gradients
    carry fp32 rounding of pre amplified up to 1e6 times: no tolerance
    holds them.)"""
    args, m, b, r = on(dev, dt, *make(2, 4, 100, 100, 64, "mask+bias+rel", R=64, seed=8))
    m = m.clone()
    m[1] = True
    mean_v = args[2][1].float().mean(dim=1, keepdim=True).expand(4, 100, 64)
    tol = 5e-2 if dt == torch.bfloat16 else 1e-4
    for bias, rel, tol_all in ((None, r, 5e-2 if dt == torch.bfloat16 else 1e-3),
                               (b, None, tol)):
        out = FA.attention_fwd(*args, m, bias, rel)[0]
        torch.testing.assert_close(out[1].float(), mean_v, rtol=0, atol=tol)
        want = FA.fused_attention_reference(*[t.float() for t in args], m, f32(bias),
                                            rel=None if rel is None else tuple(map(f32, rel)))
        torch.testing.assert_close(out.float(), want, rtol=0, atol=tol_all)
    do = torch.randn(2, 4, 100, 64, generator=torch.Generator().manual_seed(9)).to(dev, dt)
    dq, dk, dv, dbias, _ = FA.attention_bwd(*args, m, b, None, None, 0.0, do)
    leaves = [t.float().requires_grad_() for t in args]
    bl = b.float().requires_grad_()
    plain = FA.fused_attention_reference(*leaves, None, bl + torch.where(m, -1e9, 0.0))
    want = torch.autograd.grad(plain, leaves + [bl], do.float())
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    for i, (g, w) in enumerate(zip([dq, dk, dv, dbias], want)):
        err = (g.float() - w).abs().max().item() / max(w.abs().max().item(), 1e-6)
        assert err <= tol, (i, err)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 128, 256])
def test_head_widths(dev, D, dt):
    """D 32, 128 and 256 (the wide kernels: the output in 128-column
    windows, the backward's D in windows) at (100, 100) with the pad mask
    and the relation chain: the forward, and the backward where its tiles
    fit (else its refusal)."""
    args, m, _, r = on(dev, dt, *make(2, 4, 100, 100, D, "mask+rel", R=64, seed=D))
    out, keep, pre = FA.attention_fwd(*args, m, None, r, dropout_r=RATE, seed=D, want_pre=True)
    want = FA.fused_attention_reference(*[t.float() for t in args], m, rel=tuple(map(f32, r)),
                                        keep=keep, dropout_r=RATE)
    torch.testing.assert_close(out.float(), want, rtol=0,
                               atol=5e-2 if dt == torch.bfloat16 else 1e-3)
    do = torch.randn(2, 4, 100, D, generator=torch.Generator().manual_seed(D)).to(dev, dt)
    check_backward(args, m, None, r, keep, pre, RATE, do, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,D,Lq,Lk,kind", [(32, 16, 100, 100, "mask+rel"),
                                           (20, 32, 36, 36, "mask+rel"),
                                           (8, 64, 100, 114, "none"),
                                           (2, 256, 100, 14, "mask")])
def test_new_op_shapes(dev, H, D, Lq, Lk, kind, dt):
    """The shapes the rest of the op library reaches: 32 heads of 16 with
    the relation chain (two head groups; 20 heads: a group of 16 and one of
    4), keys with no pad mask over concat(y, x) (uniimg_att), 2 heads of 256
    against 14 keys (guided_att_256): the chain's pre against the plain
    chain, the dropout forward and the backward with the relation pass
    against the plain version."""
    args, m, _, r = on(dev, dt, *make(2, H, Lq, Lk, D, kind, R=64, seed=H + D))
    out, keep, pre = FA.attention_fwd(*args, m, None, r, dropout_r=RATE, seed=H,
                                      want_pre=r is not None)
    if r is not None:
        raw, w1, b1, wr, br = (t.float() for t in r)
        want_pre = (torch.matmul(torch.relu(torch.matmul(raw, w1.t()) + b1), wr.t())
                    + br).permute(0, 3, 1, 2)
        torch.testing.assert_close(pre, want_pre, rtol=0, atol=1e-5)
    want = FA.fused_attention_reference(*[t.float() for t in args], m,
                                        None if r is None else torch.log(torch.clamp(
                                            torch.relu(pre), min=1e-6)),
                                        keep=keep, dropout_r=RATE)
    torch.testing.assert_close(out.float(), want, rtol=0,
                               atol=5e-2 if dt == torch.bfloat16 else 1e-3)
    do = torch.randn(2, H, Lq, D, generator=torch.Generator().manual_seed(H)).to(dev, dt)
    check_backward(args, m, None, r, keep, pre, RATE, do, dt)


def test_search_k8_rows_with_the_relation_chain(dev):
    """B 32, H 4 in bf16 with the relation chain (the search's KPATH 8 leg
    per path): the pre residual equals the plain chain (both fp32, 1e-5),
    writing it leaves o's bits unchanged, and forward and backward match the
    plain version."""
    args, m, _, r = on(dev, torch.bfloat16, *make(32, 4, 100, 100, 64, "mask+rel", R=64,
                                                  seed=10))
    out, keep, pre = FA.attention_fwd(*args, m, None, r, dropout_r=RATE, seed=5, want_pre=True)
    plain_out, _, none = FA.attention_fwd(*args, m, None, r, dropout_r=RATE, seed=5)
    assert none is None and torch.equal(out, plain_out)
    raw, w1, b1, wr, br = (t.float() for t in r)
    want_pre = (torch.matmul(torch.relu(torch.matmul(raw, w1.t()) + b1), wr.t())
                + br).permute(0, 3, 1, 2)
    assert pre.dtype == torch.float32 and pre.shape == (32, 4, 100, 100)
    torch.testing.assert_close(pre, want_pre, rtol=0, atol=1e-5)
    want = FA.fused_attention_reference(*[t.float() for t in args], m, rel=tuple(map(f32, r)),
                                        keep=keep, dropout_r=RATE)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=5e-2)
    do = torch.randn(32, 4, 100, 64, generator=torch.Generator().manual_seed(11)).to(
        dev, torch.bfloat16)
    check_backward(args, m, None, r, keep, pre, RATE, do, torch.bfloat16)


# The VGD net's attention shapes: a 15-token query (MAX_TOKEN + 1, its last
# slot always a pad), so the encoder's SA is 15x15 and the decoder's GA
# 100x15, at the fixed net's B 64, 8 heads of 64, and at the search's B 128,
# 4 heads of 64 (HSIZE 256, KPATH 1).
VGD_SHAPES = [(15, 15), (100, 15)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk", VGD_SHAPES)
@pytest.mark.parametrize("B,H", [(64, 8), (128, 4)])
def test_vgd_shapes_match_plain_version(dev, B, H, Lq, Lk, dt):
    """The forward, the dropout forward (its keep mask the Philox bits of
    `keep_mask_reference`: 15 keys end on a partial group of 4) and the
    backward on that mask, against the plain version with the pad mask."""
    args, m, _, _ = on(dev, dt, *make(B, H, Lq, Lk, 64, "mask", seed=Lq * Lk))
    tol = 5e-2 if dt == torch.bfloat16 else 1e-4
    got = FA.fused_attention(*args, m)
    want = FA.fused_attention_reference(*[t.float() for t in args], m)
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)
    out, keep, _ = FA.attention_fwd(*args, m, dropout_r=RATE, seed=77 + Lq)
    assert torch.equal(keep.cpu().bool(), FA.keep_mask_reference(77 + Lq, B, H, Lq, Lk, RATE))
    want = FA.fused_attention_reference(*[t.float() for t in args], m, keep=keep, dropout_r=RATE)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=tol)
    do = torch.randn(B, H, Lq, 64, generator=torch.Generator().manual_seed(Lq)).to(dev, dt)
    assert bwd_fits(Lq, Lk, 64, dt)
    check_backward(args, m, None, None, keep, None, RATE, do, dt)


# The ITM net's attention shapes (arch/mmnas_itm.json): 50-token captions of
# 3 to 12 words and 36 regions of 8 to 36 objects, so the text SA is 50x50,
# the region SA and RSA 36x36 and the GA 36x50, every row's keys a valid
# prefix and a pad tail; at the train step's B 64 H 8, the eval scorer's 256
# pairs (EVAL_BATCH_SIZE * 2, forward only) and the search's B 128 H 4.
ITM_SHAPES = [(50, 50, "mask"), (36, 36, "mask"), (36, 36, "mask+rel"), (36, 50, "mask")]
PAD_VALID = {50: (3, 12), 36: (8, 36)}


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,kind", ITM_SHAPES)
@pytest.mark.parametrize("B,H,train", [(64, 8, True), (256, 8, False), (128, 4, True)])
def test_itm_shapes_match_plain_version(dev, B, H, train, Lq, Lk, kind, dt):
    """The forward and, at the train shapes, the dropout forward (its keep
    mask the Philox bits of `keep_mask_reference`) and the backward on that
    mask (with the RSA chain its relation pass too, on binary-fraction
    relation inputs, see make_rel), against the plain version."""
    q, k, v, _, _, _ = make(B, H, Lq, Lk, 64, "plain", seed=Lq * Lk + B)
    lo, hi = PAD_VALID[Lk]
    valid = torch.randint(lo, hi + 1, (B, 1, 1, 1), generator=torch.Generator().manual_seed(B))
    mask = torch.arange(Lk).view(1, 1, 1, Lk) >= valid
    args, m, _, _ = on(dev, dt, q, k, v, mask, None, None)
    r = make_rel(B, H, Lq, Lk, 4, 64, dt, dev, seed=Lq + B)[0] if "rel" in kind else None
    f32_rel = None if r is None else tuple(map(f32, r))
    tol = 5e-2 if dt == torch.bfloat16 else (1e-3 if r is not None else 1e-4)
    got = FA.fused_attention(*args, m, rel=r)
    want = FA.fused_attention_reference(*[t.float() for t in args], m, rel=f32_rel)
    torch.testing.assert_close(got.float(), want, rtol=0, atol=tol)
    if not train:
        return
    out, keep, pre = FA.attention_fwd(*args, m, None, r, dropout_r=RATE, seed=91 + Lk,
                                      want_pre=r is not None)
    assert torch.equal(keep.cpu().bool(), FA.keep_mask_reference(91 + Lk, B, H, Lq, Lk, RATE))
    want = FA.fused_attention_reference(*[t.float() for t in args], m, rel=f32_rel, keep=keep,
                                        dropout_r=RATE)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=tol)
    do = torch.randn(B, H, Lq, 64, generator=torch.Generator().manual_seed(Lq)).to(dev, dt)
    assert bwd_fits(Lq, Lk, 64, dt)
    before = FA.LAUNCHES["fused_attention_bwd_rel"]
    check_backward(args, m, None, r, keep, pre, RATE, do, dt)
    assert FA.LAUNCHES["fused_attention_bwd_rel"] == before + (r is not None)


def test_relation_pass_live_mask_flips_on_random_inputs(dev):
    """B 128, H 4, (100, 100): see `check_live_mask_flips`."""
    check_live_mask_flips(dev, 128, 4, 100, seed=21)


@pytest.mark.parametrize("B,H", [(64, 8), (128, 4)])
def test_itm_relation_pass_live_mask_flips_on_random_inputs(dev, B, H):
    """The ITM net's RSA, (36, 36), at the train step's and the search's
    batch and heads: see `check_live_mask_flips`."""
    check_live_mask_flips(dev, B, H, 36, seed=22)


def check_live_mask_flips(dev, B, H, L, seed):
    """(L, L), Rr 4, R 64, fp32 on random (not grid) inputs:
    where u = raw W1^T + b1 lies within rounding of 0 the kernel's FMA chain
    (u = fma(raw_c, W1[r, c], u) from b1, c = 0..Rr-1) and the plain
    version's matmul may disagree on relu's live mask. The test computes the
    kernel's u in the kernel's order (each fma exact in fp64, then rounded
    to fp32), counts the elements whose mask differs from the plain
    version's, and holds draw, dW1, db1 and dWr to the plain version within
    1e-4 of the largest (the sums' order, as the grid cases) plus those
    elements' whole contribution: |du| |raw_c| to dW1, |du| to db1,
    |du| |W1[r, c]| to draw, |u| |dpre| to dWr."""
    Rr, R = 4, 64
    rel, dpre = make_rel(B, H, L, L, Rr, R, torch.float32, dev, seed=seed, exact=False)
    got = FA.relation_bwd(*rel, dpre, need_draw=True)
    want = FA.relation_bwd_reference(*rel, dpre, need_draw=True)
    raw, w1, b1, wr, _ = rel
    u_plain = torch.matmul(raw, w1.t()) + b1
    u_kernel = b1.double().expand(B, L, L, R)
    for c in range(Rr):
        u_kernel = (raw[..., c:c + 1].double() * w1[:, c].double() + u_kernel).float().double()
    flip = (u_kernel > 0) != (u_plain > 0)
    du = torch.matmul(dpre.permute(0, 2, 3, 1), wr).abs() * flip       # [B, L, L, R]
    bound = (torch.einsum("bijr,bijc->rc", du, raw.abs()),
             du.sum((0, 1, 2)),
             torch.einsum("bijr,rc->bijc", du, w1.abs()),
             torch.einsum("bijr,bhij->hr", u_plain.abs() * flip, dpre.abs()))
    diffs = {}
    for name, g, w, extra in zip(("dW1", "db1", "draw", "dWr"), (got[1], got[2], got[0], got[3]),
                                 (want[1], want[2], want[0], want[3]), bound):
        d = (g - w).abs()
        slack = d - extra - 1e-4 * w.abs().max()
        diffs[name] = (d.max().item(), extra.max().item(), w.abs().max().item())
        assert slack.max().item() <= 0, (name, diffs[name])
    print(f"relation pass B{B} H{H} ({L},{L}) random inputs: {int(flip.sum())} of {flip.numel()} "
          f"live-mask flips (|u| <= {u_plain.abs()[flip].max().item() if flip.any() else 0:.2e});"
          " max |kernel - plain|, flip contribution, max |plain|: "
          + "; ".join(f"{n} {a:.3e} {b:.3e} {c:.3e}" for n, (a, b, c) in diffs.items()))
