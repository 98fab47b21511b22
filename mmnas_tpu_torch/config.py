"""Configuration system (TPU rebuild of the reference `Cfg` god-objects).

The reference builds a per-task `Cfg(Path)` object holding every
hyperparameter (train_vqa.py:82-191, search_vqa.py:42-167, train_vgd.py:92-,
train_itm.py:83-). Here the same surface is a plain dataclass so it can be
threaded through jitted functions as static metadata. Field names keep the
reference's UPPER_CASE spelling so configs read identically across repos.

Only fields that affect the TPU build are kept; CUDA/NCCL plumbing fields
(N_GPU, DEVICE_IDS, MASTER_PORT...) are replaced by the mesh config in
mmnas_tpu.parallel.

The port's own copy of mmnas_tpu/config.py: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass
class Cfg:
    """Shared hyperparameters (defaults = reference VQA train config,
    train_vqa.py:120-186)."""

    TASK: str = "vqa"                 # vqa | vgd | itm
    RUN_MODE: str = "train"           # train | val | test
    VERSION: str = "train"
    SEED: int = 888
    DEBUG: bool = False

    # data
    BATCH_SIZE: int = 64
    EVAL_BATCH_SIZE: int = 64
    NUM_WORKERS: int = 4
    TRAIN_SPLIT: str = "train"
    DATASET: str = ""                 # task-specific (vgd: refcoco..., itm: flickr)
    FEAT: str = ""                    # vgd feature mode (vg_woref | coco_mrcn)
    DATA_ROOT: str = "./data"
    SYNTH: bool = False               # synthetic data mode (no datasets on disk)
    SYNTH_SIZE: int = 512             # synthetic dataset length

    # features / embeddings (train_vqa.py:136-142)
    BBOX_FEATURE: bool = False
    FRCNFEAT_LEN: int = 100
    FRCNFEAT_SIZE: int = 2048
    BBOXFEAT_EMB_SIZE: int = 2048
    GLOVE_FEATURE: bool = True
    WORD_EMBED_SIZE: int = 300
    REL_SIZE: int = 64
    MAX_TOKEN: int = 14               # vqa 14 / vgd 15 / itm 50

    # network (train_vqa.py:144-154)
    LAYERS: int = 1
    HSIZE: int = 512
    DROPOUT_R: float = 0.1
    OPS_RESIDUAL: bool = True
    OPS_NORM: bool = True
    ATTFLAT_GLIMPSES: int = 1
    ATTFLAT_OUT_SIZE: int = 1024      # HSIZE * 2
    ATTFLAT_MLP_SIZE: int = 512

    # optimizer (train_vqa.py:156-185): 'wadam' = Adam + step warmup,
    # 'sgd' = momentum SGD + cosine annealing (train_vqa.py:163-170)
    NET_OPTIM: str = "wadam"
    NET_MOMENTUM: float = 0.9
    NET_LR_MIN: float = 0.004
    # Dropped reference field: REDUCTION — always 'sum' in every reference
    # Cfg ('mean' only as a commented-out line, train_vqa.py:159-160); our
    # losses hard-code sum reduction at their definitions
    NET_OPTIM_WARMUP: bool = True
    NET_LR_BASE: float = 0.00012
    NET_WEIGHT_DECAY: float = 0.0
    NET_GRAD_CLIP: float = 1.0        # -1 disables
    NET_LR_DECAY_R: float = 0.2
    NET_LR_DECAY_LIST: Sequence[int] = (10, 12)
    OPT_BETAS: Tuple[float, float] = (0.9, 0.98)
    OPT_EPS: float = 1e-9
    MAX_EPOCH: int = 13

    # vgd (train_vgd.py:155-162): box-label + loss config
    SCORES_LOSS: str = "kld"          # 'kld' target distribution or 'bce'
    BBOX_NORM: bool = True
    BBOX_NORM_MEANS: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    BBOX_NORM_STDS: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    OVERLAP_THRESHOLD: float = 0.5
    LOSS_AVG: bool = True
    LOSS_LAMBDA: float = 0.5

    # itm (train_itm.py:133-163): hard-negative mining + triplet loss
    NEG_BATCHSIZE: int = 50
    NEG_RANDSIZE: int = 64
    NEG_HARDSIZE: int = 5
    NEG_NEPOCH: int = 1
    NEG_START_EPOCH: int = 0
    MINE_SEMIHARD: bool = False       # beyond-reference: drop mined
                                      # negatives that tie/beat the item's
                                      # strongest own positive (likely
                                      # mislabeled true matches). The
                                      # reference mines unfiltered
                                      # (train_itm.py:299-363); under label
                                      # noise that mines FALSE negatives
                                      # (docs/evidence/
                                      # rehearsal_itm_scaled.json: mining
                                      # pass spikes loss 0.7->3.75).
                                      # MEASURED NEGATIVE at 30% caption
                                      # noise (rehearsal_itm_scaled_
                                      # semihard.json): the own-positive
                                      # threshold is itself noisy there
    MINE_SKIP_TOP: int = 0            # beyond-reference: drop each item's
                                      # k top-scored mined candidates and
                                      # keep the next NEG_HARDSIZE. Under
                                      # label noise false negatives (true
                                      # matches) concentrate at rank 1-2;
                                      # skipping them keeps the hard band
                                      # below without consulting the noisy
                                      # own-positive score (contrast
                                      # MINE_SEMIHARD). 0 = reference
                                      # parity (top-H, train_itm.py:299-363)
    MINE_NOISE_Q: float = 0.0         # beyond-reference noise-robust mining:
                                      # pool own-positive scores CORPUS-WIDE
                                      # and flag the bottom-q fraction of
                                      # captions as label-noise suspects
                                      # (a corrupted caption's own pair
                                      # scores at stranger level, so ranking
                                      # captions against each other is
                                      # robust where the per-item semihard
                                      # threshold is not). Flagged captions
                                      # are dropped from every image's
                                      # candidate pool (they may be someone
                                      # else's true match) and get RANDOM
                                      # instead of mined image negatives
                                      # (their top-scored candidate is
                                      # likely their true image). 0 = off
    ITM_DOUBLE_POS: bool = True       # reference BCE_Loss counts loss_pos
                                      # twice (itm_loss.py:22) — kept for
                                      # parity, flag to disable
    TEXT_ENC_BLOCK: int = 0           # captions per resident encoded-text
                                      # block for ITM mining/eval sweeps
                                      # (0 = whole corpus; set ~16384 at
                                      # Flickr30K train scale where the
                                      # full table exceeds HBM)
    EVAL_PAIRS: int = 0               # (image, caption) pairs per jitted
                                      # eval dispatch (0 = legacy
                                      # EVAL_BATCH_SIZE*2*n_shards); large
                                      # tiles amortize the per-dispatch
                                      # constant at real corpus sizes
    TEXT_ENC_CHUNK: int = 256         # captions per text-encoder dispatch
                                      # in the mining/eval sweeps

    # genotype (fixed-arch runs)
    ARCH_PATH: str = "./arch/mcan.json"
    GENO_EPOCH: int = 0

    # checkpointing
    RESUME: bool = False
    CKPT_FILE_PATH: Optional[str] = None
    CKPT_ROOT: str = "./logs/ckpts/"
    CKPT_BACKEND: str = "pickle"      # 'pickle' (reference-parity files) or
                                      # 'orbax' (async TPU-native saves;
                                      # train/checkpoint.py)
    CKPT_EVERY: int = 1               # save every N epochs (1 = per-epoch,
                                      # reference parity train_vqa.py:315-321;
                                      # the final epoch is always saved).
                                      # Device->host fetch of the full
                                      # params+optimizer tree dominates
                                      # short-epoch runs on slow links.
    LOG_ROOT: str = "./logs/log/"
    ARCH_ROOT: str = "./arch/"        # EVAL_PATH['arch'] (filepath_vqa.py:27)

    # TPU execution
    N_DEVICES: int = 0                # 0 = all visible devices
    MODEL_AXIS: int = 1               # mesh model-axis size (tensor
                                      # parallelism; 1 = pure DP, the
                                      # reference's only strategy). Params
                                      # follow parallel/sharding.py
                                      # megatron rules when > 1
    DTYPE: str = "float32"            # compute dtype for activations
    USE_PALLAS: bool = False          # fused attention kernels
    REMAT: bool = False               # jax.checkpoint candidate ops
                                      # (trades recompute for memory in
                                      # all-branch arch steps / big batches)
    PROFILE: bool = False             # jax.profiler trace of epoch 0 to
                                      # LOG_ROOT/profile_<VERSION>/
    DEVICE_REL: bool = False          # compute geometry relation tensors on
                                      # device from raw boxes (loaders ship
                                      # [K,4] instead of [K,K,4]); VQA/VGD
                                      # paths (K=100); ITM keeps host rel
                                      # (K=36, triplet batch plumbing)
    SHIP_INT8: bool = False           # whole-batch VQA loader ships region
                                      # features as int8 + per-region fp32
                                      # scale (dequantized in the jitted
                                      # stem): halves the H2D bytes vs the
                                      # fp16 default. For transfer-bound
                                      # hosts (measured ~45-54MB/s on this
                                      # image's relay TPU attachment —
                                      # docs/perf_analysis.md round-5
                                      # decomposition). Opt-in: adds
                                      # <=scale/2 rounding noise per
                                      # element (<=0.4% of the region's
                                      # peak activation; parity-tested)
    MULTIHOST: bool = False           # jax.distributed.initialize() first
    EVAL_EVERY_EPOCH: bool = True

    def __post_init__(self):
        # 0 would ZeroDivisionError at the first `epoch % CKPT_EVERY` gate
        # (engine/vqa.py checkpoint cadence); negatives silently degrade to
        # final-epoch-only saves — reject both at construction time.
        if self.CKPT_EVERY < 1:
            raise ValueError(
                f"CKPT_EVERY must be >= 1, got {self.CKPT_EVERY} "
                "(1 = per-epoch reference parity)")
        # negative values would make the ITM sweep loops silently EMPTY
        # (range with a negative step / empty tile range) — garbage
        # negatives and all-zero score matrices instead of an error
        for knob in ("TEXT_ENC_BLOCK", "EVAL_PAIRS"):
            if getattr(self, knob) < 0:
                raise ValueError(f"{knob} must be >= 0 (0 = default), "
                                 f"got {getattr(self, knob)}")
        # the mining sweeps select candidate ranks [skip, skip+H) out of R
        # drawn candidates — an out-of-range window would silently return
        # fewer than NEG_HARDSIZE negatives per item
        if (self.MINE_SKIP_TOP < 0
                or self.MINE_SKIP_TOP + self.NEG_HARDSIZE
                > self.NEG_RANDSIZE):
            raise ValueError(
                f"MINE_SKIP_TOP must satisfy 0 <= skip <= "
                f"NEG_RANDSIZE-NEG_HARDSIZE "
                f"({self.NEG_RANDSIZE}-{self.NEG_HARDSIZE}), "
                f"got {self.MINE_SKIP_TOP}")
        if self.TEXT_ENC_CHUNK < 1:
            raise ValueError(f"TEXT_ENC_CHUNK must be >= 1, "
                             f"got {self.TEXT_ENC_CHUNK}")
        if not 0.0 <= self.MINE_NOISE_Q < 1.0:
            raise ValueError(f"MINE_NOISE_Q must be in [0, 1), "
                             f"got {self.MINE_NOISE_Q}")
        # the noise filters are alternative hypotheses, not composable
        # layers: semihard sinks candidates to -inf, so a rank window
        # [skip, skip+H) over an under-filled pool would RE-include masked
        # candidates, and noise-q changes what both operate on (ADVICE r4)
        filters = [n for n, on in (("MINE_SEMIHARD", self.MINE_SEMIHARD),
                                   ("MINE_SKIP_TOP", self.MINE_SKIP_TOP > 0),
                                   ("MINE_NOISE_Q", self.MINE_NOISE_Q > 0))
                   if on]
        if len(filters) > 1:
            raise ValueError(
                "at most one mining noise filter may be active, got "
                + "+".join(filters))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


@dataclass
class SearchCfg(Cfg):
    """Supernet-search hyperparameters (search_vqa.py:42-167 defaults)."""

    HSIZE: int = 256
    ATTFLAT_OUT_SIZE: int = 512       # HSIZE * 2
    NODES: Sequence[Tuple[str, int]] = (("enc", 12), ("dec", 18))
    SPLIT_PORTION: float = 0.8        # train/arch bilevel split
    NET_LR_BASE: float = 0.0004
    NET_LR_DECAY_LIST: Sequence[int] = ()
    MAX_EPOCH: int = 100
    ALPHA_START: int = 20             # first epoch with arch steps
    ALPHA_EVERY: int = 5              # arch step every N weight steps
    ALPHA_BINARY_MODE: str = "full"   # 'full' (all branches) or 'two'
                                      # (two-path sampling + pair rescale,
                                      # mixed.py:136-148,200-208)
    ALPHA_LR_BASE: float = 0.1
    ALPHA_WEIGHT_DECAY: float = 0.0
    ALPHA_OPT_BETAS: Tuple[float, float] = (0.0, 0.999)
    KPATH: int = 1                    # weight step samples K independent
                                      # paths per step, each on a strided
                                      # 1/K batch slice, one union-masked
                                      # optimizer update (reference
                                      # semantics at BS/K; the serialized
                                      # 30-node chain is the latency floor,
                                      # K chains give the scheduler
                                      # independent work — see
                                      # docs/perf_analysis.md round-4 row)
    SCAN_STEPS: int = 1               # fuse N engine steps into ONE jitted
                                      # lax.scan dispatch (arch steps fire
                                      # inside via lax.cond at the same
                                      # (step+1) % ALPHA_EVERY positions,
                                      # same per-step RNG streams — parity
                                      # tested). Collapses per-step dispatch
                                      # overhead N-fold; on this image's
                                      # remote-relay TPU the per-step K8
                                      # search dispatch measures ~7.5s/step
                                      # vs a 112ms device step, so the
                                      # fused mode is the difference
                                      # between ~34 and ~2289 ex/s
                                      # (docs/evidence/bench_engine_loop_*).
                                      # Must be a multiple of ALPHA_EVERY;
                                      # 1 = reference-parity per-step loop.
    DENSE_WEIGHT_STEP: bool = False   # weight steps run ALL branches with
                                      # one-hot straight-through gates
                                      # (identical forward/grads to the
                                      # lax.switch path — tested) instead
                                      # of switching programs. MEASURED
                                      # (v5e-1, 2026-08-17, BS128 bf16):
                                      # 841.5 ex/s vs 2051 sampled — the
                                      # all-branch backward (inactive-
                                      # branch select cotangents, 51% in
                                      # one embedding-grad fusion) costs
                                      # far more than the ~27% switch
                                      # boundary it removes. Kept as the
                                      # documented negative result.
    UNIFIED_WEIGHT_STEP: bool = False  # weight steps run the switch-free
                                      # program: the 3 dec attention
                                      # candidates merged into ONE program
                                      # (params gathered by sampled index,
                                      # concat-kv + gate-built masks) and
                                      # feed_forward where-selected; zero
                                      # lax.switch in the chain. Identical
                                      # forward/grads to 'sampled'
                                      # (tests/test_unified.py).
    HYBRID_WEIGHT_STEP: bool = False  # weight steps run switch-free enc
                                      # (both tiny L=14 text branches,
                                      # where-selected) + sampled-switch
                                      # dec: removes 12 of 30 switch
                                      # sites at ~no extra FLOPs. MEASURED
                                      # (v5e-1, 2026-08-18, bf16): 1993
                                      # ex/s at BS128 vs 2051 sampled —
                                      # the removed boundaries are worth
                                      # less than the always-on second
                                      # enc branch. Kept as the fourth
                                      # documented negative result
                                      # (docs/perf_analysis.md); parity
                                      # tested in tests/test_unified.py
    def __post_init__(self):
        super().__post_init__()
        # misaligned chunks would shift which steps fire arch updates
        # relative to the reference's (step+1) % ALPHA_EVERY schedule
        if self.SCAN_STEPS < 1 or (self.SCAN_STEPS > 1
                                   and self.SCAN_STEPS % self.ALPHA_EVERY):
            raise ValueError(
                f"SCAN_STEPS must be 1 or a multiple of ALPHA_EVERY="
                f"{self.ALPHA_EVERY}, got {self.SCAN_STEPS}")

    # Dropped reference fields: ALPHA_INIT_TYPE (its normal/uniform pre-init
    # is unconditionally overwritten by the biased MCAN init in the
    # reference, hygr_vqa.py:135-156) and GENOTYPES_K (set at
    # search_vqa.py:164 but read by nothing).


# ---------------------------------------------------------------------------
# argparse parity (train_vqa.py:23-79). Train scripts share this surface; the
# reference search scripts take no CLI args (module constants) but we expose
# the same parser for them as a usability fix (SURVEY.md §5 config tiers).
# ---------------------------------------------------------------------------

def _positive_int(s: str) -> int:
    v = int(s)
    if v < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {v}")
    return v


def make_arg_parser(task: str, search: bool = False) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=f"mmnas_tpu {task} args")
    p.add_argument("--RUN", dest="RUN_MODE", default="train",
                   choices=["train", "val", "test"], type=str)
    p.add_argument("--SPLIT", dest="TRAIN_SPLIT", default="train", type=str)
    p.add_argument("--BS", dest="BATCH_SIZE", default=64, type=int)
    p.add_argument("--NW", dest="NUM_WORKERS", default=4, type=int)
    p.add_argument("--ARCH_PATH", dest="ARCH_PATH",
                   default="./arch/mcan.json", type=str)
    p.add_argument("--GENO_EPOCH", dest="GENO_EPOCH", default=0, type=int)
    p.add_argument("--GPU", dest="GPU", default="0", type=str,
                   help="kept for reference-CLI parity; on TPU use --NDEV")
    p.add_argument("--NDEV", dest="N_DEVICES", default=0, type=int,
                   help="TOTAL devices in the mesh (0 = all); the data "
                        "axis is NDEV/MODEL_AXIS")
    p.add_argument("--MODEL_AXIS", dest="MODEL_AXIS", default=1, type=int,
                   help="mesh model-axis size for tensor parallelism "
                        "(1 = pure data parallelism)")
    p.add_argument("--SEED", dest="SEED", default=None, type=int)
    p.add_argument("--VERSION", dest="VERSION", default=f"{'search' if search else 'train'}_{task}", type=str)
    p.add_argument("--RESUME", dest="RESUME", default=False, action="store_true")
    p.add_argument("--CKPT_PATH", dest="CKPT_FILE_PATH", type=str)
    p.add_argument("--CKPT_BACKEND", dest="CKPT_BACKEND", default="pickle",
                   choices=["pickle", "orbax"],
                   help="checkpoint serialization: reference-parity pickle "
                        "or async orbax directories")
    p.add_argument("--CKPT_EVERY", dest="CKPT_EVERY", default=1,
                   type=_positive_int,
                   help="save a checkpoint every N epochs (final epoch "
                        "always saved; 1 = reference per-epoch parity)")
    p.add_argument("--DATA_ROOT", dest="DATA_ROOT", default="./data", type=str)
    p.add_argument("--SYNTH", dest="SYNTH", default=False, action="store_true",
                   help="synthetic fixed-shape data (no dataset required)")
    p.add_argument("--SYNTH_SIZE", dest="SYNTH_SIZE", default=512, type=int)
    p.add_argument("--MAX_EPOCH", dest="MAX_EPOCH", default=0, type=int,
                   help="override config MAX_EPOCH (0 = default)")
    p.add_argument("--USE_PALLAS", dest="USE_PALLAS", default=False,
                   action="store_true")
    p.add_argument("--DTYPE", dest="DTYPE", default="float32",
                   choices=["float32", "bfloat16"],
                   help="activation/compute dtype (master weights stay fp32)")
    p.add_argument("--REMAT", dest="REMAT", default=False, action="store_true",
                   help="rematerialize candidate ops (memory for recompute)")
    p.add_argument("--DEVICE_REL", dest="DEVICE_REL", default=False,
                   action="store_true",
                   help="compute box relation tensors on device")
    p.add_argument("--SHIP_INT8", dest="SHIP_INT8", default=False,
                   action="store_true",
                   help="ship region features int8+scale (half the H2D "
                        "bytes; VQA packed batch path)")
    p.add_argument("--PROFILE", dest="PROFILE", default=False,
                   action="store_true",
                   help="jax.profiler trace of the first epoch")
    p.add_argument("--MULTIHOST", dest="MULTIHOST", default=False,
                   action="store_true",
                   help="call jax.distributed.initialize() (multi-host pods)")
    if search:
        p.add_argument("--ALPHA_MODE", dest="ALPHA_BINARY_MODE", default=None,
                       choices=["full", "two"],
                       help="arch-step gate mode (reference ALPHA_BINARY_MODE)")
        p.add_argument("--DENSE_WEIGHT", dest="DENSE_WEIGHT_STEP",
                       default=False, action="store_true",
                       help="weight steps compute all branches + one-hot "
                            "gates instead of lax.switch (perf experiment)")
        p.add_argument("--UNIFIED_WEIGHT", dest="UNIFIED_WEIGHT_STEP",
                       default=False, action="store_true",
                       help="switch-free weight steps: attention family "
                            "merged into one gathered-param program, "
                            "feed_forward where-selected")
        p.add_argument("--HYBRID_WEIGHT", dest="HYBRID_WEIGHT_STEP",
                       default=False, action="store_true",
                       help="switch-free enc (tiny text branches "
                            "where-selected) + sampled-switch dec")
        p.add_argument("--KPATH", dest="KPATH", default=1,
                       type=_positive_int,
                       help="sample K independent paths per weight step, "
                            "each on a 1/K batch slice (union-masked "
                            "single optimizer update)")
        p.add_argument("--SCAN_STEPS", dest="SCAN_STEPS", default=1,
                       type=_positive_int,
                       help="fuse N engine steps into one jitted lax.scan "
                            "dispatch (multiple of ALPHA_EVERY; 1 = "
                            "per-step reference loop). Collapses per-step "
                            "dispatch overhead — essential on remote-"
                            "relay TPU attachments")
    if task == "vgd":
        p.add_argument("--DATASET", dest="DATASET", default="refcoco",
                       choices=["refcoco", "refcoco+", "refcocog"], type=str)
        p.add_argument("--FEAT", dest="FEAT", default="vg_woref",
                       choices=["vg_woref", "coco_mrcn"], type=str)
    if task == "itm":
        p.add_argument("--DATASET", dest="DATASET", default="flickr", type=str)
        p.add_argument("--TEXT_ENC_BLOCK", dest="TEXT_ENC_BLOCK", default=0,
                       type=int,
                       help="captions per resident encoded-text block in "
                            "mining/eval sweeps (0 = whole corpus; use "
                            "~16384 at Flickr30K train scale)")
        p.add_argument("--EVAL_PAIRS", dest="EVAL_PAIRS", default=0, type=int,
                       help="pairs per jitted eval dispatch (0 = "
                            "EVAL_BATCH_SIZE*2*n_shards)")
        p.add_argument("--MINE_SEMIHARD", dest="MINE_SEMIHARD",
                       default=False, action="store_true",
                       help="semi-hard mining: filter mined negatives that "
                            "tie/beat the item's strongest own positive "
                            "(robust to label noise; off = reference "
                            "parity)")
        p.add_argument("--MINE_SKIP_TOP", dest="MINE_SKIP_TOP",
                       default=0, type=int,
                       help="drop each item's k top-scored mined "
                            "candidates, keep the next NEG_HARDSIZE "
                            "(false negatives under label noise rank "
                            "first; 0 = reference parity)")
        p.add_argument("--MINE_NOISE_Q", dest="MINE_NOISE_Q",
                       default=0.0, type=float,
                       help="flag the bottom-q fraction of captions by "
                            "corpus-pooled own-positive score as label-"
                            "noise suspects: drop them from candidate "
                            "pools, give them random image negatives "
                            "(0 = reference parity)")
    return p


def cfg_from_args(task: str, args, search: bool = False) -> Cfg:
    cls = SearchCfg if search else Cfg
    cfg = cls(TASK=task)
    if task == "vgd":
        # query tensor is MAX_TOKEN+1=15 ints, rel stays 14x14
        # (load_data_vgd.py:189-200 quirk); lr differs (train_vgd.py:196)
        cfg = cfg.replace(MAX_TOKEN=14, NET_LR_BASE=0.00014 if not search else cfg.NET_LR_BASE)
    elif task == "itm":
        # train_itm.py:140-196: 36 regions, 50 tokens, BCE triplets,
        # lr 1.5e-4, decay at epoch 36, 100 epochs
        cfg = cfg.replace(MAX_TOKEN=50, FRCNFEAT_LEN=36, SCORES_LOSS="bce",
                          DATASET=getattr(args, "DATASET", "flickr") or "flickr")
        if not search:
            cfg = cfg.replace(NET_LR_BASE=0.00015, NET_LR_DECAY_LIST=(36,),
                              MAX_EPOCH=100)
    overrides = {}
    for f in dataclasses.fields(cls):
        if hasattr(args, f.name) and getattr(args, f.name) is not None:
            overrides[f.name] = getattr(args, f.name)
    if getattr(args, "SEED", None) is None:
        overrides["SEED"] = random.randint(0, 9999)  # train_vqa.py:102-105
    if getattr(args, "MAX_EPOCH", 0) in (0, None):
        overrides.pop("MAX_EPOCH", None)
    cfg = cfg.replace(**overrides)
    # per-epoch eval is disabled when the val split is trained on or when
    # not training (train_vqa.py:126-130)
    if ("val" in cfg.TRAIN_SPLIT.split("+")) or cfg.RUN_MODE != "train":
        cfg = cfg.replace(EVAL_EVERY_EPOCH=False)
    if task == "itm" and not search:
        cfg = cfg.replace(EVAL_BATCH_SIZE=cfg.BATCH_SIZE * 2)  # train_itm.py:133
    else:
        # reference ties eval batch to train batch (train_vqa.py:134)
        cfg = cfg.replace(EVAL_BATCH_SIZE=cfg.BATCH_SIZE)
    # data and tensor parallelism, one process per card (parallel/mesh.py
    # launch): --MULTIHOST joins torchrun's group, several --GPU ids or
    # --NDEV N spawn a process per card; the launcher refuses cards the
    # machine has not. --MODEL_AXIS M lays the world out as world / M data
    # shards of M model ranks (parallel/sharding.py), refused here with the
    # JAX package's words (mmnas_tpu/parallel/mesh.py:41-42) where M does
    # not divide the world, and under --MULTIHOST when the group is joined
    gpus = [g for g in str(getattr(args, "GPU", "0")).split(",") if g.strip()]
    if len(gpus) > 1 and cfg.N_DEVICES not in (0, len(gpus)):
        raise ValueError(f"--NDEV {cfg.N_DEVICES} and --GPU {args.GPU} name different worlds")
    if cfg.MULTIHOST and (len(gpus) > 1 or cfg.N_DEVICES > 1):
        raise ValueError("--MULTIHOST takes its world from torchrun (one process per card, "
                         "on cuda:LOCAL_RANK): no --GPU list and no --NDEV")
    world = len(gpus) if len(gpus) > 1 else max(cfg.N_DEVICES, 1)
    if cfg.MODEL_AXIS < 1 or (not cfg.MULTIHOST and world % cfg.MODEL_AXIS):
        raise ValueError(f"n_devices {world} not divisible by model_axis {cfg.MODEL_AXIS}")
    # flags the JAX package accepts where no path reads them; the port refuses them there
    if task == "itm" and cfg.DEVICE_REL:
        raise ValueError(
            "--DEVICE_REL has no ITM path: ITM's relation tensors are built on the host "
            "(the JAX package accepts the flag for ITM and ignores it)")
    if cfg.SHIP_INT8 and (task != "vqa" or cfg.SYNTH or not cfg.DEVICE_REL):
        raise ValueError(
            "--SHIP_INT8 ships int8 features only from the whole-batch VQA loader: VQA on "
            "the packed feature store with --DEVICE_REL (the JAX package accepts the flag "
            "with any other loader and ships float features)")
    suffix = "-search" if search else "-full"
    return cfg.replace(VERSION=cfg.VERSION + suffix)
