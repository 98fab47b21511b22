#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mmnas_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA GPU and nvcc. It
1. prints the card's name and power limit, builds the CUDA kernels from
   mmnas_tpu_torch/csrc (one nvcc per source, all started together),
   prints each attention kernel's registers, spills and HMMA (tensor-core)
   instructions from ptxas and `cuobjdump -sass` (every bf16 attention
   kernel must have some; the relation pass's instantiations for 4 and 8
   heads must not spill) and turns TF32 off for matmuls and cuDNN;
2. drives the probe path, `python -m mmnas_tpu_torch.tools.probes` (the
   five Pallas debug probes of tools/debug/ as CUDA kernels) with exact
   launch counts, holds the bias probes' output against the fp64 numpy
   chain, holds each probe kernel against its plain version (the two bias
   kernels also against each other and against log(max(pre, 1e-6)) of the
   RSA attention forward's pre, bit for bit) and times them and their
   library calls, eager and on the device; prints the bias kernels'
   registers and spills (their fixed instances must not spill, and
   probe_bias2's head loop must hold every feature FMA in the SASS), holds and
   times them at their other instances (Rr 4 H 4, the generic one at Rr 3
   H 5 R 40, and H 8 at the ITM mining's B 3,200 L 36) on the device;
3. holds the forward kernel (no dropout) against its plain PyTorch version
   at the shapes of the searched VQA net (B 64, 8 heads of 64: 14x14,
   100x100, 100x14 with the pad mask, 100x100 with mask + RSA geometry
   chain, 100x100 with an additive bias), in fp32 and bf16, and times both
   and `scaled_dot_product_attention` where one call computes the function;
4. does the same for the training kernels at r = 0.1: the dropout forward
   (keep fraction 0.9 +- 0.005, the mask bits follow the seed and equal the
   numpy Philox, the output equals the plain version on the emitted mask),
   the backward and the relation pass (every gradient equals autograd
   through the plain version on that mask; with the RSA chain the kernel's
   pre residual equals the plain chain, and the output and every gradient
   are held to the plain version on that pre), and times forward, backward,
   forward + backward and, with the RSA chain, the relation pass alone
   (eager and device), each beside its bound (the function's least bytes and operations, see
   `attention_bytes_ops`);
5. repeats 3 and 4 at the search's shapes (B 128, 4 heads of 64: 14x14,
   100x14, 100x100 with the pad mask and with the RSA chain), and in bf16
   at B 32, the rows per path of the KPATH 8 leg; with the RSA chain the
   arch step's backward (no relation input needs a gradient: no dpre, no
   relation pass) gives the full backward's dq, dk, dv bit for bit;
6. drives the eval path, `Execution(cfg, cuda).run()` for `--RUN val
   --SYNTH --ARCH_PATH ./arch/mmnas_vqa.json --BS 64 --SYNTH_SIZE 256` at
   full width (HSIZE 512, 100 regions of 2048), in fp32 and bf16, from a
   checkpoint written in the JAX package's pickle format from a seeded port
   init: 16 forward launches per batch (5 encoder SA, 6 GA, 4 RSA, 1 decoder
   SA), finite logits that match the same net and batch on the CPU; then
   the serving export (`export_path`, mmnas_tpu_torch/tools/export_serving.py):
   the same net's eval forward (fp32, batch 64, a fresh seeded init)
   through torch.export with a static and with a symbolic batch, 16 nodes
   of the custom op `mmnas_tpu_torch::fused_attention_fwd` in each graph,
   saved, reloaded and called at 64 (and 32): each call bit for bit the
   in-process forward with exactly 16 forward launches, the output within
   1e-3 of the CPU's on the same weights; the export's seconds, the
   artifact's MB and the reloaded and in-process forwards' ms;
7. drives the training path, `Execution(cfg, cuda).run()` for `--RUN train
   --SYNTH --ARCH_PATH ./arch/mmnas_vqa.json --BS 64 --MAX_EPOCH 1
   --SYNTH_SIZE 640` (10 steps, DROPOUT_R 0.1, the per-epoch eval on), in
   fp32 and in bf16 on fp32 master weights: per step exactly 16
   dropout-forward, 16 backward and 4 relation-pass launches, 16 forward
   launches per eval batch; finite losses, the mean of the last 3 below the
   first. In fp32 the epoch checkpoint exists and the eval path reloads it,
   the train step is timed and profiled, and one step at DROPOUT_R 0 from
   one seeded init gives the CPU's loss (plain versions) and, leaf by leaf,
   the gradient of the plain versions in the kernels' place on the card;
8. drives the search path, `SearchExecution(cfg, cuda).run()` for `--SYNTH
   --ALPHA_MODE full` with ALPHA_START 0, ALPHA_EVERY 5, DROPOUT_R 0.1: 10
   weight steps and 2 arch steps at HSIZE 256, in fp32 at BS 128, KPATH 1
   (the reference's parity point) and in bf16 at BS 256, KPATH 8 (the
   bench's configuration), with exact launch counts from the sampled paths,
   finite losses, alpha moved, the genotype archive in the reference schema,
   the epoch checkpoint reloaded and resumed from (fp32), fp32 masters and
   optimizer states (bf16), the bf16 weight-step loss near the fp32 one; a
   fixed NetFull at HSIZE 512 built from the dumped genotype evaluates one
   batch; weight and arch steps are timed and profiled on one resident
   batch, and search examples/s counted as bench.py counts them;
8b. drives this slice's main path, the weight step's programs
   (`weight_programs_path`): first the unified decoder node's attention (B
   128, 4 heads of 64, the image queries over the keys of image and text
   with the pad mask and a dense bias: VQA's (100,114), VGD's (100,115),
   ITM's (36,86)) against its plain version, forward, dropout forward and
   backward with dbias, fp32 and bf16, with times, bounds and SDPA's
   (attn_mask = bias + mask); then 8's fp32 leg once with each of
   --DENSE_WEIGHT, --UNIFIED_WEIGHT and --HYBRID_WEIGHT (the paths 8's
   sampled leg recorded, exact launches from the paths in each program,
   finite losses, alpha moved, the archive, the checkpoint; the UNIFIED
   leg's step times), a bf16 --UNIFIED_WEIGHT leg of the VGD and of the ITM
   search (exact launches, not timed), and the unified and hybrid first
   weight step against the sampled one at DROPOUT_R 0 (the loss, each
   leaf's gradient; the RSA chain's leaves against the sampled step that
   computes the chain alike; every step's distance from the sampled step in
   fp64 reported beside);
8c. drives --REMAT (`remat_path`): the bf16 BS 256 KPATH 8 leg's 'full'
   arch step and the fp32 BS 128 KPATH 1 --DENSE_WEIGHT weight step, each
   without and with REMAT on one seeded init, batch, alpha and path at
   DROPOUT_R 0.1, HSIZE 256: the loss and every gradient within REMAT_TOL
   (bit for bit reported), the dropout generator's state after the step
   equal, exact launches (REMAT's recompute launches the dropout forward of
   each attention op the backward reaches again, on its first key), peak
   device memory and step ms both ways;
8d. drives --SCAN_STEPS (`scan_steps_path`): the fp32 VQA --UNIFIED_WEIGHT
   leg with SCAN_STEPS 5 and with SCAN_STEPS 10 under --REMAT (one chunk),
   the bf16 VGD and ITM --UNIFIED_WEIGHT legs with SCAN_STEPS 5 (each
   replayed from the CUDA graphs of its weight and arch step) and the fp32
   sampled leg with SCAN_STEPS 5 (the 'eager' dispatch: the per-step loop,
   its launches the per-step leg's), each against its
   per-step leg of 8 / 8b: the paths' digest, the params, both optimizers'
   moments and step counts and alpha within tests/test_scan_steps.py's
   tolerance (bit for bit reported), the losses; the graphs' launches at
   capture (warm-up and capture each the program's count), 10 weight and 2
   arch replays, no attention launch in the chunks besides, the card's
   launches captured x replays; two replays of the weight step at one seed
   the same loss and at the next another (its masks follow the step's
   seed); capture ms, the replayed steps' ms and the chunk's wall ms a step,
   the device-busy share, beside the per-step leg's eager step; then the
   dropout forward with its key drawn on the card and read by pointer
   (`key_cases`, B 128 H 4 at the search's and the unified node's shapes,
   fp32 and bf16): its mask `keep_mask_reference`'s at the key read back, a
   Python int key the same mask, output and backward against the plain
   version;
9. holds the forward, dropout-forward and backward kernels against their
   plain versions at the VGD net's shapes (B 64, 8 heads of 64: SA 15x15 and
   GA 100x15 with the pad mask, the query being MAX_TOKEN + 1 = 15 tokens)
   and at the VGD search's (B 128, 4 heads of 64, the same two; its RSA
   100x100 is one of 5's shapes), fp32 and bf16, with their times, bounds
   and SDPA's;
10. drives the VGD paths of `arch/mmnas_vgd.json` at full width (HSIZE 512,
   100 regions of 2048, a 15-token query), with the native C++ IoU built:
   eval (`engine/vgd.py` `Execution(cfg, cuda).run()`, `--RUN val --SYNTH
   --BS 64 --SYNTH_SIZE 256`, fp32 and bf16, from a checkpoint in the JAX
   package's pickle format: 19 forward launches per batch (3 encoder SA,
   11 GA, 5 RSA), scores and box deltas of 16 items against the same net on
   the CPU, their IoU@0.5 hits equal away from the threshold); 10 train
   steps (DROPOUT_R 0.1, fp32 and bf16 on fp32 masters: per step 19
   dropout-forward, 19 backward and 5 relation-pass launches, falling
   losses, the checkpoint reloaded, the step timed and profiled, one fp32
   step against the CPU and the plain versions as in 7); the VGD search
   (`engine/search_vgd.py`, SearchCfg HSIZE 256, BS 128, KPATH 1, fp32: 10
   weight and 2 arch steps, exact launches from the sampled paths and the
   argmax-path IoU eval, alpha moved, the genotype archive, the checkpoint,
   step times and device splits);
11. holds the forward (also at the eval scorer's 256 pairs), dropout-forward,
   backward and relation-pass kernels against their plain versions at the
   ITM net's shapes (text SA 50x50, region SA and RSA 36x36, GA 36x50, each
   row's keys a valid prefix and a pad tail, as the ITM loaders give them)
   at B 64 H 8 and at the ITM search's B 128 H 4, fp32 and bf16, and the
   forward at the mining's tiles (NEG_BATCHSIZE * NEG_RANDSIZE = 3,200
   pairs through the decoder's SA, RSA and GA) at the fixed net's 8 heads
   and the search's 4;
12. drives the ITM paths of `arch/mmnas_itm.json` at full width (HSIZE 512,
   36 regions of 2048, 50-token captions; `itm_path`): `--RUN train --SYNTH
   --BS 64 --SYNTH_SIZE 500` in fp32 and bf16 on fp32 masters, mining
   before the epoch (NEG_RANDSIZE 64, NEG_HARDSIZE 5: 12 scorer tiles of
   3,200 pairs), 8 triplet train steps (three forwards each) and the R@K
   eval over the full 100 x 500 score matrix, with exact launches from
   the genotype and the sweeps' sizes; `--RUN val --CKPT_PATH` on the epoch
   checkpoint, its score matrix's 10 x 40 corner against the CPU's; the
   mined negatives of the first items against the CPU's ranking; the split
   trunk against the forward; one fp32 step against the CPU and the plain
   versions as in 7; the train step, mining, text encoder and scorer
   timed and the scorer tile profiled; then the ITM search (`engine/search_itm.py`, SearchCfg HSIZE 256,
   BS 128, KPATH 1, fp32: mining with a sampled path, 10 weight and 2 arch
   steps of three forwards, the argmax path's R@K on the val split, exact
   launches, alpha moved, the archive, the checkpoint, a resumed epoch,
   step times);
13. holds the forward, dropout-forward, backward and relation-pass kernels
   against their plain versions at the shapes the rest of the op library
   reaches (`new_shape_cases`, B 64, fp32 and bf16: 2 heads of 256 at
   (100,100) SA and RSA and (100,14) GA, 32 heads of 16 with the RSA chain
   at (100,100), no pad mask at (100,114) and ITM's (36,86), 8 heads of
   64; and the instances the main path runs on the column-window
   backward: 4 heads of 128 and 16 heads of 32, RSA at (100,100) and no
   pad mask at (100,114)), with one launch per kernel per call and their
   times, bounds and SDPA's; past the new limits (D 272, 33 RSA heads) the
   wrapper refuses;
14. drives this slice's main path (`all_ops_path`): a VQA fixed net whose
   genotype, built from arch/mmnas_vqa.json's node counts, names all 41
   ops, at HSIZE 512: eval (fp32, bf16) with exact launches and 8 items'
   logits against the CPU, one train step (fp32, bf16 on fp32 masters)
   with exact launches, one fp32 step against the CPU and the plain
   versions as in 7;
15. evaluates arch/mmnas_vqa.json on a small VQA corpus in the reference's
   layout, made by tools/make_rehearsal_data.py and packed by
   tools/pack_features.py (run as programs), per item, with --DEVICE_REL
   (the whole-batch loader) and with --DEVICE_REL --SHIP_INT8 (int8
   features), each with exact launches and logits against the CPU, and
   each loader's steady-state examples/s (8 passes over the eval set, the
   first batch left out); and times an empty kernel beside probe_wrblock
   (the launch floor);
16. runs the accuracy rehearsal's runners (`rehearsal_path`,
   mmnas_tpu_torch/tools/rehearsal.py) on 15's corpus with the stub GloVe
   cache and its features packed (fp32): `run_vqa` for 6 epochs and
   `run_vgd` for 8 at full width (HSIZE 512, bf16 on fp32 masters, BS 64,
   arch/mcan.json), VQAEval on val and IoU@0.5 on val and testA, each at
   least 90 on val with its last epoch's loss under half its first, with
   exact launches;
17. drives the data-parallel path (`data_parallel_path`, parallel/mesh.py):
   arch/mmnas_vqa.json at HSIZE 512, fp32, DROPOUT_R 0.1, 5 train steps of
   64 and an eval of 2 batches, then the fp32 search leg (BS 128, KPATH 1) for
   5 weight steps and an arch step, single-process and then through the same
   engine loops in a process group over NCCL: world 1 in this process, whose
   losses, parameters and alpha are the single process's bit for bit, with
   the same kernel launches and one all_reduce per gradient bucket per train,
   weight and arch step; with two or more cards also one spawned process a
   card, whose first all-reduced gradient is the mean of the ranks' shards'
   computed on one card (1e-5 of the largest), the log written by rank 0
   alone, every rank the same search paths and alpha, and whose eval gives
   the single process's predictions in dataset order; the train step's ms
   with and without the group and the all-reduce's share of it;
18. drives the tensor-parallel path (`tensor_parallel_path`,
   parallel/sharding.py): first the forward, dropout-forward, backward
   and relation-pass kernels at a model rank's shapes (B 64, 4 of 8 heads
   at head0 0 and 4; the dropout forward draws the whole call's keep mask
   bit for bit, the RSA chain runs on the block of Wr's rows, the blocks'
   relation gradients make up the whole call's), then 17's work at model
   axis 2: on one card two processes share it in a gloo group, on two or
   more NCCL, data cards // 2 x model 2; at data 1 the losses, the
   gathered parameters and Adam moments and alpha equal the single
   process's (1e-5 of the largest), at data 2 or more the first
   all-reduced gradient the mean of the data shards'; every rank the
   single process's launches, search paths and eval predictions; the
   train step's ms with and without the model group's collectives;
19. prints one JSON line with every kernel's numbers (with x_library and
   x_bound, its time over the library call's and over its bound; `launches`
   from this slice's main path, REMAT's four steps and the SCAN_STEPS legs
   (a graph's: captured x replays + warm-up), each path's own counts beside
   them) and, last, the device line `{"ok": true,
   "device": {...}}`. A device time the profiler did not record in full
   (5 tries) is taken from CUDA events around replays of a CUDA graph of the
   calls, and named so: every device reading `<key>` has `<key>_by`,
   "profiler" or "cuda graph".
Any failed check raises, so the script exits non-zero and prints no result
line. It exits 2 when no CUDA device is present.

Two options run the kernels' build and one part alone, to compare two trees
on one card (copy this file into the root of the other checkout and run it
there: it imports the package beside it):

    python3 chip_smoke.py --step-times   # the VQA search's fp32 steps in
                                         # each weight program (step_times_path)
    python3 chip_smoke.py --parallel     # 17 and 18, with their checks
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "build", "mmnas_tpu_torch", "smoke")
ARCHS = {task: os.path.join(HERE, "arch", f"mmnas_{task}.json")
         for task in ("vqa", "vgd", "itm")}
SOURCES = ("fused_attention_fwd", "fused_attention_bwd", "probes")
KERNELS = {  # name: (source, the TPU kernel it replaces)
    "fused_attention_fwd": ("mmnas_tpu_torch/csrc/fused_attention_fwd.cu",
                            "mmnas_tpu/ops/pallas_attention.py:173"),
    "fused_attention_fwd_dropout": ("mmnas_tpu_torch/csrc/fused_attention_fwd.cu",
                                    "mmnas_tpu/ops/pallas_attention.py:201"),
    "fused_attention_bwd": ("mmnas_tpu_torch/csrc/fused_attention_bwd.cu",
                            "mmnas_tpu/ops/pallas_attention.py:325"),
    "fused_attention_bwd_rel": ("mmnas_tpu_torch/csrc/fused_attention_bwd.cu",
                                "mmnas_tpu/ops/pallas_attention.py:390"),
    "probe_bias": ("mmnas_tpu_torch/csrc/probes.cu", "tools/debug/_probe_bias.py:13"),
    "probe_bias2": ("mmnas_tpu_torch/csrc/probes.cu", "tools/debug/_probe_bias2.py:13"),
    "probe_slice": ("mmnas_tpu_torch/csrc/probes.cu", "tools/debug/_probe_slice.py:7"),
    "probe_outer": ("mmnas_tpu_torch/csrc/probes.cu", "tools/debug/_probe_outer.py:9"),
    "probe_wrblock_a": ("mmnas_tpu_torch/csrc/probes.cu", "tools/debug/_probe_wrblock.py:9"),
    "probe_wrblock_b": ("mmnas_tpu_torch/csrc/probes.cu", "tools/debug/_probe_wrblock.py:21"),
}

B, H, D, RR, R = 64, 8, 64, 4, 64
RATE = 0.1
SYNTH_SIZE, BATCH = 256, 64
TRAIN_SIZE = 640                  # 10 steps of 64
LAUNCHES_PER_BATCH = 16           # arch/mmnas_vqa.json at LAYERS 1
REL_LAUNCHES_PER_BATCH = 4        # its 4 rel_self_att_64 nodes
CASES = [(14, 14, "mask"), (100, 100, "mask"), (100, 14, "mask"),
         (100, 100, "mask+rel"), (100, 100, "bias")]
# arch/mmnas_vgd.json at LAYERS 1: 3 encoder SA, 11 GA, 5 RSA; its query is
# 15 tokens (MAX_TOKEN + 1), so SA 15x15 and GA 100x15
VGD_LAUNCHES_PER_BATCH, VGD_REL_LAUNCHES_PER_BATCH = 19, 5
VGD_CASES = [(15, 15, "mask"), (100, 15, "mask")]
# hits card vs CPU are compared where the CPU's IoU is this far or more
# from the threshold (the outputs agree to LOGIT_TOL, which moves a box's
# corners by far less than this share of its overlap)
VGD_IOU_NEAR = 1e-4
# the search's attention: HSIZE 256 is 4 heads of 64, batch 128 at KPATH 1;
# the bf16 BS 256 KPATH 8 leg hands each kernel 32 rows per path
SEARCH_B, SEARCH_H, SEARCH_K8_B = 128, 4, 32
SEARCH_CASES = [(14, 14, "mask"), (100, 14, "mask"), (100, 100, "mask"), (100, 100, "mask+rel")]
# the search runs: 10 weight steps, an arch step after every 5th
SEARCH_STEPS, ALPHA_EVERY = 10, 5
SEARCH_LEGS = (("float32", 128, 1), ("bfloat16", 256, 8))   # dtype, batch, KPATH
# the weight step's programs (engine/search.py `weight_mode` maps each to its mode)
WEIGHT_FLAGS = ("DENSE_WEIGHT", "UNIFIED_WEIGHT", "HYBRID_WEIGHT")
# the unified decoder node's attention: the image queries over the keys of
# concat(image, text), a pad mask and a dense additive bias: VQA's 100 over
# 100 + 14, VGD's 100 over 100 + 15 and ITM's 36 over 36 + 50
UNIFIED_CASES = [(100, 114, "mask+bias"), (100, 115, "mask+bias"), (36, 86, "mask+bias")]
# the programs' legs besides VQA's fp32 one a flag: (task, dtype, flag)
PROGRAM_LEGS = (("vgd", "bfloat16", "UNIFIED_WEIGHT"), ("itm", "bfloat16", "UNIFIED_WEIGHT"))
VGD_SEARCH_LEGS = (("float32", 128, 1),)
# ITM (arch/mmnas_itm.json): a corpus of 500 captions over 100 images,
# 50-token captions (3 to 12 of them words) and 36 regions (8 to 36 of them
# objects), mined at NEG_RANDSIZE 64 / NEG_HARDSIZE 5; its attention:
# text SA 50x50, region SA and RSA 36x36, GA 36x50, at the train step's
# B 64 H 8, the eval scorer's 256 pairs (EVAL_BATCH_SIZE * 2), the search's
# B 128 H 4, and the mining's tiles (NEG_BATCHSIZE * NEG_RANDSIZE pairs, the
# decoder's shapes, at either net's heads)
ITM_SIZE = 500
ITM_RELOAD_SIZE = 320             # the eval of the epoch checkpoint: 64 images
ITM_SCORER_B = 256
PAD_VALID = {50: (3, 12), 36: (8, 36)}   # valid keys of a "padmask" row, by Lk
ITM_CASES = [(50, 50, "padmask"), (36, 36, "padmask"), (36, 36, "padmask+rel"),
             (36, 50, "padmask")]
ITM_DECODER_CASES = ITM_CASES[1:]       # a scorer tile runs the decoder alone
ITM_SEARCH_LEGS = (("float32", 128, 1),)
ITM_CORNER = (10, 40)             # images x captions of the card-vs-CPU score check
ITM_MINE_CHECK = (2, 4)           # images, captions whose mined negatives the CPU re-ranks
# the ITM CLI's configuration the fixed-net leg must run (make_arg_parser("itm"))
ITM_CFG = {"HSIZE": 512, "MAX_TOKEN": 50, "FRCNFEAT_LEN": 36, "NEG_RANDSIZE": 64,
           "NEG_HARDSIZE": 5, "DROPOUT_R": RATE, "EVAL_EVERY_EPOCH": True,
           "SCORES_LOSS": "bce", "TEXT_ENC_BLOCK": 0}
# the probe CLI's launches: two bias kernels, slice and outer in f32 and
# bf16, the two wrblock layouts
PROBE_LAUNCHES = {"probe_bias": 1, "probe_bias2": 1, "probe_slice": 2, "probe_outer": 2,
                  "probe_wrblock_a": 1, "probe_wrblock_b": 1}
# the bias kernels' other instances the smoke runs (B, H, L, Rr, R): the
# fixed one at 4 heads, the generic one at an odd shape, and the fixed one at
# the ITM mining's tiles (3,200 pairs of 36 regions, 8 heads), where the RSA
# forward computes this chain
BIAS_INSTANCES = ((8, 4, 100, 4, 64), (8, 5, 100, 3, 40), (3200, 8, 36, 4, 64))
# the bias probes against the plain version and the fp64 chain: on
# exp(bias) = max(pre, 1e-6), absolute, and on the bias itself where
# pre > 0.1 (the log turns pre's fp32 rounding, sums of 64 terms of size
# ~1, into large errors near the 1e-6 clamp): 1e-5
PROBE_BIAS_TOL = 1e-5
# kernel vs plain version on the same inputs. fp32: both sum in fp32 in
# other orders; 1e-4, 1e-3 with the RSA chain. With the chain, the kernel's
# pre is held to the plain chain by PRE_TOL, and everything after it (the
# output, every gradient) to the plain version on the kernel's own pre: pre
# sums R = 64 terms of size ~1, so both chains round it by ~1e-7 absolute,
# and near the 1e-6 clamp log(pre) turns that into large score errors. A row
# whose keys all have pre near the clamp then moves by the rounding alone:
# at B 3,200 H 8 (36,36) on an H100 the kernel is 5.1e-3 and the plain fp32
# version 4.4e-3 from an fp64 chain and attention, 1.9e-3 apart
# (`python -m mmnas_tpu_torch.tools.rsa_conditioning`).
# bf16: the kernel rounds probabilities and output to bf16 (unit roundoff
# 2^-8 relative each, |o| < 4) against the plain version run in fp32 on the
# same bf16 inputs: 5e-2.
KERNEL_TOL = {(torch.float32, False): 1e-4, (torch.float32, True): 1e-3,
              (torch.bfloat16, False): 5e-2, (torch.bfloat16, True): 5e-2}
# gradients, kernel vs autograd through the plain version on the same keep
# mask (with the RSA chain, on the kernel's pre, as KERNEL_TOL), as a share
# of the largest reference gradient (the method of
# tests/test_pallas_dropout_tpu.py:5-12): fp32 1e-4 (sums of up to 100
# products in other orders), 1e-3 with the RSA chain (dpre = ds / pre grows
# the rounding of ds near the 1e-6 clamp); bf16 2e-2 (the kernel
# rounds ds and the dropped-out probabilities to bf16, unit roundoff 2^-8
# relative, before its products, and its results to bf16; the plain
# version runs in fp32 on the same bf16 inputs)
GRAD_TOL = {(torch.float32, False): 1e-4, (torch.float32, True): 1e-3,
            (torch.bfloat16, False): 2e-2, (torch.bfloat16, True): 2e-2}
KEEP_TOL = 0.005                  # keep fraction, >= 5 sd at 100352 draws
# the forward's pre residual against the plain chain, both fp32 from the same
# operands: sums of R = 64 terms of size ~1 in other orders, 1e-5 absolute
PRE_TOL = 1e-5
# logits, card against CPU, same net, batch and dtype: fp32 1e-3; bf16
# 5e-2 (bf16 rounds every layer's activations, 30 layers deep, in other
# places on the two devices)
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# one train step, fp32, DROPOUT_R 0, from one seeded init. The loss, card
# against CPU: 1e-5 relative. The gradient, leaf by leaf, the card's
# kernels against the plain versions in their place on the same card (the
# rest of the step runs the same library calls in both):
#   ||g_kernel - g_plain|| <= 1e-3 ||g_plain|| + 1e-6 ||g_plain, whole net||
# 1e-3 is the RSA kernels' own fp32 bound (above); the second term covers
# the leaves whose gradient is 0 in exact arithmetic and rounding noise in
# fp32 (the key projections' biases under the softmax, the AttFlat glimpse
# biases). The leaves whose gradients the relation pass computes (the stem
# `linear_y_rel` and each RSA op's `wr`) are small and never 0: they are
# held to 1e-3 of their own norm with no second term. A wrong gradient from
# a kernel moves its leaf by the size of the gradient itself.
STEP_LOSS_TOL, STEP_LEAF_TOL, STEP_LEAF_FLOOR = 1e-5, 1e-3, 1e-6
# the bf16 weight step's loss against the fp32 one, same net, batch and
# paths, DROPOUT_R 0: bf16 rounds every activation (unit roundoff 2^-8)
# through the 30-node chain: 2e-2 relative
SEARCH_BF16_LOSS_TOL = 2e-2
# a unified or hybrid first weight step against the sampled one, fp32,
# DROPOUT_R 0, the same init, batch and path: the same function through
# other kernels (the decoder's attention at (100,114) with the pad mask and
# the plain RSA chain outside the kernel, in place of three kernels of their
# own shapes). The loss to 1e-5 relative; each leaf's gradient to 1e-4 of
# the whole gradient's largest entry. The RSA chain's leaves are held to the
# sampled step that computes the chain the same way (program_first_steps):
# against the kernels' chain, fp32 rounding of pre near the 1e-6 clamp
# moves them (PRE_TOL; on an H100 a Wr by 8.2e-4 of that largest entry)
PROGRAM_LOSS_TOL, PROGRAM_GRAD_TOL = 1e-5, 1e-4
# the RSA chain's leaves: every rel op's Wr and br, the stem's W1 and b1
PROGRAM_CHAIN_LEAVES = (".wr.", "linear_y_rel.")
# the card's peaks (NVIDIA H100 SXM data sheet, at the 700 W limit)
PEAK_BYTES = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}


def ptxas_report(report):
    """Per kernel in nvcc's `-Xptxas -v` report: registers and spill store
    bytes."""
    import re

    rows, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            fn = m.group(1)
            rows.setdefault(fn, {"registers": None, "spill_bytes": 0})
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:
            rows[fn]["spill_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            rows[fn]["registers"] = int(m.group(1))
    return rows


def sass_report(built):
    """Per attention kernel instantiation: (registers, spill store bytes)
    from ptxas's report and the count of HMMA (mma.sync) and HGMMA (wgmma)
    instructions in its SASS from `cuobjdump -sass` on the built library."""
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    rows = {}
    for lib, report in built:
        if "fused_attention" not in os.path.basename(lib):
            continue
        for fn, r in ptxas_report(report).items():
            rows[fn] = {**r, "hmma": 0}
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              check=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : ([\w$]+)", line)
            if m:
                fn = m.group(1)
                rows.setdefault(fn, {"registers": None, "spill_bytes": 0, "hmma": 0})
            elif fn and ("HMMA" in line or "HGMMA" in line):
                rows[fn]["hmma"] += 1
    return {fn: r for fn, r in rows.items() if "fused_attention" in fn}


def bias_kernel_report(built):
    """The bias probes' instances in the build of csrc/probes.cu, as
    {"probe_bias[2] Rr4 H8 R64 E2": {registers, spill_bytes}} (Rr, H, R 0:
    the generic instance); prints one line each. The fixed instances (the
    tasks' and the probes' shapes) must not spill, and probe_bias2's must
    hold every feature FMA inside their head loop (`bias2_head_loop_ffma`)."""
    import re

    rows = {}
    for lib, report in built:
        if "probes" not in os.path.basename(lib):
            continue
        for fn, r in sorted(ptxas_report(report).items()):
            m = re.search(r"(probe_bias2?)_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E", fn)
            if m:
                name, rr, h, rn, e = m.groups()
                shape = "generic" if rr == "0" else f"Rr{rr} H{h} R{rn}"
                rows[f"{name} {shape} E{e}"] = r
        for key, loop_ffma in bias2_head_loop_ffma(lib).items():
            rows[key]["head_loop_ffma"] = loop_ffma
    for key, r in rows.items():
        print(f"  {key}: {r['registers']} registers, {r['spill_bytes']} bytes spilled"
              + (f", {r['head_loop_ffma']} FFMA in the head loop" if "head_loop_ffma" in r else ""))
    spilled = [k for k, r in rows.items() if "generic" not in k and r["spill_bytes"]]
    if not rows or spilled:
        raise AssertionError(f"bias probes: {len(rows)} instances in the build; fixed instances "
                             f"that spill: {spilled}")
    # probe_bias2 computes every feature again for each head: its head loop
    # holds E R (Rr + 1) FMAs (E R Rr of raw W1^T + b1, E R of the head's sum)
    hoisted = {}
    for key, r in rows.items():
        m = re.fullmatch(r"probe_bias2 Rr(\d+) H\d+ R(\d+) E(\d+)", key)
        if m:
            rr, rn, e = map(int, m.groups())
            if r.get("head_loop_ffma", 0) < e * rn * (rr + 1):
                hoisted[key] = r.get("head_loop_ffma")
    if hoisted:
        raise AssertionError(f"probe_bias2 computes its features outside the head loop: {hoisted}")
    return rows


def bias2_head_loop_ffma(lib):
    """FFMA instructions inside each fixed probe_bias2 instance's head loop
    (from a backward branch's target to the branch) in the library's SASS
    (`cuobjdump -sass`), by the names of `bias_kernel_report`."""
    import re
    import shutil

    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        m = re.search(r"probe_bias2_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)E",
                      body.split("\n", 1)[0])
        if not m or m.group(1) == "0":
            continue
        code = [(int(a, 16), op) for a, op in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
        loops = [(int(t.group(1), 16), a) for a, op in code if "BRA" in op
                 for t in [re.search(r"0x([0-9a-f]+)", op)] if t and int(t.group(1), 16) < a]
        rr, h, rn, e = m.groups()
        out[f"probe_bias2 Rr{rr} H{h} R{rn} E{e}"] = max(
            (sum("FFMA" in op for a, op in code if lo <= a <= hi) for lo, hi in loops), default=0)
    return out


def relation_kernel_report(sass):
    """The relation pass's instantiations in the SASS report, each as
    (raw channels held, heads held, features a thread, row); prints one line
    each (grouped: more than 16 heads, in groups of 16). The paths' shapes
    (4 and 8 heads) must not spill."""
    import re

    rel = {}
    for fn, r in sorted(sass.items()):
        m = re.search(r"fused_attention_bwd_rel_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)ELi(\d+)E"
                      r"Lb([01])E", fn)
        if m:
            rel[fn] = (int(m.group(2)), int(m.group(3)), int(m.group(4)), r)
            print(f"  relation pass {'fp32' if m.group(1) == 'f' else 'bf16'} Rr<={m.group(2)} "
                  f"H<={m.group(3)} F {m.group(4)}{' grouped' if m.group(5) == '1' else ''}: "
                  f"{r['registers']} registers, {r['spill_bytes']} bytes spilled")
    return rel


def zero_launches(module):
    """Every launch count of the wrappers' module (`LAUNCHES`) set to 0."""
    for n in module.LAUNCHES:
        module.LAUNCHES[n] = 0


def cuda_time_ms(fn, iters=10, warmup=2):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters=5, graph=None):
    """(ms, by): device time of one call, and how it was taken. By
    "profiler": the CUDA kernels that `iters` calls launch, summed by
    torch.profiler, over iters. Unlike cuda_time_ms it leaves out the host's
    time between launches, which bounds calls of a few microseconds of
    device work. The profiler at times records nothing, or only some of the
    launches: a reading in which a kernel appears fewer than `iters` times
    is taken again, up to 5 times. Failing that, by "cuda graph":
    `graph_time_ms(fn)`, or `graph()` where a call cannot be captured alone
    (a backward whose forward ran outside the capture)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = device_events(prof)
        us = sum(us for _, us in events)
        counts = Counter(name for name, _ in events)
        if us and all(n >= iters for n in counts.values()):
            return us / 1e3 / iters, "profiler"
    return (graph() if graph else graph_time_ms(fn, iters)), "cuda graph"


def device_events(prof):
    """(name, us) of every activity on the card that the finished profiler
    `prof` recorded, read from its raw kineto events. torch's own event tree
    (`key_averages`) costs seconds per few thousand events, which a profiled
    train step reaches; the raw list costs milliseconds."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type().name != "CUDA" or getattr(ev, "is_user_annotation", lambda: False)():
            continue
        ns = ev.duration_ns() if hasattr(ev, "duration_ns") else ev.duration_us() * 1e3
        out.append((ev.name(), ns / 1e3))
    return out


def graph_time_ms(fn, iters=10, replays=5):
    """Device time of one call from CUDA events around `replays` replays of
    a CUDA graph holding `iters` calls, over replays * iters: the graph runs
    them back to back with no host time between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # warm-up off the capture, as CUDA graphs need
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def fmt(ms, by="profiler"):
    if ms is None:
        return "not measured"
    return f"{ms:.4f}" + ("" if by == "profiler" else f" ({by})")


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    the operations ({dtype: count}) over their type's peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = sum(n / PEAK_OPS[dt] for dt, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_case(g, Lq, Lk, kind, B=B, H=H, D=D):
    """Random q, k, v (B, H, L, D), and by `kind`: a key mask ("mask": ~30%
    of the keys at random, key 0 valid; "padmask": keys from a random count
    of valid ones on, that count drawn from PAD_VALID[Lk]; "nopad": none, as
    uniimg_att's keys), an additive bias ("bias"), the RSA geometry chain
    ("rel")."""
    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    def uniform(*shape, bound):
        return (torch.rand(*shape, generator=g) * 2 - 1) * bound

    q, k, v = randn(B, H, Lq, D), randn(B, H, Lk, D), randn(B, H, Lk, D)
    mask = torch.rand(B, 1, 1, Lk, generator=g) > 0.7
    mask[..., 0] = False                     # every row keeps a valid key
    if "padmask" in kind:                    # a pad tail, as the loaders' rows
        lo, hi = PAD_VALID[Lk]
        valid = torch.randint(lo, hi + 1, (B, 1, 1, 1), generator=g)
        mask = torch.arange(Lk).view(1, 1, 1, Lk) >= valid
    bias = randn(B, H, Lq, Lk) if "bias" in kind else None
    rel = None
    if "rel" in kind:                        # init-like stem and Wr weights
        rel = (randn(B, Lq, Lk, RR, scale=2.0), uniform(R, RR, bound=0.5),
               uniform(R, bound=0.5), uniform(H, R, bound=0.125), uniform(H, bound=0.125))
    return q, k, v, (mask if "mask" in kind else None), bias, rel


def to_dev(dev, dt, q, k, v, mask, bias, rel):
    return ([t.to(dev, dt) for t in (q, k, v)], None if mask is None else mask.to(dev),
            None if bias is None else bias.to(dev, dt),
            None if rel is None else tuple(t.to(dev, dt) for t in rel))


def f32(t):
    return None if t is None else t.float()


def sdpa_inputs(args, mask, bias):
    """The float attn_mask for scaled_dot_product_attention (mask -> -1e9,
    plus the bias), or None for the RSA case, which no library call does."""
    if bias is None and mask is None:
        return None
    m = torch.zeros((), device=args[0].device, dtype=args[0].dtype)
    if mask is not None:
        m = m + torch.where(mask, -1e9, 0.0).to(args[0].dtype)
    if bias is not None:
        m = m + bias
    return m


def live_share(rel):
    """The share of relation features relu(raw W1^T + b1) that are > 0: the
    head projection and the chain's backward need only those."""
    raw, w1, b1 = (t.float() for t in rel[:3])
    return (torch.matmul(raw, w1.t()) + b1 > 0).float().mean().item()


def attention_bytes_ops(Lq, Lk, kind, dt, part, live=1.0, B=B, H=H, D=D):
    """The least work of one call at B, H, D: (bytes, {dtype: operations}).
    Bytes: each of the function's inputs read once and each of its outputs
    written once. part "fwd": q, k, v (mask, bias, raw) -> o; "bwd": q, k, v,
    do -> dq, dk, dv (dbias; the weights' gradients), given no o and no
    probabilities, so it computes the scores again; "fwd+bwd": both, with
    each input read, each output written and the scores computed once. The
    keep mask and dpre are this design's intermediates, not the function's
    (the mask follows from the seed), and count in neither; the relation
    weights and their gradients are a few KB and left out. Operations: q k^T
    once, a v (fwd), do v^T, a^T do, ds k, ds^T q (bwd), each 2 n_s D, and
    the softmax and its backward, 5 per score and pass; with RSA the
    relation chain once per (b, i, j) in fp32: raw W1^T (2 R Rr) and, over
    the `live` features, the H head projections (2 H R) and in the backward
    du, dWr (2 H R each) and dW1 (2 R Rr)."""
    es = torch.finfo(dt).bits // 8
    n_s, n_g = B * H * Lq * Lk, B * Lq * Lk
    fwd, bwd = part in ("fwd", "fwd+bwd"), part in ("bwd", "fwd+bwd")
    ops = {dt: (2 + 2 * fwd + 8 * bwd) * n_s * D + 5 * n_s * (1 + bwd)}
    nbytes = B * H * (Lq + 2 * Lk) * D * es                  # q, k, v in
    nbytes += B * H * Lq * D * es * (fwd + bwd)              # o out; do in
    nbytes += B * H * (Lq + 2 * Lk) * D * es * bwd           # dq, dk, dv out
    if "mask" in kind:
        nbytes += B * Lk
    if "bias" in kind:
        nbytes += n_s * es * (1 + bwd)                       # bias in; dbias out
    if "rel" in kind:
        nbytes += n_g * RR * es                              # raw in
        chain = n_g * (2 * R * RR + 2 * H * R * live) + n_g * R * live * (4 * H + 2 * RR) * bwd
        ops[torch.float32] = ops.get(torch.float32, 0) + chain
    return nbytes, ops


DTYPES = (torch.float32, torch.bfloat16)


def kernel_cases(FA, dev, B=B, H=H, cases=CASES, dtypes=DTYPES, D=D):
    """Forward kernel (no dropout) against its plain version (with the RSA
    chain: its pre against the plain chain, the output on that pre; see
    KERNEL_TOL)."""
    g = torch.Generator().manual_seed(0)
    rows = []
    for dt in dtypes:
        for Lq, Lk, kind in cases:
            args, m, b_, r_ = to_dev(dev, dt, *make_case(g, Lq, Lk, kind, B, H, D))
            got = FA.fused_attention(*args, m, b_, rel=r_)
            torch.cuda.synchronize()
            log_bias, pre_err = f32(b_), None
            if r_ is not None:    # pre against the plain chain, the attention on it
                again, _, pre = FA.attention_fwd(*args, m, b_, r_, want_pre=True)
                if not torch.equal(again, got):
                    raise AssertionError("the RSA forward that writes pre out differs from the "
                                         "one that does not")
                pre_err, log_bias = check_pre(pre, r_, f"fwd B{B} H{H} {dt}"), log_pre(pre)
            ref = FA.fused_attention_reference(*[a.float() for a in args], m, log_bias)
            err = (got.float() - ref).abs().max().item()
            tol = KERNEL_TOL[(dt, r_ is not None)]
            ms = cuda_time_ms(lambda: FA.fused_attention(*args, m, b_, rel=r_))
            plain_ms = cuda_time_ms(lambda: FA.fused_attention_reference(*args, m, b_, rel=r_))
            dev_ms, dev_by = device_time_ms(lambda: FA.fused_attention(*args, m, b_, rel=r_))
            am = sdpa_inputs(args, m, b_)
            library_ms = library_dev_ms = library_dev_by = None
            if r_ is None:
                def sdpa():
                    return torch.nn.functional.scaled_dot_product_attention(*args, attn_mask=am)
                library_ms = cuda_time_ms(sdpa)
                library_dev_ms, library_dev_by = device_time_ms(sdpa)
            live = 1.0 if r_ is None else live_share(r_)
            bound_ms, bound_by = bound(*attention_bytes_ops(Lq, Lk, kind, dt, "fwd", live, B, H,
                                                            D))
            row = {"dtype": str(dt).replace("torch.", ""), "B": B, "H": H, "D": D, "Lq": Lq, "Lk": Lk,
                   "operands": kind, "max_abs_err": err, "tol": tol, "pre_err": pre_err, "ms": ms,
                   "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                   "device_ms": dev_ms, "device_ms_by": dev_by, "library_device_ms": library_dev_ms,
                   "library_device_ms_by": library_dev_by}
            print(f"fwd     B{B} H{H} D{D} {row['dtype']:8s} ({Lq:3d},{Lk:3d}) {kind:8s} max_abs_err {err:.3e} "
                  f"(tol {tol:g})  kernel {ms:.4f} ms (device {fmt(dev_ms, dev_by)})  plain "
                  f"{plain_ms:.4f} ms  sdpa {fmt(library_ms)} ms (device "
                  f"{fmt(library_dev_ms, library_dev_by)})  bound "
                  f"{bound_ms:.4f} ms ({bound_by})", flush=True)
            if not (math.isfinite(err) and err <= tol):
                raise AssertionError(f"kernel disagrees with its plain version: {row}")
            rows.append(row)
    return rows


def rel_err(got, want):
    return (got.float() - want.float()).abs().max().item() / max(want.abs().max().item(), 1e-6)


def train_kernel_cases(FA, dev, B=B, H=H, cases=CASES, dtypes=DTYPES, D=D):
    """Dropout forward, backward and relation pass against their plain
    versions, and their times. With the RSA chain also the arch step's
    backward, where no relation input needs a gradient: no dpre, no
    relation pass, and dq, dk, dv equal to the full backward's bits."""
    g = torch.Generator().manual_seed(1)
    rows = []
    for dt in dtypes:
        for Lq, Lk, kind in cases:
            args, m, b_, r_ = to_dev(dev, dt, *make_case(g, Lq, Lk, kind, B, H, D))
            name = (f"B{B} H{H} D{D} {str(dt).replace('torch.', ''):8s} ({Lq:3d},{Lk:3d}) "
                    f"{kind:8s}")
            # the mask: keep rate, reproducible by seed, the numpy Philox bits
            # with the RSA chain the training forward also writes pre for the backward
            want_pre = r_ is not None
            out, keep, pre = FA.attention_fwd(*args, m, b_, r_, dropout_r=RATE, seed=1234,
                                              want_pre=want_pre)
            _, keep2, _ = FA.attention_fwd(*args, m, b_, r_, dropout_r=RATE, seed=1234)
            _, keep3, _ = FA.attention_fwd(*args, m, b_, r_, dropout_r=RATE, seed=1235)
            torch.cuda.synchronize()
            frac = keep.float().mean().item()
            if not abs(frac - (1 - RATE)) <= KEEP_TOL:
                raise AssertionError(f"{name}: keep fraction {frac}")
            if not torch.equal(keep, keep2) or torch.equal(keep, keep3):
                raise AssertionError(f"{name}: the keep mask does not follow its seed")
            if dt == torch.float32 and kind in ("mask", "padmask", "nopad"):
                want_keep = FA.keep_mask_reference(1234, B, H, Lq, Lk, RATE)
                if not torch.equal(keep.cpu().bool(), want_keep):
                    raise AssertionError(f"{name}: keep bits differ from Philox4x32-10")
            # with the RSA chain: pre against the plain chain, the rest on the kernel's pre
            pre_err = None if r_ is None else check_pre(pre, r_, name)
            ref = FA.fused_attention_reference(*[a.float() for a in args], m,
                                               f32(b_) if r_ is None else log_pre(pre),
                                               keep=keep, dropout_r=RATE)
            fwd_err = (out.float() - ref).abs().max().item()
            fwd_tol = KERNEL_TOL[(dt, r_ is not None)]

            # the backward on that mask against autograd through the plain version
            do = torch.randn(B, H, Lq, D, generator=g).to(dev, dt)
            dq, dk, dv, dbias, drel = FA.attention_bwd(*args, m, b_, r_, keep, RATE, do, pre=pre)
            leaves = [a.float().requires_grad_() for a in args]
            bl = None if b_ is None else b_.float().requires_grad_()
            pl = None if r_ is None else pre.detach().requires_grad_()
            plain = FA.fused_attention_reference(*leaves, m, bl if r_ is None else log_pre(pl),
                                                 keep=keep, dropout_r=RATE)
            wrt = leaves + [x for x in (bl, pl) if x is not None]
            want = list(torch.autograd.grad(plain, wrt, do.float()))
            dpre_plain = None
            if r_ is not None:     # dpre through the plain relation chain's backward
                dpre_plain = want.pop()
                want += FA.relation_bwd_reference(*r_, dpre_plain)[1:]
            got = [dq, dk, dv] + ([dbias] if b_ is not None else []) + \
                (list(drel[1:]) if r_ is not None else [])
            labels = ["dq", "dk", "dv"] + (["dbias"] if b_ is not None else []) + \
                (["dW1", "db1", "dWr", "dbr"] if r_ is not None else [])
            errs = {lab: rel_err(x, w) for lab, x, w in zip(labels, got, want)}
            # the backward kernel's own outputs; dW1.. come from the relation pass
            abs_err = max((x.float() - w).abs().max().item()
                          for lab, x, w in zip(labels, got, want) if lab in ("dq", "dk", "dv", "dbias"))
            tol = GRAD_TOL[(dt, r_ is not None)]
            bad = [lab for lab in labels if not (math.isfinite(errs[lab]) and errs[lab] <= tol)]

            # times: forward + backward of the kernels, of the plain version, of SDPA
            def kernel_step():
                leaves_k = [a.detach().requires_grad_() for a in args]
                o = FA.FusedAttentionFn.apply(*leaves_k, m, b_, *(r_ or (None,) * 5), RATE, 7)
                torch.autograd.grad(o, leaves_k, do)

            def plain_step():
                leaves_p = [a.detach().requires_grad_() for a in args]
                o = FA.fused_attention_reference(*leaves_p, m, b_, rel=r_, keep=keep,
                                                 dropout_r=RATE)
                torch.autograd.grad(o, leaves_p, do)

            am = sdpa_inputs(args, m, b_)

            def sdpa_fwd(leaves_s):
                return torch.nn.functional.scaled_dot_product_attention(
                    *leaves_s, attn_mask=am, dropout_p=RATE)

            def sdpa_step():
                leaves_s = [a.detach().requires_grad_() for a in args]
                torch.autograd.grad(sdpa_fwd(leaves_s), leaves_s, do)

            def fwd_call():
                return FA.attention_fwd(*args, m, b_, r_, RATE, 7, want_pre=want_pre)

            def bwd_call():
                return FA.attention_bwd(*args, m, b_, r_, keep, RATE, do, pre=pre)

            fwd_ms, bwd_ms = cuda_time_ms(fwd_call), cuda_time_ms(bwd_call)
            (fwd_dev_ms, fwd_dev_by), (bwd_dev_ms, bwd_dev_by) = (device_time_ms(fwd_call),
                                                                  device_time_ms(bwd_call))
            step_ms = cuda_time_ms(kernel_step)
            plain_fwd_ms = cuda_time_ms(lambda: FA.fused_attention_reference(
                *args, m, b_, rel=r_, keep=keep, dropout_r=RATE))
            plain_leaves = [a.detach().requires_grad_() for a in args]
            plain_out = FA.fused_attention_reference(*plain_leaves, m, b_, rel=r_, keep=keep,
                                                     dropout_r=RATE)
            plain_bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
                plain_out, plain_leaves, do, retain_graph=True))
            plain_ms = cuda_time_ms(plain_step)
            sdpa_ms = sdpa_fwd_ms = sdpa_bwd_ms = sdpa_fwd_dev_ms = sdpa_bwd_dev_ms = None
            sdpa_fwd_dev_by = sdpa_bwd_dev_by = None
            if r_ is None:
                sdpa_leaves = [a.detach().requires_grad_() for a in args]
                sdpa_out = sdpa_fwd(sdpa_leaves)

                def sdpa_bwd():
                    return torch.autograd.grad(sdpa_out, sdpa_leaves, do, retain_graph=True)

                sdpa_fwd_ms = cuda_time_ms(lambda: sdpa_fwd(args))
                sdpa_bwd_ms = cuda_time_ms(sdpa_bwd)
                sdpa_fwd_dev_ms, sdpa_fwd_dev_by = device_time_ms(lambda: sdpa_fwd(args))
                # a backward is captured with its forward: (fwd + bwd) - fwd
                sdpa_bwd_dev_ms, sdpa_bwd_dev_by = device_time_ms(
                    sdpa_bwd, graph=lambda: graph_time_ms(sdpa_step) - graph_time_ms(
                        lambda: sdpa_fwd(args)))
                if sdpa_bwd_dev_by != "profiler":
                    sdpa_bwd_dev_by = "cuda graph, fwd+bwd - fwd"
                sdpa_ms = cuda_time_ms(sdpa_step)
            live = 1.0 if r_ is None else live_share(r_)
            row = {"dtype": str(dt).replace("torch.", ""), "B": B, "H": H, "D": D, "Lq": Lq,
                   "Lk": Lk, "operands": kind, "keep_fraction": frac, "fwd_err": fwd_err, "fwd_tol": fwd_tol,
                   "pre_err": pre_err,
                   "grad_rel_err": errs, "grad_abs_err": abs_err, "grad_tol": tol,
                   "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_bwd_ms": step_ms,
                   "plain_fwd_ms": plain_fwd_ms, "plain_bwd_ms": plain_bwd_ms,
                   "plain_fwd_bwd_ms": plain_ms, "sdpa_fwd_ms": sdpa_fwd_ms,
                   "sdpa_bwd_ms": sdpa_bwd_ms, "sdpa_fwd_bwd_ms": sdpa_ms,
                   "fwd_device_ms": fwd_dev_ms, "fwd_device_ms_by": fwd_dev_by,
                   "bwd_device_ms": bwd_dev_ms, "bwd_device_ms_by": bwd_dev_by,
                   "sdpa_fwd_device_ms": sdpa_fwd_dev_ms, "sdpa_fwd_device_ms_by": sdpa_fwd_dev_by,
                   "sdpa_bwd_device_ms": sdpa_bwd_dev_ms, "sdpa_bwd_device_ms_by": sdpa_bwd_dev_by}
            for part, key in (("fwd", "fwd"), ("bwd", "bwd"), ("fwd+bwd", "fwd_bwd")):
                row[f"{key}_bound_ms"], row[f"{key}_bound_by"] = bound(
                    *attention_bytes_ops(Lq, Lk, kind, dt, part, live, B, H, D))
            if r_ is not None:
                row.update(relation_pass(FA, r_, dpre_plain, live))
                row["rel_abs_err"] = max((x.float() - w).abs().max().item()
                                         for lab, x, w in zip(labels, got, want)
                                         if lab in ("dW1", "db1", "dWr", "dbr"))
                lean = FA.attention_bwd(*args, m, b_, r_, keep, RATE, do, need_rel=False,
                                        pre=pre)
                torch.cuda.synchronize()
                if lean[4] is not None or not all(
                        torch.equal(x, y) for x, y in zip(lean[:3], (dq, dk, dv))):
                    raise AssertionError(f"{name}: the backward without dpre differs from the "
                                         "full backward in dq, dk, dv")
                row["bwd_no_rel_ms"] = cuda_time_ms(
                    lambda: FA.attention_bwd(*args, m, b_, r_, keep, RATE, do, need_rel=False,
                                             pre=pre))
            print(f"train   {name} keep {frac:.4f}  fwd err {fwd_err:.2e} (tol {fwd_tol:g})  "
                  f"grad rel err max {max(errs.values()):.2e} (tol {tol:g})  kernel fwd "
                  f"{fwd_ms:.4f} + bwd {bwd_ms:.4f} ms (device {fmt(fwd_dev_ms, fwd_dev_by)} + "
                  f"{fmt(bwd_dev_ms, bwd_dev_by)}), fwd+bwd {step_ms:.4f} ms  plain {plain_ms:.4f} ms"
                  f"  sdpa {fmt(sdpa_ms)} ms (device fwd {fmt(sdpa_fwd_dev_ms, sdpa_fwd_dev_by)} bwd "
                  f"{fmt(sdpa_bwd_dev_ms, sdpa_bwd_dev_by)})"
                  f"  bound fwd {row['fwd_bound_ms']:.4f} bwd {row['bwd_bound_ms']:.4f} "
                  f"fwd+bwd {row['fwd_bwd_bound_ms']:.4f} ms" + (
                      "" if r_ is None else
                      f"  relation pass {row['rel_ms']:.4f} ms (device "
                      f"{fmt(row['rel_device_ms'], row['rel_device_ms_by'])}),"
                      f" plain {row['rel_plain_ms']:.4f} ms,"
                      f" bound {row['rel_bound_ms']:.4f} ms (live share {live:.3f}); bwd without "
                      f"dpre {row['bwd_no_rel_ms']:.4f} ms, dq dk dv equal"),
                  flush=True)
            if not (math.isfinite(fwd_err) and fwd_err <= fwd_tol):
                raise AssertionError(f"dropout forward disagrees with its plain version: {row}")
            if bad:
                raise AssertionError(f"backward disagrees with its plain version in {bad}: {row}")
            rows.append(row)
    return rows


def log_pre(pre):
    """The attention's bias from the relation chain's output pre, as
    rsa_log_bias takes it: log(clamp(relu(pre), 1e-6))."""
    return torch.log(torch.clamp(torch.relu(pre), min=1e-6))


def check_pre(pre, rel, name):
    """The largest distance of the kernel's relation chain output pre
    ([B, H, Lq, Lk], fp32) from the plain chain's on the same operands in
    fp32, which must be within PRE_TOL."""
    raw, w1, b1, wr, br = (t.float() for t in rel)
    plain = (torch.matmul(torch.relu(torch.matmul(raw, w1.t()) + b1), wr.t()) + br)
    err = (pre - plain.permute(0, 3, 1, 2)).abs().max().item()
    if not err <= PRE_TOL:
        raise AssertionError(f"{name}: the kernel's pre is {err} off the plain chain")
    return err


def relation_pass(FA, rel, dpre, live):
    """Times of the relation pass alone, eager and device (its gradients
    are checked with the backward's), on the plain version's dpre, and its
    bound: raw and dpre read once, raw W1^T for every feature, the rest
    (du, dWr, dW1, db1) for the live ones, all in fp32."""
    B, H, Lq, Lk = dpre.shape
    n = B * Lq * Lk
    nbytes = n * RR * (torch.finfo(rel[0].dtype).bits // 8) + n * H * 4
    ops = n * 2 * R * RR + n * R * live * (4 * H + 2 * RR + 1)
    bound_ms, bound_by = bound(nbytes, {torch.float32: ops})
    dev_ms, dev_by = device_time_ms(lambda: FA.relation_bwd(*rel, dpre))
    return {"rel_ms": cuda_time_ms(lambda: FA.relation_bwd(*rel, dpre)),
            "rel_device_ms": dev_ms, "rel_device_ms_by": dev_by,
            "rel_plain_ms": cuda_time_ms(lambda: FA.relation_bwd_reference(*rel, dpre)),
            "rel_bound_ms": bound_ms, "rel_bound_by": bound_by, "live_share": live}


def cfg_for(run, dtype, task="vqa", **extra):
    """`--RUN run --SYNTH --ARCH_PATH <the task's genotype> --BS 64` of the
    task's fixed-net CLI (make_arg_parser(task)): HSIZE 512, 100 regions of
    2048; VQA's 14-token question, VGD's 15-token query."""
    from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser

    args = ["--RUN", run, "--SYNTH", "--ARCH_PATH", ARCHS[task], "--BS", str(BATCH), "--SEED",
            "0", "--NW", "8", "--DTYPE", dtype]
    for k, v in extra.items():
        args += [f"--{k}", str(v)]
    cfg = cfg_from_args(task, make_arg_parser(task).parse_args(args))
    return cfg.replace(LOG_ROOT=os.path.join(WORK, "log"), CKPT_ROOT=os.path.join(WORK, "ckpts"))


def engines(task):
    """(fixed-net Execution, SearchExecution, attention ops per batch,
    rel_self_att_64 ops per batch) of the task's genotype at LAYERS 1."""
    from mmnas_tpu_torch.engine import itm, search, search_itm, search_vgd, vgd, vqa

    if task == "vqa":
        return vqa.Execution, search.SearchExecution, LAUNCHES_PER_BATCH, REL_LAUNCHES_PER_BATCH
    if task == "itm":
        enc_att, dec_att, n_rsa = itm_genotype_ops()
        return itm.Execution, search_itm.SearchExecution, enc_att + dec_att, n_rsa
    return (vgd.Execution, search_vgd.SearchExecution, VGD_LAUNCHES_PER_BATCH,
            VGD_REL_LAUNCHES_PER_BATCH)


def itm_genotype_ops():
    """(encoder attention ops, decoder attention ops, rel_self_att_64 ops) of
    arch/mmnas_itm.json at LAYERS 1, counted from the genotype."""
    from mmnas_tpu_torch.genotype import load_genotype

    genotype = load_genotype(ARCHS["itm"])
    att = [sum(op != "feed_forward" for node in genotype[c] for op in node) for c in ("enc", "dec")]
    rel = sum(op == "rel_self_att_64" for node in genotype["dec"] for op in node)
    return att[0], att[1], rel


def eval_path(FA, dev, card):
    from mmnas_tpu_torch.engine.vqa import Execution, batch_to_device
    from mmnas_tpu_torch.models.convert import to_jax_params
    from mmnas_tpu_torch.train.checkpoint import save_checkpoint

    ckpt = os.path.join(WORK, "mmnas_vqa_seed0.pkl")

    # a seeded port init, written in the JAX package's checkpoint format
    cfg32 = cfg_for("val", "float32", SYNTH_SIZE=SYNTH_SIZE, CKPT_PATH=ckpt)
    exe = Execution(cfg32, dev)
    dataset = exe.build_dataset("val")
    net = exe.build_net(dataset)
    print(f"main path: HSIZE {cfg32.HSIZE}, {cfg32.FRCNFEAT_LEN} regions of "
          f"{cfg32.FRCNFEAT_SIZE}, {cfg32.MAX_TOKEN} tokens, REL_SIZE {cfg32.REL_SIZE}, "
          f"{sum(p.numel() for p in net.parameters())} parameters", flush=True)
    save_checkpoint(ckpt, {"state_dict": to_jax_params(net), "net_optim": None, "epoch": 0})
    del net

    n_batches = math.ceil(SYNTH_SIZE / BATCH)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = cfg_for("val", dtype, SYNTH_SIZE=SYNTH_SIZE, CKPT_PATH=ckpt)
        exe = Execution(cfg, dev)
        zero_launches(FA)
        result = exe.run()
        torch.cuda.synchronize()
        launches = dict(FA.LAUNCHES)
        want = {"fused_attention_fwd": LAUNCHES_PER_BATCH * n_batches,
                "fused_attention_fwd_dropout": 0, "fused_attention_bwd": 0,
                "fused_attention_bwd_rel": 0}
        if launches != want:
            raise AssertionError(f"{dtype} eval: kernel launches {launches}, expected {want}")
        if result.preds.shape != (SYNTH_SIZE,):
            raise AssertionError(f"{dtype}: predictions of shape {result.preds.shape}")

        # device-side forward time on one resident batch
        gpu_net = exe.load_net(dataset)
        # drained to the end, so no loader thread competes for the host
        host_batch = list(exe.make_loader(dataset, BATCH))[0]
        batch = batch_to_device(host_batch, dev)
        with torch.inference_mode():
            fwd_ms = cuda_time_ms(lambda: gpu_net(batch), iters=10)

            # the same net and batch on the CPU, through the plain versions
            small = {k: v[:8] for k, v in host_batch.items()}
            gpu_logits = gpu_net(batch_to_device(small, dev)).cpu()
            cpu_net = Execution(cfg, torch.device("cpu")).load_net(dataset)
            cpu_logits = cpu_net(batch_to_device(small, torch.device("cpu")))
        if gpu_logits.shape != (8, dataset.ans_size) or not torch.isfinite(gpu_logits).all():
            raise AssertionError(f"{dtype}: bad logits {gpu_logits.shape}")
        diff = (gpu_logits - cpu_logits).abs().max().item()
        tol = LOGIT_TOL[dtype]
        agree = (gpu_logits.argmax(-1) == cpu_logits.argmax(-1)).float().mean().item()
        print(f"eval {dtype}: {launches['fused_attention_fwd']} kernel launches over {n_batches} "
              f"batches; accuracy {result.accuracy}; {SYNTH_SIZE / result.seconds:.1f} examples/s "
              f"end to end (loader included), {BATCH / fwd_ms * 1000:.1f} examples/s forward "
              f"only ({fwd_ms:.3f} ms per batch of {BATCH}) on {card}; logits card vs CPU max "
              f"abs diff {diff:.3e} (tol {tol:g}), argmax agreement {agree:.3f}", flush=True)
        if not diff <= tol:
            raise AssertionError(f"{dtype}: card logits differ from the CPU run by {diff}")
        out[dtype] = {"launches": launches["fused_attention_fwd"],
                      "examples_per_s": SYNTH_SIZE / result.seconds, "forward_ms": fwd_ms,
                      "logit_diff": diff}
    return out


EXPORT_BATCHES = (BATCH, BATCH // 2)   # the symbolic artifact's calls


def export_path(FA, dev, card):
    """The serving export (tools/export_serving.py) of arch/mmnas_vqa.json's
    eval forward at HSIZE 512, fp32, batch 64: exported with a static and
    with a symbolic batch, saved, loaded back and called (at 64, and 32 for
    the symbolic one), each call bit for bit the in-process forward with
    exactly eval_path's launches of the forward kernel, through the custom
    op; the output against the CPU's forward on the same weights; the
    export's seconds, the artifact's MB, and the reloaded and in-process
    forwards' ms."""
    from mmnas_tpu_torch.tools import export_serving as ES

    net, example = ES.build_eval_fwd("vqa", ARCHS["vqa"], "", BATCH, dev)
    want_launches = {"fused_attention_fwd": LAUNCHES_PER_BATCH, "fused_attention_fwd_dropout": 0,
                     "fused_attention_bwd": 0, "fused_attention_bwd_rel": 0}
    out = {}
    with torch.no_grad():
        for symbolic in (False, True):
            label = "symbolic" if symbolic else "static"
            t0 = time.perf_counter()
            program = ES.export_artifact(net, example, symbolic)
            export_s = time.perf_counter() - t0
            if ES.attention_nodes(program) != LAUNCHES_PER_BATCH:
                raise AssertionError(f"export {label}: {ES.attention_nodes(program)} attention "
                                     f"op nodes, expected {LAUNCHES_PER_BATCH}")
            path = os.path.join(WORK, f"mmnas_vqa_{label}.pt2")
            torch.export.save(program, path)
            served = torch.export.load(path).module()
            leg = {"export_s": export_s, "mb": os.path.getsize(path) / 1e6, "calls": {}}
            for n in EXPORT_BATCHES if symbolic else (BATCH,):
                b = ES.sub_batch(example, n)
                want = net(b)
                zero_launches(FA)
                got = served(b)
                torch.cuda.synchronize()
                launches = dict(FA.LAUNCHES)
                if launches != want_launches:
                    raise AssertionError(f"export {label} at batch {n}: launches {launches}, "
                                         f"expected {want_launches}")
                if not torch.equal(got, want):
                    raise AssertionError(f"export {label} at batch {n}: the reloaded output "
                                         f"differs from the in-process forward by "
                                         f"{float((got - want).abs().max())}")
                leg["calls"][n] = {"launches": launches["fused_attention_fwd"],
                                   "served_ms": cuda_time_ms(lambda: served(b), iters=10),
                                   "served_device_ms": device_time_ms(lambda: served(b))}
            out[label] = leg
        b = ES.sub_batch(example, BATCH)
        inproc = {"ms": cuda_time_ms(lambda: net(b), iters=10),
                  "device_ms": device_time_ms(lambda: net(b))}
        # the symbolic artifact on 8 items against the CPU's forward on the same weights
        n = min(8, BATCH)
        cpu_net, cpu_example = ES.build_eval_fwd("vqa", ARCHS["vqa"], "", n, "cpu")
        cpu_net.load_state_dict({k: v.cpu() for k, v in net.state_dict().items()})
        diff = float((served(ES.sub_batch(example, n)).cpu() - cpu_net(cpu_example)).abs().max())
    if not diff <= LOGIT_TOL["float32"]:
        raise AssertionError(f"export: the reloaded card output differs from the CPU by {diff}")
    out.update(in_process=inproc, logit_diff_vs_cpu=diff)
    for label in ("static", "symbolic"):
        leg = out[label]
        print(f"export {label}: {leg['export_s']:.1f} s, {leg['mb']:.1f} MB; " + "; ".join(
            f"batch {n}: {c['launches']} forward launches, reloaded {c['served_ms']:.3f} ms "
            f"(device {fmt(*c['served_device_ms'])})" for n, c in leg["calls"].items())
            + f" on {card}", flush=True)
    print(f"export: in-process forward at batch {BATCH} {inproc['ms']:.3f} ms (device "
          f"{fmt(*inproc['device_ms'])}) on {card}; reloaded output vs the CPU max abs diff "
          f"{diff:.3e} (tol {LOGIT_TOL['float32']:g})", flush=True)
    return out


def train_path(FA, dev, card, task):
    """Execution.run() of RUN train on the task's genotype at full width:
    TRAIN_SIZE // BATCH steps at DROPOUT_R 0.1 with the per-epoch eval, in
    fp32 and in bf16 on fp32 masters. Per leg: exact launches, finite losses
    whose last 3 average below the first, fp32 masters and Adam moments, the
    epoch checkpoint evaluated again. Then the fp32 train step alone on one
    resident batch, timed and profiled, and `one_step_parity`."""
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.train.checkpoint import ckpt_path
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    engine, _, n_att, n_rsa = engines(task)
    steps = TRAIN_SIZE // BATCH
    want = {"fused_attention_fwd": n_att * steps,          # the per-epoch eval
            "fused_attention_fwd_dropout": n_att * steps,
            "fused_attention_bwd": n_att * steps,
            "fused_attention_bwd_rel": n_rsa * steps}
    legs = {}
    for dtype in ("float32", "bfloat16"):
        name = f"{task} train {dtype}"
        cfg = cfg_for("train", dtype, task, SYNTH_SIZE=TRAIN_SIZE, MAX_EPOCH=1,
                      VERSION=f"smoke_{task}_{dtype}")
        if not (cfg.DROPOUT_R == RATE and cfg.EVAL_EVERY_EPOCH and cfg.NET_GRAD_CLIP > 0):
            raise AssertionError(f"unexpected train config {cfg}")
        zero_launches(FA)
        t0 = time.perf_counter()
        result = engine(cfg, dev).run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, losses = dict(FA.LAUNCHES), result.step_losses
        print(f"{name}: {steps} steps, losses per batch of {BATCH} "
              f"{[round(x, 4) for x in losses]}; {launches}; {seconds:.1f} s with the loader and "
              "the eval", flush=True)
        if launches != want:
            raise AssertionError(f"{name}: kernel launches {launches}, expected {want}")
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: losses {losses}")
        if not sum(losses[-3:]) / 3 < losses[0]:
            raise AssertionError(f"{name}: loss did not fall: {losses}")
        kinds = {p.dtype for p in result.net.parameters()} | {
            t.dtype for key in ("m", "v") for t in result.opt_state[key].values()}
        if kinds != {torch.float32}:
            raise AssertionError(f"{name}: masters or Adam moments in {kinds}")
        ckpt = ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, 1)
        zero_launches(FA)
        reloaded = engine(cfg_for("val", dtype, task, SYNTH_SIZE=BATCH, CKPT_PATH=ckpt), dev).run()
        torch.cuda.synchronize()
        items = reloaded.preds if hasattr(reloaded, "preds") else reloaded.hits
        if items.shape != (BATCH,) or FA.LAUNCHES["fused_attention_fwd"] != n_att:
            raise AssertionError(f"{name}: eval of the epoch checkpoint: {items.shape}, "
                                 f"{FA.LAUNCHES}")
        print(f"eval of {os.path.relpath(ckpt, HERE)}: accuracy {reloaded.accuracy}", flush=True)
        legs[dtype] = {"launches": launches, "losses": losses, "seconds": seconds,
                       "reloaded_accuracy": reloaded.accuracy}
        if dtype == "float32":
            trained, exe = result, engine(cfg, dev)
        del result

    # the train step alone, one resident batch, dropout on
    dataset = exe.build_dataset("train")
    host_batch = list(exe.make_loader(dataset, BATCH))[0]
    keys = INPUT_KEYS + exe.TARGET_KEYS
    batch = batch_to_device(host_batch, dev, keys)
    net = trained.net
    params = dict(net.named_parameters())
    optim = build_net_optimizer(exe.cfg, steps)
    state = optim.init(params)
    gen = torch.Generator(dev).manual_seed(3)
    step_ms = cuda_time_ms(lambda: exe.train_step(net, optim, state, params, batch, gen),
                           iters=5, warmup=1)
    split = profile_step(lambda: exe.train_step(net, optim, state, params, batch, gen))
    print(f"{task} train step fp32 BS {BATCH}: {step_ms:.2f} ms, {BATCH / step_ms * 1000:.1f} "
          f"examples/s on {card}; device time split {split}", flush=True)
    del net, params, state, trained
    grad = one_step_parity(engine, exe.cfg.replace(DROPOUT_R=0.0), dataset,
                           {k: v[:16] for k, v in host_batch.items()}, keys, steps, n_rsa, task,
                           dev)
    return {"legs": legs, "step_ms": step_ms, "examples_per_s": BATCH / step_ms * 1000,
            "device_split": split, **grad}


def bias_errs(got, want):
    """(max |exp(got) - exp(want)|, max |got - want| where exp(want) > 0.1):
    the bias probes' two measures (PROBE_BIAS_TOL)."""
    got, want = got.double().cpu(), want.double().cpu()
    away = want.exp() > 0.1
    return ((got.exp() - want.exp()).abs().max().item(),
            (got - want)[away].abs().max().item())


def bias_case_inputs(Bn, Hn, L, Rr, Rn, seed):
    """raw, W1, b1, Wr, br (numpy fp32, port layouts) at a bias-probe shape,
    drawn as the probes' own (`bias_inputs`) are."""
    r = np.random.RandomState(seed)
    return (np.abs(r.randn(Bn, L, L, Rr)).astype(np.float32),
            (r.randn(Rn, Rr) * 0.5).astype(np.float32), (r.randn(Rn) * 0.1).astype(np.float32),
            (r.randn(Hn, Rn) * 0.3).astype(np.float32), (r.randn(Hn) * 0.1).astype(np.float32))


def bias_from_attention(FA, rel, seed=0):
    """log(max(pre, 1e-6)) of the `pre` that the RSA attention forward writes
    for the chain `rel` (q, k, v random at D 64): the bits the bias probes
    must give."""
    raw, wr = rel[0], rel[3]
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(raw.shape[0], wr.shape[0], raw.shape[1], D, generator=g).to(raw.device)
               for _ in range(3))
    _, _, pre = FA.attention_fwd(q, k, v, None, None, tuple(rel), want_pre=True)
    return torch.log(torch.clamp(pre, min=1e-6))


def bias_bytes_ops(Bn, Hn, L, Rr, Rn, live=1.0):
    """The bias probes' least work: raw in, [B, H, L, L] out; raw W1^T once
    per (b, i, j) and the H head projections of the live features, in fp32;
    and probe_bias2's own-work floor in ms, the FMAs its definition asks for
    (the features again for every head: B L L H (2 R Rr + 2 R))."""
    n = Bn * L * L
    floor_ms = n * Hn * (2 * Rn * Rr + 2 * Rn) / PEAK_OPS[torch.float32] * 1e3
    return n * (Rr + Hn) * 4, {torch.float32: n * (2 * Rn * Rr + 2 * Hn * Rn * live)}, floor_ms


def bias_instances(PR, FA, dev):
    """The bias kernels at each (Rr, H) instance the smoke runs besides the
    probes' own (Rr 4, H 8): the fixed Rr 4 H 4, the generic instance at Rr
    3 H 5 R 40, and Rr 4 H 8 at the ITM mining's B 3,200 L 36
    (BIAS_INSTANCES). Each held to the plain version (PROBE_BIAS_TOL), the two
    kernels to each other and to the attention forward's pre, bit for bit;
    each timed on the device beside its bound."""
    out = {}
    for Bn, Hn, L, Rr, Rn in BIAS_INSTANCES:
        args = [torch.from_numpy(a).to(dev) for a in bias_case_inputs(Bn, Hn, L, Rr, Rn, Hn)]
        once, fresh = PR.probe_bias(*args), PR.probe_bias(*args, fresh=True)
        plain, att = PR.bias_reference(*args), bias_from_attention(FA, args)
        torch.cuda.synchronize()
        key = f"B{Bn} H{Hn} L{L} Rr{Rr} R{Rn}"
        errs = [bias_errs(got, plain) for got in (once, fresh)]
        if not (torch.equal(once, fresh) and torch.equal(once, att)
                and max(max(e) for e in errs) <= PROBE_BIAS_TOL):
            raise AssertionError(f"bias probes at {key}: bits equal {torch.equal(once, fresh)}, "
                                 f"vs the attention's pre {torch.equal(once, att)}; vs plain "
                                 f"{errs}")
        nbytes, ops, floor_ms = bias_bytes_ops(Bn, Hn, L, Rr, Rn, live_share(args[:3]))
        bound_ms, bound_by = bound(nbytes, ops)
        out[key] = {"max_abs_err": max(e[0] for e in errs), "bound_ms": bound_ms,
                    "bound_by": bound_by, "own_work_floor_ms_bias2": floor_ms}
        for name, fresh_ in (("probe_bias", False), ("probe_bias2", True)):
            ms, by = device_time_ms(lambda: PR.probe_bias(*args, fresh=fresh_))
            out[key][f"{name}_device_ms"], out[key][f"{name}_device_ms_by"] = ms, by
        ms = {n: fmt(out[key][f"{n}_device_ms"], out[key][f"{n}_device_ms_by"])
              for n in ("probe_bias", "probe_bias2")}
        print(f"probe   bias instance {key}: device ms probe_bias {ms['probe_bias']}, probe_bias2 "
              f"{ms['probe_bias2']}; bound {bound_ms:.5f} ms, probe_bias2's own-work floor "
              f"{floor_ms:.5f} ms", flush=True)
    return out


def probe_path(PR, FA, dev, bias_regs):
    """The probe CLI on the card with its launch counts, then every probe
    kernel against its plain version on the probes' inputs, and its times;
    the bias kernels also against the RSA attention forward's pre, at each
    instance, with their registers and spills from the build
    (`bias_kernel_report`)."""
    zero_launches(PR)
    results = PR.main([])                    # python -m mmnas_tpu_torch.tools.probes
    torch.cuda.synchronize()
    launches = dict(PR.LAUNCHES)
    print(f"probe path: launches {launches}", flush=True)
    if launches != PROBE_LAUNCHES:
        raise AssertionError(f"probes: kernel launches {launches}, expected {PROBE_LAUNCHES}")
    raw, w1, b1, wr, br = PR.bias_inputs()
    fp64 = torch.from_numpy(PR.bias_fp64(raw, w1, b1, wr, br))
    vs_fp64 = {}
    for name in ("bias", "bias2"):
        vs_fp64[name] = bias_errs(torch.from_numpy(results[name]["out"]), fp64)
        if not max(vs_fp64[name]) <= PROBE_BIAS_TOL:
            raise AssertionError(f"probe {name} against the fp64 chain: {vs_fp64[name]}")
    for name in ("slice", "outer", "wrblock"):
        if any(d != 0.0 for d in results[name].values()):
            raise AssertionError(f"probe {name} is not exact: {results[name]}")

    rows = {}

    def record(name, err, kernel, plain, nbytes, ops, library=None, **extra):
        """kernel, plain, library: calls, each timed eager; kernel and
        library also on the device."""
        bound_ms, bound_by = bound(nbytes, ops)
        ms, plain_ms = cuda_time_ms(kernel), cuda_time_ms(plain)
        dev_ms, dev_by = device_time_ms(kernel)
        library_ms, (library_dev_ms, library_dev_by) = (
            (None, (None, None)) if library is None
            else (cuda_time_ms(library), device_time_ms(library)))
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms, "device_ms": dev_ms,
                      "device_ms_by": dev_by, "library_device_ms": library_dev_ms,
                      "library_device_ms_by": library_dev_by, **extra}
        library_read = ("none" if library is None else
                        f"{library_ms:.4f} ms (device {fmt(library_dev_ms, library_dev_by)})")
        print(f"probe   {name:16s} max_abs_err {err:.3e}  kernel {ms:.4f} ms (device "
              f"{fmt(dev_ms, dev_by)})  plain {plain_ms:.4f} ms  library {library_read}"
              f"  bound {bound_ms:.5f} ms ({bound_by})", flush=True)

    # rows 5-6: the RSA log-bias, features once for all heads / per head
    args = [torch.from_numpy(a).to(dev) for a in (raw, w1, b1, wr, br)]
    once, fresh = PR.probe_bias(*args), PR.probe_bias(*args, fresh=True)
    plain = PR.bias_reference(*args)
    torch.cuda.synchronize()
    if not torch.equal(once, fresh):
        raise AssertionError("probe_bias and probe_bias2 differ in their bits")
    # the bits the probes exist to show: those of the RSA attention forward
    if not torch.equal(once, bias_from_attention(FA, args)):
        raise AssertionError("the bias probes differ from log(max(pre, 1e-6)) of the RSA "
                             "attention forward's pre")
    Bn, L, Rr = raw.shape[0], raw.shape[1], raw.shape[3]
    Rn, Hn = w1.shape[0], wr.shape[0]
    live = live_share(args[:3])
    nbytes, ops, floor_ms = bias_bytes_ops(Bn, Hn, L, Rr, Rn, live)
    for name, got, fresh_ in (("probe_bias", once, False), ("probe_bias2", fresh, True)):
        exp_err, log_err = bias_errs(got, plain)
        if not max(exp_err, log_err) <= PROBE_BIAS_TOL:
            raise AssertionError(f"{name} against its plain version: {exp_err}, {log_err}")
        extra = {"own_work_floor_ms": floor_ms} if fresh_ else {}
        record(name, exp_err, lambda: PR.probe_bias(*args, fresh=fresh_),
               lambda: PR.bias_reference(*args), nbytes, ops,
               log_err_where_pre_over_0_1=log_err, vs_fp64=vs_fp64["bias2" if fresh_ else "bias"],
               live_share=live, shape=f"B{Bn} H{Hn} L{L} Rr{Rr} R{Rn} fp32",
               registers={k: r for k, r in bias_regs.items() if k.split()[0] == name}, **extra)
    print(f"probe   probe_bias2 own-work floor {floor_ms:.5f} ms (its definition's FMAs) beside "
          f"the function's bound {rows['probe_bias2']['bound_ms']:.5f} ms", flush=True)
    instances = bias_instances(PR, FA, dev)
    for name in ("probe_bias", "probe_bias2"):
        rows[name]["instances"] = instances

    # row 7: 2 plane in fp32, four row chunks, from f32 and bf16 planes
    cases = {}
    for dt, plane in PR.slice_inputs().items():
        plane = plane.to(dev)
        got, want = PR.probe_slice(plane), PR.slice_reference(plane)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe_slice {dt} differs from its plain version")
        cases[str(dt)] = {"ms": cuda_time_ms(lambda: PR.probe_slice(plane)),
                          "plain_ms": cuda_time_ms(lambda: PR.slice_reference(plane))}
    plane = PR.slice_inputs()[torch.float32].to(dev)
    n = plane.numel()
    record("probe_slice", 0.0, lambda: PR.probe_slice(plane), lambda: PR.slice_reference(plane),
           n * 8, {torch.float32: n}, lambda: torch.mul(plane, 2),
           cases=cases, shape="[1,100,100] f32 -> f32")

    # row 8: plane (x) w + b1 in fp32
    cases = {}
    for dt, ops_ in PR.outer_inputs().items():
        ops_ = [t.to(dev) for t in ops_]
        got, want = PR.probe_outer(*ops_), PR.outer_reference(*ops_)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe_outer {dt} differs from its plain version")
        cases[str(dt)] = {"ms": cuda_time_ms(lambda: PR.probe_outer(*ops_)),
                          "plain_ms": cuda_time_ms(lambda: PR.outer_reference(*ops_))}
    pl, w, b1_ = (t.to(dev) for t in PR.outer_inputs()[torch.float32])
    n, Rn = pl.numel(), w.numel()
    record("probe_outer", 0.0, lambda: PR.probe_outer(pl, w, b1_),
           lambda: PR.outer_reference(pl, w, b1_), (n + 2 * Rn + n * Rn) * 4,
           {torch.float32: 2 * n * Rn}, lambda: torch.addcmul(b1_, pl[..., None], w),
           cases=cases, shape="[100,100] (x) [64] f32 -> f32")

    # row 9: Wr through a per-head slice (A) and a dynamic index (B)
    wr_ = PR.wrblock_inputs().to(dev)
    want = PR.wrblock_reference(wr_)
    for variant in ("a", "b"):
        got = PR.probe_wrblock(wr_, variant)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe_wrblock_{variant} differs from its plain version")
        record(f"probe_wrblock_{variant}", 0.0, lambda: PR.probe_wrblock(wr_, variant),
               lambda: PR.wrblock_reference(wr_), wr_.numel() * 4 * 3, {},
               lambda: wr_.repeat(2, 1, 1, 1), shape="Wr [8,64,1] -> [2,8,64,1] f32")
    for name, row in rows.items():
        row["launches"] = launches[name]
    return {"launches": launches, "vs_fp64": vs_fp64, "rows": rows}


def search_cfg(dtype, batch, kpath, task="vqa", flag=None, **extra):
    """`--SYNTH --ALPHA_MODE full` of the task's search CLI at BS `batch`,
    KPATH `kpath` (and `--<flag>`, a weight step's program), one epoch of
    SEARCH_STEPS weight steps (the 80/20 split: SYNTH_SIZE = steps * batch /
    0.8), arch steps from epoch 0 every ALPHA_EVERY."""
    from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser

    size = SEARCH_STEPS * batch * 5 // 4
    args = ["--SYNTH", "--SYNTH_SIZE", str(size), "--BS", str(batch), "--KPATH", str(kpath),
            "--DTYPE", dtype, "--SEED", "0", "--NW", "8", "--MAX_EPOCH", "1",
            "--ALPHA_MODE", "full",
            "--VERSION", f"smoke_search_{task}_{dtype}" + (f"_{flag.lower()}" if flag else "")]
    args += [f"--{flag}"] if flag else []
    cfg = cfg_from_args(task, make_arg_parser(task, search=True).parse_args(args), search=True)
    return cfg.replace(ALPHA_START=0, ALPHA_EVERY=ALPHA_EVERY, LOG_ROOT=os.path.join(WORK, "log"),
                       CKPT_ROOT=os.path.join(WORK, "ckpts"),
                       ARCH_ROOT=os.path.join(WORK, "arch"), **extra)


def attention_ops(idx):
    """(attention ops, rel_self_att_64 ops) on the path idx."""
    from mmnas_tpu_torch.models.supernet import SPACES

    att = sum(int(sum(SPACES[c][int(i)] != "feed_forward" for i in idx[c])) for c in SPACES)
    rel = int(sum(SPACES["dec"][int(i)] == "rel_self_att_64" for i in idx["dec"]))
    return att, rel


def arch_backwards(idx):
    """The backward launches of a 'full' arch step on the path idx: one per
    sampled attention op whose inputs depend on alpha. The net's weights
    enter detached, so the first node of each cell has none, unless it is a
    guided attention reading the encoder's output."""
    from mmnas_tpu_torch.models.supernet import SPACES

    first = sum(SPACES[c][int(idx[c][0])] in ("self_att_64", "rel_self_att_64") for c in SPACES)
    return attention_ops(idx)[0] - first


def weight_launches(idx, mode, every):
    """(dropout forwards, backwards, relation passes) of one weight-step
    forward on the path idx in the program `mode` (`every`: the attention
    ops of all nodes). 'sampled': one of each per attention op, a relation
    pass per rel_self_att_64 op; 'full' (--DENSE_WEIGHT): every op's
    forward, the backward of the path's alone (the others are detached);
    'unified': one attention a node of either cell (the encoder's
    self_att_64, the decoder's unified node), each backward run (where
    feed_forward is kept, on the zero gradient `torch.where` gives it), no
    relation pass (the unified node's RSA chain is outside the kernel);
    'hybrid': the unified encoder's and the sampled decoder's."""
    att, rel = attention_ops(idx)
    nodes = len(idx["enc"]) + len(idx["dec"])
    return {"sampled": (att, att, rel), "full": (every, att, rel), "unified": (nodes, nodes, 0),
            "hybrid": (len(idx["enc"]) + path_ops(idx)[1],) * 2 + (rel,)}[mode]


def search_launches(result, eval_fwd, forwards=1, mode="sampled"):
    """The launches the recorded paths call for, each step running
    `forwards` forwards (ITM's triplet: 3): per weight step, for each of its
    paths, those of `weight_launches` in the program `mode`; per 'full' arch
    step a dropout forward for every attention op of every node and the
    backwards of `arch_backwards`; `eval_fwd` forwards for the eval (and
    ITM's mining)."""
    from mmnas_tpu_torch.models.supernet import SPACES

    every = sum(result.net.n_nodes[c] * sum(op != "feed_forward" for op in SPACES[c])
                for c in SPACES)
    want = {"fused_attention_fwd": eval_fwd, "fused_attention_fwd_dropout": 0,
            "fused_attention_bwd": 0, "fused_attention_bwd_rel": 0}
    for kind, _, p in result.paths:
        if kind == "arch":
            want["fused_attention_fwd_dropout"] += forwards * every
            want["fused_attention_bwd"] += forwards * arch_backwards(p)
        elif kind == "weight":
            for idx in p:
                fwd, bwd, rel = weight_launches(idx, mode, every)
                want["fused_attention_fwd_dropout"] += forwards * fwd
                want["fused_attention_bwd"] += forwards * bwd
                want["fused_attention_bwd_rel"] += forwards * rel
    return want, every


def paths_json(paths):
    """Recorded paths with their index arrays as lists."""
    def plain(p):
        if isinstance(p, dict):
            return {c: np.asarray(v).tolist() for c, v in p.items()}
        return [plain(x) for x in p]

    return [[kind, step, plain(p)] for kind, step, p in paths]


def path_ops(idx):
    """(encoder attention ops, decoder attention ops) on the path idx."""
    from mmnas_tpu_torch.models.supernet import SPACES

    return tuple(int(sum(SPACES[c][int(i)] != "feed_forward" for i in idx[c])) for c in SPACES)


def itm_sweep_launches(cfg, n_caps, enc_att, dec_att, kind):
    """Forward launches of one ITM corpus sweep (engine/itm.py) over n_caps
    captions of 5 per image: the text encoder over TEXT_ENC_CHUNK captions a
    call, then one scorer call per tile, each running the decoder:
    mining ("mine"), ceil(items / NEG_BATCHSIZE) tiles in each direction;
    the eval ("eval"), ceil(n_imgs * n_caps / (EVAL_BATCH_SIZE * 2))."""
    if cfg.TEXT_ENC_BLOCK:
        raise AssertionError("the smoke counts whole-table sweeps (TEXT_ENC_BLOCK 0)")
    n_imgs = n_caps // 5
    chunks = math.ceil(n_caps / cfg.TEXT_ENC_CHUNK)
    if kind == "mine":
        group = max(1, cfg.NEG_BATCHSIZE)
        tiles = math.ceil(n_imgs / group) + math.ceil(n_caps / group)
    else:
        tiles = math.ceil(n_imgs * n_caps / (cfg.EVAL_PAIRS or cfg.EVAL_BATCH_SIZE * 2))
    return chunks * enc_att + tiles * dec_att


def search_path(FA, dev, card, task, legs, flag=None, states=None):
    """The task's search legs (dtype, batch, KPATH) through
    SearchExecution.run(), each with its checks (exact launches from the
    sampled paths and the argmax-path eval, finite losses, alpha moved, the
    genotype archive in the reference schema, the checkpoint reloads), step
    times and device split. With `flag` (one of WEIGHT_FLAGS) the weight
    steps run that program. Without, VQA's fp32 leg also resumes from its
    checkpoint and hands its genotype to a fixed net, and its bf16 leg is
    held to fp32. Each leg records its paths' digest (`paths_sha1`). With
    `states` (a dict) each leg's key maps there to (the leg, `search_state`
    of its run), for scan_steps_path."""
    from mmnas_tpu_torch.engine.search import weight_mode
    from mmnas_tpu_torch.models.convert import from_jax_params
    from mmnas_tpu_torch.models.supernet import SPACES, NetSearch
    from mmnas_tpu_torch.train.checkpoint import ckpt_path, load_checkpoint

    _, engine, _, _ = engines(task)
    out = {}
    for dtype, batch, kpath in legs:
        cfg = search_cfg(dtype, batch, kpath, task, flag)
        mode = weight_mode(cfg)
        if not (cfg.DROPOUT_R == RATE and cfg.EVAL_EVERY_EPOCH and cfg.HSIZE == 256
                and cfg.NET_GRAD_CLIP > 0 and cfg.ALPHA_BINARY_MODE == "full"
                and (mode == "sampled") == (flag is None)):
            raise AssertionError(f"unexpected search config {cfg}")
        arch_json = os.path.join(cfg.ARCH_ROOT, cfg.VERSION + ".json")
        name = f"{task} search {dtype} BS {batch} KPATH {kpath}" + (f" --{flag}" if flag else "")
        zero_launches(FA)
        t0 = time.perf_counter()
        result = engine(cfg, dev).run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = dict(FA.LAUNCHES)
        run_state = search_state(result) if states is not None else None
        split = int(cfg.SYNTH_SIZE * cfg.SPLIT_PORTION)
        alpha_host = result.alpha_host
        chosen = NetSearch.chosen_indices(alpha_host)
        if task == "itm":      # the mining sweeps of the sampled paths, R@K of the argmax one
            eval_fwd = sum(itm_sweep_launches(cfg, cfg.SYNTH_SIZE, *path_ops(p), "mine")
                           for kind, _, p in result.paths if kind == "mine")
            eval_fwd += itm_sweep_launches(cfg, max(20, cfg.SYNTH_SIZE // 4), *path_ops(chosen),
                                           "eval")
        else:
            eval_fwd = math.ceil((cfg.SYNTH_SIZE - split) / batch) * attention_ops(chosen)[0]
        want, every = search_launches(result, eval_fwd, 3 if task == "itm" else 1, mode)
        kinds = [(k, step) for k, step, _ in result.paths]
        want_kinds = [("mine", 0)] if task == "itm" else []
        for step in range(SEARCH_STEPS):
            want_kinds += [("weight", step)] + ([("arch", step)] * ((step + 1) % ALPHA_EVERY == 0))
        losses = result.step_losses
        print(f"{name}: {len(losses)} weight steps, losses per batch "
              f"{[round(x, 3) for x in losses]}; {launches} (expected {want}, {every} attention "
              f"ops per arch step); {seconds:.1f} s with the loader and the eval on {card}",
              flush=True)
        if kinds != want_kinds or every != 66:
            raise AssertionError(f"{name}: steps {kinds}, {every} attention ops per node set")
        # every kernel of the leg's path (the unified program runs no relation pass)
        if launches != want or not all(v for k, v in launches.items()
                                       if k != "fused_attention_bwd_rel" or mode != "unified"):
            raise AssertionError(f"{name}: kernel launches {launches}, expected {want}")
        if len(losses) != SEARCH_STEPS or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: losses {losses}")
        init = result.net.init_alpha()
        moved = {c: (result.alpha[c].cpu() - init[c]).abs().max().item() for c in init}
        if not all(v > 0 for v in moved.values()):
            raise AssertionError(f"{name}: alpha did not move: {moved}")
        with open(arch_json) as f:
            archive = json.load(f)
        genotype = archive.get("epoch1")
        if list(archive) != ["epoch1"] or genotype != result.net.genotype(alpha_host) or any(
                len(genotype[c]) != result.net.n_nodes[c]
                or any(len(node) != 1 or node[0] not in SPACES[c] for node in genotype[c])
                for c in SPACES):
            raise AssertionError(f"{name}: genotype archive {archive}")
        ckpt = load_checkpoint(ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, 1))
        state = from_jax_params(ckpt["state_dict"])
        own = result.net.state_dict()
        if (set(ckpt) != {"state_dict", "net_optim", "alpha", "alpha_optim", "epoch"}
                or ckpt["epoch"] != 1 or set(state) != set(own)
                or not all(torch.equal(state[k], own[k].cpu()) for k in own)
                or not all(np.array_equal(ckpt["alpha"][c], alpha_host[c]) for c in SPACES)):
            raise AssertionError(f"{name}: the epoch checkpoint does not reload")
        leg = {"launches": launches, "expected": want, "losses": losses, "seconds": seconds,
               "alpha_moved": moved, "genotype": genotype,
               "paths_sha1": hashlib.sha1(json.dumps(paths_json(result.paths)).encode()
                                          ).hexdigest(),
               "first_path": next(p for kind, _, p in paths_json(result.paths)
                                  if kind == "weight")}
        if flag is None and task in ("vqa", "itm") and dtype == "float32":
            leg["resume"] = search_resume(cfg, dev, arch_json, engine)
        if flag is None and task == "vqa" and dtype == "float32":
            leg["fixed_net"] = fixed_net_from_genotype(FA, dev, arch_json)
        elif flag is None and task == "vqa":
            leg["precision"] = search_precision(cfg, result, dev)
        # of the programs' legs only VQA's --UNIFIED_WEIGHT is timed, and
        # without the arch step alone: it is the sampled leg's program
        if flag is None or (task, flag) == ("vqa", "UNIFIED_WEIGHT"):
            leg.update(search_step_times(cfg, result, dev, card, engine, time_arch=flag is None))
        out[f"{dtype}_bs{batch}_k{kpath}" + (f"_{flag.lower()}" if flag else "")] = leg
        if states is not None:
            states[state_key(task, dtype, batch, kpath, flag)] = (leg, run_state)
        del result, state, own, ckpt, run_state
        torch.cuda.empty_cache()
    return out


def program_first_steps(dev, idxs):
    """The first weight step of the unified and hybrid programs against the
    sampled one's (fp32, DROPOUT_R 0, one seeded init, the weight split's
    first batch, the paths `idxs`): the loss within PROGRAM_LOSS_TOL, and
    leaf by leaf the gradient Adam is handed (after the clip) within
    PROGRAM_GRAD_TOL of the whole gradient's largest entry. The RSA chain's
    leaves (each rel op's Wr, the stem's W1 and b1: PROGRAM_CHAIN_LEAVES)
    are held to the sampled step that computes the chain as the program
    does, so that pre is the same bits in both: the unified node's plain
    `rsa_log_bias` is the sampled step's with the plain version in the
    kernels' place; the hybrid program's sampled decoder runs the kernels'
    chain. Against the other their difference is pre's rounding near the
    1e-6 clamp (PRE_TOL), reported beside. Reported too, not held: each
    step's distance from the sampled step in fp64 (the net, the inputs, the
    loss and the plain attention with its RSA chain in fp64; LayerNorm's
    statistics stay fp32), the exact gradient both chains round."""
    import mmnas_tpu_torch.models.net as NET
    import mmnas_tpu_torch.ops.attention as ATT
    from mmnas_tpu_torch.engine.search import SearchExecution
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    exe = SearchExecution(search_cfg("float32", SEARCH_B, 1, DROPOUT_R=0.0), dev)
    dataset = exe.build_dataset()
    batch = batch_to_device(list(exe.make_loader(dataset, list(range(SEARCH_B))))[0], dev,
                            INPUT_KEYS + ("ans",))
    steps, compute_dtype = {}, NET.compute_dtype
    for name, flag, attention in (("sampled", None, None), ("sampled_plain", None, plain_attention),
                                  ("sampled_fp64", None, plain_attention_fp64),
                                  ("UNIFIED_WEIGHT", "UNIFIED_WEIGHT", None),
                                  ("HYBRID_WEIGHT", "HYBRID_WEIGHT", None)):
        exe = SearchExecution(search_cfg("float32", SEARCH_B, 1, flag=flag, DROPOUT_R=0.0), dev)
        net = exe.build_net(dataset)
        if name == "sampled_fp64":    # the same init in fp64; the step casts its inputs to it
            net.double()
            NET.compute_dtype = lambda cfg: torch.float64
        masters = dict(net.named_parameters())
        optim = build_net_optimizer(exe.cfg, SEARCH_STEPS)
        grads, adam_step = {}, optim.step

        def capture(state, params, g, mask, grads=grads, adam_step=adam_step):
            grads.update({n: t.detach().clone() for n, t in g.items()})
            return adam_step(state, params, g, mask)

        optim.step = capture
        saved = ATT.fused_attention
        ATT.fused_attention = attention or saved
        try:
            loss, _ = exe.weight_step(net, optim, optim.init(masters), masters, batch, idxs,
                                      torch.Generator(dev), net.init_alpha())
        finally:
            ATT.fused_attention, NET.compute_dtype = saved, compute_dtype
        steps[name] = (float(loss), grads)
        del net, masters
    loss0, g0 = steps["sampled"]
    scale = max(float(g.abs().max()) for g in g0.values())

    def errs(g, ref, names):
        return {n: float((g[n].double() - ref[n].double()).abs().max()) / scale for n in names}

    loss64, g64 = steps["sampled_fp64"]
    chain = [n for n in g0 if any(k in n for k in PROGRAM_CHAIN_LEAVES)]
    vs_fp64 = {"loss": loss64}
    for name in ("sampled", "sampled_plain", "UNIFIED_WEIGHT", "HYBRID_WEIGHT"):
        e_chain, e_rest = errs(steps[name][1], g64, chain), errs(steps[name][1], g64,
                                                                 [n for n in g0 if n not in chain])
        worst = max(e_chain, key=e_chain.get)
        vs_fp64[name] = {"loss_rel": abs(steps[name][0] - loss64) / abs(loss64),
                         "chain_err": e_chain[worst], "chain_worst_leaf": worst,
                         "grad_err": max(e_rest.values())}

    out = {}
    for flag, chain_ref in (("UNIFIED_WEIGHT", "sampled_plain"), ("HYBRID_WEIGHT", "sampled")):
        loss, g = steps[flag]
        if set(g) != set(g0):
            raise AssertionError(f"--{flag}: the first step's leaves differ from the sampled one's")
        rest = errs(g, g0, [n for n in g0 if n not in chain])
        held = errs(g, steps[chain_ref][1], chain)
        beside = errs(g, g0, chain)
        worst = {k: max(e, key=e.get) for k, e in (("rest", rest), ("chain", held),
                                                   ("chain_vs_sampled", beside))}
        out[flag] = {"loss": loss, "loss_sampled": loss0, "loss_rel": abs(loss - loss0) / abs(loss0),
                     "grad_err": rest[worst["rest"]], "grad_worst_leaf": worst["rest"],
                     "chain_err": held[worst["chain"]], "chain_worst_leaf": worst["chain"],
                     "chain_ref": chain_ref,
                     "chain_err_vs_sampled": beside[worst["chain_vs_sampled"]],
                     "leaves": len(g0), "chain_leaves": len(chain)}
    print(f"first weight step against the sampled program (fp32, DROPOUT_R 0, the sampled leg's "
          f"first path; the RSA chain's leaves against the sampled step that computes the chain "
          f"alike): {out} (tol loss {PROGRAM_LOSS_TOL:g}, gradient {PROGRAM_GRAD_TOL:g} of its "
          f"largest entry {scale:.3e})", flush=True)
    print(f"the same steps against the sampled step in fp64 (the gradient's errors in units of "
          f"its largest entry): {vs_fp64}", flush=True)
    if not all(r["loss_rel"] <= PROGRAM_LOSS_TOL and r["grad_err"] <= PROGRAM_GRAD_TOL
               and r["chain_err"] <= PROGRAM_GRAD_TOL for r in out.values()):
        raise AssertionError(f"a program's first weight step is not the sampled one's: {out}")
    return dict(out, vs_fp64=vs_fp64)


def weight_programs_path(FA, dev, card, sampled, states=None):
    """This slice's main path: the weight step's programs through
    SearchExecution.run(): the VQA search leg of search_path (fp32, BS 128,
    KPATH 1: 10 weight and 2 arch steps, DROPOUT_R 0.1) once with each of
    --DENSE_WEIGHT, --UNIFIED_WEIGHT and --HYBRID_WEIGHT, with its checks
    (exact launches from the paths in each program; the --UNIFIED_WEIGHT
    leg's step times), each leg's paths those of the sampled leg (`sampled`:
    search_path's VQA legs); then a bf16 --UNIFIED_WEIGHT leg for VGD and
    for ITM (PROGRAM_LEGS, not timed), and the unified and hybrid first
    steps against the sampled one (program_first_steps). Before them the
    unified decoder node's attention at the three tasks' shapes
    (UNIFIED_CASES: B 128, 4 heads, (100,114), (100,115), (36,86), the pad
    mask and a dense bias) against its plain version: forward, dropout
    forward, backward with dbias, fp32 and bf16."""
    fwd = kernel_cases(FA, dev, SEARCH_B, SEARCH_H, UNIFIED_CASES)
    train = train_kernel_cases(FA, dev, SEARCH_B, SEARCH_H, UNIFIED_CASES)
    legs, main = {}, Counter()
    base = sampled["{}_bs{}_k{}".format(*SEARCH_LEGS[0])]
    for flag in WEIGHT_FLAGS:
        leg = search_path(FA, dev, card, "vqa", SEARCH_LEGS[:1], flag, states)
        (key, leg), = leg.items()
        if leg["paths_sha1"] != base["paths_sha1"]:
            raise AssertionError(f"--{flag}: the paths differ from the sampled leg's")
        main.update(leg["launches"])
        legs[f"vqa_{key}"] = leg
    for task, dtype, flag in PROGRAM_LEGS:
        (key, leg), = search_path(FA, dev, card, task, ((dtype, SEARCH_B, 1),), flag,
                                  states).items()
        legs[f"{task}_{key}"] = leg
    if not all(main[k] for k in FA.LAUNCHES):
        raise AssertionError(f"weight programs: a kernel of the path never ran: {dict(main)}")
    first = program_first_steps(dev, [{c: np.asarray(v) for c, v in idx.items()}
                                      for idx in base["first_path"]])
    return {"legs": legs, "main_path_launches": dict(main), "first_steps": first,
            "kernels_fwd": fwd, "kernels_train": train}


# ---------------------------------------------------------------------------
# --REMAT and --SCAN_STEPS: rematerialized candidate ops, the search's step
# chunks as CUDA-graph replays
# ---------------------------------------------------------------------------

# (dtype, batch, KPATH, step): the K 8 leg's arch step, the K 1 leg's
# --DENSE_WEIGHT weight step (REMAT reaches the 'full' program alone)
REMAT_STEPS = (("bfloat16", 2 * SEARCH_B, 8, "arch"), ("float32", SEARCH_B, 1, "weight"))
REMAT_TOL = 1e-6      # of the largest entry, where REMAT's step is not the plain one's bits
# (task, dtype, --flag, SCAN_STEPS, extra): each held to the per-step leg of
# its program that search_path ran (`states`); the last runs the sampled
# program, whose dispatch is 'eager' (the per-step loop)
SCAN_LEGS = (("vqa", "float32", "UNIFIED_WEIGHT", 5, {}),
             ("vqa", "float32", "UNIFIED_WEIGHT", 10, {"REMAT": True}),
             ("vgd", "bfloat16", "UNIFIED_WEIGHT", 5, {}),
             ("itm", "bfloat16", "UNIFIED_WEIGHT", 5, {}),
             ("vqa", "float32", None, 5, {}))
SCAN_RTOL, SCAN_ATOL = 2e-4, 2e-5     # tests/test_scan_steps.py's, the JAX chunk's


def state_key(task, dtype, batch, kpath, flag):
    return f"{task}_{dtype}_bs{batch}_k{kpath}" + (f"_{flag.lower()}" if flag else "")


def search_state(result):
    """Every number of a search run's checkpoint, on the host: the fp32
    masters, both optimizers' moments and step counts, alpha."""
    out = {f"param.{n}": p.detach().cpu() for n, p in result.net.named_parameters()}
    for key in ("m", "v"):
        out.update({f"net_optim.{key}.{n}": t.cpu() for n, t in result.opt_state[key].items()})
        out.update({f"alpha_optim.{key}.{c}": t.cpu() for c, t in result.alpha_state[key].items()})
    out.update({f"alpha.{c}": a.detach().cpu() for c, a in result.alpha.items()})
    out["counts"] = (dict(result.opt_state["t"]), result.opt_state["step"],
                     dict(result.alpha_state["t"]), result.alpha_state["step"])
    out["losses"] = list(result.step_losses)
    return out


def state_errors(got, want):
    """(bit for bit, the largest |got - want| - SCAN_ATOL - SCAN_RTOL |want|
    over the leaves: <= 0 where every leaf is within the tolerance, its
    leaf, the step counts equal)."""
    bits, worst, leaf = True, -math.inf, None
    for n, w in want.items():
        if n in ("counts", "losses"):
            continue
        g = got[n]
        bits &= torch.equal(g, w)
        over = float((g.double() - w.double()).abs().sub(SCAN_ATOL + SCAN_RTOL * w.double().abs())
                     .max())
        if over > worst:
            worst, leaf = over, n
    return bits, worst, leaf, got["counts"] == want["counts"]


def remat_path(FA, dev, card):
    """REMAT on the search's 'full' program: REMAT_STEPS, each once without
    and once with --REMAT on one seeded init, batch, alpha and path, at
    DROPOUT_R 0.1, HSIZE 256: the loss and every gradient to the bit (or
    within REMAT_TOL of the largest entry), the generator's state after the
    step equal; exact launches (REMAT's recompute runs the dropout forward
    of each attention op the backward reaches a second time, on the same
    key); peak device memory above the resident state and the step's ms
    (CUDA events), both ways."""
    from mmnas_tpu_torch.engine.search import SearchExecution
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS, compute_params
    from mmnas_tpu_torch.models.supernet import CELLS, SPACES

    out = {}
    for dtype, batch, kpath, kind in REMAT_STEPS:
        flag = "DENSE_WEIGHT" if kind == "weight" else None
        cfg = search_cfg(dtype, batch, kpath, flag=flag)
        exe = SearchExecution(cfg, dev)
        dataset = exe.build_dataset()
        net = exe.build_net(dataset)
        split = int(cfg.SYNTH_SIZE * cfg.SPLIT_PORTION)
        rows = list(range(split, split + batch)) if kind == "arch" else list(range(batch))
        b = batch_to_device(list(exe.make_loader(dataset, rows))[0], dev, INPUT_KEYS + ("ans",))
        r = np.random.RandomState(3)
        alpha = {c: (a + torch.from_numpy(r.randn(*a.shape).astype(np.float32))).to(dev)
                 for c, a in net.init_alpha().items()}
        idx = net.sample_indices({c: a.cpu().numpy() for c, a in alpha.items()},
                                 torch.Generator().manual_seed(4))
        gen = torch.Generator(dev)
        masters = dict(net.named_parameters())

        def step():
            gen.manual_seed(77)
            if kind == "arch":
                loss, grads = exe.arch_grads(net, alpha, b, idx, gen)
                return loss, dict(zip(CELLS, grads)), gen.get_state()
            params = compute_params(net, cfg, None)
            loss = exe.path_loss(net, params, b, [idx], gen,
                                 {c: a.detach() for c, a in alpha.items()}, "full")
            grads = torch.autograd.grad(loss, list(masters.values()), allow_unused=True)
            return loss, {n: g for n, g in zip(masters, grads) if g is not None}, gen.get_state()

        every = sum(net.n_nodes[c] * sum(op != "feed_forward" for op in SPACES[c]) for c in SPACES)
        att, rel = attention_ops(idx)
        again = arch_backwards(idx) if kind == "arch" else att   # ops the backward reaches
        runs = {}
        for remat in (False, True):
            net.cfg = cfg.replace(REMAT=remat)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            zero_launches(FA)
            loss, grads, state = step()
            torch.cuda.synchronize()
            launches = dict(FA.LAUNCHES)
            peak = torch.cuda.max_memory_allocated()
            want = {"fused_attention_fwd": 0,
                    "fused_attention_fwd_dropout": every + (again if remat else 0),
                    "fused_attention_bwd": again,
                    "fused_attention_bwd_rel": rel if kind == "weight" else 0}
            if launches != want:
                raise AssertionError(f"remat {kind} step REMAT={remat}: launches {launches}, "
                                     f"expected {want}")
            del loss, grads
            ms = cuda_time_ms(lambda: step()[0], iters=3, warmup=1)
            runs[remat] = {"launches": launches, "peak_bytes": peak,
                           "peak_above_resident_bytes": peak - resident, "step_ms": ms}
        net.cfg = cfg.replace(REMAT=False)
        plain = step()
        net.cfg = cfg.replace(REMAT=True)
        remat = step()
        scale = max(float(g.abs().max()) for g in plain[1].values())
        bits = torch.equal(plain[0], remat[0]) and all(
            torch.equal(g, remat[1][n]) for n, g in plain[1].items())
        err = max(float((g - remat[1][n]).abs().max()) for n, g in plain[1].items()) / scale
        loss0, loss1 = float(plain[0].detach()), float(remat[0].detach())
        loss_err = abs(loss0 - loss1) / abs(loss0)
        same_state = torch.equal(plain[2], remat[2])
        config = f"{dtype} BS {batch} KPATH {kpath}" + (f" --{flag}" if flag else "")
        name = f"remat {kind} step {config}"
        print(f"{name} on {card}: loss and gradients bit for bit {bits} (largest gradient error "
              f"{err:.3e} of {scale:.3e}, loss {loss_err:.3e}), generator state equal "
              f"{same_state}; without REMAT {runs[False]}, with {runs[True]}", flush=True)
        if (set(plain[1]) != set(remat[1]) or not same_state or err > REMAT_TOL
                or loss_err > REMAT_TOL):
            raise AssertionError(f"{name}: REMAT changes the step")
        out[kind] = {"config": config,
                     "bit_equal": bits, "grad_err": err, "loss_err": loss_err,
                     "generator_state_equal": same_state, "without": runs[False],
                     "with": runs[True]}
        del net, exe, b, plain, remat, masters
        torch.cuda.empty_cache()
    return out


def captured_launches(task, mode, kind, remat):
    """The attention launches of one capture of a step program at the
    VQA search spaces (12 encoder nodes of self_att_64 / feed_forward, 18
    decoder nodes of self/rel/guided attention / feed_forward), each
    forward `forwards` times (ITM's triplet: 3). The weight step 'unified':
    an attention and its backward a node. The 'full' arch step, with the
    path on the device: every attention op's dropout forward, and the
    backward of every op whose inputs depend on alpha (the inactive ones on
    `torch.where`'s zero gradient): all but the first encoder node's
    self_att_64 and the first decoder node's self_att_64 and
    rel_self_att_64; under REMAT those recompute their forward."""
    forwards = 3 if task == "itm" else 1
    if kind == "weight" and mode == "unified":
        fwd, bwd = 30, 30
    elif kind == "arch":
        fwd, bwd = 66, 66 - 3
        fwd += bwd if remat else 0
    else:
        raise ValueError(f"no capture count for {kind} {mode}")
    return {"fused_attention_fwd": 0, "fused_attention_fwd_dropout": forwards * fwd,
            "fused_attention_bwd": forwards * bwd, "fused_attention_bwd_rel": 0}


def scan_steps_path(FA, dev, card, states):
    """SCAN_STEPS: SCAN_LEGS through SearchExecution.run(), each against the
    per-step leg of the same program and config (`states`, kept by
    search_path): the paths' digest equal, the params, both optimizers'
    moments and alpha within (SCAN_RTOL, SCAN_ATOL) (and whether to the
    bit), the step counts and the losses. The 'graph' legs: each program's
    warm-up and capture launch `captured_launches`, the weight graph replays
    10 times and the arch graph 2, nothing else launches eagerly in the
    chunks; the launches the card ran, captured x replays + warm-up + the
    eval's. The first leg: two replays of the weight step on the same
    inputs and state draw the same masks at one step's seed and others at
    the next (the losses); capture ms, the replayed steps' ms (CUDA events
    around replays) and the chunk's wall ms a step, the device-busy share
    beside the per-step leg's eager steps."""
    from mmnas_tpu_torch.engine.search import weight_mode

    out, main = {}, Counter()
    for task, dtype, flag, scan, extra in SCAN_LEGS:
        _, engine, _, _ = engines(task)
        ref_key = state_key(task, dtype, SEARCH_B, 1, flag)
        ref, want = states[ref_key]
        cfg = search_cfg(dtype, SEARCH_B, 1, task, flag, SCAN_STEPS=scan, **extra)
        cfg = cfg.replace(VERSION=f"{cfg.VERSION}_scan{scan}" + ("_remat" if extra else ""))
        name = f"{task} search {dtype} --SCAN_STEPS {scan}" + (f" --{flag}" if flag else "") + (
            " --REMAT" if extra else "")
        zero_launches(FA)
        t0 = time.perf_counter()
        exe = engine(cfg, dev)
        result = exe.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, log = dict(FA.LAUNCHES), exe.chunk_log
        got = search_state(result)
        sha = hashlib.sha1(json.dumps(paths_json(result.paths)).encode()).hexdigest()
        bits, worst, leaf, counts = state_errors(got, want)
        loss_ok = np.allclose(got["losses"], want["losses"], rtol=SCAN_RTOL, atol=SCAN_ATOL)
        leg = {"dispatch": log["dispatch"], "seconds": seconds, "paths_sha1": sha,
               "bit_equal": bits, "worst_over_tol": worst, "worst_leaf": leaf,
               "chunk_s": log.get("chunk_s"), "eager_launches": log.get("eager_launches"),
               "counted_launches": launches}
        dispatch = "graph" if flag else "eager"
        if log["dispatch"] != dispatch or sha != ref["paths_sha1"] or not counts or worst > 0 \
                or not loss_ok:
            raise AssertionError(f"{name}: dispatch {log['dispatch']}, paths {sha} vs "
                                 f"{ref['paths_sha1']}, counts equal {counts}, worst {worst} at "
                                 f"{leaf}, losses {got['losses']} vs {want['losses']}")
        eval_fwd = ref["expected"]["fused_attention_fwd"]
        if dispatch == "eager":
            effective = launches
            if launches != ref["launches"]:
                raise AssertionError(f"{name}: launches {launches}, the per-step leg's "
                                     f"{ref['launches']}")
        else:
            mode = weight_mode(cfg)
            effective = Counter({"fused_attention_fwd": eval_fwd})
            counted = Counter({"fused_attention_fwd": eval_fwd})
            for kind, replays in (("weight", SEARCH_STEPS), ("arch", SEARCH_STEPS // ALPHA_EVERY)):
                plog, expect = log[kind], captured_launches(task, mode, kind, cfg.REMAT)
                if plog["captured"] != expect or plog["warmup"] != expect \
                        or plog["replays"] != replays:
                    raise AssertionError(f"{name}: {kind} graph {plog}, expected {expect} "
                                         f"captured and warmed up, {replays} replays")
                for k, v in expect.items():
                    effective[k] += v * (replays + 1)    # the replays and the warm-up
                    counted[k] += 2 * v
                leg[f"{kind}_capture_ms"] = plog["capture_s"] * 1e3
                leg[f"{kind}_captured"] = plog["captured"]
            if any(log["eager_launches"].values()) or launches != dict(counted):
                raise AssertionError(f"{name}: launches {launches}, expected {dict(counted)}; "
                                     f"eager in the chunks {log['eager_launches']}")
        leg["launches"] = dict(effective)
        main.update(effective)
        print(f"{name}: {log['dispatch']} dispatch, paths as the per-step leg's, states bit for "
              f"bit {bits} (worst {worst:.3e} over the tolerance at {leaf}); launches on the card "
              f"{dict(effective)} (counted {launches}); chunks {log.get('chunk_s')} s; "
              f"{seconds:.1f} s with the loader and the eval on {card}", flush=True)
        if dispatch == "graph" and not out:
            leg.update(replay_readings(exe, ref, card, name))
        out[f"{task}_{dtype}_scan{scan}" + (f"_{flag.lower()}" if flag else "_sampled")
            + ("_remat" if extra else "")] = leg
        exe.programs.clear()      # the graphs and their memory pools, freed now
        del exe, result, got
        torch.cuda.empty_cache()
    return {"legs": out, "main_path_launches": dict(main)}


def replay_readings(exe, ref, card, name):
    """The first 'graph' leg's programs after its run, each replay from the
    state the run ended in, put back before it, with the programs' step
    counts (`state[0]`) at 0: the run's bias-correction table ends at its
    last step, and the counts move no loss. The weight step's masks follow
    its seed (the loss at step 0's seed twice, at step 1's), the replays' device
    ms (CUDA events around each replay alone), the chunk's wall ms a step
    and the busy share, beside the per-step leg's eager step."""
    progs = {k: exe.programs[k] for k in ("weight", "arch")}
    saved = {k: [t.clone() for t in p.state] for k, p in progs.items()}
    for k, p in progs.items():
        if p.state[0] is not p.counts:
            raise AssertionError(f"{name}: the {k} program's state does not start at its counts")
        saved[k][0].zero_()

    def replay(kind, seed, timed=False):
        prog = progs[kind]
        with torch.no_grad():
            for t, v in zip(prog.state, saved[kind]):
                t.copy_(v)
        prog.generator.manual_seed(seed)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        prog.graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) if timed else prog.outputs[0].clone()

    from mmnas_tpu_torch.engine.vqa import step_seed

    first, second = (step_seed(exe.cfg.SEED, step) for step in (0, 1))   # steps 0 and 1's
    a, a2, b = replay("weight", first), replay("weight", first), replay("weight", second)
    if not (torch.equal(a, a2) and not torch.equal(a, b)):
        raise AssertionError(f"{name}: replays at step 0's seed give losses {a.item()}, "
                             f"{a2.item()}, at step 1's {b.item()}: the masks do not follow "
                             "the step's seed")
    w_ms = sorted(replay("weight", 7 + i, True) for i in range(5))[2]      # the median
    a_ms = sorted(replay("arch", 7 + i, True) for i in range(3))[1]
    per_chunk = SEARCH_STEPS // len(exe.chunk_log["chunk_s"])
    wall = exe.chunk_log["chunk_s"][-1] * 1e3     # a chunk of replays only (the first captures)
    device = per_chunk * w_ms + per_chunk // ALPHA_EVERY * a_ms
    out = {"mask_losses": [a.item(), a2.item(), b.item()], "weight_replay_ms": w_ms,
           "arch_replay_ms": a_ms, "chunk_wall_ms_per_step": wall / per_chunk,
           "busy_share": device / wall, "eager_weight_step_ms": ref.get("weight_step_ms"),
           "eager_loop_ms_per_step": ref.get("loop_ms", 0) / SEARCH_STEPS,
           "eager_device_split_weight": ref.get("device_split_weight")}
    print(f"{name} on {card}: capture ms weight {exe.chunk_log['weight']['capture_s'] * 1e3:.1f}, "
          f"arch {exe.chunk_log['arch']['capture_s'] * 1e3:.1f}; replayed weight step "
          f"{w_ms:.2f} ms, arch step {a_ms:.2f} ms (device, CUDA events); a chunk of "
          f"{per_chunk} steps {wall:.1f} ms wall, busy {device / wall:.1%}; the per-step leg's "
          f"eager weight step {ref.get('weight_step_ms')} ms, its loop "
          f"{out['eager_loop_ms_per_step']:.2f} ms a weight step, device split "
          f"{ref.get('device_split_weight')}; masks: losses {out['mask_losses']}", flush=True)
    return out


def key_cases(FA, dev):
    """The dropout forward with its key drawn on the card (`draw_key`) and
    read by pointer, at the search's and the unified node's shapes (B 128,
    4 heads), fp32 and bf16: its mask against `keep_mask_reference` at the
    key read back, bit for bit (the first 8 batch rows), a Python int key
    the same mask; its output and the backward on that mask against the
    plain version (KERNEL_TOL, GRAD_TOL)."""
    from mmnas_tpu_torch.ops.primitives import draw_key

    g, rows = torch.Generator().manual_seed(9), []
    gen = torch.Generator(dev).manual_seed(10)
    for dt in DTYPES:
        for Lq, Lk, kind in SEARCH_CASES + UNIFIED_CASES:
            args, m, b_, r_ = to_dev(dev, dt, *make_case(g, Lq, Lk, kind, SEARCH_B, SEARCH_H, D))
            key = draw_key(gen, dev)
            out, keep, pre = FA.attention_fwd(*args, m, b_, r_, dropout_r=RATE, seed=key,
                                              want_pre=r_ is not None)
            value = FA.key_value(key)
            _, keep_int, _ = FA.attention_fwd(*args, m, b_, r_, dropout_r=RATE, seed=value)
            want_keep = FA.keep_mask_reference(value, 8, SEARCH_H, Lq, Lk, RATE)
            name = f"key by pointer B{SEARCH_B} H{SEARCH_H} {dt} ({Lq},{Lk}) {kind}"
            if not torch.equal(keep[:8].cpu().bool(), want_keep) or not torch.equal(keep, keep_int):
                raise AssertionError(f"{name}: the mask is not the key's")
            bias = f32(b_) if r_ is None else log_pre(pre)
            leaves = [a.float().requires_grad_() for a in args]
            ref = FA.fused_attention_reference(*leaves, m, bias, keep=keep, dropout_r=RATE)
            do = torch.randn(ref.shape, generator=g).to(dev, dt)
            grads = torch.autograd.grad(ref, leaves, do.float())
            dq, dk, dv, _, _ = FA.attention_bwd(*args, m, b_, r_, keep, RATE, do, pre=pre)
            fwd_err = (out.float() - ref).abs().max().item()
            scale = max(float(t.abs().max()) for t in grads)
            grad_err = max(float((a.float() - w).abs().max()) for a, w in zip((dq, dk, dv), grads))
            grad_err /= scale
            tol = (KERNEL_TOL[(dt, r_ is not None)], GRAD_TOL[(dt, r_ is not None)])
            rows.append({"case": name, "key": value, "fwd_err": fwd_err, "grad_err": grad_err})
            if fwd_err > tol[0] or grad_err > tol[1]:
                raise AssertionError(f"{name}: forward {fwd_err}, gradient {grad_err} past {tol}")
    print(f"dropout key by pointer: {len(rows)} cases, masks bit for bit, largest forward error "
          f"{max(r['fwd_err'] for r in rows):.3e}, gradient {max(r['grad_err'] for r in rows):.3e}",
          flush=True)
    return rows


def search_resume(cfg, dev, arch_json, engine):
    """RESUME from the epoch-1 checkpoint for a second epoch of the task's
    SearchExecution `engine`: the global steps, the archive and both
    optimizers' step counts continue (ITM mines again first)."""
    from mmnas_tpu_torch.train.checkpoint import ckpt_path, load_checkpoint

    cfg = cfg.replace(RESUME=True, CKPT_FILE_PATH=ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, 1),
                      MAX_EPOCH=2, EVAL_EVERY_EPOCH=False)
    result = engine(cfg, dev).run()
    torch.cuda.synchronize()
    with open(arch_json) as f:
        archive = json.load(f)
    ckpt = load_checkpoint(ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, 2))
    steps = (int(ckpt["net_optim"]["step"]), int(ckpt["alpha_optim"]["step"]))
    first = next(step for kind, step, _ in result.paths if kind == "weight")
    mined = [step for kind, step, _ in result.paths if kind == "mine"]
    print(f"search resume: from global step {first}, mining at epochs {mined}, losses "
          f"{[round(x, 3) for x in result.step_losses]}; archive {list(archive)}; optimizer "
          f"steps (net, alpha) {steps}", flush=True)
    if (first != SEARCH_STEPS or list(archive) != ["epoch1", "epoch2"]
            or mined != ([1] if cfg.TASK == "itm" else [])
            or ckpt["epoch"] != 2 or steps != (2 * SEARCH_STEPS, 2 * SEARCH_STEPS // ALPHA_EVERY)
            or not all(map(math.isfinite, result.step_losses))):
        raise AssertionError(f"search resume: {first}, {mined}, {list(archive)}, {steps}")
    return {"first_step": first, "losses": result.step_losses, "optimizer_steps": steps}


def fixed_net_from_genotype(FA, dev, arch_json):
    """The chain search -> genotype -> fixed net: NetFull of the fixed-net
    Cfg (HSIZE 512) on the archive's last genotype, one eval batch."""
    from mmnas_tpu_torch.engine.vqa import Execution, batch_to_device
    from mmnas_tpu_torch.genotype import load_genotype

    cfg = cfg_for("val", "float32", SYNTH_SIZE=BATCH, ARCH_PATH=arch_json, GENO_EPOCH=2)
    exe = Execution(cfg, dev)
    dataset = exe.build_dataset("val")
    net = exe.build_net(dataset).to(dev).eval()
    batch = batch_to_device(list(exe.make_loader(dataset, BATCH))[0], dev)
    genotype = load_genotype(arch_json, 2)
    att = sum(op != "feed_forward" for c in ("enc", "dec") for node in genotype[c] for op in node)
    zero_launches(FA)
    with torch.inference_mode():
        logits = net(batch)
    torch.cuda.synchronize()
    print(f"fixed net from the searched genotype: HSIZE {cfg.HSIZE}, {att} attention ops, "
          f"logits {tuple(logits.shape)}, {FA.LAUNCHES['fused_attention_fwd']} forward launches",
          flush=True)
    if (cfg.HSIZE != 512 or logits.shape != (BATCH, dataset.ans_size)
            or not torch.isfinite(logits).all() or FA.LAUNCHES["fused_attention_fwd"] != att):
        raise AssertionError(f"fixed net from the genotype: {logits.shape}, {FA.LAUNCHES}")
    return {"hsize": cfg.HSIZE, "attention_ops": att, "launches": FA.LAUNCHES["fused_attention_fwd"]}


def search_precision(cfg, result, dev):
    """bf16 on fp32 masters: the masters, alpha and both optimizers' states
    stay fp32; on one batch at DROPOUT_R 0, the first weight step's paths,
    the bf16 step's loss is within SEARCH_BF16_LOSS_TOL of the fp32 one
    (both from the same seeded init)."""
    from mmnas_tpu_torch.engine.search import SearchExecution
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    kinds = ({p.dtype for p in result.net.parameters()} | {a.dtype for a in result.alpha.values()}
             | {t.dtype for st in (result.opt_state, result.alpha_state) for key in ("m", "v")
                for t in st[key].values()})
    if kinds != {torch.float32}:
        raise AssertionError(f"search bf16: masters, alpha or optimizer states in {kinds}")
    idxs = result.paths[0][2]
    losses = {}
    for dtype in ("float32", "bfloat16"):
        c0 = search_cfg(dtype, cfg.BATCH_SIZE, cfg.KPATH, DROPOUT_R=0.0)
        exe = SearchExecution(c0, dev)
        dataset = exe.build_dataset()
        host = list(exe.make_loader(dataset, list(range(c0.BATCH_SIZE))))[0]
        net = exe.build_net(dataset)
        masters = dict(net.named_parameters())
        optim = build_net_optimizer(c0, SEARCH_STEPS)
        loss, _ = exe.weight_step(net, optim, optim.init(masters), masters,
                                  batch_to_device(host, dev, INPUT_KEYS + ("ans",)), idxs,
                                  torch.Generator(dev), net.init_alpha())
        losses[dtype] = float(loss)
        del net, masters
    rel = abs(losses["bfloat16"] - losses["float32"]) / abs(losses["float32"])
    print(f"search bf16 vs fp32, one weight step at DROPOUT_R 0 on the same paths and batch: "
          f"loss {losses['bfloat16']:.4f} vs {losses['float32']:.4f} (rel {rel:.2e}, tol "
          f"{SEARCH_BF16_LOSS_TOL:g}); masters, alpha and optimizer states {sorted(map(str, kinds))}",
          flush=True)
    if not rel <= SEARCH_BF16_LOSS_TOL:
        raise AssertionError(f"search bf16 loss {losses['bfloat16']} vs fp32 {losses['float32']}")
    return {"loss_bf16": losses["bfloat16"], "loss_fp32": losses["float32"], "rel": rel}


def search_step_times(cfg, result, dev, card, engine, time_arch=True):
    """Weight step and arch step ms on one resident batch each (CUDA
    events; the host's sampling included), search examples/s over
    SEARCH_STEPS weight steps of the engine's own loop
    (`SearchExecution.steps`: an arch step after every ALPHA_EVERY-th, the
    alpha host copy renewed after it) on resident batches, what
    bench.py:462-494 counts, and each step's device split. `engine`: the
    task's SearchExecution class; without `time_arch` the arch step is not
    timed alone (None)."""
    from mmnas_tpu_torch.engine.search import SearchResult, host_copy
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    exe = engine(cfg, dev)
    dataset = exe.build_dataset()
    split, bs, keys = (int(cfg.SYNTH_SIZE * cfg.SPLIT_PORTION), cfg.BATCH_SIZE,
                       INPUT_KEYS + exe.TARGET_KEYS)
    wb = batch_to_device(list(exe.make_loader(dataset, list(range(bs))))[0], dev, keys)
    ab = batch_to_device(list(exe.make_loader(dataset, list(range(split, split + bs))))[0], dev,
                         keys)
    net = result.net
    masters = dict(net.named_parameters())
    optim, aoptim = build_net_optimizer(cfg, SEARCH_STEPS), exe.alpha_optimizer()
    alpha = {c: a.clone() for c, a in result.alpha.items()}
    run = SearchResult(net, alpha, optim.init(masters), aoptim.init(alpha),
                       alpha_host=host_copy(alpha))
    sampler, gen = torch.Generator().manual_seed(11), torch.Generator(dev).manual_seed(12)

    def weight():
        idxs = [net.sample_indices(run.alpha_host, sampler) for _ in range(cfg.KPATH)]
        exe.weight_step(net, optim, run.opt_state, masters, wb, idxs, gen, run.alpha)

    def arch():
        exe.arch_step(net, aoptim, run.alpha_state, run.alpha, ab,
                      net.sample_indices(run.alpha_host, sampler), gen)
        run.alpha_host = host_copy(run.alpha)

    def loop():
        exe.steps(run, optim, aoptim, [wb] * SEARCH_STEPS, lambda: ab, 0, True, gen)

    weight_ms = cuda_time_ms(weight, iters=3, warmup=1)
    arch_ms = cuda_time_ms(arch, iters=2, warmup=1) if time_arch else None
    loop_ms = cuda_time_ms(loop, iters=1, warmup=0)      # warm: the steps above ran it
    ex_s = SEARCH_STEPS * bs / loop_ms * 1000
    split_w, split_a = profile_step(weight), profile_step(arch) if time_arch else None
    print(f"search {cfg.TASK} {cfg.DTYPE} BS {bs} KPATH {cfg.KPATH} on {card}: weight step "
          f"{weight_ms:.2f} ms,"
          f" arch step {'not timed' if arch_ms is None else f'{arch_ms:.2f} ms'}, {SEARCH_STEPS} "
          f"weight + {SEARCH_STEPS // ALPHA_EVERY} arch steps {loop_ms:.2f} ms = {ex_s:.1f} "
          f"examples/s; device split weight step {split_w}, arch step {split_a}",
          flush=True)
    return {"weight_step_ms": weight_ms, "arch_step_ms": arch_ms, "loop_ms": loop_ms,
            "examples_per_s": ex_s, "device_split_weight": split_w, "device_split_arch": split_a}


def step_times_path(dev, card):
    """The VQA search's fp32 BS 128 KPATH 1 steps (DROPOUT_R 0.1, HSIZE 256)
    in each weight program, sampled, --DENSE_WEIGHT, --UNIFIED_WEIGHT and
    --HYBRID_WEIGHT, each from its seeded init and alpha:
    `search_step_times` (the weight step's ms by CUDA events with the
    host's sampling, the engine's loop, the device split; the arch step
    with the sampled program's). `python3 chip_smoke.py --step-times` runs
    the kernels' build and this alone; copied into the root of another
    checkout, it times that checkout's package, so two trees compare on one
    card."""
    from mmnas_tpu_torch.engine.search import SearchExecution, SearchResult, host_copy

    out = {}
    for flag in (None,) + WEIGHT_FLAGS:
        cfg = search_cfg("float32", SEARCH_B, 1, "vqa", flag)
        exe = SearchExecution(cfg, dev)
        net = exe.build_net(exe.build_dataset())
        alpha = {c: a.to(dev) for c, a in net.init_alpha().items()}
        result = SearchResult(net, alpha, {}, {}, alpha_host=host_copy(alpha))
        out[flag or "sampled"] = search_step_times(cfg, result, dev, card, SearchExecution,
                                                   time_arch=flag is None)
        del exe, net, alpha, result
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# visual grounding (VGD): arch/mmnas_vgd.json, its train and eval, the search
# ---------------------------------------------------------------------------

def vgd_eval_path(FA, dev, card):
    """Execution.run() of RUN val at full width from a checkpoint in the JAX
    package's pickle format, fp32 and bf16: exact launches, hits of the
    right shape; the scores and box deltas of 16 items against the same net
    on the CPU, and their hits equal except where the IoU is within
    VGD_IOU_NEAR of the threshold; the forward's time on a resident batch."""
    from mmnas_tpu_torch.engine.vgd import (EVAL_KEYS, Execution, eval_params, grounding_forward,
                                            grounding_hits)
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.models.convert import to_jax_params
    from mmnas_tpu_torch.train.checkpoint import save_checkpoint
    from mmnas_tpu_torch.utils import bbox as BBOX

    lib = BBOX._load_lib()
    if not lib:
        raise AssertionError("the native C++ IoU did not build: the labels took the numpy path")
    print(f"native IoU: {os.path.relpath(lib._name, HERE)}", flush=True)
    ckpt = os.path.join(WORK, "mmnas_vgd_seed0.pkl")
    cfg32 = cfg_for("val", "float32", "vgd", SYNTH_SIZE=SYNTH_SIZE, CKPT_PATH=ckpt)
    exe = Execution(cfg32, dev)
    dataset = exe.build_dataset("val")
    net = exe.build_net(dataset)
    item = dataset[0]
    print(f"VGD path: HSIZE {cfg32.HSIZE}, {cfg32.FRCNFEAT_LEN} regions of {cfg32.FRCNFEAT_SIZE}, "
          f"query {item['ques_ix'].shape[0]} tokens, text relation {item['rel_ques'].shape}, "
          f"{sum(p.numel() for p in net.parameters())} parameters", flush=True)
    if item["ques_ix"].shape != (15,) or item["rel_ques"].shape != (14, 14, 3):
        raise AssertionError("VGD items off the reference shapes")
    save_checkpoint(ckpt, {"state_dict": to_jax_params(net), "net_optim": None, "epoch": 0})
    del net

    n_batches = math.ceil(SYNTH_SIZE / BATCH)
    keys = EVAL_KEYS
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = cfg_for("val", dtype, "vgd", SYNTH_SIZE=SYNTH_SIZE, CKPT_PATH=ckpt)
        exe = Execution(cfg, dev)
        zero_launches(FA)
        result = exe.run()
        torch.cuda.synchronize()
        launches = dict(FA.LAUNCHES)
        want = {"fused_attention_fwd": VGD_LAUNCHES_PER_BATCH * n_batches,
                "fused_attention_fwd_dropout": 0, "fused_attention_bwd": 0,
                "fused_attention_bwd_rel": 0}
        if launches != want:
            raise AssertionError(f"VGD {dtype} eval: kernel launches {launches}, expected {want}")
        if result.hits.shape != (SYNTH_SIZE,) or not np.isfinite(result.ious).all():
            raise AssertionError(f"VGD {dtype}: hits of shape {result.hits.shape}")

        gpu_net = exe.load_masters(dataset)
        host_batch = list(exe.make_loader(dataset, BATCH))[0]
        batch = batch_to_device(host_batch, dev, keys)
        with torch.inference_mode():
            params = eval_params(gpu_net, cfg)
            fwd_ms = cuda_time_ms(lambda: grounding_forward(gpu_net, params, batch), iters=10)
            small = {k: v[:16] for k, v in host_batch.items()}
            g_scores, g_reg = grounding_forward(gpu_net, params, batch_to_device(small, dev, keys))
            g_hits, g_iou = grounding_hits(cfg, g_scores, g_reg, batch_to_device(small, dev, keys))
            cpu = torch.device("cpu")
            cpu_net = Execution(cfg, cpu).load_masters(dataset)
            cb = batch_to_device(small, cpu, keys)
            c_scores, c_reg = grounding_forward(cpu_net, eval_params(cpu_net, cfg), cb)
            c_hits, c_iou = grounding_hits(cfg, c_scores, c_reg, cb)
        g_scores, g_reg, g_hits, g_iou = (t.cpu() for t in (g_scores, g_reg, g_hits, g_iou))
        if (g_scores.shape != (16, 100) or g_reg.shape != (16, 100, 4)
                or not (torch.isfinite(g_scores).all() and torch.isfinite(g_reg).all())):
            raise AssertionError(f"VGD {dtype}: bad outputs {g_scores.shape} {g_reg.shape}")
        diff = max((g_scores - c_scores).abs().max().item(), (g_reg - c_reg).abs().max().item())
        near = (c_iou - cfg.OVERLAP_THRESHOLD).abs() < VGD_IOU_NEAR
        hits_equal = bool(torch.equal(g_hits[~near], c_hits[~near]))
        tol = LOGIT_TOL[dtype]
        print(f"VGD eval {dtype}: {launches['fused_attention_fwd']} kernel launches over "
              f"{n_batches} batches; IoU@0.5 accuracy {result.accuracy}% ({int(result.hits.sum())} "
              f"hits); {SYNTH_SIZE / result.seconds:.1f} examples/s end to end (loader "
              f"included), {BATCH / fwd_ms * 1000:.1f} examples/s forward only ({fwd_ms:.3f} ms "
              f"per batch of {BATCH}) on {card}; scores and deltas card vs CPU max abs diff "
              f"{diff:.3e} (tol {tol:g}); hits card {int(g_hits.sum())} CPU {int(c_hits.sum())} "
              f"of 16, {int(near.sum())} near the threshold", flush=True)
        if not diff <= tol:
            raise AssertionError(f"VGD {dtype}: card outputs differ from the CPU run by {diff}")
        if not hits_equal:
            raise AssertionError(f"VGD {dtype}: hits differ between the card and the CPU")
        out[dtype] = {"launches": launches["fused_attention_fwd"],
                      "examples_per_s": SYNTH_SIZE / result.seconds, "forward_ms": fwd_ms,
                      "output_diff": diff, "accuracy": result.accuracy}
    return out


# ---------------------------------------------------------------------------
# image-text matching (ITM): arch/mmnas_itm.json, mining, train, R@K eval
# ---------------------------------------------------------------------------

def itm_path(FA, dev, card):
    """`Execution.run()` of `--RUN train --SYNTH --ARCH_PATH
    ./arch/mmnas_itm.json --BS 64 --SYNTH_SIZE 500` at full width (HSIZE
    512, 36 regions of 2048, 50-token captions), fp32 and bf16 on fp32
    masters: hard-negative mining before the epoch (NEG_RANDSIZE 64,
    NEG_HARDSIZE 5) over the corpus of 100 images, a triplet train step per
    batch of 64 (three forwards, DROPOUT_R 0.1), then the R@K eval over the
    full 100 x 500 score matrix; exact launches, finite losses, fp32
    masters and Adam moments. Per leg then: the epoch checkpoint evaluated
    again (`--RUN val --CKPT_PATH`, ITM_RELOAD_SIZE captions) with exact
    launches, its score matrix's ITM_CORNER against the CPU's; the negatives
    mined for the first ITM_MINE_CHECK items against the CPU's ranking of the
    same candidates under the same initial net, equal away from ties (scores
    closer than twice the card-vs-CPU difference); encode_text +
    apply_decoder against forward on the card, bit for bit; the train step
    (wall and device split), the mining, the text encoder and the scorer
    timed. fp32 also runs `one_step_parity`."""
    from mmnas_tpu_torch.data.loader import _stack
    from mmnas_tpu_torch.engine import itm as ITM
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS, compute_call, compute_dtype, compute_params
    from mmnas_tpu_torch.train.checkpoint import ckpt_path
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    engine, _, n_att, n_rsa = engines("itm")
    enc_att, dec_att, _ = itm_genotype_ops()
    cpu = torch.device("cpu")
    steps = math.ceil(ITM_SIZE / BATCH)
    legs = {}
    for dtype in ("float32", "bfloat16"):
        name = f"itm train {dtype}"
        cfg = cfg_for("train", dtype, "itm", SYNTH_SIZE=ITM_SIZE, MAX_EPOCH=1,
                      VERSION=f"smoke_itm_{dtype}")
        if not (all(getattr(cfg, k) == v for k, v in ITM_CFG.items())
                and cfg.EVAL_BATCH_SIZE * 2 == ITM_SCORER_B and cfg.NET_GRAD_CLIP > 0):
            raise AssertionError(f"unexpected ITM config {cfg}")
        exe = engine(cfg, dev)
        mined, mine = [], exe.mine_hard_negatives

        def recorded(net, dataset, epoch, mine=mine, mined=mined):
            """The mining, timed, with the negatives it wrote and its scorer's
            tiles (index arrays and device scores, in call order) kept."""
            tiles, score = [], ITM.score_pairs

            def kept(*args):
                out = score(*args)
                tiles.append((args[3], args[4], out))
                return out

            ITM.score_pairs = kept
            t0 = time.perf_counter()
            try:
                mine(net, dataset, epoch)
            finally:
                ITM.score_pairs = score
            torch.cuda.synchronize()
            mined.append((dataset.neg_caps_idx_tensor.copy(), dataset.neg_imgs_idx_tensor.copy(),
                          time.perf_counter() - t0, tiles))

        exe.mine_hard_negatives = recorded
        zero_launches(FA)
        t0 = time.perf_counter()
        result = exe.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, losses = dict(FA.LAUNCHES), result.step_losses
        want = {"fused_attention_fwd": sum(itm_sweep_launches(cfg, ITM_SIZE, enc_att, dec_att, k)
                                           for k in ("mine", "eval")),
                "fused_attention_fwd_dropout": 3 * n_att * steps,
                "fused_attention_bwd": 3 * n_att * steps,
                "fused_attention_bwd_rel": 3 * n_rsa * steps}
        print(f"{name}: mining {mined[0][2] if mined else 0:.2f} s, {steps} steps, losses per "
              f"batch of {BATCH} {[round(x, 3) for x in losses]}; {launches} (expected {want}); "
              f"{seconds:.1f} s with the mining, the loader and the eval on {card}", flush=True)
        if launches != want:
            raise AssertionError(f"{name}: kernel launches {launches}, expected {want}")
        if len(mined) != 1 or len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{name}: {len(mined)} mining passes, losses {losses}")
        kinds = {p.dtype for p in result.net.parameters()} | {
            t.dtype for key in ("m", "v") for t in result.opt_state[key].values()}
        if kinds != {torch.float32}:
            raise AssertionError(f"{name}: masters or Adam moments in {kinds}")
        leg = {"launches": launches, "losses": losses, "seconds": seconds,
               "mining_s": mined[0][2]}
        t_check = time.perf_counter()

        # --RUN val on the epoch checkpoint; its score matrix's corner on the CPU
        vcfg = cfg_for("val", dtype, "itm", SYNTH_SIZE=ITM_RELOAD_SIZE,
                       CKPT_PATH=ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, 1))
        zero_launches(FA)
        reloaded = engine(vcfg, dev).run()
        torch.cuda.synchronize()
        want_val = {"fused_attention_fwd": itm_sweep_launches(vcfg, ITM_RELOAD_SIZE, enc_att,
                                                              dec_att, "eval"),
                    "fused_attention_fwd_dropout": 0, "fused_attention_bwd": 0,
                    "fused_attention_bwd_rel": 0}
        n_imgs = ITM_RELOAD_SIZE // 5
        if (dict(FA.LAUNCHES) != want_val or reloaded.scores.shape != (n_imgs, ITM_RELOAD_SIZE)
                or not np.isfinite(reloaded.scores).all()):
            raise AssertionError(f"{name}: eval of the checkpoint: {FA.LAUNCHES}, expected "
                                 f"{want_val}; scores {reloaded.scores.shape}")
        vexe = engine(vcfg, cpu)
        vds = vexe.build_dataset("val")
        ni, nc = ITM_CORNER
        with torch.inference_mode():
            encode, decode = ITM.pair_fns(*cpu_reference(vexe.load_masters(vds), vcfg))
            corpus = cpu_corpus(vds, vcfg)
            te = ITM.encode_window(encode, corpus["caps"], 0, nc, vcfg.TEXT_ENC_CHUNK)
            ii, cc = (a.reshape(-1) for a in np.meshgrid(np.arange(ni), np.arange(nc),
                                                          indexing="ij"))
            corner = np.asarray(ITM.score_pairs(decode, corpus, te, ii, cc)).reshape(ni, nc)
        corner_diff = float(np.abs(reloaded.scores[:ni, :nc] - corner).max())
        tol = LOGIT_TOL[dtype]
        print(f"{name}: eval of the checkpoint over {n_imgs} x {ITM_RELOAD_SIZE}: R@1/5/10 i2t "
              f"{[reloaded.stats[f'i2t_r{k}'] for k in (1, 5, 10)]} t2i "
              f"{[reloaded.stats[f't2i_r{k}'] for k in (1, 5, 10)]}, "
              f"{n_imgs * ITM_RELOAD_SIZE / reloaded.seconds:.1f} pairs/s end to end; scores card "
              f"vs CPU on the {ni} x {nc} corner max abs diff {corner_diff:.3e} (tol {tol:g})",
              flush=True)
        if not corner_diff <= tol:
            raise AssertionError(f"{name}: card scores differ from the CPU's by {corner_diff}")
        leg.update(reload_stats=reloaded.stats, corner_diff=corner_diff,
                   eval_pairs_per_s=n_imgs * ITM_RELOAD_SIZE / reloaded.seconds)
        print(f"  ({time.perf_counter() - t_check:.1f} s)", flush=True)
        t_check = time.perf_counter()

        # the mined negatives of the first items, against the CPU's ranking
        ds = exe.build_dataset("train")
        leg["mined_vs_cpu"] = itm_mined_vs_cpu(engine, cfg, ds, mined[0], name)
        print(f"  ({time.perf_counter() - t_check:.1f} s)", flush=True)
        t_check = time.perf_counter()

        # split trunk vs forward on the card; the train step, encoder and scorer timed
        net = result.net
        host = _stack([ds[i] for i in range(BATCH)])
        keys = INPUT_KEYS + exe.TARGET_KEYS
        batch = batch_to_device(host, dev, keys)
        with torch.inference_mode():
            cast = compute_params(net, cfg) if compute_dtype(cfg) != torch.float32 else None
            full = compute_call(net, cfg, (batch,), params=cast)
            encode, decode = ITM.pair_fns(net, cfg)
            split = decode(*encode(batch["ques_ix"]), batch)
            torch.cuda.synchronize()
            if split.shape != (BATCH,) or not torch.equal(split, full):
                raise AssertionError(f"{name}: encode_text + apply_decoder differ from forward "
                                     f"by {(split - full).abs().max().item()}")
            corpus = exe.device_corpus(ds)
            enc_ms = cuda_time_ms(lambda: ITM.encode_window(
                encode, corpus["caps"], 0, ITM_SIZE, cfg.TEXT_ENC_CHUNK), iters=3, warmup=1)
            te = ITM.encode_window(encode, corpus["caps"], 0, ITM_SIZE, cfg.TEXT_ENC_CHUNK)
            r = np.random.RandomState(0)
            ii, cc = r.randint(0, ITM_SIZE // 5, ITM_SCORER_B), r.randint(0, ITM_SIZE,
                                                                         ITM_SCORER_B)
            tile_ms = cuda_time_ms(lambda: ITM.score_pairs(decode, corpus, te, ii, cc).scores)
            tile_split = profile_step(lambda: ITM.score_pairs(decode, corpus, te, ii, cc).scores)
        params = dict(net.named_parameters())
        optim = build_net_optimizer(cfg, steps)
        state = optim.init(params)
        gen = torch.Generator(dev).manual_seed(3)
        step_ms = cuda_time_ms(lambda: exe.train_step(net, optim, state, params, batch, gen),
                               iters=5, warmup=1)
        step_split = profile_step(lambda: exe.train_step(net, optim, state, params, batch, gen))
        print(f"{name} on {card}: train step BS {BATCH} {step_ms:.2f} ms ({BATCH / step_ms * 1000:.1f}"
              f" triplets/s), device split {step_split}; mining {mined[0][2]:.2f} s; text encoder "
              f"{ITM_SIZE / enc_ms * 1000:.1f} captions/s; scorer {ITM_SCORER_B} pairs "
              f"{tile_ms:.3f} ms = {ITM_SCORER_B / tile_ms * 1000:.1f} pairs/s, device split "
              f"{tile_split}; split trunk equals forward", flush=True)
        leg.update(step_ms=step_ms, step_device_split=step_split,
                   text_captions_per_s=ITM_SIZE / enc_ms * 1000, tile_ms=tile_ms,
                   tile_device_split=tile_split, scorer_pairs_per_s=ITM_SCORER_B / tile_ms * 1000)
        del net, params, state, result
        print(f"  ({time.perf_counter() - t_check:.1f} s)", flush=True)
        if dtype == "float32":
            leg.update(one_step_parity(engine, cfg.replace(DROPOUT_R=0.0), ds,
                                       {k: v[:16] for k, v in host.items()}, keys, steps, n_rsa,
                                       "itm", dev))
        legs[dtype] = leg
        torch.cuda.empty_cache()
    return {"legs": legs}


# this slice's main path: a VQA fixed net whose genotype names every one of
# the 41 ops, at HSIZE 512, batch 64 (all_ops_path), and the whole-batch VQA
# loader with DEVICE_REL and SHIP_INT8 (device_rel_path). The kernel shapes
# its attention reaches past the shapes above (NEW_SHAPE_CASES: B, H, D,
# cases): 2 heads of 256 (self_att_256, rel_self_att_256, guided_att_256),
# 32 heads of 16 with the relation chain (rel_self_att_16), and keys with no
# pad mask over concat(y, x) (uniimg_att_64: VQA's 100 regions over 114 keys,
# ITM's 36 over 86), and the instances that the main path runs on the
# column-window backward at the shipped widths (rel_self_att_128 and
# uniimg_att_128: 4 heads of 128; rel_self_att_32 and uniimg_att_32: 16 of 32)
NEW_SHAPE_CASES = [(B, 2, 256, [(100, 100, "mask"), (100, 100, "mask+rel"), (100, 14, "mask")]),
                   (B, 32, 16, [(100, 100, "mask+rel")]),
                   (B, H, D, [(100, 114, "nopad"), (36, 86, "nopad")]),
                   (B, 4, 128, [(100, 100, "mask+rel"), (100, 114, "nopad")]),
                   (B, 16, 32, [(100, 100, "mask+rel"), (100, 114, "nopad")])]
ALL_OPS_EVAL_SIZE = 2 * BATCH
# the ops that read neither y nor the relation go to the encoder
DECODER_OPS = ("rel_self_att_", "guided_att_", "uniimg_att_", "self_att_256")
REHEARSAL = os.path.join(WORK, "rehearsal")   # the small packed corpus (device_rel_path)
LOADER_PASSES = 8           # passes over its 200 questions: 25 batches of 64 a loader


def all_ops_genotype():
    """A genotype with arch/mmnas_vqa.json's node counts (12 encoder, 18
    decoder) naming all 41 ops: the 26 that read neither y nor the relation
    spread over the encoder's nodes (2 or 3 a node, summed as the reference
    sums a node's ops), the 15 others one a node in the decoder, cycled to
    fill its 18 nodes."""
    from mmnas_tpu_torch.genotype import load_genotype
    from mmnas_tpu_torch.ops.registry import OPS

    ref = load_genotype(ARCHS["vqa"])
    n_enc, n_dec = len(ref["enc"]), len(ref["dec"])
    dec_ops = [n for n in OPS if n.startswith(DECODER_OPS)]
    enc_ops = [n for n in OPS if n not in dec_ops]
    return {"enc": [enc_ops[i::n_enc] for i in range(n_enc)],
            "dec": [[dec_ops[i % len(dec_ops)]] for i in range(n_dec)]}


def genotype_launches(genotype):
    """(attention ops, rel_self_att ops) of a genotype at LAYERS 1."""
    ops = [n for c in ("enc", "dec") for node in genotype[c] for n in node]
    return sum("_att_" in n for n in ops), sum(n.startswith("rel_self_att_") for n in ops)


def new_shape_cases(FA, dev):
    """The kernels at NEW_SHAPE_CASES against their plain versions (fp32 and
    bf16, forward, dropout forward, backward, relation pass), with their
    times, bounds and SDPA's; each kernel launched exactly once per call
    (the wrappers' counts), and past the new limits the wrapper refuses."""
    fwd, train = [], []
    g = torch.Generator().manual_seed(5)
    for Bn, Hn, Dn, cases in NEW_SHAPE_CASES:
        fwd += kernel_cases(FA, dev, Bn, Hn, cases, D=Dn)
        train += train_kernel_cases(FA, dev, Bn, Hn, cases, D=Dn)
        for Lq, Lk, kind in cases:               # one launch per kernel per call
            args, m, _, r_ = to_dev(dev, torch.float32, *make_case(g, Lq, Lk, kind, Bn, Hn, Dn))
            leaves = [a.requires_grad_() for a in args]
            if r_ is not None:
                r_ = (r_[0],) + tuple(t.requires_grad_() for t in r_[1:])
            zero_launches(FA)
            out = FA.fused_attention(*leaves, m, rel=r_, dropout_r=RATE,
                                     generator=torch.Generator(dev).manual_seed(1))
            out.sum().backward()
            torch.cuda.synchronize()
            want = {"fused_attention_fwd": 0, "fused_attention_fwd_dropout": 1,
                    "fused_attention_bwd": 1, "fused_attention_bwd_rel": int(r_ is not None)}
            if dict(FA.LAUNCHES) != want:
                raise AssertionError(f"B{Bn} H{Hn} D{Dn} ({Lq},{Lk}) {kind}: launches "
                                     f"{FA.LAUNCHES}, expected {want}")
    q = torch.zeros(1, 1, 8, 272, device=dev)                     # past the new limits
    rel = (torch.zeros(1, 8, 8, RR, device=dev), torch.zeros(R, RR, device=dev),
           torch.zeros(R, device=dev), torch.zeros(33, R, device=dev), torch.zeros(33, device=dev))
    for call, what in ((lambda: FA.attention_fwd(q, q, q), "head width"),
                       (lambda: FA.attention_fwd(*[torch.zeros(1, 33, 8, 16, device=dev)] * 3,
                                                 rel=rel), "heads")):
        try:
            call()
        except ValueError as e:
            if what not in str(e):
                raise
        else:
            raise AssertionError(f"the wrapper took a shape past its {what} limit")
    print(f"new shapes: {len(fwd)} forward and {len(train)} training cases agree, one launch "
          "per kernel per call, past the limits refused", flush=True)
    return fwd, train


def all_ops_path(FA, dev, card):
    """This slice's main path. `Execution.run()` of RUN val (fp32, bf16) on
    the all-ops genotype at full width from a seeded checkpoint: exact
    forward launches, logits of 8 items card vs CPU; one train step on one
    resident batch (DROPOUT_R 0.1, fp32 and bf16 on fp32 masters) with exact
    launches and a finite loss, the fp32 step timed; `one_step_parity`.
    Returns the main path's launches: the fp32 eval's forwards, the fp32
    train step's dropout forwards, backwards and relation passes."""
    from mmnas_tpu_torch.engine.vqa import Execution, batch_to_device
    from mmnas_tpu_torch.models.convert import to_jax_params
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.train.checkpoint import save_checkpoint
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    genotype = all_ops_genotype()
    arch = os.path.join(WORK, "all_ops.json")
    with open(arch, "w") as f:
        json.dump({"epoch0": genotype}, f)
    n_att, n_rsa = genotype_launches(genotype)
    ckpt = os.path.join(WORK, "all_ops_seed0.pkl")
    cfg32 = cfg_for("val", "float32", SYNTH_SIZE=ALL_OPS_EVAL_SIZE, CKPT_PATH=ckpt,
                    ARCH_PATH=arch)
    exe = Execution(cfg32, dev)
    dataset = exe.build_dataset("val")
    net = exe.build_net(dataset)
    names = sorted({n for c in genotype.values() for node in c for n in node})
    print(f"all-ops net: {len(names)} ops, {n_att} attention ({n_rsa} RSA) ops, "
          f"{sum(p.numel() for p in net.parameters())} parameters", flush=True)
    if len(names) != 41:
        raise AssertionError(f"the all-ops genotype names {len(names)} ops")
    save_checkpoint(ckpt, {"state_dict": to_jax_params(net), "net_optim": None, "epoch": 0})
    del net
    out, main = {"genotype": genotype}, {}
    n_batches = ALL_OPS_EVAL_SIZE // BATCH
    for dtype in ("float32", "bfloat16"):
        cfg = cfg_for("val", dtype, SYNTH_SIZE=ALL_OPS_EVAL_SIZE, CKPT_PATH=ckpt, ARCH_PATH=arch)
        exe = Execution(cfg, dev)
        zero_launches(FA)
        result = exe.run()
        torch.cuda.synchronize()
        launches = dict(FA.LAUNCHES)
        want = {"fused_attention_fwd": n_att * n_batches, "fused_attention_fwd_dropout": 0,
                "fused_attention_bwd": 0, "fused_attention_bwd_rel": 0}
        if launches != want or result.preds.shape != (ALL_OPS_EVAL_SIZE,):
            raise AssertionError(f"all-ops {dtype} eval: launches {launches}, expected {want}; "
                                 f"predictions {result.preds.shape}")
        gpu_net = exe.load_net(dataset)
        host_batch = list(exe.make_loader(dataset, BATCH))[0]
        batch = batch_to_device(host_batch, dev)
        with torch.inference_mode():
            fwd_ms = cuda_time_ms(lambda: gpu_net(batch), iters=5, warmup=1)
            small = {k: v[:8] for k, v in host_batch.items()}
            gpu_logits = gpu_net(batch_to_device(small, dev)).cpu()
            cpu_net = Execution(cfg, torch.device("cpu")).load_net(dataset)
            cpu_logits = cpu_net(batch_to_device(small, torch.device("cpu")))
        diff = (gpu_logits - cpu_logits).abs().max().item()
        print(f"all-ops eval {dtype}: {launches['fused_attention_fwd']} forward launches over "
              f"{n_batches} batches; forward {fwd_ms:.3f} ms per batch of {BATCH} on {card}; "
              f"logits card vs CPU max abs diff {diff:.3e} (tol {LOGIT_TOL[dtype]:g})", flush=True)
        if not (torch.isfinite(gpu_logits).all() and diff <= LOGIT_TOL[dtype]):
            raise AssertionError(f"all-ops {dtype}: card logits differ from the CPU's by {diff}")
        out[f"eval_{dtype}"] = {"launches": launches, "forward_ms": fwd_ms, "logit_diff": diff}
        if dtype == "float32":
            main["fused_attention_fwd"] = launches["fused_attention_fwd"]
        del gpu_net, cpu_net

    keys = INPUT_KEYS + Execution.TARGET_KEYS
    for dtype in ("float32", "bfloat16"):
        cfg = cfg_for("train", dtype, SYNTH_SIZE=BATCH, ARCH_PATH=arch)
        exe = Execution(cfg, dev)
        dataset = exe.build_dataset("train")
        host_batch = list(exe.make_loader(dataset, BATCH))[0]
        batch = batch_to_device(host_batch, dev, keys)
        net = exe.build_net(dataset).to(dev)
        params = dict(net.named_parameters())
        optim = build_net_optimizer(cfg, 1)
        state = optim.init(params)
        gen = torch.Generator(dev).manual_seed(3)
        zero_launches(FA)
        loss, _ = exe.train_step(net, optim, state, params, batch, gen)
        torch.cuda.synchronize()
        launches = dict(FA.LAUNCHES)
        want = {"fused_attention_fwd": 0, "fused_attention_fwd_dropout": n_att,
                "fused_attention_bwd": n_att, "fused_attention_bwd_rel": n_rsa}
        if launches != want or not math.isfinite(float(loss)):
            raise AssertionError(f"all-ops {dtype} train step: launches {launches}, expected "
                                 f"{want}; loss {float(loss)}")
        step_ms = cuda_time_ms(lambda: exe.train_step(net, optim, state, params, batch, gen),
                               iters=3, warmup=1)
        print(f"all-ops train step {dtype} BS {BATCH}: loss {float(loss):.4f}, {launches}; "
              f"{step_ms:.2f} ms on {card}", flush=True)
        out[f"train_{dtype}"] = {"launches": launches, "loss": float(loss), "step_ms": step_ms}
        if dtype == "float32":
            main.update({k: launches[k] for k in ("fused_attention_fwd_dropout",
                                                  "fused_attention_bwd",
                                                  "fused_attention_bwd_rel")})
        del net, params, state
    out.update(one_step_parity(Execution, cfg_for("train", "float32", ARCH_PATH=arch
                                                  ).replace(DROPOUT_R=0.0),
                               dataset, {k: v[:16] for k, v in host_batch.items()}, keys, 1,
                               n_rsa, "all-ops", dev))
    out["main_path_launches"] = main
    return out


def data_cfg(run, dtype, flags=(), **extra):
    """`--RUN run --DATA_ROOT <the rehearsal corpus> --ARCH_PATH
    arch/mmnas_vqa.json --BS 64` of the VQA CLI with `flags` (--DEVICE_REL,
    --SHIP_INT8), GloVe off (the corpus has no GloVe cache)."""
    from mmnas_tpu_torch.config import cfg_from_args, make_arg_parser

    args = ["--RUN", run, "--DATA_ROOT", REHEARSAL, "--ARCH_PATH", ARCHS["vqa"], "--BS",
            str(BATCH), "--SEED", "0", "--NW", "8", "--DTYPE", dtype, *flags]
    for k, v in extra.items():
        args += [f"--{k}", str(v)]
    cfg = cfg_from_args("vqa", make_arg_parser("vqa").parse_args(args))
    return cfg.replace(LOG_ROOT=os.path.join(WORK, "log"), CKPT_ROOT=os.path.join(WORK, "ckpts"),
                       GLOVE_FEATURE=False)


def loader_rate(FA, exe, dataset, dev, n_att):
    """Steady-state examples/s of the eval loop with its loader: LOADER_PASSES
    passes over `dataset` in order through the engine's loader and net, as
    `Execution.eval` runs them (the forward, the argmax fetched to the host),
    timed from the end of the first batch to the end of the last, so that the
    loader's start and the first batch stay out; exact forward launches."""
    from mmnas_tpu_torch.data.loader import Loader
    from mmnas_tpu_torch.data.sampler import SubsetShardSampler
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.models.net import compute_call, compute_params

    cfg = exe.cfg
    idx = np.tile(np.arange(len(dataset)), LOADER_PASSES)
    loader = Loader(dataset, BATCH, num_workers=cfg.NUM_WORKERS,
                    sampler=SubsetShardSampler(len(dataset), subset_indices=idx))
    net = exe.load_net(dataset)
    n = 0
    zero_launches(FA)
    with torch.inference_mode():
        params = compute_params(net, cfg)
        for batch in loader:
            compute_call(net, cfg, (batch_to_device(batch, dev),), params=params
                         ).argmax(dim=-1).cpu()
            if n == 0:
                t0 = time.perf_counter()
            n += 1
    seconds = time.perf_counter() - t0
    if FA.LAUNCHES["fused_attention_fwd"] != n_att * n or n * BATCH != len(idx):
        raise AssertionError(f"loader rate: {n} batches, {FA.LAUNCHES}")
    return (n - 1) * BATCH / seconds, seconds


def device_rel_path(FA, dev, card):
    """The VQA eval through the real-data loaders on a small corpus in the
    reference's on-disk layout, made on the spot by tools/make_rehearsal_data.py
    and packed by tools/pack_features.py (run as programs): `Execution.run()`
    of RUN val (arch/mmnas_vqa.json, HSIZE 512, 100 regions of 2048) with the
    per-item loader (host relation tensors, fp32 features), with DEVICE_REL
    (the whole-batch loader: fp16 features, raw boxes) and with DEVICE_REL
    and SHIP_INT8 (int8 features and fp32 scales), each with exact forward
    launches; the flags' logits of 8 items card vs CPU and against the
    per-item path's (int8 rounding: within 5% of the largest); each loader's
    steady-state examples/s (`loader_rate`). `run_seconds` is one
    `Execution.run()` of the 200 questions, the loader's start included."""
    from mmnas_tpu_torch.data.vqa import VqaDataset
    from mmnas_tpu_torch.engine.vqa import Execution, batch_to_device
    from mmnas_tpu_torch.genotype import load_genotype
    from mmnas_tpu_torch.models.convert import to_jax_params
    from mmnas_tpu_torch.train.checkpoint import save_checkpoint

    t0 = time.perf_counter()
    for tool, args in (("make_rehearsal_data.py", ["--out", REHEARSAL, "--seed", "0"]),
                       ("pack_features.py", ["--src", os.path.join(
                           REHEARSAL, "vqa", "bua-r101-max100", "val2014"), "--max_len", "100"])):
        subprocess.run([sys.executable, os.path.join(HERE, "tools", tool), *args], check=True,
                       capture_output=True, text=True)
    print(f"rehearsal corpus made and packed in {time.perf_counter() - t0:.1f} s", flush=True)
    ckpt = os.path.join(WORK, "rehearsal_vqa_seed0.pkl")
    exe = Execution(data_cfg("val", "float32", CKPT_PATH=ckpt), dev)
    dataset = exe.build_dataset("val")
    net = exe.build_net(dataset)
    save_checkpoint(ckpt, {"state_dict": to_jax_params(net), "net_optim": None, "epoch": 0})
    del net
    n_att, _ = genotype_launches(load_genotype(ARCHS["vqa"]))
    n_batches = math.ceil(len(dataset) / BATCH)
    out, logits = {}, {}
    for leg, flags in (("per_item", ()), ("device_rel", ("--DEVICE_REL",)),
                       ("device_rel_int8", ("--DEVICE_REL", "--SHIP_INT8"))):
        cfg = data_cfg("val", "float32", flags, CKPT_PATH=ckpt)
        exe = Execution(cfg, dev)
        zero_launches(FA)
        result = exe.run()
        torch.cuda.synchronize()
        if FA.LAUNCHES["fused_attention_fwd"] != n_att * n_batches:
            raise AssertionError(f"{leg}: {FA.LAUNCHES}, expected {n_att * n_batches} forwards")
        ds = VqaDataset(cfg, "val")
        if (leg != "per_item") != ds.supports_batch():
            raise AssertionError(f"{leg}: whole-batch loader {ds.supports_batch()}")
        idx = np.arange(8)
        host = ds.get_batch(idx) if leg != "per_item" else {
            k: np.stack([ds[i][k] for i in idx]) for k in ds[0]}
        if leg == "device_rel_int8" and (host["frcn_feat_q"].dtype != np.int8
                                         or "rel_img" in host):
            raise AssertionError(f"{leg}: batch {[(k, v.dtype) for k, v in host.items()]}")
        gpu_net = exe.load_net(ds)
        with torch.inference_mode():
            g = gpu_net(batch_to_device(host, dev)).cpu()
            c = Execution(cfg, torch.device("cpu")).load_net(ds)(
                batch_to_device(host, torch.device("cpu")))
        diff = (g - c).abs().max().item()
        logits[leg] = g
        launches = FA.LAUNCHES["fused_attention_fwd"]
        if not (torch.isfinite(g).all() and diff <= LOGIT_TOL["float32"]):
            raise AssertionError(f"{leg}: card logits differ from the CPU's by {diff}")
        del gpu_net
        eps, seconds = loader_rate(FA, exe, ds, dev, n_att)
        print(f"VQA eval on the packed corpus, {leg}: {len(dataset)} questions in "
              f"{result.seconds:.3f} s ({launches} forward launches); steady state "
              f"{eps:.1f} examples/s with the loader over {LOADER_PASSES} passes "
              f"({seconds:.3f} s) on {card}; logits card vs CPU {diff:.3e}", flush=True)
        out[leg] = {"examples_per_s": eps, "steady_seconds": seconds,
                    "run_seconds": result.seconds, "logit_diff": diff, "launches": launches}
    scale = logits["per_item"].abs().max().item()
    for leg in ("device_rel", "device_rel_int8"):
        d = (logits[leg] - logits["per_item"]).abs().max().item()
        out[leg]["vs_per_item"] = d
        if not d <= 0.05 * scale:
            raise AssertionError(f"{leg}: logits {d} off the per-item path's (largest {scale})")
    return out


# rehearsal_path's epochs: its train loops are the per-item loaders' (about
# 140 items/s from the npz files while a bf16 step runs, on an H100 80GB HBM3
# at 700 W), so 20 epochs of each task's 1,000 items would take ~290 s. From
# the packed stores (fp32, the npz values) they run at 200-260 items/s, and the
# tools' 20-epoch runs had converged by these epochs (docs/evidence/
# rehearsal_torch_{vqa,vgd}.json: VQA's loss 0.046 at epoch 5 of 3.89,
# VGD's 0.0045 at epoch 8 of 0.060)
REHEARSAL_EPOCHS = {"vqa": 6, "vgd": 8}
# the pass marks of rehearsal_path at full width (the JAX package's TPU runs
# of 20 epochs read 100.0 and 100.0 / 100.0, docs/evidence/
# rehearsal_{vqa,vgd}.json); the last epoch's loss under this share of the first
REHEARSAL_MIN = {"vqa": 90.0, "vgd": 90.0}
REHEARSAL_LOSS_DROP = 0.5


def rehearsal_sizes():
    """{task: (train items, [eval items per split])} of the small corpus
    (device_rel_path's), read from its files: VQA's train annotations and
    val questions, VGD's train refs and val / testA refs."""
    def count(*parts, key=None):
        with open(os.path.join(REHEARSAL, *parts)) as f:
            data = json.load(f)
        return len(data[key] if key else data)

    anno, refs = ("vqa", "annotations"), ("vgd", "refcoco")
    return {"vqa": (count(*anno, "v2_mscoco_train2014_annotations.json", key="annotations"),
                    [count(*anno, "v2_OpenEnded_mscoco_val2014_questions.json",
                           key="questions")]),
            "vgd": (count(*refs, "train.json"), [count(*refs, "val.json"),
                                                 count(*refs, "testA.json")])}


def rehearsal_path(FA, dev, card):
    """The accuracy rehearsal's runners (mmnas_tpu_torch/tools/rehearsal.py)
    on the small corpus device_rel_path made, with the stub GloVe cache
    (mmnas_tpu_torch/tools/make_glove_cache.py, run as a program) and its
    region features in packed stores (fp32: VQA's splits in one, VGD's in
    another): run_vqa and run_vgd (REHEARSAL_EPOCHS each) at full width
    (HSIZE 512, bf16 on fp32 masters, BS 64, arch/mcan.json: 6 SA in the
    encoder, 6 SA and 6 GA in the decoder, DROPOUT_R 0.1), then VQAEval on
    val and IoU@0.5 on val and testA. Each must reach REHEARSAL_MIN on val
    with its last epoch's loss under REHEARSAL_LOSS_DROP of its first, with
    exact launches: per train step a dropout forward and a backward per
    attention op, per eval batch a forward."""
    from mmnas_tpu_torch.genotype import load_genotype
    from mmnas_tpu_torch.tools import rehearsal as RH

    t0 = time.perf_counter()
    for task in ("vqa", "vgd"):
        subprocess.run([sys.executable, "-m", "mmnas_tpu_torch.tools.make_glove_cache",
                        "--task", task, "--data_root", REHEARSAL, "--stub"], check=True,
                       capture_output=True, text=True, cwd=HERE)
    RH.pack_splits(os.path.join(REHEARSAL, "vqa", "bua-r101-max100"),
                   ("train2014", "val2014", "test2015"), "float32")
    RH.pack_splits(os.path.join(REHEARSAL, "vgd"), ("bua-r101-fix100",), "float32")
    print(f"stub GloVe caches and packed stores in {time.perf_counter() - t0:.1f} s", flush=True)
    arch = os.path.join(HERE, "arch", "mcan.json")
    n_att, n_rsa = genotype_launches(load_genotype(arch))
    out = {}
    for task, (n_train, n_evals) in rehearsal_sizes().items():
        runner, metric = {"vqa": (RH.run_vqa, "value"), "vgd": (RH.run_vgd, "acc_iou0.5_val")}[task]
        zero_launches(FA)
        t = time.perf_counter()
        epochs = REHEARSAL_EPOCHS[task]
        result = runner(REHEARSAL, epochs, arch_path=arch, version=f"smoke_rehearsal_{task}",
                        device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        steps = epochs * math.ceil(n_train / BATCH)
        want = {"fused_attention_fwd": n_att * sum(math.ceil(n / BATCH) for n in n_evals),
                "fused_attention_fwd_dropout": n_att * steps,
                "fused_attention_bwd": n_att * steps, "fused_attention_bwd_rel": n_rsa * steps}
        launches = {k: FA.LAUNCHES[k] for k in want}
        losses = result["train_loss_per_example"]
        print(f"rehearsal {task}: {metric} {result[metric]}"
              + (f", test {result['acc_iou0.5_test']}" if task == "vgd" else "")
              + f" after {epochs} epochs of {n_train} items in {seconds:.1f} s "
              f"(train {result['train_wall_s']} s, {result['train_ex_per_s']} ex/s) on {card}; "
              f"loss per example {losses}; launches {launches}", flush=True)
        if launches != want:
            raise AssertionError(f"rehearsal {task}: launches {launches}, expected {want}")
        if not (result[metric] is not None and result[metric] >= REHEARSAL_MIN[task]
                and all(map(math.isfinite, losses))
                and losses[-1] < REHEARSAL_LOSS_DROP * losses[0]):
            raise AssertionError(f"rehearsal {task}: {metric} {result[metric]} (at least "
                                 f"{REHEARSAL_MIN[task]}), losses {losses}")
        out[task] = {metric: result[metric], "epochs": epochs, "seconds": seconds,
                     "launches": launches,
                     **{k: result[k] for k in ("train_loss_per_example", "train_wall_s",
                                               "train_ex_per_s")},
                     **({"acc_iou0.5_test": result["acc_iou0.5_test"]} if task == "vgd" else {})}
    return out


def launch_floor(PR, dev):
    """Device time of an empty kernel (csrc/probes.cu `mmnas_probe_empty`,
    one block of 32 threads), the least any launch takes on this card: by
    device_time_ms, and by CUDA events around CUDA-graph replays beside the
    two probe_wrblock kernels' (row 9, a 2x8x64 fp32 copy) by the same
    method."""
    import ctypes

    from mmnas_tpu_torch.csrc import build

    fn = build.load("probes").mmnas_probe_empty
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def call():
        if fn(torch.cuda.current_stream(dev).cuda_stream) != 0:
            raise RuntimeError("the empty kernel did not launch")

    ms, by = device_time_ms(call)
    wr_ = PR.wrblock_inputs().to(dev)
    out = {"empty_device_ms": ms, "empty_device_ms_by": by, "empty_graph_ms": graph_time_ms(call),
           **{f"wrblock_{v}_graph_ms": graph_time_ms(lambda v=v: PR.probe_wrblock(wr_, v))
              for v in ("a", "b")}}
    print("launch floor: an empty kernel " + ", ".join(f"{k} {fmt(v) if isinstance(v, float) else v}"
                                                      for k, v in out.items()), flush=True)
    return out


def cpu_reference(net, cfg):
    """(net, cfg) of the CPU's reference for the card's scores: under
    bf16 the net's parameters rounded to bf16 and computed on in fp32 (the
    same numbers the card's bf16 path starts from, evaluated with less
    rounding and without the CPU's slow bf16 products)."""
    if cfg.DTYPE != "bfloat16":
        return net, cfg
    net = net.to(torch.bfloat16).float()
    net.cfg = cfg = cfg.replace(DTYPE="float32")     # the net casts its inputs by its cfg
    return net, cfg


def cpu_corpus(dataset, cfg):
    """The corpus on the CPU for `cpu_reference`: stored at the card's
    compute dtype, computed on in fp32."""
    from mmnas_tpu_torch.engine import itm as ITM
    from mmnas_tpu_torch.models.net import compute_dtype

    corpus = ITM.corpus_to_device(dataset, torch.device("cpu"), compute_dtype(cfg))
    return {k: v.float() if v.is_floating_point() else v for k, v in corpus.items()}


def itm_mined_vs_cpu(engine, cfg, dataset, mined, name):
    """The epoch-0 negatives the card mined for the first ITM_MINE_CHECK
    images and captions (`mined`: both sweeps' negatives, the seconds, the
    scorer's tiles): the candidates drawn again from the mining's RNG stream
    are the pairs of each sweep's first tile; the negatives are the top
    NEG_HARDSIZE of the card's own scores of that tile; and against the
    CPU's scores of the same pairs under the same seeded initial net (see
    `cpu_reference`), with s_H the CPU's H-th best score and the band twice
    the card-vs-CPU score difference, they hold every candidate scored above
    s_H + band and none scored below s_H - band (the top H, equal away from
    ties). The difference itself is held to LOGIT_TOL."""
    from mmnas_tpu_torch.engine import itm as ITM

    n_caps, R, Hn = len(dataset), cfg.NEG_RANDSIZE, cfg.NEG_HARDSIZE
    n_imgs, group = n_caps // 5, max(1, cfg.NEG_BATCHSIZE)
    rng = np.random.RandomState(cfg.SEED * 97)
    cand = (ITM.draw_candidates(n_imgs, n_caps, True, 5, rng, R, group),
            ITM.draw_candidates(n_caps, n_imgs, False, 5, rng, R, group))
    tiles = mined[3]
    card, pairs = [], []
    # the caption sweep's ceil(n_imgs / group) tiles come first, then the image sweep's
    for direction, (tile, n) in enumerate(zip((tiles[0], tiles[math.ceil(n_imgs / group)]),
                                              ITM_MINE_CHECK)):
        rows = np.repeat(np.arange(n), R)
        want = ((rows, cand[0][:n].reshape(-1)) if direction == 0
                else (cand[1][:n].reshape(-1), rows))
        if not all(np.array_equal(np.asarray(a)[:n * R], w) for a, w in zip(tile[:2], want)):
            raise AssertionError(f"{name}: the mining's tile {direction} is not the candidates "
                                 "drawn again from its RNG stream")
        card.append(np.asarray(tile[2])[:n * R].reshape(n, R))
        pairs.append(want)
    net, rcfg = cpu_reference(engine(cfg, torch.device("cpu")).build_net(dataset), cfg)
    corpus = cpu_corpus(dataset, cfg)
    cpu = []
    with torch.inference_mode():
        encode, decode = ITM.pair_fns(net, rcfg)
        for (ii, cc), n in zip(pairs, ITM_MINE_CHECK):
            x, mask = encode(corpus["caps"][torch.from_numpy(np.unique(cc))])
            rel = np.searchsorted(np.unique(cc), cc)
            cpu.append(np.asarray(ITM.score_pairs(decode, corpus, {"x": x, "mask": mask}, ii,
                                                  rel)).reshape(n, R))
    diff = max(float(np.abs(a - b).max()) for a, b in zip(card, cpu))
    tol = LOGIT_TOL[cfg.DTYPE]
    exact = 0
    for direction, (s_card, s_cpu) in enumerate(zip(card, cpu)):
        for item in range(len(s_cpu)):
            ids, got = cand[direction][item], set(mined[direction][item].tolist())
            for row, band, whose in ((s_card[item], 0.0, "card's"),
                                     (s_cpu[item], 2 * diff, "CPU's")):
                s_h = np.sort(row)[::-1][Hn - 1]
                must, may = set(ids[row > s_h + band]), set(ids[row >= s_h - band])
                if not must <= got <= may:
                    raise AssertionError(f"{name}: item {item} of sweep {direction} mined {got}; "
                                         f"the {whose} top {Hn}: all of {must}, within {may}")
            exact += got == may            # nothing of the CPU's band left out: no tie
    print(f"{name}: mined negatives of {sum(ITM_MINE_CHECK)} items equal the CPU's top "
          f"{Hn} away from ties ({exact} with no tie); their scores card vs CPU max abs diff "
          f"{diff:.3e} (tol {tol:g})", flush=True)
    if not diff <= tol:
        raise AssertionError(f"{name}: mining scores card vs CPU differ by {diff}")
    return {"items": sum(ITM_MINE_CHECK), "no_tie": int(exact), "score_diff": diff}


def one_step_parity(engine, cfg0, dataset, small, keys, steps, n_rsa, label, dev="cuda"):
    """One train step at DROPOUT_R 0 from one seeded init: on the card with
    the kernels, on the card with the plain versions in their place, on the
    CPU. The loss card vs CPU within STEP_LOSS_TOL; the gradient leaf by
    leaf, kernels vs plain on the card, by the rule of STEP_LEAF_TOL."""
    import mmnas_tpu_torch.ops.attention as ATT
    from mmnas_tpu_torch.engine.vqa import batch_to_device
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    out = {}
    for name, d, attention in (("kernels", dev, None), ("plain", dev, plain_attention),
                               ("cpu", "cpu", None)):
        e = engine(cfg0, torch.device(d))
        net = e.build_net(dataset).to(d)                   # the init is drawn on the CPU
        params = dict(net.named_parameters())
        optim = build_net_optimizer(cfg0, steps)
        state = optim.init(params)
        b = batch_to_device(small, torch.device(d), keys)
        grads = {}
        hooks = [p.register_hook(lambda g, n=n: grads.__setitem__(n, g.detach().cpu().clone()))
                 for n, p in params.items()]
        saved = ATT.fused_attention
        ATT.fused_attention = attention or saved
        try:
            loss, _ = e.train_step(net, optim, state, params, b, torch.Generator(d))
        finally:
            ATT.fused_attention = saved
        for h in hooks:
            h.remove()
        out[name] = (float(loss), grads)
    (l_gpu, g_kernels), (_, g_plain), (l_cpu, _) = out["kernels"], out["plain"], out["cpu"]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    whole = math.sqrt(sum(float((g ** 2).sum()) for g in g_plain.values()))
    leaf = {n: (float((g_kernels[n] - g).norm()), float(g.norm())) for n, g in g_plain.items()}
    relation = [n for n in leaf if n.startswith("linear_y_rel.") or ".wr." in n]
    floor = {n: 0.0 if n in relation else STEP_LEAF_FLOOR * whole for n in leaf}
    over = {n: d for n, (d, ref) in leaf.items() if not d <= STEP_LEAF_TOL * ref + floor[n]}
    worst = max(leaf, key=lambda n: leaf[n][0] / max(leaf[n][1], floor[n]))
    rel_leaves = {n: (leaf[n][0], leaf[n][1]) for n in relation}
    print(f"{label} one step (fp32, DROPOUT_R 0, 16 examples): loss card {l_gpu:.6f} vs CPU "
          f"{l_cpu:.6f} (rel {loss_err:.2e}, tol {STEP_LOSS_TOL:g}); gradients, kernels vs plain "
          f"on the card, {len(leaf)} leaves: worst {worst} {leaf[worst][0]:.3e} of "
          f"{leaf[worst][1]:.3e} (whole-net norm {whole:.3e}); tol {STEP_LEAF_TOL:g} of the leaf "
          f"+ {STEP_LEAF_FLOOR:g} of the whole", flush=True)
    print("  the relation pass's leaves, no floor: " + "; ".join(
        f"{n} {d:.3e} of {ref:.3e} ({d / ref:.2e})" for n, (d, ref) in rel_leaves.items()),
        flush=True)
    if not loss_err <= STEP_LOSS_TOL:
        raise AssertionError(f"{label}: one train step's loss differs between the card and the "
                             f"CPU: {l_gpu} vs {l_cpu}")
    if len(relation) != 2 + 2 * n_rsa:
        raise AssertionError(f"{label}: expected the stem and {n_rsa} RSA ops' wr among the "
                             f"leaves, found {relation}")
    if over:
        raise AssertionError(f"{label}: kernel gradients differ from the plain versions' in {over}")
    return {"step_loss_card_vs_cpu": loss_err,
            "step_grad_kernels_vs_plain": {"worst_leaf": worst, "diff": leaf[worst][0],
                                           "norm": leaf[worst][1], "whole_norm": whole,
                                           "relation_leaves": rel_leaves}}


def plain_attention(q, k, v, mask=None, log_bias=None, *, rel=None, dropout_r=0.0,
                    generator=None):
    """The plain version in the kernels' place, at DROPOUT_R 0."""
    from mmnas_tpu_torch.ops.fused_attention import fused_attention_reference

    if dropout_r:
        raise ValueError("the plain stand-in runs without dropout")
    return fused_attention_reference(q, k, v, mask, log_bias, rel=rel)


def plain_attention_fp64(q, k, v, mask=None, log_bias=None, *, rel=None, dropout_r=0.0,
                         generator=None):
    """The plain version in fp64 (the RSA chain, scores, softmax, a.v), at
    DROPOUT_R 0."""
    from mmnas_tpu_torch.ops.primitives import mask_scores

    if dropout_r:
        raise ValueError("the plain stand-in runs without dropout")
    if rel is not None:
        raw, w1, b1, wr, br = (t.double() for t in rel)
        pre = torch.relu(torch.matmul(torch.relu(torch.matmul(raw, w1.t()) + b1), wr.t()) + br)
        log_bias = torch.log(torch.clamp(pre, min=1e-6)).permute(0, 3, 1, 2)
    scores = torch.matmul(q.double(), k.double().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if log_bias is not None:
        scores = scores + log_bias.double()
    att = torch.softmax(mask_scores(scores, mask), dim=-1)
    return torch.matmul(att, v.double()).to(q.dtype)


def profile_step(step):
    """Device time of one call of `step` (a train step, a scorer tile) by
    kind of kernel, from torch.profiler: the port's kernels, cuBLAS/CUTLASS
    products, everything else."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step()
        torch.cuda.synchronize()
    split = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for name, us in device_events(prof):
        name = name.lower()
        kind = ("port_kernels" if "fused_attention" in name else
                "gemm" if any(s in name for s in ("gemm", "cublas", "cutlass", "xmma", "sm90",
                                                  "nvjet"))
                else "other")
        split[kind] += us / 1e3 / 3
    if not any(split.values()):
        return "not measured (the profiler saw no device time)"
    return {k: round(v, 3) for k, v in split.items()}


DP = os.path.join(WORK, "dp")           # the data-parallel phase's checkpoints, logs, rank files
DP_TRAIN_STEPS = 5                      # fixed-net train steps a rank
DP_EVAL_BATCHES = 2                     # eval batches of the single process
DP_SEARCH_STEPS = 5                     # search weight steps a rank, an arch step after the 5th
DP_GRAD_TOL = 1e-5                      # the all-reduced gradient vs the mean of the shards', of
                                        # the largest entry


def dp_train_cfg(world, root):
    """arch/mmnas_vqa.json at full width, fp32, DROPOUT_R 0.1: one epoch of
    DP_TRAIN_STEPS steps of BATCH a rank, no per-epoch eval."""
    cfg = cfg_for("train", "float32", SYNTH_SIZE=DP_TRAIN_STEPS * BATCH * world, MAX_EPOCH=1,
                  VERSION="smoke_dp")
    return cfg.replace(EVAL_EVERY_EPOCH=False, CKPT_ROOT=os.path.join(root, "ckpts"),
                       LOG_ROOT=os.path.join(root, "log"))


def dp_search_cfg(world, root):
    """The search's fp32 leg (SearchCfg, HSIZE 256, BS 128 a rank, KPATH 1)
    for one epoch of DP_SEARCH_STEPS weight steps a rank, its arch step
    after the ALPHA_EVERY-th, the argmax path's eval."""
    size = DP_SEARCH_STEPS * SEARCH_B * world * 5 // 4
    return search_cfg("float32", SEARCH_B, 1).replace(
        SYNTH_SIZE=size, VERSION="smoke_dp_search", CKPT_ROOT=os.path.join(root, "ckpts"),
        LOG_ROOT=os.path.join(root, "log"), ARCH_ROOT=os.path.join(root, "arch"))


def dp_runs(dev, world, root, eval_ckpt):
    """This rank's fixed-net train, the eval of `eval_ckpt`, and the search,
    through the engines' loops, in whatever group the process is in; then
    the train step on one resident batch and the gradients' all-reduce
    alone, timed (in a group also the step with the all-reduce left out, in
    turns: with, without, without, with, twice). Every all_reduce_grads call is
    recorded: its tensors, the buckets they make and the all_reduce calls
    it issued; the first call's gradients (after the reduce) are kept."""
    from mmnas_tpu_torch.data.loader import Loader
    from mmnas_tpu_torch.engine.search import SearchExecution
    from mmnas_tpu_torch.engine.vqa import Execution, batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.ops import fused_attention as FA
    from mmnas_tpu_torch.parallel import mesh as pmesh
    from mmnas_tpu_torch.train.checkpoint import ckpt_path
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    reduce, calls, first = pmesh.all_reduce_grads, [], []

    def recorded(grads, **kw):
        before = pmesh.COUNTS["all_reduce"]
        reduce(grads, **kw)
        calls.append({"tensors": len(grads), "buckets": len(pmesh.buckets(grads)),
                      "all_reduce": pmesh.COUNTS["all_reduce"] - before})
        if not first:
            first.append([g.detach().clone() for g in grads])

    out = {"rank": pmesh.rank(), "world": pmesh.world_size()}
    pmesh.all_reduce_grads = recorded
    try:
        cfg = dp_train_cfg(world, root)
        zero_launches(FA)
        trained = Execution(cfg, dev).run()
        torch.cuda.synchronize()
        out["train"] = {"losses": trained.step_losses, "launches": dict(FA.LAUNCHES),
                        "calls": list(calls), "ckpt": ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, 1)}
        out["first_grads"] = first[0]
        out["train"]["log"] = None
        if pmesh.is_writer():
            with open(os.path.join(cfg.LOG_ROOT, f"log_{cfg.VERSION}.txt")) as f:
                out["train"]["log"] = f.read()
        zero_launches(FA)
        evaluated = Execution(cfg_for("val", "float32", SYNTH_SIZE=DP_EVAL_BATCHES * BATCH,
                                      CKPT_PATH=eval_ckpt or out["train"]["ckpt"]), dev).run()
        out["eval"] = {"preds": evaluated.preds, "launches": dict(FA.LAUNCHES)}
        calls.clear()
        scfg = dp_search_cfg(world, root)
        zero_launches(FA)
        searched = SearchExecution(scfg, dev).run()
        torch.cuda.synchronize()
        out["search"] = {"losses": searched.step_losses, "launches": dict(FA.LAUNCHES),
                         "calls": list(calls), "paths": searched.paths}
    finally:
        pmesh.all_reduce_grads = reduce
    if world == 1:         # the final state, for the bit-for-bit comparison
        out["params"] = {n: p.detach().clone() for n, p in trained.net.named_parameters()}
        out["search"]["params"] = {n: p.detach().clone()
                                   for n, p in searched.net.named_parameters()}
    out["search"]["alpha"] = {c: a.detach().clone() for c, a in searched.alpha.items()}
    del searched

    # the train step alone on this rank's first batch, and its all-reduce
    exe = Execution(cfg, dev)
    dataset = exe.build_dataset("train")
    batch = batch_to_device(next(iter(exe.make_loader(dataset, BATCH))), dev,
                            INPUT_KEYS + exe.TARGET_KEYS)
    net, gen = trained.net, torch.Generator(dev).manual_seed(3)
    params = dict(net.named_parameters())
    optim = build_net_optimizer(cfg, DP_TRAIN_STEPS)
    state = optim.init(params)
    def step_ms():
        return cuda_time_ms(lambda: exe.train_step(net, optim, state, params, batch, gen),
                            iters=10, warmup=2)

    if pmesh.is_initialized():
        times = {True: [], False: []}
        for reducing in (True, False, False, True) * 2:
            pmesh.all_reduce_grads = reduce if reducing else (lambda grads, **kw: None)
            try:
                times[reducing].append(step_ms())
            finally:
                pmesh.all_reduce_grads = reduce
        out["step_ms"], out["step_ms_no_reduce"] = (sum(times[k]) / 4 for k in (True, False))
    else:
        out["step_ms"] = step_ms()
    grads = [torch.randn_like(p) for p in params.values()]
    out["all_reduce_ms"] = cuda_time_ms(lambda: pmesh.all_reduce_grads(grads), iters=10,
                                        warmup=2)
    out["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    del trained, net, params, state, grads
    torch.cuda.empty_cache()
    return out


def dp_member(dev, world, eval_ckpt):
    """A rank of the data-parallel phase on several cards: dp_runs, its
    record saved for the parent (the gradients on rank 0 alone)."""
    from mmnas_tpu_torch.parallel import mesh as pmesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dp_runs(dev, world, os.path.join(DP, f"world{world}"), eval_ckpt)
    if not pmesh.is_writer():
        del out["first_grads"]
    torch.save(out, os.path.join(DP, f"world{world}", f"rank{pmesh.rank()}.pt"))


def shard_grads(dev, world, rank):
    """One process, no group: the gradients of the train step on the batch
    rank `rank` of `world` takes first, with the dropout seed that rank
    draws (step_seed), from the seeded init every rank starts from."""
    from mmnas_tpu_torch.data.loader import Loader
    from mmnas_tpu_torch.data.sampler import SubsetShardSampler
    from mmnas_tpu_torch.engine.vqa import Execution, batch_to_device, step_seed
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.parallel import mesh as pmesh
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    cfg = dp_train_cfg(world, os.path.join(DP, "shards"))
    exe = Execution(cfg, dev)
    dataset = exe.build_dataset("train")
    loader = Loader(dataset, BATCH, num_workers=cfg.NUM_WORKERS, sampler=SubsetShardSampler(
        len(dataset), num_replicas=world, rank=rank, shuffle=True))
    batch = batch_to_device(next(iter(loader)), dev, INPUT_KEYS + exe.TARGET_KEYS)
    net = exe.build_net(dataset).to(dev)
    params = dict(net.named_parameters())
    optim = build_net_optimizer(cfg, DP_TRAIN_STEPS)
    seen, reduce = [], pmesh.all_reduce_grads
    pmesh.all_reduce_grads = lambda grads, **kw: seen.append([g.detach().clone() for g in grads])
    try:
        exe.train_step(net, optim, optim.init(params), params, batch,
                       torch.Generator(dev).manual_seed(step_seed(cfg.SEED, 0, rank)))
    finally:
        pmesh.all_reduce_grads = reduce
    return seen[0]


def dp_check_calls(name, calls, steps, kinds):
    """Every all_reduce_grads call of a run issued one all_reduce per bucket
    of its tensors; there were `steps` of them, of `kinds` tensor counts."""
    bad = [c for c in calls if c["all_reduce"] != c["buckets"]]
    if len(calls) != steps or bad or not all(c["tensors"] in kinds for c in calls):
        raise AssertionError(f"{name}: all-reduce calls {calls}")


def data_parallel_path(FA, devices, card):
    """The fixed-net train (5 steps), its eval (2 batches) and the search
    (5 weight steps, an arch step) single-process, then in a process group
    over NCCL of the cards the machine has (parallel/mesh.py), through the
    engines' own loops. World 1 (in this process): losses, parameters and
    alpha bit for bit the single process's, the same kernel launches, one
    all_reduce per bucket per step. Two or more cards (spawned, one process
    a card, world = the cards): the first step's all-reduced gradient is the
    mean of the ranks' shards' gradients computed here, finite losses, the
    log written by rank 0 alone, every rank the same search paths and
    alpha, the eval of the single process's checkpoint in dataset order
    equal to the single process's. Step ms with and without the group, and
    the all-reduce's share of the step. `devices`: every card of the
    machine. Returns (its record, the single process's results that
    tensor_parallel_path holds the model ranks to)."""
    from mmnas_tpu_torch.parallel import mesh as pmesh

    cards, card0 = len(devices), devices[0]
    alone = dp_runs(card0, 1, os.path.join(DP, "alone"), None)
    if (len(alone["train"]["calls"]) != DP_TRAIN_STEPS
            or any(c["all_reduce"] for c in alone["train"]["calls"] + alone["search"]["calls"])):
        raise AssertionError(f"single process: all-reduce calls {alone['train']['calls']}")
    ckpt = alone["train"]["ckpt"]

    pmesh.init(0, 1, card0, f"tcp://localhost:{pmesh.free_port()}")
    try:
        backend = "nccl" if card0.type == "cuda" else "gloo"
        if pmesh.world_size() != 1 or torch.distributed.get_backend() != backend:
            raise AssertionError(f"the world-1 group is not {backend}'s")
        group = dp_runs(card0, 1, os.path.join(DP, "world1"), ckpt)
    finally:
        pmesh.shutdown()
    name = f"data parallel, world 1 over {backend}"
    train_calls, search_calls = group["train"]["calls"], group["search"]["calls"]
    dp_check_calls(f"{name} train", train_calls, DP_TRAIN_STEPS, {len(group["params"])})
    # 5 weight steps (the sampled path's leaves) and 1 arch step (alpha's 2)
    dp_check_calls(f"{name} search", search_calls, DP_SEARCH_STEPS + 1, range(1, 10**6))
    if [c["tensors"] == 2 for c in search_calls] != [False] * DP_SEARCH_STEPS + [True]:
        raise AssertionError(f"{name}: search all-reduce calls {search_calls}")
    for key in ("train", "eval", "search"):
        if group[key]["launches"] != alone[key]["launches"]:
            raise AssertionError(f"{name} {key}: launches {group[key]['launches']}, the single "
                                 f"process's {alone[key]['launches']}")
    unused = [n for n in FA.LAUNCHES
              if not sum(group[k]["launches"][n] for k in ("train", "eval", "search"))]
    if unused:
        raise AssertionError(f"{name}: no launch of {unused}")
    same = {
        "train losses": group["train"]["losses"] == alone["train"]["losses"],
        "train params": all(torch.equal(group["params"][n], p)
                            for n, p in alone["params"].items()),
        "eval preds": np.array_equal(group["eval"]["preds"], alone["eval"]["preds"]),
        "search losses": group["search"]["losses"] == alone["search"]["losses"],
        "search paths": repr(group["search"]["paths"]) == repr(alone["search"]["paths"]),
        "search params": all(torch.equal(group["search"]["params"][n], p)
                             for n, p in alone["search"]["params"].items()),
        "alpha": all(torch.equal(group["search"]["alpha"][c], a)
                     for c, a in alone["search"]["alpha"].items())}
    losses = alone["train"]["losses"] + alone["search"]["losses"]
    if not all(same.values()) or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{name}: not the single process's bit for bit: {same}")
    share = group["all_reduce_ms"] / group["step_ms"]
    print(f"{name}: train losses {[round(x, 3) for x in group['train']['losses']]}, search "
          f"losses {[round(x, 3) for x in group['search']['losses']]}; bit for bit the single "
          f"process's ({', '.join(same)}); launches {group['train']['launches']} (train), "
          f"{group['search']['launches']} (search); all-reduces per step {train_calls[0]} "
          f"(train), {search_calls[0]} (weight), {search_calls[-1]} (arch)", flush=True)
    print(f"data parallel train step fp32 BS {BATCH}: {alone['step_ms']:.3f} ms without a group, "
          f"{group['step_ms']:.3f} ms in the world-1 {backend} group "
          f"({group['step_ms_no_reduce']:.3f} ms there with the all-reduce left out, in turns); "
          f"the all-reduce of its {group['grad_bytes'] / 2**20:.1f} MiB of gradients "
          f"{group['all_reduce_ms']:.3f} ms, {100 * share:.1f}% of the step, on {card}",
          flush=True)
    out = {"world1": {"same": same, "launches": {k: group[k]["launches"] for k in
                                                  ("train", "eval", "search")},
                      "all_reduce_calls": {"train_step": train_calls[0],
                                           "weight_step": search_calls[0],
                                           "arch_step": search_calls[-1]},
                      "step_ms_alone": alone["step_ms"], "step_ms_group": group["step_ms"],
                      "step_ms_group_no_reduce": group["step_ms_no_reduce"],
                      "all_reduce_ms": group["all_reduce_ms"], "all_reduce_share": share,
                      "grad_bytes": group["grad_bytes"]},
           "cards": cards}
    del group
    alone_preds = alone["eval"]["preds"]
    reference = {"train_losses": alone["train"]["losses"], "eval_preds": alone_preds,
                 "search_losses": alone["search"]["losses"], "paths": alone["search"]["paths"],
                 "launches": {k: alone[k]["launches"] for k in ("train", "eval", "search")},
                 "train_ckpt": ckpt, "search_ckpt": os.path.join(
                     DP, "alone", "ckpts", "smoke_dp_search_epoch1.pkl"),
                 "step_ms": alone["step_ms"], "first_grads": alone["first_grads"]}
    del alone
    torch.cuda.empty_cache()
    if cards >= 2:
        out[f"world{cards}"] = dp_several(devices, ckpt, alone_preds, card)
    return out, reference


def dp_several(devices, ckpt, alone_preds, card):
    """data_parallel_path on every card of `devices`, one spawned process a
    card."""
    from mmnas_tpu_torch.parallel import mesh as pmesh

    world, dev = len(devices), devices[0]
    name = f"data parallel, world {world}"
    os.makedirs(os.path.join(DP, f"world{world}"), exist_ok=True)
    t0 = time.perf_counter()
    pmesh.spawn(dp_member, (world, ckpt), devices)
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(DP, f"world{world}", f"rank{r}.pt"), weights_only=False,
                        map_location=dev) for r in range(world)]
    shards = [shard_grads(dev, world, r) for r in range(world)]
    want = [sum(parts) / world for parts in zip(*shards)]
    got = [g.to(dev) for g in ranks[0]["first_grads"]]
    largest = max(float(w.abs().max()) for w in want)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want)) / largest
    shards_differ = any(not torch.equal(a, b) for a, b in zip(shards[0], shards[1]))
    losses = [x for r in ranks for x in r["train"]["losses"] + r["search"]["losses"]]
    log = ranks[0]["train"]["log"]
    checks = {
        "first gradient is the mean of the shards'": err <= DP_GRAD_TOL and shards_differ,
        "finite losses": all(map(math.isfinite, losses)) and len(
            ranks[0]["train"]["losses"]) == DP_TRAIN_STEPS,
        "logged by rank 0 alone": log is not None and log.count("epoch = 1 ") == 1,
        "every rank the same losses": all(r["train"]["losses"] == ranks[0]["train"]["losses"]
                                          for r in ranks),
        "every rank the same search paths and alpha": all(
            repr(r["search"]["paths"]) == repr(ranks[0]["search"]["paths"])
            and all(torch.equal(r["search"]["alpha"][c].cpu(), a.cpu())
                    for c, a in ranks[0]["search"]["alpha"].items()) for r in ranks),
        "eval preds in dataset order": all(np.array_equal(r["eval"]["preds"], alone_preds)
                                           for r in ranks)}
    for r in ranks:
        dp_check_calls(f"{name} rank {r['rank']} train", r["train"]["calls"], DP_TRAIN_STEPS,
                       {len(got)})
    print(f"{name}: {seconds:.1f} s; train losses {[round(x, 3) for x in ranks[0]['train']['losses']]}"
          f"; first gradient {err:.2e} of the largest from the mean of the {world} shards'; "
          f"step {ranks[0]['step_ms']:.3f} ms ({ranks[0]['step_ms_no_reduce']:.3f} ms with the "
          f"all-reduce left out), the all-reduce {ranks[0]['all_reduce_ms']:.3f} ms on {card}; "
          f"{checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{name}: {checks}")
    return {"seconds": seconds, "checks": checks, "grad_err": err,
            "step_ms": ranks[0]["step_ms"], "step_ms_no_reduce": ranks[0]["step_ms_no_reduce"],
            "all_reduce_ms": ranks[0]["all_reduce_ms"],
            "all_reduce_share": ranks[0]["all_reduce_ms"] / ranks[0]["step_ms"]}


TP = os.path.join(WORK, "tp")           # the tensor-parallel phase's checkpoints, logs, rank files
TP_MODEL_AXIS = 2
# The model ranks against the single process, fp32: the same function with
# the partial outputs and gradients added over the model group in another
# order. The losses and alpha to TP_TOL of the largest.
TP_TOL = 1e-5
# The first step's gradient (at data 2 or more, against the mean of the data
# shards' from one process), over the whole gradient's norm: as the one
# step's card-vs-plain check (GRAD_TOL's fp32 1e-3). Not entry by entry: a
# ReLU whose input rounds to the other side of 0 under the other order moves
# that unit's whole column (a feed_forward fc's, in a CPU run at full width,
# B 2: 10% of that column's largest entry) and the RSA chain near its 1e-6
# clamp moves rows (PRE_TOL).
TP_GRAD_NORM_TOL = 1e-3
# After the 5 train (or weight) steps: the Adam moments m and v over their
# norms, bounded by what the gradients' bound gives them (m is a weighted
# sum of the steps' gradients, v of their squares: 1e-3 and 2e-3); every
# parameter entry within the two runs' Adam steps of each other (2 x the
# steps' rates: Adam turns a gradient that differs in sign, at a kink or in
# rounding noise, into moves of up to lr either way).
TP_MOMENT_TOL = {"m": 1e-3, "v": 2e-3, "alpha_m": 1e-3}
# alpha's entries whose difference is one flipped sign of a last gradient
# within the noise of 0 (`tp_alpha_errs`), of the 96 entries (12 nodes x 2
# ops, 18 x 4): at most this many
TP_ALPHA_FLIPS = 2
# ...but the moments of the RSA chain's weights (Wr, br, the stem's W1, b1)
# are not held: their gradients run through dpre = ds / pre, which fp32
# rounding of pre near the 1e-6 clamp moves by whole rows (PR 7,
# tools/rsa_conditioning.py), and two runs whose parameters part by Adam's
# steps part there first (measured on the card: m of a Wr 20% of its
# largest entry apart after 5 weight steps, while the first step's whole
# gradient was 1.1e-5 apart). They are reported beside the rest.
TP_CLAMP_LEAVES = ("/wr/", "linear_y_rel/")
# the model ranks' attention shapes (4 of the fixed net's 8 heads, at head0
# 0 and 4): the RSA chain at (100,100) and the plain SA / GA shapes
TP_CASES = [(100, 100, "mask+rel"), (100, 14, "mask"), (14, 14, "mask")]


def tp_kernel_cases(FA, dev):
    """Rows 1-3b at a model rank's shapes: B 64, heads [head0, head0 + 4)
    of 8 (head0 0 and 4), fp32 and bf16. The dropout forward at head0 draws
    the whole call's keep mask for its heads bit for bit; the output, the
    backward and, with the RSA chain on the block of Wr's rows and br, the
    relation pass agree with their plain versions (KERNEL_TOL, GRAD_TOL);
    the blocks' dWr rows and their dW1, db1 summed equal the whole call's
    (GRAD_TOL)."""
    g = torch.Generator().manual_seed(11)
    half, rows = H // TP_MODEL_AXIS, []
    for dt in DTYPES:
        for Lq, Lk, kind in TP_CASES:
            args, m, b_, r_ = to_dev(dev, dt, *make_case(g, Lq, Lk, kind, B, H, D))
            do = torch.randn(B, H, Lq, D, generator=g).to(dev, dt)
            _, keep_all, pre_all = FA.attention_fwd(*args, m, b_, r_, dropout_r=RATE, seed=4321,
                                                    want_pre=r_ is not None)
            whole_rel = None if r_ is None else FA.attention_bwd(
                *args, m, b_, r_, keep_all, RATE, do, pre=pre_all)[4]
            name = f"B{B} H{half} of {H} D{D} {str(dt).replace('torch.', ''):8s} ({Lq:3d},{Lk:3d}) {kind:8s}"
            blocks, row = [], {"dtype": str(dt).replace("torch.", ""), "B": B, "H": half,
                               "heads_total": H, "Lq": Lq, "Lk": Lk, "operands": kind}
            for head0 in (0, half):
                sl = slice(head0, head0 + half)
                part = [a[:, sl].contiguous() for a in args]
                rb = None if r_ is None else (*r_[:3], r_[3][sl].contiguous(),
                                              r_[4][sl].contiguous())
                dop = do[:, sl].contiguous()
                out, keep, pre = FA.attention_fwd(*part, m, b_, rb, dropout_r=RATE, seed=4321,
                                                  want_pre=rb is not None, head0=head0,
                                                  heads_total=H)
                torch.cuda.synchronize()
                if not torch.equal(keep, keep_all[:, sl]):
                    raise AssertionError(f"{name} head0 {head0}: the keep mask is not the whole "
                                         "call's")
                if dt == torch.float32 and rb is None and not torch.equal(
                        keep.cpu().bool(), FA.keep_mask_reference(4321, B, half, Lq, Lk, RATE,
                                                                  head0, H)):
                    raise AssertionError(f"{name} head0 {head0}: keep bits differ from Philox")
                if rb is not None:
                    check_pre(pre, rb, name)
                ref = FA.fused_attention_reference(*[a.float() for a in part], m,
                                                   None if rb is None else log_pre(pre),
                                                   keep=keep, dropout_r=RATE)
                fwd_err = (out.float() - ref).abs().max().item()
                dq, dk, dv, _, drel = FA.attention_bwd(*part, m, b_, rb, keep, RATE, dop, pre=pre)
                leaves = [a.float().requires_grad_() for a in part]
                pl = None if rb is None else pre.detach().requires_grad_()
                plain = FA.fused_attention_reference(*leaves, m,
                                                     None if rb is None else log_pre(pl),
                                                     keep=keep, dropout_r=RATE)
                want = list(torch.autograd.grad(plain, leaves + ([pl] if pl is not None else []),
                                                dop.float()))
                labels = ["dq", "dk", "dv"]
                got = [dq, dk, dv]
                if rb is not None:
                    want += FA.relation_bwd_reference(*rb, want.pop())[1:]
                    labels += ["dW1", "db1", "dWr", "dbr"]
                    got += list(drel[1:])
                    blocks.append(drel)
                errs = {lab: rel_err(x, w) for lab, x, w in zip(labels, got, want)}
                tol, grad_tol = KERNEL_TOL[(dt, rb is not None)], GRAD_TOL[(dt, rb is not None)]
                bad = [lab for lab, e in errs.items() if not (math.isfinite(e) and e <= grad_tol)]
                if not (math.isfinite(fwd_err) and fwd_err <= tol) or bad:
                    raise AssertionError(f"{name} head0 {head0}: forward err {fwd_err} (tol {tol}),"
                                         f" gradients {errs} (tol {grad_tol})")
                row[f"head0_{head0}"] = {"fwd_err": fwd_err, "grad_rel_err": errs}
            if r_ is not None:        # the blocks make up the whole call's relation gradients
                summed = {"dW1": (blocks[0][1] + blocks[1][1], whole_rel[1]),
                          "db1": (blocks[0][2] + blocks[1][2], whole_rel[2]),
                          "dWr": (torch.cat([blocks[0][3], blocks[1][3]]), whole_rel[3]),
                          "dbr": (torch.cat([blocks[0][4], blocks[1][4]]), whole_rel[4])}
                row["blocks_vs_whole"] = {k: rel_err(a, b) for k, (a, b) in summed.items()}
                if not all(e <= GRAD_TOL[(dt, True)] for e in row["blocks_vs_whole"].values()):
                    raise AssertionError(f"{name}: the head blocks' relation gradients are not "
                                         f"the whole call's: {row['blocks_vs_whole']}")
            # the model rank's calls at head0 4, timed
            part = [a[:, half:].contiguous() for a in args]
            rb = None if r_ is None else (*r_[:3], r_[3][half:].contiguous(),
                                          r_[4][half:].contiguous())
            _, keep, pre = FA.attention_fwd(*part, m, b_, rb, dropout_r=RATE, seed=7,
                                            want_pre=rb is not None, head0=half, heads_total=H)
            dop = do[:, half:].contiguous()
            row["fwd_ms"] = cuda_time_ms(lambda: FA.attention_fwd(
                *part, m, b_, rb, RATE, 7, want_pre=rb is not None, head0=half, heads_total=H))
            row["bwd_ms"] = cuda_time_ms(lambda: FA.attention_bwd(*part, m, b_, rb, keep, RATE,
                                                                  dop, pre=pre))
            print(f"tensor parallel kernels {name}: keep masks the whole call's at head0 0 and "
                  f"{half}; errs {row['head0_0']} / {row[f'head0_{half}']}; "
                  f"{row.get('blocks_vs_whole', '')}; fwd {row['fwd_ms']:.4f} ms, bwd "
                  f"{row['bwd_ms']:.4f} ms", flush=True)
            rows.append(row)
    return rows


def tp_member(dev, root, eval_ckpt):
    """A rank of the tensor-parallel phase: data_parallel_path's train,
    eval and search through the engines' loops at model axis 2, then the
    train step on one resident batch, timed with the model group's
    collectives and with them left out (in turns), and its collectives
    counted. Saves its record for the parent."""
    import torch.distributed as dist

    from mmnas_tpu_torch.engine.search import SearchExecution
    from mmnas_tpu_torch.engine.vqa import Execution, batch_to_device
    from mmnas_tpu_torch.models.net import INPUT_KEYS
    from mmnas_tpu_torch.ops import fused_attention as FA
    from mmnas_tpu_torch.parallel import mesh as pmesh
    from mmnas_tpu_torch.train.checkpoint import ckpt_path
    from mmnas_tpu_torch.train.optimizer import build_net_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data, axis = pmesh.data_axis_size(), pmesh.model_axis_size()
    out = {"rank": pmesh.rank(), "backend": dist.get_backend(),
           "grid": (pmesh.data_rank(), pmesh.model_rank(), data, axis)}
    reduce, first = pmesh.all_reduce_grads, []

    def recorded(grads, **kw):
        reduce(grads, **kw)
        if not first:
            first.append([g.detach().cpu().clone() for g in grads])

    pmesh.all_reduce_grads = recorded
    try:
        cfg = dp_train_cfg(data, root)
        zero_launches(FA)
        pmesh.zero_counts()
        trained = Execution(cfg, dev).run()
        torch.cuda.synchronize()
    finally:
        pmesh.all_reduce_grads = reduce
    out["train"] = {"losses": trained.step_losses, "launches": dict(FA.LAUNCHES),
                    "model_counts": dict(pmesh.MODEL_COUNTS),
                    "ckpt": ckpt_path(cfg.CKPT_ROOT, cfg.VERSION, 1)}
    out["first_grads"] = first[0]
    zero_launches(FA)
    evaluated = Execution(cfg_for("val", "float32", SYNTH_SIZE=DP_EVAL_BATCHES * BATCH,
                                  CKPT_PATH=eval_ckpt), dev).run()
    out["eval"] = {"preds": evaluated.preds, "launches": dict(FA.LAUNCHES)}
    scfg = dp_search_cfg(data, root)
    zero_launches(FA)
    searched = SearchExecution(scfg, dev).run()
    torch.cuda.synchronize()
    out["search"] = {"losses": searched.step_losses, "launches": dict(FA.LAUNCHES),
                     "paths": searched.paths, "ckpt": ckpt_path(scfg.CKPT_ROOT, scfg.VERSION, 1)}
    del searched

    # the train step alone, with and without the model group's collectives
    exe = Execution(cfg, dev)
    batch = batch_to_device(next(iter(exe.make_loader(exe.build_dataset("train"), BATCH))), dev,
                            INPUT_KEYS + exe.TARGET_KEYS)
    net, gen = trained.net, torch.Generator(dev).manual_seed(3)
    params = dict(net.named_parameters())
    optim = build_net_optimizer(cfg, DP_TRAIN_STEPS)
    state = optim.init(params)

    def step():
        exe.train_step(net, optim, state, params, batch, gen)

    before = dict(pmesh.MODEL_COUNTS)
    step()
    out["model_collectives_per_step"] = {k: pmesh.MODEL_COUNTS[k] - before[k] for k in before}
    real = (pmesh.model_all_reduce, pmesh.model_all_gather)
    times = {True: [], False: []}
    for on in (True, False, False, True):
        if not on:        # every rank leaves them out alike; the results are not used
            pmesh.model_all_reduce = lambda t: t
            pmesh.model_all_gather = lambda t: [t] * axis
        try:
            times[on].append(cuda_time_ms(step, iters=2, warmup=1))
        finally:
            pmesh.model_all_reduce, pmesh.model_all_gather = real
    out["step_ms"], out["step_ms_no_model_collectives"] = (sum(times[k]) / 2 for k in (True, False))
    del trained, net, params, state
    torch.cuda.empty_cache()
    torch.save(out, os.path.join(root, f"rank{pmesh.rank()}.pt"))


def tp_first_grad_err(dev, ranks, data, alone_first):
    """Data shard 0's first all-reduced gradient, its model ranks' shards
    joined along their split dims, against the single process's first
    gradient (`alone_first`, at data 1) or the mean of the data shards'
    that one process computes (shard_grads): the difference's norm over
    the reference's."""
    from mmnas_tpu_torch.engine.vqa import Execution
    from mmnas_tpu_torch.parallel.sharding import split_dim

    cfg = dp_train_cfg(data, os.path.join(TP, "shards"))
    exe = Execution(cfg, dev)
    names = [(n, p.dim()) for n, p in exe.build_net(exe.build_dataset("train")).named_parameters()]
    shards = [r["first_grads"] for r in ranks if r["grid"][0] == 0]
    if data == 1:
        want = [g.cpu() for g in alone_first]
    else:
        parts = [shard_grads(dev, data, r) for r in range(data)]
        want = [(sum(p[i] for p in parts) / data).cpu() for i in range(len(names))]
    diff = ref = 0.0
    for i, (n, ndim) in enumerate(names):
        d = split_dim(n, ndim)
        got = shards[0][i] if d is None else torch.cat([s[i] for s in shards], dim=d)
        diff += float(((got - want[i]) ** 2).sum())
        ref += float((want[i] ** 2).sum())
    return math.sqrt(diff / ref)


def tp_tree_errs(got, want, lr_steps):
    """The checkpoint `got` against `want`: per tree (the parameters, the
    Adam moments m and v, and alpha with its moment m where present) the
    largest difference over the largest entry ("max"), the difference's
    norm over the tree's ("norm") and the leaf of the largest difference;
    the parameters' largest difference beside the Adam steps' bound
    2 x lr_steps."""
    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}{k}/")
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}{i}/")
        else:
            yield prefix[:-1], np.asarray(tree, np.float64)

    trees = {"params": (got["state_dict"], want["state_dict"]),
             "m": (got["net_optim"]["m"], want["net_optim"]["m"]),
             "v": (got["net_optim"]["v"], want["net_optim"]["v"])}
    if "alpha" in got:
        trees.update(alpha=(got["alpha"], want["alpha"]),
                     alpha_m=(got["alpha_optim"]["m"], want["alpha_optim"]["m"]))
    def diffs(pairs):
        worst = max((float(np.abs(x - y).max()) if x.size else 0.0, path)
                    for (path, x), (_, y) in pairs)
        return {"max": worst[0] / max(float(np.abs(y).max()) for _, (_, y) in pairs),
                "norm": math.sqrt(sum(float(((x - y) ** 2).sum()) for (_, x), (_, y) in pairs)
                                  / sum(float((y ** 2).sum()) for _, (_, y) in pairs)),
                "worst_leaf": worst[1], "worst_abs": worst[0]}

    errs = {}
    for key, (a, b) in trees.items():
        pairs = list(zip(leaves(a), leaves(b)))
        if [p for (p, _), (q, _) in pairs if p != q] or not pairs:
            raise AssertionError(f"tensor parallel: the checkpoint's {key} tree differs")
        clamp = [pq for pq in pairs if any(s in pq[0][0] + "/" for s in TP_CLAMP_LEAVES)]
        if key in ("m", "v") and clamp:        # the moments held apart from the chain's
            errs[f"{key}_rsa_chain"] = diffs(clamp)
            pairs = [pq for pq in pairs if pq not in clamp]
        errs[key] = diffs(pairs)
    errs["params"]["adam_bound"] = 2 * lr_steps
    return errs


def tp_alpha_errs(got, want):
    """Alpha of the search checkpoint `got` against `want`, entry by entry
    to TP_TOL of alpha's largest entry, except where the difference is one
    flipped gradient sign: alpha's Adam (betas (0, 0.999)) moves an entry by
    about its rate whatever its gradient's size, so a last gradient that
    lies within the noise of 0 in both runs (TP_MOMENT_TOL["alpha_m"] of
    the largest entry of `want`'s moment m, which is that gradient at beta1
    0) can take opposite signs in the two runs and move the entry either
    way. Such an entry is excused when the two runs' moments m have
    opposite signs, both lie within the noise, and the difference less the
    two runs' own last Adam moves (each from its checkpoint's m, v and step
    count) is within TP_TOL: the runs agreed before that step. At most
    TP_ALPHA_FLIPS entries may be excused."""
    cfg = search_cfg("float32", SEARCH_B, 1)
    if cfg.ALPHA_OPT_BETAS[0] != 0.0 or cfg.ALPHA_WEIGHT_DECAY:
        raise AssertionError("alpha's moment m is its last gradient only at beta1 0, no decay")
    b2, lr = np.float32(cfg.ALPHA_OPT_BETAS[1]), np.float32(cfg.ALPHA_LR_BASE)
    state = {k: {c: {key: np.asarray(ck["alpha_optim"][key][c], np.float32) for key in ("m", "v")}
                 for c in ck["alpha"]} for k, ck in (("got", got), ("want", want))}
    steps = {k: int(ck["alpha_optim"]["step"]) for k, ck in (("got", got), ("want", want))}
    if steps["got"] != steps["want"]:
        raise AssertionError(f"tensor parallel: alpha's step counts {steps}")
    noise = TP_MOMENT_TOL["alpha_m"] * max(float(np.abs(s["m"]).max())
                                           for s in state["want"].values())
    scale = max(float(np.abs(a).max()) for a in want["alpha"].values())
    bc2 = np.float32(1) - b2 ** np.float32(steps["want"])

    def last_move(s):
        """The last arch step's Adam move, in fp32 as WarmupAdam.step takes
        it (bias correction of m 1 at beta1 0, eps 1e-8)."""
        return (s["m"] / (np.sqrt(s["v"] / bc2) + np.float32(1e-8)) * -lr).astype(np.float64)

    worst, flips = 0.0, []
    for c, a in want["alpha"].items():
        diff = np.asarray(got["alpha"][c], np.float64) - np.asarray(a, np.float64)
        g, w = state["got"][c], state["want"][c]
        residual = np.abs(diff - (last_move(g) - last_move(w)))
        flipped = ((np.sign(g["m"]) * np.sign(w["m"]) < 0) & (np.abs(g["m"]) <= noise)
                   & (np.abs(w["m"]) <= noise) & (residual <= TP_TOL * scale))
        for i in zip(*np.nonzero(flipped)):
            flips.append({"entry": f"{c}{list(map(int, i))}", "diff": float(diff[i]),
                          "m_got": float(g["m"][i]), "m_want": float(w["m"][i]),
                          "residual": float(residual[i])})
        worst = max(worst, float(np.abs(diff)[~flipped].max(initial=0.0)) / scale)
    return {"max": worst, "flips": flips, "gradient_noise": noise, "arch_steps": steps["want"]}


def tensor_parallel_path(FA, devices, card, alone):
    """The kernels at a model rank's shapes (tp_kernel_cases), then
    data_parallel_path's work at model axis 2 (parallel/sharding.py), one
    spawned process a rank: on one card the two model ranks share it in a
    gloo group (NCCL refuses two ranks on a card); on two or more, data
    cards // 2 x model 2 over NCCL. At data 1 the losses, the gathered
    parameters and Adam moments (the epoch checkpoints) and alpha equal the
    single process's (`alone`, data_parallel_path's): the losses and alpha
    to TP_TOL (an alpha entry whose last gradient flipped its sign within
    the noise of 0 excused, `tp_alpha_errs`), the first gradient to
    TP_GRAD_NORM_TOL, the moments to
    TP_MOMENT_TOL, every parameter within the runs' Adam steps; at data 2
    or more the first all-reduced gradient is the mean of the data shards'
    (TP_GRAD_NORM_TOL). Always: every rank the single process's
    kernel launches (at 4 heads), search paths and eval predictions (of
    its checkpoint), data shard 0's losses on each of its model ranks; the
    train step with and without the model group's collectives."""
    from mmnas_tpu_torch.parallel import mesh as pmesh
    from mmnas_tpu_torch.train.checkpoint import load_checkpoint

    kernels = tp_kernel_cases(FA, devices[0])
    if len(devices) >= 2:
        ranks_on = devices[:len(devices) - len(devices) % 2]
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    else:
        ranks_on, backend = [devices[0]] * TP_MODEL_AXIS, "gloo"
    world, data = len(ranks_on), len(ranks_on) // TP_MODEL_AXIS
    name = f"tensor parallel, data {data} x model {TP_MODEL_AXIS} over {backend}"
    root = os.path.join(TP, f"world{world}")
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    pmesh.spawn(tp_member, (root, alone["train_ckpt"]), ranks_on, model_axis=TP_MODEL_AXIS,
                backend=backend)
    seconds = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(world)]
    shard0 = [r for r in ranks if r["grid"][0] == 0]
    checks = {
        f"the group is {backend}'s": all(r["backend"] == backend for r in ranks),
        "the grid is the JAX mesh's": all(r["grid"] == (r["rank"] // TP_MODEL_AXIS,
                                                        r["rank"] % TP_MODEL_AXIS, data,
                                                        TP_MODEL_AXIS) for r in ranks),
        # the eval's batches split over the data shards
        "every rank the single process's launches": all(
            r[k]["launches"] == alone["launches"][k] for r in ranks for k in ("train", "search"))
        and all(r["eval"]["launches"] == {n: c // data for n, c in alone["launches"]["eval"].items()}
                for r in ranks),
        "every rank the single process's search paths": all(
            repr(r["search"]["paths"]) == repr(alone["paths"]) for r in ranks),
        "every rank the single process's eval predictions": all(
            np.array_equal(r["eval"]["preds"], alone["eval_preds"]) for r in ranks),
        "a data shard's model ranks the same losses": all(
            r["train"]["losses"] == shard0[0]["train"]["losses"]
            and r["search"]["losses"] == shard0[0]["search"]["losses"] for r in shard0),
        "finite losses": all(math.isfinite(x) for r in ranks
                             for x in r["train"]["losses"] + r["search"]["losses"]),
        "the model group's collectives ran": all(
            r["model_collectives_per_step"]["all_reduce"] > 0 for r in ranks)}
    errs = {}
    if data == 1:
        lr = cfg_for("train", "float32").NET_LR_BASE / 4      # the first warmup rate
        search_lr = search_cfg("float32", SEARCH_B, 1).NET_LR_BASE / 4
        for key, want in (("train", alone["train_losses"]), ("search", alone["search_losses"])):
            got = shard0[0][key]["losses"]
            errs[f"{key}_losses"] = max(abs(a - b) for a, b in zip(got, want)) / max(
                abs(b) for b in want) if len(got) == len(want) else math.inf
        errs["train_ckpt"] = tp_tree_errs(load_checkpoint(shard0[0]["train"]["ckpt"]),
                                          load_checkpoint(alone["train_ckpt"]),
                                          DP_TRAIN_STEPS * lr)
        errs["search_ckpt"] = tp_tree_errs(load_checkpoint(shard0[0]["search"]["ckpt"]),
                                           load_checkpoint(alone["search_ckpt"]),
                                           DP_SEARCH_STEPS * search_lr)
        ckpts = (errs["train_ckpt"], errs["search_ckpt"])
        errs["alpha"] = tp_alpha_errs(load_checkpoint(shard0[0]["search"]["ckpt"]),
                                      load_checkpoint(alone["search_ckpt"]))
        checks["losses and alpha the single process's"] = (
            errs["train_losses"] <= TP_TOL and errs["search_losses"] <= TP_TOL
            and errs["alpha"]["max"] <= TP_TOL
            and len(errs["alpha"]["flips"]) <= TP_ALPHA_FLIPS)
        checks["moments the single process's"] = all(
            e[k]["norm"] <= tol for e in ckpts for k, tol in TP_MOMENT_TOL.items() if k in e)
        checks["parameters within the runs' Adam steps"] = all(
            e["params"]["worst_abs"] <= e["params"]["adam_bound"] for e in ckpts)
    errs["first_grad_norm"] = tp_first_grad_err(devices[0], ranks, data, alone["first_grads"])
    checks["the first gradient " + ("the single process's" if data == 1 else
                                    "the mean of the data shards'")] = (
        errs["first_grad_norm"] <= TP_GRAD_NORM_TOL)
    r0 = ranks[0]
    print(f"{name}: {seconds:.1f} s; train losses {[round(x, 3) for x in r0['train']['losses']]}; "
          f"errors against the single process {errs}; model-group collectives a train step "
          f"{r0['model_collectives_per_step']}; train step fp32 BS {BATCH} "
          f"{r0['step_ms']:.3f} ms a rank ({r0['step_ms_no_model_collectives']:.3f} ms with the "
          f"model group's collectives left out, in turns; one process {alone['step_ms']:.3f} "
          f"ms) on {card}; {checks}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"{name}: {checks}")
    return {"backend": backend, "data": data, "model": TP_MODEL_AXIS, "seconds": seconds,
            "checks": checks, "errors": errs, "kernels": kernels,
            "launches_per_rank": {k: r0[k]["launches"] for k in ("train", "eval", "search")},
            "model_collectives_per_train_step": r0["model_collectives_per_step"],
            "model_collectives_train_epoch": r0["train"]["model_counts"],
            "step_ms": r0["step_ms"], "step_ms_no_model_collectives":
                r0["step_ms_no_model_collectives"], "step_ms_one_process": alone["step_ms"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    mode = sys.argv[1] if len(sys.argv) > 1 else None
    if mode not in (None, "--step-times", "--parallel") or len(sys.argv) > 2:
        print("usage: chip_smoke.py [--step-times | --parallel]", file=sys.stderr)
        return 2
    from mmnas_tpu_torch.csrc import build
    from mmnas_tpu_torch.ops import fused_attention as FA
    from mmnas_tpu_torch.tools import probes as PR

    os.makedirs(WORK, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, "
          f"cudnn {torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:      # one nvcc per source, in parallel
        built = list(pool.map(build.build, SOURCES))
    print(f"built {[os.path.relpath(lib, HERE) for lib, _ in built]} in "
          f"{time.perf_counter() - t0:.2f} s")
    # the options' parts alone (their build may be cached: no ptxas report)
    if mode == "--step-times":
        print(json.dumps({"step_times": step_times_path(torch.device("cuda"), card)}))
        return 0
    if mode == "--parallel":
        cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        data_parallel, alone = data_parallel_path(FA, cards, card)
        print(json.dumps({"data_parallel": data_parallel,
                          "tensor_parallel": tensor_parallel_path(FA, cards, card, alone)}))
        return 0
    sass = sass_report(built)
    for fn, r in sorted(sass.items()):
        print(f"  {fn}: {r['registers']} registers, {r['spill_bytes']} bytes spilled, "
              f"{r['hmma']} HMMA")
    no_mma = [fn for fn, r in sass.items()
              if "bfloat16" in fn and "bwd_rel" not in fn and r["hmma"] == 0]
    if not sass or no_mma:
        raise AssertionError(f"bf16 attention kernels without tensor-core instructions: "
                             f"{no_mma or 'no kernel found in the SASS'}")
    bias_regs = bias_kernel_report(built)
    rel_sass = relation_kernel_report(sass)
    spilled = [fn for fn, (_, heads, _, r) in rel_sass.items() if heads <= 8 and r["spill_bytes"]]
    if len(rel_sass) != 16 or spilled:
        raise AssertionError(f"relation pass: {len(rel_sass)} of 16 instantiations found; spills at "
                             f"4 or 8 heads in {spilled}")

    dev = torch.device("cuda")
    t_phase = time.perf_counter()

    def phase(label):
        nonlocal t_phase
        now = time.perf_counter()
        print(f"-- {label} done in {now - t_phase:.1f} s", flush=True)
        t_phase = now

    probes = probe_path(PR, FA, dev, bias_regs)
    phase("probes")
    fwd_cases = kernel_cases(FA, dev)
    train_cases = train_kernel_cases(FA, dev)
    phase("kernels at the fixed net's shapes")
    search_fwd = kernel_cases(FA, dev, SEARCH_B, SEARCH_H, SEARCH_CASES)
    search_train = train_kernel_cases(FA, dev, SEARCH_B, SEARCH_H, SEARCH_CASES)
    search_fwd += kernel_cases(FA, dev, SEARCH_K8_B, SEARCH_H, SEARCH_CASES, (torch.bfloat16,))
    search_train += train_kernel_cases(FA, dev, SEARCH_K8_B, SEARCH_H, SEARCH_CASES,
                                       (torch.bfloat16,))
    phase("kernels at the search's shapes")
    evals = eval_path(FA, dev, card)
    phase("eval")
    export = export_path(FA, dev, card)
    phase("export: the eval forward through torch.export, saved and reloaded")
    train = train_path(FA, dev, card, "vqa")
    phase("train")
    states = {}       # the per-step legs' final states, for scan_steps_path
    search = search_path(FA, dev, card, "vqa", SEARCH_LEGS, states=states)
    phase("search")
    programs = weight_programs_path(FA, dev, card, search, states)
    phase("weight programs: --DENSE_WEIGHT, --UNIFIED_WEIGHT, --HYBRID_WEIGHT")
    remat = remat_path(FA, dev, card)
    phase("REMAT: the 'full' arch and --DENSE_WEIGHT weight steps with and without")
    scan = scan_steps_path(FA, dev, card, states)
    del states
    keys = key_cases(FA, dev)
    phase("SCAN_STEPS: chunks replayed from CUDA graphs, and eager; the dropout key by pointer")
    vgd_fwd = kernel_cases(FA, dev, B, H, VGD_CASES)
    vgd_train_cases = train_kernel_cases(FA, dev, B, H, VGD_CASES)
    vgd_search_fwd = kernel_cases(FA, dev, SEARCH_B, SEARCH_H, VGD_CASES)
    vgd_search_train = train_kernel_cases(FA, dev, SEARCH_B, SEARCH_H, VGD_CASES)
    phase("kernels at the VGD net's and the VGD search's shapes")
    vgd = {"eval": vgd_eval_path(FA, dev, card)}
    phase("VGD eval")
    vgd["train"] = train_path(FA, dev, card, "vgd")
    phase("VGD train")
    vgd["search"] = search_path(FA, dev, card, "vgd", VGD_SEARCH_LEGS)
    phase("VGD search")
    itm_fwd = kernel_cases(FA, dev, B, H, ITM_CASES)
    itm_train_cases = train_kernel_cases(FA, dev, B, H, ITM_CASES)
    itm_fwd += kernel_cases(FA, dev, ITM_SCORER_B, H, ITM_CASES)
    itm_fwd += kernel_cases(FA, dev, SEARCH_B, SEARCH_H, ITM_CASES)
    itm_train_cases += train_kernel_cases(FA, dev, SEARCH_B, SEARCH_H, ITM_CASES)
    for c in (cfg_for("train", "float32", "itm"),
              search_cfg(*ITM_SEARCH_LEGS[0], task="itm")):       # the mining's tiles
        itm_fwd += kernel_cases(FA, dev, c.NEG_BATCHSIZE * c.NEG_RANDSIZE, c.HSIZE // D,
                                ITM_DECODER_CASES)
    phase("kernels at the ITM net's, scorer's, mining's and search's shapes")
    itm = itm_path(FA, dev, card)
    phase("ITM mining, train and eval")
    itm["search"] = search_path(FA, dev, card, "itm", ITM_SEARCH_LEGS)
    phase("ITM search")
    new_fwd, new_train = new_shape_cases(FA, dev)
    phase("kernels at the new shapes (D 256, 32 RSA heads, no pad mask)")
    all_ops = all_ops_path(FA, dev, card)
    phase("the all-ops net: eval, train step")
    device_rel = device_rel_path(FA, dev, card)
    phase("VQA eval on the packed corpus with DEVICE_REL and SHIP_INT8")
    rehearsal = rehearsal_path(FA, dev, card)
    phase("rehearsal: run_vqa and run_vgd on the small corpus")
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    data_parallel, alone = data_parallel_path(FA, cards, card)
    phase("data parallel: train, eval and search in a process group over NCCL")
    tensor_parallel = tensor_parallel_path(FA, cards, card, alone)
    phase("tensor parallel: the model ranks' kernels, train, eval and search at model axis 2")
    floor = launch_floor(PR, dev)

    def pick(rows, Lq, Lk, kind):
        return next(r for r in rows if r["dtype"] == "float32" and (r["Lq"], r["Lk"],
                                                                   r["operands"]) == (Lq, Lk, kind))

    def at_search_shape(rows, kind, keys):
        r = pick(rows, 100, 100, kind)
        return {"shape": f"B{SEARCH_B} H{SEARCH_H} (100,100) {kind} fp32",
                **{k: r[v] for k, v in keys.items()}}

    def at_shapes(rows, keys, rel=None):
        """A path's attention shapes, fp32 and bf16 (with rel True or False,
        only the cases with or without the RSA chain)."""
        return [{"shape": f"B{r['B']} H{r['H']} D{r['D']} ({r['Lq']},{r['Lk']}) {r['operands']} "
                          f"{r['dtype']}",
                 **{k: r[v] for k, v in keys.items()}} for r in rows
                if rel is None or ("rel" in r["operands"]) == rel]

    fwd, drop = pick(fwd_cases, 100, 100, "mask"), pick(train_cases, 100, 100, "mask")
    rel = pick(train_cases, 100, 100, "mask+rel")
    fp32_train = [r for r in train_cases if r["dtype"] == "float32"]
    def with_by(keys):
        """The key map with each device reading's `_by` beside it."""
        return {**keys, **{f"{k}_by": f"{v}_by" for k, v in keys.items() if "device" in k}}

    fwd_keys = with_by({"ms": "ms", "plain_ms": "plain_ms", "bound_ms": "bound_ms",
                        "bound_by": "bound_by", "library_ms": "library_ms",
                        "device_ms": "device_ms", "library_device_ms": "library_device_ms"})
    drop_keys = with_by({"ms": "fwd_ms", "plain_ms": "plain_fwd_ms", "bound_ms": "fwd_bound_ms",
                         "bound_by": "fwd_bound_by", "library_ms": "sdpa_fwd_ms",
                         "device_ms": "fwd_device_ms", "library_device_ms": "sdpa_fwd_device_ms"})
    bwd_keys = with_by({"ms": "bwd_ms", "plain_ms": "plain_bwd_ms", "bound_ms": "bwd_bound_ms",
                        "bound_by": "bwd_bound_by", "library_ms": "sdpa_bwd_ms",
                        "device_ms": "bwd_device_ms", "library_device_ms": "sdpa_bwd_device_ms"})
    rel_keys = with_by({"ms": "rel_ms", "plain_ms": "rel_plain_ms", "bound_ms": "rel_bound_ms",
                        "bound_by": "rel_bound_by", "device_ms": "rel_device_ms"})
    rows = [
        {"name": "fused_attention_fwd", "max_abs_err": max(
            c["max_abs_err"] for c in fwd_cases if c["dtype"] == "float32"),
         "ms": fwd["ms"], "plain_ms": fwd["plain_ms"], "bound_ms": fwd["bound_ms"],
         "bound_by": fwd["bound_by"], "library_ms": fwd["library_ms"],
         **{k: fwd[v] for k, v in fwd_keys.items() if "device" in k},
         "shape": "B64 H8 (100,100) mask fp32",
         "search_shape": at_search_shape(search_fwd, "mask", fwd_keys),
         "vgd_shapes": at_shapes(vgd_fwd, fwd_keys),
         "vgd_search_shapes": at_shapes(vgd_search_fwd, fwd_keys),
         "itm_shapes": at_shapes(itm_fwd, fwd_keys),
         "new_shapes": at_shapes(new_fwd, fwd_keys),
         "unified_shapes": at_shapes(programs["kernels_fwd"], fwd_keys)},
        {"name": "fused_attention_fwd_dropout",
         "max_abs_err": max(c["fwd_err"] for c in fp32_train),
         "ms": drop["fwd_ms"], "plain_ms": drop["plain_fwd_ms"], "bound_ms": drop["fwd_bound_ms"],
         "bound_by": drop["fwd_bound_by"], "library_ms": drop["sdpa_fwd_ms"],
         **{k: drop[v] for k, v in drop_keys.items() if "device" in k},
         "shape": "B64 H8 (100,100) mask fp32 r 0.1",
         "search_shape": at_search_shape(search_train, "mask", drop_keys),
         "vgd_shapes": at_shapes(vgd_train_cases, drop_keys),
         "vgd_search_shapes": at_shapes(vgd_search_train, drop_keys),
         "itm_shapes": at_shapes(itm_train_cases, drop_keys),
         "new_shapes": at_shapes(new_train, drop_keys),
         "unified_shapes": at_shapes(programs["kernels_train"], drop_keys)},
        {"name": "fused_attention_bwd", "max_abs_err": max(c["grad_abs_err"] for c in fp32_train),
         "ms": drop["bwd_ms"], "plain_ms": drop["plain_bwd_ms"], "bound_ms": drop["bwd_bound_ms"],
         "bound_by": drop["bwd_bound_by"], "library_ms": drop["sdpa_bwd_ms"],
         **{k: drop[v] for k, v in bwd_keys.items() if "device" in k},
         "shape": "B64 H8 (100,100) mask fp32 r 0.1",
         "search_shape": at_search_shape(search_train, "mask", bwd_keys),
         "vgd_shapes": at_shapes(vgd_train_cases, bwd_keys),
         "vgd_search_shapes": at_shapes(vgd_search_train, bwd_keys),
         "itm_shapes": at_shapes(itm_train_cases, bwd_keys),
         "new_shapes": at_shapes(new_train, bwd_keys),
         "unified_shapes": at_shapes(programs["kernels_train"], bwd_keys)},
        {"name": "fused_attention_bwd_rel", "max_abs_err": rel["rel_abs_err"],
         "ms": rel["rel_ms"], "plain_ms": rel["rel_plain_ms"], "bound_ms": rel["rel_bound_ms"],
         "bound_by": rel["rel_bound_by"], "library_ms": None,
         **{k: rel[v] for k, v in rel_keys.items() if "device" in k}, "library_device_ms": None,
         "shape": "B64 H8 (100,100) Rr4 R64 fp32",
         "search_shape": at_search_shape(search_train, "mask+rel", rel_keys),
         "itm_shapes": at_shapes(itm_train_cases, rel_keys, rel=True),
         "new_shapes": at_shapes(new_train, rel_keys, rel=True)},
    ]
    # the attention kernels' launches on this slice's main path, REMAT's
    # steps (both ways) and the SCAN_STEPS legs (a graph's launches:
    # captured x replays + warm-up); each path's own counts beside them
    main_path = Counter(scan["main_path_launches"])
    for step in remat.values():
        for way in ("without", "with"):
            main_path.update(step[way]["launches"])
    if not all(main_path[k] for k in FA.LAUNCHES):
        raise AssertionError(f"REMAT and SCAN_STEPS: a kernel of the path never ran: "
                             f"{dict(main_path)}")
    for row in rows:
        fwd_only = row["name"] == "fused_attention_fwd"
        row["launches"] = main_path[row["name"]]
        row["launches_by_path"] = {
            **{f"remat_{kind}_{way}": step[way]["launches"][row["name"]]
               for kind, step in remat.items() for way in ("without", "with")},
            **{f"scan_steps_{k}": leg["launches"][row["name"]]
               for k, leg in scan["legs"].items()},
            **{f"weight_programs_{k}": leg["launches"][row["name"]]
               for k, leg in programs["legs"].items()},
            "all_ops_fp32": all_ops["main_path_launches"][row["name"]],
            "all_ops_eval_bf16": all_ops["eval_bfloat16"]["launches"][row["name"]],
            "all_ops_train_bf16": all_ops["train_bfloat16"]["launches"][row["name"]],
            "device_rel_int8_eval": device_rel["device_rel_int8"]["launches"] if fwd_only else 0,
            **{f"rehearsal_{task}": leg["launches"][row["name"]]
               for task, leg in rehearsal.items()},
            "itm_fixed_fp32": itm["legs"]["float32"]["launches"][row["name"]],
            "eval_fp32": evals["float32"]["launches"] if fwd_only else 0,
            "export_reloaded_fp32": export["static"]["calls"][BATCH]["launches"] if fwd_only else 0,
            **{f"train_{dt}": leg["launches"][row["name"]] for dt, leg in train["legs"].items()},
            **{f"search_{leg}": v["launches"][row["name"]] for leg, v in search.items()},
            "vgd_eval_fp32": vgd["eval"]["float32"]["launches"] if fwd_only else 0,
            **{f"vgd_train_{dt}": leg["launches"][row["name"]]
               for dt, leg in vgd["train"]["legs"].items()},
            "vgd_search_fp32": vgd["search"]["float32_bs128_k1"]["launches"][row["name"]],
            **{f"itm_train_{dt}": leg["launches"][row["name"]] for dt, leg in itm["legs"].items()},
            "itm_search_fp32": itm["search"]["float32_bs128_k1"]["launches"][row["name"]],
            **{f"data_parallel_world1_{k}": launches[row["name"]]
               for k, launches in data_parallel["world1"]["launches"].items()},
            **{f"tensor_parallel_model_rank_{k}": launches[row["name"]]
               for k, launches in tensor_parallel["launches_per_rank"].items()}}
    rows += [{"name": name, **row} for name, row in probes["rows"].items()]
    for row in rows:          # row 9 beside the launch floor
        if row["name"].startswith("probe_wrblock"):
            row["launch_floor"] = floor
    for row in rows:
        source, replaces = KERNELS[row["name"]]
        row.update(route="cuda", source=source, replaces=replaces,
                   x_library=None if row["library_ms"] is None else row["ms"] / row["library_ms"],
                   x_bound=row["ms"] / row["bound_ms"])
    # every case's numbers, too long for the result line, go to a file
    details = os.path.join(WORK, "kernel_cases.json")
    with open(details, "w") as f:
        json.dump({"fwd": fwd_cases, "train": train_cases, "search_fwd": search_fwd,
                   "search_train": search_train, "vgd_fwd": vgd_fwd, "vgd_train": vgd_train_cases,
                   "vgd_search_fwd": vgd_search_fwd, "vgd_search_train": vgd_search_train,
                   "itm_fwd": itm_fwd, "itm_train": itm_train_cases, "new_fwd": new_fwd,
                   "new_train": new_train, "unified_fwd": programs["kernels_fwd"],
                   "unified_train": programs["kernels_train"], "key_by_pointer": keys}, f)
    print(f"kernel cases: {os.path.relpath(details, HERE)}")
    print(json.dumps({"kernels": rows, "probes": {k: v for k, v in probes.items() if k != "rows"},
                      "eval": evals, "export": export, "train": train, "search": search,
                      "weight_programs": {k: v for k, v in programs.items()
                                          if not k.startswith("kernels_")},
                      "remat": remat, "scan_steps": scan,
                      "key_by_pointer": {"cases": len(keys),
                                         "fwd_err": max(r["fwd_err"] for r in keys),
                                         "grad_err": max(r["grad_err"] for r in keys)},
                      "vgd": vgd, "itm": itm,
                      "all_ops": all_ops, "device_rel": device_rel, "rehearsal": rehearsal,
                      "data_parallel": data_parallel, "tensor_parallel": tensor_parallel,
                      "launch_floor": floor}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
