#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout on a host with one CUDA card:

    python3 chip_smoke.py

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``
(K1 decode attention, K2 flash attention, K3 similarity top-k, K4 RG-LRU
scan, K5 RWKV-6 scan), holds each against its plain PyTorch version on the
card, serves one mixed batch (SCORE, COMPLETE, CLASSIFY, EMBED) with
proxy-8b at full width (32 layers, d_model 4096, vocab 128256, bf16,
random weights from a seed), checks that the served path launched each
kernel the expected number of times and that its results are well formed,
holds what goes through the kernels (every decode step's logits,
CLASSIFY's label logprobs, EMBED's vectors) to the same computed through
the plain attention, then drives the semantic index over the same engine
(CortexClient -> RequestPipeline -> Scheduler -> EMBED ->
SemanticIndexManager -> IvfFlatIndex -> the similarity top-k kernel) and
holds its searches to a plain-path manager over the same store.  Then it
builds oracle-70b at full width (its depth cut to 20 of 80 layers) beside
proxy-8b and runs five AISQL queries through ``AisqlEngine.sql`` over the
cascade pair and the index (AI_FILTER with cascades, AI_CLASSIFY with
GROUP BY, AI_COMPLETE with LIMIT, a semantic join rewritten to
classification, ORDER BY AI_SIMILARITY ... LIMIT), with K1, K2 and K3 in
the loop, and again through their plain versions, gating on the tables,
the meters and the rows of both runs.  It serves the first three queries
again over HTTP (``AisqlHttpServer`` -> ``ServingEngine`` with 4 workers
and three tenants), one at a time and then streamed at once, holds their
rows to the in-process run, asks NL2SQL one question (a 422 after its
attempts: random weights write no valid SQL), and checks the error
paths, the tenants' billing, the traces and the retry counters.  Then it
serves the same mix with
rwkv6-1.6b (24 RWKV-6 blocks, d_model 2048, every
wkv scan through K5) and recurrentgemma-9b (38 RG-LRU and local-attention
layers, d_model 4096, vocab 256000: RG-LRU scans through K4, the
sliding-window attention through K2 and K1 at head dim 256), both at full
width and depth on the engine's static path, with the same gates against
their plain paths (every scan and attention through its plain version).
Then the zoo phase serves the same mix with qwen3-32b (qk-norm),
command-r-35b (LayerNorm, parallel blocks, tied 256000-row embedding),
minitron-8b, phi3.5-moe-42b-a6.6b (16 experts, top-2; 24 of its 32
layers) and qwen2-moe-a2.7b (60 experts padded to 64, top-4, a fused
shared expert), each alone on the card at full width on the continuous
batcher, with the same gates; for the two mixtures of experts it counts
the tokens whose experts differ between the kernel and plain paths and
excuses a gap only where such a flip lies within a stated margin of the
plain router's decision; the zoo phase ends with stablelm-12b (LayerNorm,
parallel blocks, K1 and K2 at head dim 160).  Then whisper-base (an
encoder-decoder over audio frames: K2 without the causal mask for the
encoder and the cross-attention, a decode step's one query included) and
qwen2-vl-7b (16 patches before the text, M-RoPE; its SCORE and CLASSIFY
raise as the JAX engine's do, and the script checks that they do) are
served at full width and depth on the static path, with the same gates.
The dry-run phase follows the mesh phase: a few cells run both on meta
through the dry-run and for real on a 1x1 NCCL mesh, held to equal
counts and to the card's peak memory; ``launch/dryrun.py`` runs over a
subset of the production-mesh cells on the host (no card) after the
last timed phase, so it takes no host time from one.  Then the training
phase: ``launch/train.py`` trains
proxy-8b at full width (4 of its 32 layers) for a few steps with
checkpoints, the last
checkpoint is held to the trained state bit for bit, and a second run
resumes from it; then one ``loss_fn`` backward of proxy-8b, of
recurrentgemma-9b (one period and its tail, two microbatches), of
rwkv6-1.6b and of whisper-base goes through K2, K4 and K5 (their
autograd Functions; K4's backward is K4 run in reverse) and through the
plain versions, with gates on the launch counts, on every gradient leaf
and on the loss falling over a few train steps.  Last it times each
kernel beside its plain version, its bound and, where one exists, one
PyTorch library call.  The last line is a JSON object with
``"ok": true``; any failed check exits non-zero without it.  It needs no
network and imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA data sheet
# dense, per type; "tf32": the tensor cores' TF32 product rate (K3)
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
TOL = {"bfloat16": 5e-2, "float32": 2e-4}  # the tolerances of the CPU tests
# K2 without the causal mask at whisper-base's shapes (1500 keys), bf16.
# On N(0, 1) inputs an output element has std ~0.04, so TOL's 5e-2 would
# pass a kernel that dropped the ragged 28-key tail tile (1500 = 23 * 64 +
# 28; ~0.02 off): these are held to max|out-plain| <= CROSS_TOL, five
# times the largest reading (0.000977 and 0.00195 on the H100, PERF.md
# section 6).  The served inputs give outputs of order one (max|err| read
# 0.0039 and 0.0078, one bf16 step), so there the gate is relative:
# ||out-plain|| / ||plain|| <= CROSS_REL_TOL, a few times what rounding P
# and the output to bf16 gives (~0.003)
CROSS_TOL = 1e-2
CROSS_REL_TOL = 1e-2
# kernel-served vs plain-served limits at full width (bf16), a few times
# the readings on the H100 (PERF.md, section 6): decode-step logits
# (relative L2 per row), SCORE's prefill logits (the same, static path
# only), CLASSIFY label logprobs (nats), EMBED cosine (lower limit).  The
# zoo's: qwen3-32b read 0.0207 / 0.0284 / 0.999965, command-r-35b 0.0184
# / 0.0371 / 0.999974, minitron-8b 0.017 / 0.0121 / 0.999975, and the MoE
# models 0.0146 (phi3.5) and 0.0202 (qwen2) on decode rows without a
# router flip (the rest are excused by flips, ROUTER_MARGIN_TOL)
SERVE_TOL = {
    "proxy-8b": {"decode_logits_rel": 0.05, "classify_logprob": 0.05,
                 "embed_cosine": 0.9995},
    "qwen3-32b": {"decode_logits_rel": 0.05, "classify_logprob": 0.1,
                  "embed_cosine": 0.9995},
    "command-r-35b": {"decode_logits_rel": 0.05, "classify_logprob": 0.1,
                      "embed_cosine": 0.9995},
    "minitron-8b": {"decode_logits_rel": 0.05, "classify_logprob": 0.05,
                    "embed_cosine": 0.9995},
    "phi3.5-moe-42b-a6.6b": {"decode_logits_rel": 0.05,
                             "classify_logprob": 0.05,
                             "embed_cosine": 0.9995},
    "qwen2-moe-a2.7b": {"decode_logits_rel": 0.05, "classify_logprob": 0.05,
                        "embed_cosine": 0.9995},
    "rwkv6-1.6b": {"decode_logits_rel": 0.05, "score_logits_rel": 0.1,
                   "classify_logprob": 0.05, "embed_cosine": 0.9995},
    "recurrentgemma-9b": {"decode_logits_rel": 0.08,
                          "score_logits_rel": 0.08,
                          "classify_logprob": 0.05, "embed_cosine": 0.9995},
    # the last three of the zoo, stated before their first run on the
    # card at about two to three times the dense zoo's readings above:
    # stablelm-12b (40 layers, LayerNorm, parallel blocks, K1 and K2 at hd
    # 160) on the continuous batcher as command-r-35b; whisper-base (6
    # encoder and 6 decoder layers, every attention through K2 or K1) and
    # qwen2-vl-7b (28 layers, 16 patches before the text, M-RoPE) on the
    # static path, whose SCORE gate holds every prefill's logits.
    # qwen2-vl serves no CLASSIFY (it raises, as in the JAX package)
    "stablelm-12b": {"decode_logits_rel": 0.05, "classify_logprob": 0.1,
                     "embed_cosine": 0.9995},
    "whisper-base": {"decode_logits_rel": 0.05, "score_logits_rel": 0.05,
                     "classify_logprob": 0.05, "embed_cosine": 0.9995},
    "qwen2-vl-7b": {"decode_logits_rel": 0.05, "score_logits_rel": 0.05,
                    "embed_cosine": 0.9995},
}
# AISQL phase, kernel path vs plain path (PERF.md, section 6): a cascade
# row may be kept by one path only if a plain SCORE of it lies within
# AISQL_SCORE_TOL of the threshold it was held to, and SCOREs may differ
# by that much.  SCORE runs the continuous batcher's chunked prefill,
# through K2's chunked entry on the kernel path (bf16 q.k and p.v, the
# qk-norm's sums in another order) and its plain version on the other:
# the card read SCOREs up to 0.0241 apart over 381 prompts and flips
# within plain margins of 0.016, so the band is about twice that.  A
# CLASSIFY label may differ only where the plain path's logprob margin to
# the decision is within AISQL_LOGPROB_TOL, a few times the largest
# kernel-vs-plain label logprob difference the card read (0.0306 nats)
AISQL_SCORE_TOL = 0.05
AISQL_LOGPROB_TOL = 0.1
# the top logits kept of each token a COMPLETE picks on oracle-70b
TOPS = 8
# HTTP phase (PERF.md, section 6): what the engines computed for the
# queries served over HTTP, one at a time and then three at once from
# three tenants, against the in-process kernel run and each other:
# SCOREs within HTTP_SCORE_TOL, CLASSIFY label logprobs within
# HTTP_LOGPROB_TOL (nats), each COMPLETE step's top logit within
# HTTP_LOGIT_TOL; a row may differ only where the reference's margin to
# the decision lies within the same band.  The card read no difference
# (384 SCOREs, 256 label logprobs, 512 COMPLETE steps in each
# comparison): the shared pipeline dispatches each session's requests
# apart, so every engine call gets the in-process run's batch, and the
# kernels give the same bits for the same batch.  So the bands are 0
HTTP_SCORE_TOL = 0.0
HTTP_LOGPROB_TOL = 0.0
HTTP_LOGIT_TOL = 0.0
# K2's chunked entry (the batcher's prefill step of each attention layer)
# at the benchmark cell's shapes, qwen3-32b (B 8, T 32, 64 q / 8 kv
# heads, hd 128, qk-norm) over nb blocks of 32 slots, and proxy-8b's and
# stablelm-12b's (hd 160) heads without a norm: (what, H, KV, hd, norm,
# nb).  Held to the plain version within CHUNK_REL_TOL, rel. L2 over the
# output: both round the output to bf16 (2^-9 relative) and p to bf16
# before p v; the kernel's qk-norm sums squares in another order, which
# can move a bf16 q or k by one unit in the last place
CHUNK_SHAPES = ([("qwen3-32b", 64, 8, 128, True, nb) for nb in (1, 8, 64)]
                + [("proxy-8b", 32, 8, 128, False, 8),
                   ("stablelm-12b", 32, 8, 160, False, 8)])
CHUNK_REL_TOL = 1e-2
# oracle-70b's depth on the card: all 80 layers hold 141 GB of bf16; 20
# hold 38.4 GB beside proxy-8b's 16.1 GB
ORACLE_LAYERS = 20
# the zoo phase: decoders with qk-norm (qwen3-32b), parallel blocks and a
# tied 256000-row embedding (command-r-35b), a 256000-row vocabulary
# (minitron-8b), mixtures of experts (phi3.5-moe, qwen2-moe) and head dim
# 160 (stablelm-12b), each alone on the card at full width.  Depth is cut
# only where the bf16 weights do not fit beside the served batch; each cut
# with its reason
ZOO = ("qwen3-32b", "command-r-35b", "minitron-8b", "phi3.5-moe-42b-a6.6b",
       "qwen2-moe-a2.7b", "stablelm-12b")
ZOO_CUTS = {"phi3.5-moe-42b-a6.6b": (
    24, "all 32 layers hold 83.8 GB of bf16, more than the card's 80 GB")}
# MoE models, kernel path vs plain path: K1 and K2 differ from their plain
# versions by bf16 rounding, and where the router's plain decision is a
# near-tie that can send a token to another expert (a flip), after which
# its logits differ by far more than SERVE_TOL.  A decode row (a pass, for
# CLASSIFY and EMBED, whose rows share expert capacity) may break its
# SERVE_TOL gate only where its first flip, at the earliest layer that
# has one (both paths routed alike below it), lies within
# ROUTER_MARGIN_TOL of the plain decision: the plain router's k-th minus
# (k+1)-th logit for a top-k flip, the plain log-gate gap at the
# expert's capacity edge for a capacity-drop flip.  Stated before the
# first run; the H100 read first-flip margins up to 0.0372 (qwen2-moe)
# and router-logit differences up to 0.0692 on the layers below a first
# flip (PERF.md, sections 6 and 7)
ROUTER_MARGIN_TOL = 0.05
# K3 (similarity top-k, fp32): values within TOPK_TOL of the plain
# version; ids equal except between rows whose plain scores lie within
# TOPK_TOL of each other (fp32 sums in another order); on sign vectors,
# where every score is exact, ids equal with no exception
TOPK_TOL = 1e-5
SEED = 0
N_LAYERS = 32
# The training phase (train_path), gates stated before its first run.
# Per-leaf relative L2 between the gradients of one loss_fn backward
# through the kernels and through their plain versions, bf16 at full
# width: the kernels' outputs round to bf16 at other places than the plain
# versions', and the difference carries through every layer's backward.
TRAIN_GRAD_TOL = 5e-2
# launch/train.py's runs: proxy-8b at full width, 4 of its 32 layers (the
# fp32 moments of all 32 alone take 64 GB), B x S tokens a step, a
# checkpoint every TRAIN_CKPT_EVERY steps: TRAIN_CKPT_EVERY steps, then a
# second run on the same directory that resumes there and runs to
# TRAIN_STEPS.  Two checkpoints of 19.2 GB: the card's host refuses a
# command that writes more than 45 GiB to its disk, deleted files
# included, and three (a first run of 6 steps, a resume to 7) were
# ended there (chip run, PR 21)
TRAIN_LAYERS = 4
TRAIN_CKPT_EVERY = 3
TRAIN_STEPS = 2 * TRAIN_CKPT_EVERY
TRAIN_B, TRAIN_S = 8, 512
# launch/train.py's default 1e-3 is set for the smoke models (d_model 64).
# AdamW's first step moves every weight by about the learning rate, and
# the warmup is one step at 6 steps: at d_model 4096 the loss jumped from
# 12.49 to 29.8 at 1e-3 and to 20.4 at 1e-4 on the first readings
# (PERF.md, section 6).  1e-5 gives a [4096, 14336] weight about the
# relative step (||update|| / ||W||, ~4%) that 1e-3 gives the smoke
# model's [64, 128]
TRAIN_LR = 1e-5
# the gradient cells: arch -> (layers, or None for full depth; B; S;
# dtype).  recurrentgemma-9b: one period and its tail (rglru, rglru,
# local; rglru, rglru), S past its window of 2048, its config's 2
# microbatches; whisper-base whole, its encoder over 1500 frames.
# rwkv6-1.6b runs whole in fp32 (K5 reads r, k, v in fp32): in bf16 at
# 24 layers the two paths' gradients read rel. L2 up to 2.1 at layer 0
# and 0.94 at layer 23 while the same comparison in fp32 read at most
# 0.0116 (PERF.md, section 6): bf16 rounding, not K5, decides the
# bf16 reading at that depth
GRAD_CELLS = {"proxy-8b": (TRAIN_LAYERS, TRAIN_B, TRAIN_S, "bfloat16"),
              "recurrentgemma-9b": (5, 2, 2560, "bfloat16"),
              "rwkv6-1.6b": (None, 4, 256, "float32"),
              "whisper-base": (None, 8, 128, "bfloat16")}
# train steps of each cell after its gradient check (the loss must fall)
GRAD_STEPS = 2
# the gradients the models ask of K4: da and db (h0 is the zero state)
RGLRU_NEEDS = (True, True, False)
# The mesh phase (mesh_path), gates stated before its first run.
# proxy-8b at full width decodes MESH_STEPS tokens at B = MESH_B over a
# MESH_SLOTS-slot cache (17.2 GB of bf16) filled from seeds, the rows'
# lengths MESH_LENGTHS (rows 0-1 leave the second half of the cache, a
# rank's whole chunk on two ranks, empty), on (a) a 1x1 mesh over NCCL
# with the shard context armed, and (b) a (data=1, model=2) mesh of two
# gloo ranks on the one card (weights TP-sharded, cache sequence-
# sharded).  Both are fed the unarmed one-rank path's greedy tokens; (a)
# is held to that path's logits and (b) to (a)'s: each row's relative L2
# within MESH_LOGITS_REL (the served proxy-8b's decode gate) for (a) and
# MESH_TP_LOGITS_REL for (b), and the greedy token equal except where the
# reference's top-1 minus top-2 logit is under MESH_TOKEN_MARGIN.  (b)
# read 0.04959 in every run, all of it bf16 rounding of the row-parallel
# sums: tools/mesh_probe.py reads the same with each chunked attention
# replaced by K1 over the whole cache, and the fp32 run below reads
# 8.8e-6; so (b)'s bf16 gate is twice that reading, and the fp32 run's
# MESH_FP32_REL is the one that catches a fault
MESH_B = 4
MESH_SLOTS = 32768
MESH_LENGTHS = (1000, 9000, 20000, 32000)
MESH_STEPS = 4
MESH_LOGITS_REL = 0.05
MESH_TP_LOGITS_REL = 0.1
MESH_TOKEN_MARGIN = 0.1
# (b) again with the weights and the cache in fp32 (K1's fp32 path) and
# MESH_FP32_LAYERS of the 32 layers, held to the unarmed one-rank path in
# fp32: bf16's rounding of the row-parallel sums is gone there, so a
# fault in the tensor-parallel sums or the chunks' logsumexp combine
# worth 1e-4 of the logits fails.  At full depth two fp32 ranks hold 38
# GB each, which with the rest of this script's process does not fit on
# the card; tools/mesh_probe.py runs them at full depth alone
MESH_FP32_REL = 1e-4
MESH_FP32_LAYERS = 16
# (b) qwen2-moe-a2.7b at full width, expert-parallel over model=2 (64
# padded experts, 32 a rank), one train-mode pass of MESH_MOE_B x
# MESH_MOE_S tokens, held to the one-rank pass: every position's logits
# within the zoo's SERVE_TOL (relative L2), or the pass's first router
# flips within ROUTER_MARGIN_TOL of the one-rank decision.  And each MoE
# layer of the expert-parallel pass is held to the one-rank MoE on the
# same input (the same routing): the layer's output within
# MESH_MOE_LAYER_REL (relative L2 over all tokens; bf16 rounding of the
# two ranks' partial sums), the aux loss within MESH_MOE_AUX_REL
MESH_MOE_B, MESH_MOE_S = 4, 64
MESH_MOE_LAYER_REL = 1e-2
MESH_MOE_AUX_REL = 1e-5
# (b) MESH_TRAIN_STEPS launch/train.py --model-parallel 2 --backend gloo
# steps of proxy-8b at TRAIN_LAYERS layers against the one-rank run: the
# first step's loss within MESH_TRAIN_LOSS_REL and its gradient norm
# within MESH_TRAIN_GRAD_REL of each other (bf16 rounding of the row-
# parallel sums), and the second step's fall in loss (what the first
# update did) within MESH_TRAIN_DROP_REL of the one-rank fall; no
# checkpoint (--ckpt-every 0: the training phase's two already take the
# card's disk budget)
MESH_TRAIN_STEPS = 2
MESH_TRAIN_LOSS_REL = 5e-3
MESH_TRAIN_GRAD_REL = 1e-2
MESH_TRAIN_DROP_REL = 2e-2
# the mesh phase's processes must end within this many seconds
MESH_RANK_TIMEOUT = 600

# The dry-run phase.  (a) ``launch/dryrun.py`` in DRY_JOBS processes on
# the host, started after the last timed phase (they would take host
# time from the timed phases): DRY_SHAPES of every arch on the
# single-pod mesh but DRY_LEFT_OUT, and proxy-8b's cells on both meshes;
# they must end within DRY_TIMEOUT s of their start.  rwkv6-1.6b's
# train_4k is left
# out: K5's backward is the plain recompute, a Python loop over 4096
# steps a layer, which the dry-run runs on meta as the card runs it
# (835 s on one host core; its record is in results_torch/).  (b) On a 1x1 NCCL mesh, each cell of
# DRY_CELLS run for real and through ``dryrun.run_cell`` on meta: FLOPs,
# bytes, collectives and launches equal, and the dry-run's peak within
# DRY_PEAK_REL (or DRY_PEAK_SLACK bytes, for the allocator's rounding and
# the cuBLAS workspace) of the card's, both stated before the first
# reading.  (arch, layers (None: all), (kind, seq_len, batch)); a decode
# cell's cache holds seq_len - 1 tokens, so the step's K1 reads every slot
DRY_SHAPES = ("decode_32k", "train_4k")
DRY_LEFT_OUT = (("rwkv6-1.6b", "train_4k"),)
# the processes of (a): name -> (arch list, shape or None: every cell on
# both meshes); train_4k's archs split over four, by their trace times
DRY_JOBS = {
    "proxy-8b": (("proxy-8b",), None),
    "decode_32k": (None, "decode_32k"),
    "train_4k_a": (("qwen3-32b",), "train_4k"),
    "train_4k_b": (("command-r-35b", "minitron-8b", "whisper-base"),
                   "train_4k"),
    "train_4k_c": (("recurrentgemma-9b", "stablelm-12b"), "train_4k"),
    "train_4k_d": (("phi3.5-moe-42b-a6.6b", "qwen2-moe-a2.7b",
                    "qwen2-vl-7b"), "train_4k"),
}
DRY_TIMEOUT = 400
DRY_PEAK_REL = 0.10
DRY_PEAK_SLACK = 64 << 20
DRY_CELLS = (
    ("proxy-8b", 4, ("decode", 4096, 8)),
    ("proxy-8b", 4, ("prefill", 2048, 2)),
    ("proxy-8b", 4, ("train", 512, 8)),
    ("recurrentgemma-9b", 5, ("decode", 4096, 8)),      # a period + tail
    ("recurrentgemma-9b", 5, ("prefill", 2048, 2)),
    ("rwkv6-1.6b", None, ("decode", 4096, 8)),
    ("rwkv6-1.6b", None, ("prefill", 2048, 2)),
    ("qwen2-moe-a2.7b", None, ("prefill", 2048, 2)),
)

# each kernel's source and the TPU kernel it replaces
KERNEL_FILES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention/kernel.py:74"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:86"),
    # K2's chunked-prefill entry: no TPU kernel (the JAX package runs a
    # decode step of several tokens a row as dense masked einsums)
    "flash_attention_chunked": (
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "none: src/repro/models/attention.py:170 decode_attention (dense)"),
    "similarity_topk": ("src/repro_torch/kernels/csrc/similarity_topk.cu",
                        "src/repro/kernels/similarity_topk/kernel.py:69"),
    "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                   "src/repro/kernels/rglru_scan/kernel.py:46"),
    # K4 run in reverse: the gradient of the scan (the JAX package
    # differentiates lax.scan around the same TPU kernel's plain version)
    "rglru_scan_bwd": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                       "src/repro/kernels/rglru_scan/kernel.py:46"),
    "rwkv6_scan": ("src/repro_torch/kernels/csrc/rwkv6_scan.cu",
                   "src/repro/kernels/rwkv6_scan/kernel.py:55"),
}

PROMPTS_SCORE = [
    "Is the following review positive? 'The film was a delight from start "
    "to finish.'",
    "Does this ticket describe a billing problem? 'I was charged twice for "
    "my March invoice.'",
    "Is this sentence about sports? 'The striker scored twice in the final "
    "minutes.'",
    "Is the product in this listing a laptop? 'Ultra-thin 14-inch notebook, "
    "16 GB RAM, 1 TB SSD.'",
    "Does the email ask for a meeting? 'Could we find thirty minutes on "
    "Thursday to go over the plan?'",
    "Is this headline about the weather? 'Heavy snow expected across the "
    "north this weekend.'",
    "Is the customer angry? 'This is the third time the order has arrived "
    "broken and nobody answers.'",
    "Does the abstract mention a database? 'We present a query optimizer "
    "for semantic operators in SQL.'",
]
PROMPTS_COMPLETE = [
    "Summarize in one sentence: the quarterly report shows revenue up 12% "
    "while costs stayed flat.",
    "Translate to French: the library opens at nine in the morning.",
    "Write a short product title for a stainless steel water bottle.",
    "Continue the list of primary colours: red, blue,",
]
PROMPTS_CLASSIFY = [
    ("Classify the sentiment of: 'The battery died after one day.'",
     ("positive", "negative", "neutral")),
    ("Which department should handle: 'My password reset link expired.'",
     ("billing", "support", "sales")),
]
PROMPTS_EMBED = [
    "Wireless noise-cancelling headphones with a 30-hour battery.",
    "A comparison of columnar storage formats for analytical queries.",
]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_ms(fn, iters: int = 20):
    """The kernels' own time per call from the profiler: for each kernel
    ``fn`` launches once a call, its mean device time a launch, summed.
    Where a call is short, the events of ``cuda_time_ms`` time the host's
    launches instead.  Averaged over the launches recorded, not over
    ``iters``: a profiler session after an earlier one in the same process
    may not record every launch.  None where it records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for name, _, d in device_events(prof):
        n, total = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, total + d)
    ns = sum(total / n for n, total in by_name.values())
    return ns / 1e6 if ns else None


def device_events(prof):
    """(name, start ns, duration ns) of every device event (kernel, copy)
    that a profiler session recorded, read from its raw events: building
    the op tree of ``key_averages()`` over ~10^5 launches takes minutes,
    and its per-op device times count each kernel under its op and again
    as itself."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def max_err(x, y) -> float:
    return float((x.float() - y.float()).abs().max())


def rel_l2(x, y) -> float:
    """||x - y|| / ||y||, over the whole tensor."""
    return float((x.float() - y.float()).norm() / y.float().norm())


# ---------------------------------------------------------------------------
# bounds: bytes each input read once and each output written once, and the
# operations these inputs need (valid keys only), whichever takes longer
# ---------------------------------------------------------------------------


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def decode_bound(q, kc, lengths, lse=True):
    B, _, H, hd = q.shape
    KV = kc.shape[2]
    es = q.element_size()
    keys = int(lengths.clamp(0, kc.shape[1]).sum())
    nbytes = (2 * B * H * hd * es             # q in, out
              + 2 * keys * KV * hd * es       # valid K and V rows
              + 4 * B + 4 * B * H * lse)      # lengths, lse
    ops = 4.0 * keys * H * hd                 # q.k and p.v
    return bound(nbytes, ops, str(q.dtype).split(".")[-1])


def rwkv_bound(r):
    """K5: r, k, v read in their type, w read and o written in fp32, u,
    s0 and sT in fp32; 5 hd^2 operations a step per (row, head)."""
    B, S, H, hd = r.shape
    n = B * S * H * hd
    nbytes = (3 * r.element_size() * n + 4 * n + 4 * n   # r,k,v; w; o
              + 4 * H * hd + 2 * 4 * B * H * hd * hd)   # u; s0, sT
    return bound(nbytes, 5.0 * n * hd, "float32")


def flash_bound(q, k, causal, window):
    B, Sq, H, hd = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    es = q.element_size()
    pairs = 0
    for i in range(Sq):
        qp = i + Skv - Sq
        hi = min(qp, Skv - 1) if causal else Skv - 1
        lo = max(0, qp - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    nbytes = es * (2 * B * Sq * H * hd + 2 * B * Skv * KV * hd)
    ops = 4.0 * B * H * hd * pairs
    return bound(nbytes, ops, str(q.dtype).split(".")[-1])


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def build_kernels(*kernel_ops):
    t0 = time.perf_counter()
    libs = [m.LIB for m in kernel_ops]
    with ThreadPoolExecutor(len(libs)) as pool:     # one nvcc per source
        list(pool.map(lambda lib: lib.load(), libs))
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          + " + ".join(lib.source.name for lib in libs)
          + " (nvcc, sm_90a, in parallel)")
    for lib in libs:
        regs = [ln.strip() for ln in lib.build_log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {lib.source.name}: {lib.build_seconds:.1f} s, ptxas: "
              + " | ".join(sorted(set(regs))[:6]))


def check_kernels(torch, dec_ops, flash_ops, dev):
    """Each kernel against its plain version at the serving model's
    attention widths, bf16 and fp32; returns the max error per kernel."""
    H, KV, hd = 32, 8, 128
    errs = {"decode_attention": 0.0, "flash_attention": 0.0}
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        B, Smax = 8, 512
        q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(dtype)
        kc = torch.randn((B, Smax, KV, hd), generator=gen,
                         device=dev).to(dtype)
        vc = torch.randn((B, Smax, KV, hd), generator=gen,
                         device=dev).to(dtype)
        lengths = torch.tensor([1, 31, 33, 200, 512, 64, 65, 500],
                               dtype=torch.int32, device=dev)
        out, lse = dec_ops.flash_decode(q, kc, vc, lengths, return_lse=True)
        ref, ref_lse = dec_ops.flash_decode(q, kc, vc, lengths,
                                            impl="reference",
                                            return_lse=True)
        torch.cuda.synchronize()
        e, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        print(f"K1 decode {name} B={B} H={H} KV={KV} hd={hd} Smax={Smax} "
              f"lengths={lengths.tolist()}: max|out-plain|={e:.3g} "
              f"max|lse-plain|={e_lse:.3g} (tol {TOL[name]})")
        if not (e <= TOL[name] and e_lse <= TOL["float32"]):
            fail(f"K1 {name} disagrees with its plain version")
        errs["decode_attention"] = max(errs["decode_attention"], e)
        for Sq, Skv, window in ((1, 1, 0), (37, 37, 0), (128, 128, 0),
                                (384, 384, 0), (384, 384, 64),
                                (128, 384, 0)):
            B = 2
            q = torch.randn((B, Sq, H, hd), generator=gen,
                            device=dev).to(dtype)
            k = torch.randn((B, Skv, KV, hd), generator=gen,
                            device=dev).to(dtype)
            v = torch.randn((B, Skv, KV, hd), generator=gen,
                            device=dev).to(dtype)
            out = flash_ops.flash_attention(q, k, v, window=window)
            ref = flash_ops.flash_attention(q, k, v, window=window,
                                            impl="reference")
            torch.cuda.synchronize()
            e = max_err(out, ref)
            print(f"K2 flash {name} B={B} H={H} KV={KV} hd={hd} Sq={Sq} "
                  f"Skv={Skv} causal window={window}: max|out-plain|="
                  f"{e:.3g} (tol {TOL[name]})")
            if not e <= TOL[name]:
                fail(f"K2 {name} Sq={Sq} Skv={Skv} window={window} "
                     "disagrees with its plain version")
            errs["flash_attention"] = max(errs["flash_attention"], e)
    check_attention_hd256(torch, dec_ops, flash_ops, dev, gen, errs)
    check_attention_hd160_and_cross(torch, dec_ops, flash_ops, dev, gen,
                                    errs)
    return errs


def check_attention_hd256(torch, dec_ops, flash_ops, dev, gen, errs):
    """K1 and K2 at recurrentgemma's local-attention widths (16 q heads on
    one kv head, hd 256): K1 over a 2048-slot ring at the ring lengths a
    decode step gives (a prefix of min(pos + 1, 2048) slots), K2 in window
    mode with the window shorter and longer than the sequence."""
    H, KV, hd = 16, 1, 256
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]

        def r(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        B, W = 8, 2048
        q, kc, vc = r(B, 1, H, hd), r(B, W, KV, hd), r(B, W, KV, hd)
        lengths = torch.tensor([1, 33, 64, 65, 384, 1000, 2047, 2048],
                               dtype=torch.int32, device=dev)
        out, lse = dec_ops.flash_decode(q, kc, vc, lengths, return_lse=True)
        ref, ref_lse = dec_ops.flash_decode(q, kc, vc, lengths,
                                            impl="reference",
                                            return_lse=True)
        torch.cuda.synchronize()
        e, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        print(f"K1 decode {name} B={B} H={H} KV={KV} hd={hd} ring {W} "
              f"lengths={lengths.tolist()}: max|out-plain|={e:.3g} "
              f"max|lse-plain|={e_lse:.3g} (tol {TOL[name]})")
        if not (e <= TOL[name] and e_lse <= TOL["float32"]):
            fail(f"K1 {name} hd {hd} disagrees with its plain version")
        errs["decode_attention@hd256"] = max(
            errs.get("decode_attention@hd256", 0.0), e)
        for S, window in ((37, 16), (128, 2048), (384, 2048), (384, 100)):
            B = 2
            q, k, v = r(B, S, H, hd), r(B, S, KV, hd), r(B, S, KV, hd)
            out = flash_ops.flash_attention(q, k, v, window=window)
            ref = flash_ops.flash_attention(q, k, v, window=window,
                                            impl="reference")
            torch.cuda.synchronize()
            e = max_err(out, ref)
            print(f"K2 flash {name} B={B} H={H} KV={KV} hd={hd} S={S} "
                  f"window={window}: max|out-plain|={e:.3g} (tol "
                  f"{TOL[name]})")
            if not e <= TOL[name]:
                fail(f"K2 {name} hd {hd} S={S} window={window} disagrees "
                     "with its plain version")
            errs["flash_attention@hd256"] = max(
                errs.get("flash_attention@hd256", 0.0), e)


def check_attention_hd160_and_cross(torch, dec_ops, flash_ops, dev, gen,
                                    errs):
    """K1 and K2 at stablelm-12b's attention widths (32 q heads on 8 kv
    heads, hd 160: the served batch's kinds of lengths and the full shapes,
    a 512-slot cache and S = 384), and K2 without the causal mask at
    whisper-base's (8 heads, 8 kv heads, hd 64): the encoder's
    self-attention over its 1500 frames, a pass's cross-attention (64
    tokens) and a decode step's (one query) over them."""
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]

        def r(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        B, H, KV, hd, Smax = 8, 32, 8, 160, 512
        q, kc, vc = r(B, 1, H, hd), r(B, Smax, KV, hd), r(B, Smax, KV, hd)
        lengths = torch.tensor([1, 31, 33, 100, 512, 64, 65, 500],
                               dtype=torch.int32, device=dev)
        out, lse = dec_ops.flash_decode(q, kc, vc, lengths, return_lse=True)
        ref, ref_lse = dec_ops.flash_decode(q, kc, vc, lengths,
                                            impl="reference",
                                            return_lse=True)
        torch.cuda.synchronize()
        e, e_lse = max_err(out, ref), max_err(lse, ref_lse)
        print(f"K1 decode {name} B={B} H={H} KV={KV} hd={hd} Smax={Smax} "
              f"lengths={lengths.tolist()}: max|out-plain|={e:.3g} "
              f"max|lse-plain|={e_lse:.3g} (tol {TOL[name]})")
        if not (e <= TOL[name] and e_lse <= TOL["float32"]):
            fail(f"K1 {name} hd {hd} disagrees with its plain version")
        errs["decode_attention@hd160"] = max(
            errs.get("decode_attention@hd160", 0.0), e)
        cases = [(2, H, KV, hd, Sq, Skv, True)
                 for Sq, Skv in ((1, 1), (37, 37), (128, 128), (384, 384),
                                 (128, 384))]
        cases += [(b, 8, 8, 64, Sq, 1500, False)
                  for b, Sq in ((2, 1500), (8, 64), (8, 1))]
        for b, h, kv, d, Sq, Skv, causal in cases:
            q, k, v = r(b, Sq, h, d), r(b, Skv, kv, d), r(b, Skv, kv, d)
            out = flash_ops.flash_attention(q, k, v, causal=causal)
            ref = flash_ops.flash_attention(q, k, v, causal=causal,
                                            impl="reference")
            torch.cuda.synchronize()
            e = max_err(out, ref)
            tol = (CROSS_TOL if not causal and dtype == torch.bfloat16
                   else TOL[name])
            print(f"K2 flash {name} B={b} H={h} KV={kv} hd={d} Sq={Sq} "
                  f"Skv={Skv} causal={causal}: max|out-plain|={e:.3g} "
                  f"rel. L2 {rel_l2(out, ref):.3g} (tol {tol})")
            if not e <= tol:
                fail(f"K2 {name} hd {d} Sq={Sq} Skv={Skv} causal={causal} "
                     "disagrees with its plain version")
            key = "flash_attention@" + ("hd160" if causal else "cross")
            errs[key] = max(errs.get(key, 0.0), e)


def decays(torch, gen, shape, dev):
    """Decays in (0, 1), as the models make them."""
    return torch.sigmoid(torch.randn(shape, generator=gen, device=dev) + 2)


def rel_err(x, ref) -> float:
    """max |x - ref| over max(1, max |ref|): K5's state and outputs grow
    with the sequence, and fp32 rounding with them."""
    return max_err(x, ref) / max(1.0, float(ref.abs().max()))


def check_scans(torch, rglru_ops, rwkv_ops, dev, errs):
    """K4 and K5 against their plain versions, bf16 and fp32 inputs, at
    the served models' widths (K4: W = 4096; K5: 32 heads of 64) and the
    full shapes (B = 8, S = 384), a served decode step (S = 1) and odd
    sizes, K5 also with decays that underflow to 0; K5 also chained: two launches over the halves, the second from
    the first's state, equal one launch over the whole.  K4 also at the
    train shape (B = 1, S = 2560), and K4 in reverse (the backward)
    against the plain reverse, with every gradient and with the model's
    (no dh0).  K4 both ways must give the plain version's bits (both
    round the multiply and the add apart); K5 within TOL["float32"]
    relative to the largest plain value."""
    from repro_torch.kernels.rglru_scan.ref import rglru_scan_bwd_ref
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    errs.setdefault("rglru_scan", 0.0)
    errs.setdefault("rglru_scan_bwd", 0.0)
    errs.setdefault("rwkv6_scan", 0.0)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for B, S, W in ((8, 384, 4096), (8, 45, 4096), (3, 37, 300),
                        (1, 2560, 4096)):
            a = decays(torch, gen, (B, S, W), dev).to(dtype)
            b = torch.randn((B, S, W), generator=gen, device=dev).to(dtype)
            h0 = torch.randn((B, W), generator=gen, device=dev)
            hs, hT = rglru_ops.rglru_scan(a, b, h0)
            ref_hs, ref_hT = rglru_ops.rglru_scan(a, b, h0, impl="reference")
            torch.cuda.synchronize()
            e = max(max_err(hs, ref_hs), max_err(hT, ref_hT))
            same = torch.equal(hs, ref_hs) and torch.equal(hT, ref_hT)
            d_hs = torch.randn((B, S, W), generator=gen, device=dev)
            d_hT = torch.randn((B, W), generator=gen, device=dev)
            want = rglru_scan_bwd_ref(a, ref_hs, h0, d_hs, d_hT)
            e_bwd, same_bwd = 0.0, True
            for needs in ((True, True, True), (True, True, False)):
                got = rglru_ops.rglru_scan_bwd_cuda(a, hs, h0, d_hs, d_hT,
                                                    needs)
                torch.cuda.synchronize()
                for g, w, n in zip(got, want, needs):
                    if n:
                        e_bwd = max(e_bwd, max_err(g, w))
                        same_bwd &= g.dtype == w.dtype and torch.equal(g, w)
                    else:
                        same_bwd &= g is None
            print(f"K4 rglru {name} B={B} S={S} W={W}: max|h-plain|={e:.3g}"
                  f", bitwise equal {same}; reverse max|grad-plain|="
                  f"{e_bwd:.3g}, bitwise equal {same_bwd}")
            if not (same and same_bwd):
                fail(f"K4 {name} B={B} S={S} W={W} differs from its plain "
                     "version (forward or reverse)")
            errs["rglru_scan"] = max(errs["rglru_scan"], e)
            errs["rglru_scan_bwd"] = max(errs["rglru_scan_bwd"], e_bwd)
        for B, S, H, hd, small in ((8, 384, 32, 64, False),
                                   (8, 45, 32, 64, False),
                                   (8, 1, 32, 64, False),
                                   (3, 37, 5, 64, False),
                                   (2, 19, 3, 16, False),
                                   (8, 385, 32, 64, True)):
            r, k, v = (torch.randn((B, S, H, hd), generator=gen,
                                   device=dev).to(dtype) for _ in range(3))
            if small:       # w = exp(-exp(x)), x up to 5: some w are 0
                x = torch.randn((B, S, H, hd), generator=gen, device=dev)
                w = torch.exp(-torch.exp((2 * x + 1).clamp(-6, 5)))
            else:
                w = decays(torch, gen, (B, S, H, hd), dev)
            u = torch.randn((H, hd), generator=gen, device=dev) * 0.1
            s0 = torch.randn((B, H, hd, hd), generator=gen, device=dev)
            o, sT = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)
            again = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0)
            ref_o, ref_sT = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0,
                                                impl="reference")
            torch.cuda.synchronize()
            e = max(rel_err(o, ref_o), rel_err(sT, ref_sT))
            msg = ""
            if S > 1:
                h = S // 2
                o1, s1 = rwkv_ops.rwkv6_scan(r[:, :h], k[:, :h], v[:, :h],
                                             w[:, :h], u, s0)
                o2, s2 = rwkv_ops.rwkv6_scan(r[:, h:], k[:, h:], v[:, h:],
                                             w[:, h:], u, s1)
                e_chain = max(rel_err(torch.cat([o1, o2], 1), o),
                              rel_err(s2, sT))
                msg = f", two halves chained vs one launch {e_chain:.3g}"
                e = max(e, e_chain)
            repeat = (torch.equal(again[0], o)
                      and torch.equal(again[1], sT))
            e_abs = max(max_err(o, ref_o), max_err(sT, ref_sT))
            finite = bool(torch.isfinite(o).all() and torch.isfinite(sT).all())
            print(f"K5 rwkv6 {name} B={B} S={S} H={H} hd={hd}"
                  f"{' (decays down to 0)' if small else ''}: rel. max|"
                  f"err| vs plain {e:.3g} (tol {TOL['float32']}), max|err| "
                  f"{e_abs:.3g}{msg}, repeat bitwise equal {repeat}, "
                  f"finite {finite}")
            if not (e <= TOL["float32"] and repeat and finite):
                fail(f"K5 {name} B={B} S={S} H={H} disagrees with its plain "
                     "version or with itself")
            errs["rwkv6_scan"] = max(errs["rwkv6_scan"], e_abs)


def requests(arch="proxy-8b"):
    from repro_torch.inference.backend import (CLASSIFY, COMPLETE, EMBED,
                                               SCORE, Request)
    reqs = [Request(p, arch, SCORE) for p in PROMPTS_SCORE]
    reqs += [Request(p, arch, COMPLETE, max_tokens=16)
             for p in PROMPTS_COMPLETE]
    reqs += [Request(p, arch, CLASSIFY, labels=lbls)
             for p, lbls in PROMPTS_CLASSIFY]
    reqs += [Request(p, arch, EMBED, metadata={"embed_dim": 256})
             for p in PROMPTS_EMBED]
    for i, r in enumerate(reqs):
        r.request_id = i + 1
    return reqs


def check_results(reqs, results):
    from repro_torch.inference.backend import CLASSIFY, COMPLETE, EMBED, SCORE
    if len(results) != len(reqs):
        fail(f"{len(results)} results for {len(reqs)} requests")
    for r, res in zip(reqs, results):
        if res.request_id != r.request_id or res.kind != r.kind:
            fail(f"result {res.request_id}/{res.kind} out of order")
        if res.tokens_in <= 0 or not res.credits > 0:
            fail(f"request {r.request_id}: not metered")
        if r.kind == SCORE and not (0.0 <= res.score <= 1.0
                                    and math.isfinite(res.score)):
            fail(f"request {r.request_id}: score {res.score}")
        if r.kind == COMPLETE and not (
                1 <= res.tokens_out <= r.max_tokens
                and isinstance(res.text, str)):
            fail(f"request {r.request_id}: {res.tokens_out} tokens out")
        if r.kind == CLASSIFY and res.label not in r.labels:
            fail(f"request {r.request_id}: label {res.label!r}")
        if r.kind == EMBED:
            v = res.embedding
            n = math.sqrt(sum(x * x for x in v))
            if len(v) != 256 or not abs(n - 1.0) < 1e-4:
                fail(f"request {r.request_id}: embedding norm {n}")


class Spy:
    """Wraps ``owner.name``, passing every call through, and hands each
    call's arguments and result to ``record(args, kw, out)``."""

    def __init__(self, owner, name, record):
        self.owner, self.name, self.record = owner, name, record

    def __enter__(self):
        orig = self.orig = getattr(self.owner, self.name)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            self.record(args, kw, out)
            return out
        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def first_launch_per_pass(pass_of):
    """A Spy recorder keeping the inputs of the first kernel launch of each
    model pass (the layers of one pass share ``pass_of(args)``) in
    ``passes``.  The served path never writes to a tensor after handing it
    to a kernel, so references suffice."""
    passes = []

    def record(args, kw, out):
        key = pass_of(args)
        if not passes or passes[-1][0] != key:
            passes.append((key, args, kw))
    return passes, record


def step_logits(batcher, tables, lens, cur, impl):
    """The logits of one continuous-batcher decode step with single-token
    attention ``impl``, on a gathered copy of the paged KV (the pool is
    left as it was)."""
    from repro_torch.models import attention
    params = batcher.engine.params
    cache = batcher.kv.gather(batcher.kv.pool, tables, lens)
    with attention.use_decode_impl(impl):
        out = batcher.model.apply(params, {"tokens": cur}, mode="decode",
                                  cache=cache)
    return batcher.model.logits_of(params, out["hidden"][:, 0])


def routing(params, x, ctx):
    """Which experts computed each token in one MoE layer, recomputed on
    the layer's input with the model's own routing functions, and what
    their margins need: ``chosen`` / ``kept`` [T, E] bool (the router's
    top-k; what survived the capacity), ``route_margin`` [T] (the k-th
    minus the (k+1)-th router logit over the true experts), ``gates``
    [T, E], ``edge`` [E, 2] (each expert's last kept and first dropped
    gate, (inf, 0) where nothing dropped) and the router ``logits`` over
    the true experts [T, E]."""
    import torch
    from repro_torch.models import blocks
    m = ctx.cfg.moe
    w = params["router"]["w"]
    x2d = x.reshape(-1, x.shape[-1])
    T = x2d.shape[0]
    gates, _ = blocks._route(w, x2d, m)
    cap = min(blocks._capacity(m, T, ctx.mode), T)
    g, idx = blocks._top_k(gates.T, cap)                  # [E, C]
    kept = torch.zeros_like(gates.T, dtype=torch.bool)
    kept.scatter_(1, idx, g > 0)
    k = m.num_experts_per_tok
    logits = (x2d.float() @ w)[:, :m.num_experts]
    top = torch.sort(logits, dim=-1, descending=True).values
    edge = torch.tensor([[math.inf, 0.0]]).expand(gates.shape[1], 2)
    if cap < T:
        order = torch.sort(gates.T, dim=-1, descending=True).values
        edge = order[:, cap - 1:cap + 1]
    return {"chosen": (gates > 0).cpu(), "kept": kept.T.cpu(),
            "route_margin": (top[:, k - 1] - top[:, k]).cpu(),
            "gates": gates.cpu(), "edge": edge.cpu(), "logits": logits.cpu()}


class RouterTap:
    """For a model with a mixture of experts, records the ``routing`` of
    every MoE layer that a model pass of mode ``mode`` runs while a
    ``sink`` is set (``into``), once ``installed``; a no-op for a dense
    model.  The recomputation launches no attention kernel."""

    def __init__(self, cfg):
        self.on = cfg.moe is not None
        self.sink, self.mode = None, None

    @contextlib.contextmanager
    def installed(self):
        if not self.on:
            yield self
            return
        from repro_torch.models import blocks
        with Spy(blocks, "moe_apply", self._record):
            yield self

    @contextlib.contextmanager
    def into(self, sink, mode):
        prev = self.sink, self.mode
        self.sink, self.mode = sink, mode
        try:
            yield
        finally:
            self.sink, self.mode = prev

    def _record(self, args, kw, out):
        params, x, ctx = args
        if self.sink is not None and ctx.mode == self.mode:
            self.sink.append(routing(params, x, ctx))


def expert_flips(k_recs, p_recs, n_layers):
    """Every token whose computing experts differ between one pass on the
    kernel path (``k_recs``, a ``routing`` record a layer) and on the
    plain path (``p_recs``): [(layer, token, kind, plain margin)].  Kind
    "route" where the router's top-k differs (margin: its plain logit
    gap); "drop" where only the capacity drop does, at an expert whose
    chosen tokens are the same on both paths (margin: the smallest plain
    log-gate gap between the token and the capacity edge it crossed: the
    first dropped gate for a token the plain path kept, the last kept for
    one it dropped); "displaced" where the drop differs only at experts
    that a route flip of another token entered or left (a consequence,
    margin None)."""
    if len(k_recs) != n_layers or len(p_recs) != n_layers:
        fail(f"router tap: {len(k_recs)} / {len(p_recs)} MoE layers "
             f"recorded in a pass of {n_layers}")
    out = []
    for layer, (a, b) in enumerate(zip(k_recs, p_recs)):
        diff = a["kept"] != b["kept"]
        moved = (a["chosen"] != b["chosen"]).any(0)        # [E]
        for t in diff.any(1).nonzero().flatten().tolist():
            if not bool((a["chosen"][t] == b["chosen"][t]).all()):
                out.append((layer, t, "route", float(b["route_margin"][t])))
                continue
            es = (diff[t] & ~moved).nonzero().flatten().tolist()
            if es:
                lg = [math.log(float(b["gates"][t, e])) for e in es]
                gaps = [g - math.log(float(b["edge"][e, 1]))
                        if b["kept"][t, e] else
                        math.log(float(b["edge"][e, 0])) - g
                        for g, e in zip(lg, es)]
                out.append((layer, t, "drop", min(gaps)))
            else:
                out.append((layer, t, "displaced", None))
    return out


def first_flips(flips, token=None):
    """The flips (of ``token`` alone, if given) at the earliest layer that
    has one: below it both paths routed alike, so only the kernels'
    rounding can have moved its decisions."""
    fl = [f for f in flips if token is None or f[1] == token]
    if not fl:
        return []
    lo = min(f[0] for f in fl)
    return [f for f in fl if f[0] == lo]


def router_delta(k_recs, p_recs, flips, token=None):
    """The largest router-logit difference between the paths (of
    ``token``, if given) on the layers up to the first flip, all layers
    where there is none: how far the kernels' rounding alone moved the
    router's inputs."""
    first = first_flips(flips, token)
    last = first[0][0] if first else len(k_recs) - 1
    d = 0.0
    for a, b in zip(k_recs[:last + 1], p_recs[:last + 1]):
        x = (a["logits"] - b["logits"]).abs()
        d = max(d, float((x if token is None else x[token]).max()))
    return d


def explained(first) -> bool:
    """A gap is explained by first flips that are decisions (route or
    drop) all within ROUTER_MARGIN_TOL of the plain path's."""
    margins = [f[3] for f in first if f[3] is not None]
    return bool(margins) and max(margins) <= ROUTER_MARGIN_TOL


def fmt_flips(first, shown=6):
    """Layer, counts by kind, and the margins of the first decisions."""
    if not first:
        return ""
    kinds = {}
    for f in first:
        kinds[f[2]] = kinds.get(f[2], 0) + 1
    margins = sorted(f[3] for f in first if f[3] is not None)
    return (f"layer {first[0][0]}: "
            + ", ".join(f"{n} {k}" for k, n in sorted(kinds.items()))
            + f", plain margins {[float(f'{m:.4g}') for m in margins[:shown]]}"
            + (f" ... {margins[-1]:.4g}" if len(margins) > shown else ""))


def serve_and_check(torch, eng, errs):
    """Serve the mixed batch with ``eng`` (a model on the continuous
    batcher) on the kernel path (counting launches, timing steps),
    re-serve it through the plain attention, gate on both, and time each
    kernel at the served inputs with the most work.  For a mixture of
    experts, count the tokens whose experts differ between the paths
    (``RouterTap``) and excuse a gap past SERVE_TOL only where such a flip
    within ROUTER_MARGIN_TOL explains it.  Returns the rows of the kernels
    line."""
    from repro_torch.inference import tokenizer as tok
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.models import attention
    cfg = eng.cfg
    arch = eng.arch
    L = cfg.num_layers
    reqs = requests(arch)
    marks = [("start", time.perf_counter())]
    # warm-up: the first calls pay for cuBLAS handles and allocator growth
    eng.submit_batch(reqs[:1] + reqs[-1:])
    torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    batcher = eng._batcher
    if batcher is None:
        fail(f"{arch} is not on the continuous batcher")
    step_ms = []
    prefill_ms = []
    orig_decode, orig_prefill = batcher._decode_fn, batcher._prefill_fn

    def timed(fn, sink):
        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t) * 1e3)
            return out
        return run

    batcher._decode_fn = timed(orig_decode, step_ms)
    batcher._prefill_fn = timed(orig_prefill, prefill_ms)
    before = eng.backend_stats()
    k1_passes, k1_record = first_launch_per_pass(lambda a: id(a[3]))
    k2_passes, k2_record = first_launch_per_pass(lambda a: tuple(a[0].shape))
    ids, lps = [], []
    dec_ops.LAUNCHES = 0
    flash_ops.LAUNCHES = 0
    flash_ops.CHUNKED_LAUNCHES = 0
    kc_best, kc_record = chunk_recorder()
    with Spy(dec_ops, "decode_attention_cuda", k1_record), \
            Spy(flash_ops, "flash_attention_cuda", k2_record), \
            Spy(flash_ops, "chunked_attention_cuda", kc_record), \
            Spy(eng, "_sequence_logprob",
                lambda a, kw, out: lps.extend(out[0])), \
            Spy(tok, "decode", lambda a, kw, out: ids.append(list(a[0]))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = eng.submit_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"decode_attention": dec_ops.LAUNCHES,
                "flash_attention": flash_ops.LAUNCHES,
                "flash_attention_chunked": flash_ops.CHUNKED_LAUNCHES}
    batcher._decode_fn, batcher._prefill_fn = orig_decode, orig_prefill
    marks.append(("served", time.perf_counter()))
    after = eng.backend_stats()
    check_results(reqs, results)
    decode_steps = after["decode_steps"] - before["decode_steps"]
    prefill_tokens = after["prefill_tokens"] - before["prefill_tokens"]
    n_cls = sum(r.kind == "classify" for r in reqs)
    n_emb = sum(r.kind == "embed" for r in reqs)
    cls_passes = -(-n_cls // eng.max_batch)
    passes = cls_passes + -(-n_emb // eng.max_batch)
    expect = {"decode_attention": L * decode_steps,
              "flash_attention": L * passes,
              "flash_attention_chunked": 2 * L * len(prefill_ms)}
    print(f"{arch} served {len(reqs)} requests in {wall:.3f} s: "
          f"{decode_steps} decode steps, {len(prefill_ms)} chunked-prefill "
          f"steps ({prefill_tokens} prompt tokens), {passes} full-sequence "
          "passes")
    kernel_layers = (after["prefill_attn_kernel_layers"]
                     - before["prefill_attn_kernel_layers"])
    print(f"{arch} launches: {launches}, expected {expect}; prefill layers "
          f"through K2's chunked entry {kernel_layers} of "
          f"{L * len(prefill_ms)}")
    if (launches != expect or min(launches.values()) == 0
            or kernel_layers != L * len(prefill_ms)):
        fail(f"{arch}: kernel launch counts differ from the served path's "
             "steps")
    med_step = statistics.median(step_ms) if step_ms else float("nan")
    print(f"{arch} decode step: median {med_step:.3f} ms over {len(step_ms)} "
          f"steps (B={eng.max_batch} slots); chunked prefill "
          f"{prefill_tokens / (sum(prefill_ms) / 1e3):.1f} tokens/s over "
          f"{len(prefill_ms)} steps")

    # 4. re-serve through the plain attention on the same weights, and hold
    #    what went through the kernels to it: each decode step's logits
    #    (K1, both attentions on the same step state), CLASSIFY's label
    #    logprobs and EMBED's vectors (K2).  SCORE is chunked prefill only
    #    on this backend (K2's chunked entry, counted above; its SCOREs are
    #    held to the plain path in the AISQL phase).  The router tap records
    #    each MoE layer's experts in the full-sequence passes of both runs
    #    and in both attentions of each probed decode step
    tap = RouterTap(cfg)
    k_passes, p_passes = [], []
    # per decode step: rel. L2 error of each active row, the rows, max
    # |err|, same top-1 count, rows, expert flips
    probe = []
    deltas = []           # router-logit differences before a flip
    ref_ids, ref_lps, ref_results = [], [], None

    def probed(tables, lens, act, cur):
        rows = act.bool()
        k_rec, p_rec = [], []
        with tap.into(k_rec, "decode"):
            lk = step_logits(batcher, tables, lens, cur, "auto")[rows]
        with tap.into(p_rec, "decode"):
            lp = step_logits(batcher, tables, lens, cur, "reference")[rows]
        rel = (lk - lp).norm(dim=-1) / lp.norm(dim=-1)
        same = (lk.argmax(-1) == lp.argmax(-1)).sum()
        ids = rows.nonzero().flatten().tolist()
        flips = expert_flips(k_rec, p_rec, L) if tap.on else []
        if tap.on:
            deltas.append(max(router_delta(k_rec, p_rec, flips, r)
                              for r in ids))
        probe.append((rel.tolist(), ids, max_err(lk, lp), int(same),
                      int(rows.sum()), flips))
        return orig_decode(tables, lens, act, cur)

    passes_of = [r for r in reqs if r.kind in ("classify", "embed")]
    k_lps = lps
    k_emb = k_emb_served = [r.embedding for r in results
                            if r.kind == "embed"]
    with tap.installed():
        if tap.on:
            # the full-sequence passes again on the kernel path, recorded
            # (the timed run above is kept free of the tap's work)
            k_lps = []
            with tap.into(k_passes, "train"), \
                    Spy(eng, "_sequence_logprob",
                        lambda a, kw, out: k_lps.extend(out[0])):
                again = eng.submit_batch(passes_of)
            k_emb = [r.embedding for r in again if r.kind == "embed"]
            same = k_emb == k_emb_served and k_lps == lps
            print(f"{arch} CLASSIFY and EMBED passes again with the router "
                  f"tap: bitwise equal to the served run {same}")
        batcher.decode_impl = "reference"
        batcher._decode_fn = probed
        try:
            with attention.use_flash_impl("reference"), \
                    tap.into(p_passes, "train"), \
                    Spy(eng, "_sequence_logprob",
                        lambda a, kw, out: ref_lps.extend(out[0])), \
                    Spy(tok, "decode",
                        lambda a, kw, out: ref_ids.append(list(a[0]))):
                ref_results = eng.submit_batch(reqs)
        finally:
            batcher._decode_fn = orig_decode
            batcher.decode_impl = "auto"
    check_results(reqs, ref_results)
    marks.append(("plain run and probes", time.perf_counter()))
    if tap.on and not (len(k_passes) == len(p_passes) == passes * L):
        fail(f"{arch}: router tap recorded {len(k_passes)} / "
             f"{len(p_passes)} MoE layers for {passes} passes")
    rels = [e for p in probe for e in p[0]]
    logits_abs = max(p[2] for p in probe)
    top1 = (sum(p[3] for p in probe), sum(p[4] for p in probe))
    d_lp = max(abs(a - b) for a, b in zip(k_lps, ref_lps))
    cos = min(sum(x * y for x, y in zip(a, b.embedding)) for a, b in
              zip(k_emb, [r for r in ref_results if r.kind == "embed"]))
    agree = []            # matching leading tokens / tokens generated
    for a, b in zip(ids, ref_ids):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        agree.append(f"{n}/{max(len(a), len(b))}")
    same_label = sum(a.label == b.label for a, b in zip(results, ref_results)
                     if a.kind == "classify")
    tol = SERVE_TOL[arch]
    print(f"{arch} kernel vs plain, K1: decode-step logits over {len(probe)} "
          f"steps max rel. L2 err {max(rels):.3g} (tol "
          f"{tol['decode_logits_rel']}), max |err| {logits_abs:.3g}, "
          f"same top-1 token {top1[0]}/{top1[1]} rows")
    print(f"{arch} kernel vs plain, K2: CLASSIFY label logprobs {len(lps)} "
          f"pairs max |err| {d_lp:.3g} nats (tol {tol['classify_logprob']}),"
          f" labels same {same_label}/{n_cls}; EMBED min cosine {cos:.6f} "
          f"(tol {tol['embed_cosine']})")
    print(f"{arch} COMPLETE leading tokens equal {agree} (not gated: greedy "
          "argmax over near-flat random logits can flip on bf16 rounding)")
    if len(lps) != len(ref_lps) or not lps or not probe:
        fail(f"{arch}: the served path ran no CLASSIFY pass or no decode "
             "step")
    # decode rows past the gate, each excused only by a flip in its row
    bad = []
    for step, (rel, rows, *_, flips) in enumerate(probe):
        for row, e in zip(rows, rel):
            if e > tol["decode_logits_rel"]:
                first = first_flips(flips, row)
                bad.append((step, row, e, first, explained(first)))
    # CLASSIFY and EMBED passes, whose rows share expert capacity
    pass_ok = {"classify": d_lp <= tol["classify_logprob"],
               "embed": cos >= tol["embed_cosine"]}
    pass_first = {}
    if tap.on:
        pflips = [expert_flips(k_passes[i * L:(i + 1) * L],
                               p_passes[i * L:(i + 1) * L], L)
                  for i in range(passes)]
        deltas += [router_delta(k_passes[i * L:(i + 1) * L],
                                p_passes[i * L:(i + 1) * L], pflips[i])
                   for i in range(passes)]
        pass_first = {"classify": first_flips(
            [f for fl in pflips[:cls_passes] for f in fl]),
            "embed": first_flips([f for fl in pflips[cls_passes:]
                                  for f in fl])}
        by_layer = {}
        for fl in [p[-1] for p in probe] + pflips:
            for f in fl:
                by_layer[f[0]] = by_layer.get(f[0], 0) + 1
        decisions = (sum(int(r["chosen"].shape[0]) for r in k_passes)
                     + sum(len(p[1]) for p in probe) * L)
        firsts = sorted(f[3] for p in probe for row in p[1]
                        for f in first_flips(p[-1], row)
                        if f[3] is not None)
        clean = [e for p in probe for row, e in zip(p[1], p[0])
                 if not first_flips(p[-1], row)]
        print(f"{arch} router flips (tokens whose experts differ, kernel vs "
              f"plain path) by layer: {dict(sorted(by_layer.items()))} over "
              f"{decisions} token-layer decisions; router-logit "
              "difference up to each row's (pass's) first flip: max "
              f"{max(deltas):.4g}; decode rows without a "
              f"flip: max rel. L2 err {max(clean, default=0.0):.3g}; "
              "first-flip plain margins of decode rows "
              f"{[float(f'{m:.4g}') for m in firsts]}; of the "
              f"CLASSIFY pass: {fmt_flips(pass_first['classify']) or 'none'};"
              f" of the EMBED pass: {fmt_flips(pass_first['embed']) or 'none'}"
              f" (band {ROUTER_MARGIN_TOL})")
    for step, row, e, first, ok in bad:
        print(f"{arch} decode step {step} row {row}: rel. L2 err {e:.3g} past "
              f"{tol['decode_logits_rel']}; "
              + (f"excused by {fmt_flips(first)}" if ok else
                 f"first flips: {fmt_flips(first) or 'none'}: NOT excused"))
    for kind, ok in pass_ok.items():
        if not ok:
            first = pass_first.get(kind, [])
            print(f"{arch} {kind} pass past its gate; "
                  + (f"excused by {fmt_flips(first)}" if explained(first)
                     else f"first flips: {fmt_flips(first) or 'none'}: NOT "
                     "excused"))
    unexcused = ([b for b in bad if not b[4]]
                 + [k for k, ok in pass_ok.items()
                    if not ok and not explained(pass_first.get(k, []))])
    if unexcused:
        fail(f"{arch}: the kernel-served and plain-served results disagree")

    # 5. profile one served batch: device busy share and top kernels
    marks.append(("gates", time.perf_counter()))
    profile_served(torch, eng, reqs)
    marks.append(("profile", time.perf_counter()))

    # 6. time each kernel at the served inputs with the most work (K1: the
    #    decode step with the most valid keys; K2: the largest pass) and at
    #    the model's long shapes, beside its plain version, its bound and
    #    SDPA
    if not k1_passes or not k2_passes:
        fail(f"{arch}: the served path launched a kernel no time")
    k1_keys = [int(a[3].clamp(max=a[1].shape[1]).sum())
               for _, a, _ in k1_passes]
    k1_served = k1_passes[k1_keys.index(max(k1_keys))]
    k2_served = max(k2_passes, key=lambda p: math.prod(p[0]))
    rows = []
    for name, (_, args, kw) in (("decode_attention", k1_served),
                                ("flash_attention", k2_served)):
        t = (time_decode(torch, dec_ops, *args) if name == "decode_attention"
             else time_flash(torch, flash_ops, *args, **kw))
        err = gate_err(name, t.pop("max_abs_err"), args[0].dtype)
        errs[name] = max(errs[name], err)
        rows.append(kernel_row(name, launches[name], errs[name], t))
    if kc_best[0] is not None:
        t = time_chunked(torch, flash_ops, f"{arch} served", *kc_best[0])
        del t["launches"]            # the checked call's: the row has the
        rows.append(kernel_row(      # served path's count
            "flash_attention_chunked", launches["flash_attention_chunked"],
            t.pop("max_abs_err"), t))
    marks.append(("K1 / K2 timing", time.perf_counter()))
    if arch == "proxy-8b":
        print_roofline(eng, {"decode": step_ms, "prefill": prefill_ms})
        marks.append(("roofline", time.perf_counter()))
    print(f"{arch} phase seconds: " + ", ".join(
        f"{a} {t1 - t0:.1f}" for (_, t0), (a, t1) in zip(marks, marks[1:])))
    return rows


def print_roofline(eng, step_ms):
    """(c) ``backend_roofline()`` after the served batch: each step kind's
    counted FLOPs (K1 / K2 by their reported work), bytes, roofline times
    and MFU bound beside the measured median step.  Gates: FLOPs > 0 and
    0 <= mfu_bound <= 1."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    launched = dec_ops.LAUNCHES + flash_ops.LAUNCHES
    t0 = time.perf_counter()
    rep = eng.backend_roofline()
    launched = dec_ops.LAUNCHES + flash_ops.LAUNCHES - launched
    if set(rep) != {"prefill", "decode"}:
        fail(f"backend_roofline kinds {sorted(rep)}")
    for kind, r in rep.items():
        med = statistics.median(step_ms[kind]) if step_ms[kind] else \
            float("nan")
        by = r["detail"]["flops_by_path"]
        print(f"roofline {r['arch']} {r['shape']}: tokens/step "
              f"{r['tokens_per_step']}, FLOPs {r['hlo_flops_per_dev']:.4g} "
              f"(dots {by.get('dot', 0):.4g}, K1 "
              f"{by.get('decode_attention', 0):.4g}, K2 "
              f"{by.get('flash_attention', 0):.4g}), bytes "
              f"{r['hlo_bytes_per_dev']:.4g}, t_compute "
              f"{r['t_compute_s'] * 1e3:.4f} ms, t_memory "
              f"{r['t_memory_s'] * 1e3:.4f} ms, bound {r['bottleneck']}, "
              f"mfu_bound {r['mfu_bound']:.4f}; measured median step "
              f"{med:.3f} ms; {card_line()}")
        if not (r["hlo_flops_per_dev"] > 0 and 0.0 <= r["mfu_bound"] <= 1.0):
            fail(f"backend_roofline {kind}: FLOPs "
                 f"{r['hlo_flops_per_dev']} mfu_bound {r['mfu_bound']}")
    print(f"roofline: analysis took {time.perf_counter() - t0:.1f} s "
          f"({launched} K1 / K2 launches of its own)")


def gate_err(name, err, dtype):
    """Fail unless a timed launch agreed with its plain version."""
    tol = TOL[str(dtype).split(".")[-1]]
    if not err <= tol:
        fail(f"{name} disagrees with its plain version on the timed "
             f"inputs: {err} > {tol}")
    return err


# ---------------------------------------------------------------------------
# rwkv6-1.6b and recurrentgemma-9b on the engine's static path (K5; K4, K2
# and K1 at hd 256)
# ---------------------------------------------------------------------------


def clone_tree(tree):
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    return tree.clone()


@contextlib.contextmanager
def kernel_impls(impl):
    """Every kernel of the model path at ``impl``: "auto" launches the
    kernels, "reference" runs their plain versions."""
    from repro_torch.models import attention, blocks
    with attention.use_flash_impl(impl), attention.use_decode_impl(impl), \
            blocks.use_scan_impl(impl):
        yield


def rel_rows(a, b) -> float:
    """Largest relative L2 error of a row of ``a`` against ``b``."""
    return float(((a.float() - b.float()).norm(dim=-1)
                  / b.float().norm(dim=-1)).max())


def serve_static(torch, arch, kernels, per_pass, per_step, kinds=None):
    """Serve the mixed batch (its requests of ``kinds``, all if None) with
    ``arch`` at full width on the static path through the kernels, then
    through their plain versions, and gate on launch counts, well-formed
    results and kernel-vs-plain agreement (every prefill's logits,
    decode-step logits on the same state, CLASSIFY logprobs, EMBED
    cosine).  ``kernels`` maps each kernel name to (ops module, wrapper
    name); ``per_pass`` / ``per_step`` give its launches per
    full-sequence pass and per decode step.  Returns the engine, the first
    launch of each kernel in each run of launches of one shape in a pass
    ({name: [(args, kwargs), ...]}), the launch counts and {"passes": n,
    "steps": n}."""
    from repro_torch.inference.engine import TorchInferenceEngine
    from repro_torch.inference import tokenizer as tok
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = TorchInferenceEngine(arch, smoke=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = eng.cfg
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"engine: {cfg.name} {cfg.num_layers} layers "
          f"({'+'.join(cfg.period)} x {cfg.num_periods}"
          f"{' + ' + '+'.join(cfg.tail) if cfg.tail else ''}) d_model "
          f"{cfg.d_model} d_ff {cfg.d_ff} vocab {cfg.vocab_size} "
          f"{cfg.dtype}, {n_params / 1e9:.2f} B params, backend "
          f"{eng.backend}, built in {time.perf_counter() - t0:.1f} s; "
          "depth not cut")
    if eng.backend != "static":
        fail(f"{arch} is not on the static path")
    reqs = [r for r in requests(arch) if kinds is None or r.kind in kinds]
    eng.submit_batch(reqs[:1] + reqs[-1:])          # warm-up
    model = eng.model
    modes = []
    step_ms = []

    def counted(params, batch, *, mode, cache=None):
        modes.append(mode)                  # launches below key on len()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.apply(params, batch, mode=mode, cache=cache)
        torch.cuda.synchronize()
        if mode == "decode":
            step_ms.append((time.perf_counter() - t) * 1e3)
        return out

    first = {}
    spies = []
    for name, (mod, fn) in kernels.items():
        first[name], rec = first_launch_per_pass(
            lambda a: (len(modes), tuple(a[0].shape), tuple(a[1].shape)))
        spies.append(Spy(mod, fn, rec))
        mod.LAUNCHES = 0
    lps, scores, ids = [], [], []
    eng.model = dataclasses.replace(model, apply=counted)
    try:
        with contextlib.ExitStack() as stack:
            for spy in spies:
                stack.enter_context(spy)
            stack.enter_context(Spy(eng, "_sequence_logprob",
                                    lambda a, kw, out: lps.extend(out[0])))
            stack.enter_context(Spy(eng, "_prefill",
                                    lambda a, kw, out: scores.append(out[0])))
            stack.enter_context(Spy(tok, "decode",
                                    lambda a, kw, out: ids.append(list(a[0]))))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results = eng.submit_batch(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        eng.model = model
    launches = {name: mod.LAUNCHES for name, (mod, _) in kernels.items()}
    check_results(reqs, results)
    passes = sum(m != "decode" for m in modes)
    steps = sum(m == "decode" for m in modes)
    expect = {name: per_pass[name] * passes + per_step[name] * steps
              for name in kernels}
    med = statistics.median(step_ms) if step_ms else float("nan")
    print(f"{arch} served {len(reqs)} requests in {wall:.3f} s: {passes} "
          f"full-sequence passes, {steps} decode steps (median "
          f"{med:.3f} ms)")
    print(f"{arch} launches: {launches}, expected {expect}")
    if launches != expect or min(launches.values()) == 0:
        fail(f"{arch}: kernel launch counts differ from the served path's "
             "passes and steps")

    # the same batch through the plain versions; each decode step's
    # logits computed both ways on copies of the same state
    probe = []
    ref_lps, ref_scores, ref_ids = [], [], []

    def probed(params, batch, *, mode, cache=None):
        if mode == "decode":
            with kernel_impls("auto"):
                hk = model.apply(params, batch, mode=mode,
                                 cache=clone_tree(cache))["hidden"]
            hp = model.apply(params, batch, mode=mode,
                             cache=clone_tree(cache))["hidden"]
            lk = model.logits_of(params, hk[:, 0])
            lp = model.logits_of(params, hp[:, 0])
            probe.append((rel_rows(lk, lp), max_err(lk, lp),
                          int((lk.argmax(-1) == lp.argmax(-1)).sum()),
                          lk.shape[0]))
        return model.apply(params, batch, mode=mode, cache=cache)

    eng.model = dataclasses.replace(model, apply=probed)
    try:
        with kernel_impls("reference"), \
                Spy(eng, "_sequence_logprob",
                    lambda a, kw, out: ref_lps.extend(out[0])), \
                Spy(eng, "_prefill",
                    lambda a, kw, out: ref_scores.append(out[0])), \
                Spy(tok, "decode",
                    lambda a, kw, out: ref_ids.append(list(a[0]))):
            ref_results = eng.submit_batch(reqs)
    finally:
        eng.model = model
    check_results(reqs, ref_results)
    tol = SERVE_TOL[arch]
    classify = any(r.kind == "classify" for r in reqs)
    if (len(lps) != len(ref_lps) or bool(lps) != classify or not probe
            or not scores or len(scores) != len(ref_scores)):
        fail(f"{arch}: the served path ran no CLASSIFY pass, no prefill or "
             "no decode step, or the two runs prefilled differently")
    score_rel = max(rel_rows(a, b) for a, b in zip(scores, ref_scores))
    logits_rel = max(p[0] for p in probe)
    logits_abs = max(p[1] for p in probe)
    top1 = (sum(p[2] for p in probe), sum(p[3] for p in probe))
    d_lp = max((abs(a - b) for a, b in zip(lps, ref_lps)), default=0.0)
    cos = min(sum(x * y for x, y in zip(a.embedding, b.embedding))
              for a, b in zip(results, ref_results) if a.kind == "embed")
    d_score = max((abs(a.score - b.score) for a, b in
                   zip(results, ref_results) if a.kind == "score"),
                  default=0.0)
    agree = []
    for a, b in zip(ids, ref_ids):
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        agree.append(f"{n}/{max(len(a), len(b))}")
    print(f"{arch} kernel vs plain: prefill logits over {len(scores)} "
          f"passes max rel. L2 err {score_rel:.3g} (tol "
          f"{tol['score_logits_rel']}), SCORE max |diff| {d_score:.3g}; "
          f"decode-step logits over {len(probe)} steps max rel. L2 err "
          f"{logits_rel:.3g} (tol {tol['decode_logits_rel']}), max |err| "
          f"{logits_abs:.3g}, same top-1 token {top1[0]}/{top1[1]} rows")
    print(f"{arch} kernel vs plain: CLASSIFY label logprobs {len(lps)} "
          f"pairs max |err| {d_lp:.3g} nats (tol "
          f"{tol.get('classify_logprob', 'none: no CLASSIFY')}); EMBED min "
          f"cosine {cos:.6f} (tol {tol['embed_cosine']}); COMPLETE leading "
          f"tokens equal {agree} (not gated)")
    if not (score_rel <= tol["score_logits_rel"]
            and logits_rel <= tol["decode_logits_rel"]
            and (not classify or d_lp <= tol["classify_logprob"])
            and cos >= tol["embed_cosine"]):
        fail(f"{arch}: the kernel-served and plain-served results disagree")
    profile_served(torch, eng, reqs)
    print(f"{arch}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    return (eng, {name: [(a, kw) for _, a, kw in first[name]]
                  for name in kernels}, launches,
            {"passes": passes, "steps": steps})


def zoo_path(torch, errs):
    """The zoo's qk-norm, parallel-block and MoE decoders, each alone on
    the card at full width (depth cut only as ZOO_CUTS says), built from
    the seed in bf16 on the card and served through ``serve_and_check``:
    decode steps through K1, CLASSIFY and EMBED passes through K2.
    Returns their kernels-line rows."""
    from repro_torch.configs import base as cfgs
    from repro_torch.inference.engine import TorchInferenceEngine
    rows = []
    for arch in ZOO:
        cfg = full = cfgs.get_config(arch)
        if arch in ZOO_CUTS:
            n, why = ZOO_CUTS[arch]
            cfg = dataclasses.replace(full, num_layers=n)
            cut = f"depth cut to {n} of {full.num_layers} layers: {why}"
        else:
            cut = f"depth not cut ({full.num_layers} layers)"
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = TorchInferenceEngine(cfg, smoke=False, seed=SEED)
        torch.cuda.synchronize()
        built = time.perf_counter() - t0
        leaves = list(_leaves(eng.params))
        n_params = sum(t.numel() for t in leaves)
        n_bytes = sum(t.numel() * t.element_size() for t in leaves)
        feats = [f for f, on in (("qk-norm", cfg.qk_norm),
                                 ("LayerNorm", cfg.use_layernorm),
                                 ("parallel block", cfg.parallel_block),
                                 ("tied embedding", cfg.tie_embeddings))
                 if on]
        if cfg.moe is not None:
            m = cfg.moe
            feats.append(f"MoE {m.num_experts} experts (padded to "
                         f"{m.padded_num_experts}) top-{m.num_experts_per_tok}"
                         + (", fused shared expert" if m.num_shared_experts
                            else ""))
        print(f"engine: {arch} {cfg.num_layers} layers d_model {cfg.d_model} "
              f"heads {cfg.num_heads}/{cfg.num_kv_heads} hd {cfg.head_dim} "
              f"vocab {cfg.vocab_size} rope theta {cfg.rope_theta:g} "
              f"{cfg.dtype} [{', '.join(feats) or 'dense'}], "
              f"{n_params / 1e9:.2f} B params, {n_bytes / 1e9:.1f} GB, "
              f"backend {eng.backend}, built in {built:.1f} s; {cut}")
        if eng.cfg != dataclasses.replace(full, num_layers=cfg.num_layers):
            fail(f"{arch} is not at full width")
        t0 = time.perf_counter()
        got = serve_and_check(torch, eng, errs)
        if cfg.head_dim == 160:           # K1 and K2 at hd 160's full shapes
            got = [r | full_shapes(torch, r["name"], cfg) for r in got]
        rows += [r | {"path": arch} for r in got]
        print(f"{arch}: phase {time.perf_counter() - t0:.1f} s, peak device "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del eng, leaves
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def full_shapes(torch, name, cfg):
    """Kernel ``name`` (K1 or K2) timed at the model's full attention
    shapes, as ``long_shapes`` times proxy-8b's: K1 over a full 512-slot
    cache of 8 rows, K2 over an 8-row, 384-token prefill.  Returns the
    timings as ``full_*`` keys of the kernel's row."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    if name == "decode_attention":
        t = time_decode(torch, dec_ops, r(8, 1, H, hd), r(8, 512, KV, hd),
                        r(8, 512, KV, hd),
                        torch.full((8,), 512, dtype=torch.int32, device=dev))
    else:
        t = time_flash(torch, flash_ops, r(8, 384, H, hd), r(8, 384, KV, hd),
                       r(8, 384, KV, hd), iters=20)
    gate_err(name, t.pop("max_abs_err"), torch.bfloat16)
    return {f"full_{k}": v for k, v in t.items()}


def whisper_path(torch, errs):
    """whisper-base served at full width and depth on the static path
    (frames from the requests; every attention through K2 or K1), then
    K2 timed at each of its served shapes (the encoder's self-attention,
    the decoder's causal self-attention, the cross-attention of a pass and
    of a decode step) and K1 at its served decode step.  Returns their
    kernels-line rows."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    E, L, Se = 6, 6, 1500
    eng, calls, launches, counts = serve_static(
        torch, "whisper-base",
        {"flash_attention": (flash_ops, "flash_attention_cuda"),
         "decode_attention": (dec_ops, "decode_attention_cuda")},
        {"flash_attention": E + 2 * L, "decode_attention": 0},
        {"flash_attention": L, "decode_attention": L})
    cfg = eng.cfg
    if (cfg.encoder_layers, cfg.num_layers, cfg.encoder_seq,
            cfg.d_model) != (E, L, Se, 512):
        fail("whisper-base is not at full width and depth")
    passes, steps = counts["passes"], counts["steps"]
    kinds = {"encoder self-attention": (lambda q, k: q == k == Se, E * passes),
             "decoder self-attention": (lambda q, k: q == k != Se,
                                        L * passes),
             "cross-attention, a pass": (lambda q, k: 1 < q != k == Se,
                                         L * passes),
             "cross-attention, a decode step": (lambda q, k: q == 1 < k == Se,
                                                L * steps)}
    rows = []
    for what, (match, n) in kinds.items():
        got = [c for c in calls["flash_attention"]
               if match(c[0][0].shape[1], c[0][1].shape[1])]
        if not got:
            fail(f"whisper-base: no served K2 launch of the {what}")
        args, kw = most_work(got, lambda a: a[0].numel() * a[1].shape[1])
        print(f"whisper-base K2, {what}:")
        t = time_flash(torch, flash_ops, *args, **kw, rel_tol=None
                       if kw["causal"] else CROSS_REL_TOL)
        err = gate_err("K2", t.pop("max_abs_err"), args[0].dtype)
        errs["flash_attention@cross"] = max(
            errs.get("flash_attention@cross", 0.0), err)
        rows.append(kernel_row("flash_attention", n, err, t,
                               path=f"whisper-base: {what}"))
    if sum(r["launches"] for r in rows) != launches["flash_attention"]:
        fail("whisper-base: K2 launches by shape do not add up")
    d_args, _ = most_work(calls["decode_attention"],
                          lambda a: int(a[3].clamp(max=a[1].shape[1]).sum()))
    t = time_decode(torch, dec_ops, *d_args)
    err = gate_err("K1", t.pop("max_abs_err"), d_args[0].dtype)
    errs["decode_attention"] = max(errs["decode_attention"], err)
    rows.append(kernel_row("decode_attention", launches["decode_attention"],
                           err, t, path="whisper-base"))
    del eng, calls
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def qwen2_vl_path(torch, errs):
    """qwen2-vl-7b served at full width and depth on the static path: its
    COMPLETE and EMBED requests (16 patches from each request before the
    text, M-RoPE positions; K2 over the P + L tokens of a pass, K1 at
    every decode step), then its SCORE and CLASSIFY, which raise as the
    JAX engine's do (TypeError: the prefill's P + L positions overrun the
    cache sized for L; KeyError: CLASSIFY's pass builds no patches).  K1
    and K2 are timed at their served inputs with the most work.  Returns
    their kernels-line rows."""
    from repro_torch.inference.backend import CLASSIFY, COMPLETE, EMBED, SCORE
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    L = 28
    eng, calls, launches, _ = serve_static(
        torch, "qwen2-vl-7b",
        {"flash_attention": (flash_ops, "flash_attention_cuda"),
         "decode_attention": (dec_ops, "decode_attention_cuda")},
        {"flash_attention": L, "decode_attention": 0},
        {"flash_attention": 0, "decode_attention": L},
        kinds=(COMPLETE, EMBED))
    cfg = eng.cfg
    if (cfg.num_layers, cfg.d_model, cfg.mrope_sections) != (
            L, 3584, (16, 24, 24)):
        fail("qwen2-vl-7b is not at full width and depth")
    for kind, exc in ((SCORE, TypeError), (CLASSIFY, KeyError)):
        req = [r for r in requests("qwen2-vl-7b") if r.kind == kind][:1]
        try:
            eng.submit_batch(req)
        except exc as e:
            print(f"qwen2-vl-7b {kind} raises {type(e).__name__}: {e} "
                  "(as the JAX engine does)")
        else:
            fail(f"qwen2-vl-7b {kind} did not raise {exc.__name__}")
    rows = []
    f_args, f_kw = most_work(calls["flash_attention"],
                             lambda a: a[0].numel())
    t = time_flash(torch, flash_ops, *f_args, **f_kw)
    err = gate_err("K2", t.pop("max_abs_err"), f_args[0].dtype)
    errs["flash_attention"] = max(errs["flash_attention"], err)
    rows.append(kernel_row("flash_attention", launches["flash_attention"],
                           err, t, path="qwen2-vl-7b"))
    d_args, _ = most_work(calls["decode_attention"],
                          lambda a: int(a[3].clamp(max=a[1].shape[1]).sum()))
    t = time_decode(torch, dec_ops, *d_args)
    err = gate_err("K1", t.pop("max_abs_err"), d_args[0].dtype)
    errs["decode_attention"] = max(errs["decode_attention"], err)
    rows.append(kernel_row("decode_attention", launches["decode_attention"],
                           err, t, path="qwen2-vl-7b"))
    del eng, calls
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# training: launch/train.py at full width with a checkpoint and a resume,
# then one loss_fn backward through the kernels against the plain path
# (K2; K4, K2 with a window at hd 256; K5; K2 without the mask, Sq != Skv)
# ---------------------------------------------------------------------------


def remat_launches(cfg):
    """K2, K4, K5 launches of one loss_fn backward of one microbatch with
    remat: two for each layer whose period runs under activation
    checkpointing (its forward and the recompute), one for a tail layer
    and for a whisper encoder layer, which do not."""
    from repro_torch.configs import base as cfgs
    got = {"flash_attention": 0, "rglru_scan": 0, "rwkv6_scan": 0}
    if cfg.is_encoder_decoder:
        got["flash_attention"] = cfg.encoder_layers + 2 * 2 * cfg.num_layers
        return got
    kernel = {cfgs.ATTN: "flash_attention", cfgs.LOCAL_ATTN:
              "flash_attention", cfgs.RGLRU: "rglru_scan",
              cfgs.RWKV: "rwkv6_scan"}
    n_body = cfg.num_periods * len(cfg.period)
    for layer, blk in enumerate(cfg.block_pattern):
        got[kernel[blk]] += 2 if layer < n_body else 1
    return got


def named_leaves(tree, prefix=""):
    """(path, tensor) pairs in the order of ``optim.leaves``."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in named_leaves(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [kv for i, v in enumerate(tree)
                for kv in named_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def train_kernels():
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
    return {"flash_attention": flash_ops, "rglru_scan": rglru_ops,
            "rwkv6_scan": rwkv_ops}


def zero_launches(mods):
    for m in mods.values():
        m.LAUNCHES = 0
        if hasattr(m, "REVERSE_LAUNCHES"):
            m.REVERSE_LAUNCHES = 0


def launch_counts(mods):
    """Each kernel's launches, K4's reverse (its backward) apart."""
    got = {n: m.LAUNCHES for n, m in mods.items()}
    got["rglru_scan_bwd"] = mods["rglru_scan"].REVERSE_LAUNCHES
    return got


def device_busy(events):
    """(busy ns: the union of the events' intervals, {name: (n, ns)})."""
    spans, by_name = [], {}
    for name, t, d in events:
        spans.append((t, t + d))
        n, total = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, total + d)
    if not spans:
        return 0, by_name
    spans.sort()
    busy, (lo, hi) = 0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy += hi - lo
            lo, hi = a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo, by_name


def profile_step(torch, what, fn, share_of=None):
    """One call of ``fn`` under the profiler: wall time, device busy time
    and idle share, and the device work that took most of it.  Returns
    the idle share, and with ``share_of`` also the share of the busy time
    spent in kernels whose name holds that string (None, None where no
    device time was recorded)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, by_name = device_busy(device_events(prof))
    if not busy:
        print(f"profile {what}: no device time recorded (not measured)")
        return (None, None) if share_of else None
    idle = 1 - busy / 1e9 / wall
    print(f"profile {what}: wall {wall * 1e3:.1f} ms (profiler on), device "
          f"busy {busy / 1e6:.1f} ms, idle share {idle:.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, total) in top[:8]:
        print(f"  {total / 1e6:9.3f} ms {n:6d}x  {name[:90]}")
    if not share_of:
        return idle
    ns = sum(total for name, (_, total) in by_name.items() if share_of in name)
    print(f"  {share_of}: {ns / 1e6:.3f} ms, {ns / busy:.4f} of the busy time")
    return idle, ns / busy


def train_batch(torch, cfg, B, S, dev, seed=SEED):
    """Step 0 of the token pipeline on the card; whisper's frames drawn
    from a generator seeded with ``seed``."""
    from repro_torch.train.data import TokenPipeline
    pipe = TokenPipeline(cfg.vocab_size, seq_len=S, global_batch=B,
                         seed=seed)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in pipe.batch_at(0).items()}
    if cfg.frontend == "frames":
        gen = torch.Generator(device=dev).manual_seed(seed)
        batch["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                      generator=gen, device=dev)
    return batch


def launch_run(torch):
    """launch/train.py for proxy-8b at full width (TRAIN_LAYERS layers):
    TRAIN_CKPT_EVERY steps and their checkpoint, restored and held to the
    trained state bit for bit, then a second run on the same directory
    that resumes from it and runs to TRAIN_STEPS.  The loss must fall
    within each run and from the first step to the last.  Returns the K2
    launches of both runs, the step time and the peak memory."""
    import shutil
    import tempfile
    from repro_torch import bridge
    from repro_torch.launch import train
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.optim import leaves
    mods = train_kernels()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckdir:
        free = shutil.disk_usage(ckdir).free
        print(f"train: checkpoints in {ckdir} ({free / 1e9:.0f} GB free)")
        argv = ["--arch", "proxy-8b", "--no-smoke", "--layers",
                str(TRAIN_LAYERS), "--batch", str(TRAIN_B), "--seq",
                str(TRAIN_S), "--ckpt-dir", ckdir, "--ckpt-every",
                str(TRAIN_CKPT_EVERY), "--seed", str(SEED), "--lr",
                str(TRAIN_LR)]
        torch.cuda.reset_peak_memory_stats()
        zero_launches(mods)
        t0 = time.perf_counter()
        out = train.run(argv + ["--steps", str(TRAIN_CKPT_EVERY)])
        wall = time.perf_counter() - t0
        launches = {n: m.LAUNCHES for n, m in mods.items()}
        cfg, hist = out["cfg"], out["history"]
        peak = torch.cuda.max_memory_allocated() / 1e9
        if (cfg.d_model != 4096 or cfg.num_heads != 32
                or cfg.num_kv_heads != 8 or cfg.head_dim != 128
                or cfg.vocab_size != 128256
                or cfg.num_layers != TRAIN_LAYERS):
            fail("the launch run's proxy-8b is not at full width")
        n_params = sum(t.numel() for t in leaves(out["state"]["params"]))
        losses = [h["loss"] for h in hist]
        secs = [h["seconds"] for h in hist]
        print(f"train: launch/train.py proxy-8b {TRAIN_LAYERS} of "
              f"{N_LAYERS} layers, {n_params / 1e9:.2f} B params, B="
              f"{TRAIN_B} S={TRAIN_S}: {len(hist)} steps in {wall:.1f} s "
              f"(checkpoints included), losses "
              f"{[round(x, 4) for x in losses]}, step seconds "
              f"{[round(x, 3) for x in secs]}, peak {peak:.1f} GB, K2 "
              f"launches {launches['flash_attention']}")
        want = 2 * TRAIN_LAYERS * TRAIN_CKPT_EVERY
        if launches != {"flash_attention": want, "rglru_scan": 0,
                        "rwkv6_scan": 0}:
            fail(f"launch run: launches {launches}, want K2 {want} (2 a "
                 "layer a step, remat)")
        if not all(math.isfinite(x) for x in losses):
            fail(f"launch run: losses not finite: {losses}")
        if not losses[-1] < losses[0]:
            fail(f"launch run: loss did not fall: {losses}")
        mgr = CheckpointManager(ckdir)
        if mgr.all_steps() != [TRAIN_CKPT_EVERY]:
            fail(f"launch run: checkpoints {mgr.all_steps()}")
        t0 = time.perf_counter()
        state = out.pop("state")
        restored = bridge.state_from_jax(cfg, mgr.restore(
            TRAIN_CKPT_EVERY, bridge.state_dtypes(cfg, state)))
        read_s = time.perf_counter() - t0
        a_leaves, b_leaves = leaves(state), leaves(restored)
        if len(a_leaves) != len(b_leaves) or not all(
                a.dtype == b.dtype and torch.equal(a, b.to(a.device))
                for a, b in zip(a_leaves, b_leaves)):
            fail("launch run: the restored checkpoint differs from the "
                 "trained state")
        print(f"train: step {TRAIN_CKPT_EVERY} restored in {read_s:.1f} s, "
              f"equal to the trained state bit for bit ({len(a_leaves)} "
              "leaves)")
        del state, restored, a_leaves, b_leaves, out
        gc.collect()
        torch.cuda.empty_cache()
        zero_launches(mods)
        t0 = time.perf_counter()
        again = train.run(argv + ["--steps", str(TRAIN_STEPS)])
        wall2 = time.perf_counter() - t0
        k2_again = mods["flash_attention"].LAUNCHES
        rest = [h["loss"] for h in again["history"]]
        if (again["resumed_from"] != TRAIN_CKPT_EVERY
                or len(rest) != TRAIN_STEPS - TRAIN_CKPT_EVERY):
            fail(f"resumed run: resumed_from {again['resumed_from']}, "
                 f"{len(rest)} steps")
        if k2_again != 2 * TRAIN_LAYERS * len(rest):
            fail(f"resumed run: K2 launches {k2_again}")
        if (not all(math.isfinite(x) for x in rest) or not rest[-1] < rest[0]
                or not rest[-1] < losses[0]):
            fail(f"resumed run: losses {rest} not finite or not falling "
                 f"(first run {losses})")
        if mgr.all_steps() != [TRAIN_CKPT_EVERY, TRAIN_STEPS]:
            fail(f"resumed run: checkpoints {mgr.all_steps()}")
        secs += [h["seconds"] for h in again["history"]]
        print(f"train: resumed run from step {again['resumed_from']} in "
              f"{wall2:.1f} s (restore and checkpoint included), losses "
              f"{[round(x, 4) for x in rest]}")
        del again
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention": launches["flash_attention"] + k2_again,
            "step_s": statistics.median(secs[1:]), "peak_gb": peak}


def grad_cell(torch, arch, layers, B, S, dtype):
    """One loss_fn backward (``grad_accum`` microbatches as the config
    says) of ``arch`` at full width through the kernels and through their
    plain versions: launch counts, every leaf's gradient finite and nonzero
    and within TRAIN_GRAD_TOL (relative L2) of the plain path's; then
    GRAD_STEPS train steps through the kernels on the same batch, the
    loss finite and falling.  Returns the launches, times, memory and the
    inputs of each kernel's launch with the most work."""
    from repro_torch.configs import base as cfgs
    from repro_torch.models import model_zoo
    from repro_torch.train import optim, train_step
    dev = torch.device("cuda")
    cfg = dataclasses.replace(cfgs.get_config(arch), dtype=dtype)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = model_zoo.build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    batch = train_batch(torch, cfg, B, S, dev)
    step = train_step.make_train_step(
        model, optim.AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                 total_steps=GRAD_STEPS))
    accum = cfg.grad_accum_steps
    mods = train_kernels()
    calls = {n: [] for n in mods}
    want = {n: accum * c for n, c in remat_launches(cfg).items()}
    # K4's reverse: one a RG-LRU layer's backward, checkpointed or not
    want["rglru_scan_bwd"] = accum * cfg.block_pattern.count(cfgs.RGLRU)
    n_params = sum(t.numel() for t in optim.leaves(params))

    def grads(reference):
        zero_launches(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with kernel_impls("reference" if reference else "auto"):
            loss, _, g = step.grads(params, batch)
        loss = float(loss)
        return loss, g, time.perf_counter() - t0, launch_counts(mods)

    def keep(name):
        """Keep the inputs of the launch with the most work."""
        def record(args, kw, out):
            if not calls[name] or (args[0].numel()
                                   > calls[name][0][0][0].numel()):
                calls[name] = [([a.detach() for a in args], kw)]
        return record

    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as spies:
        for n in ("flash_attention", "rglru_scan", "rwkv6_scan"):
            spies.enter_context(Spy(mods[n], f"{n}_cuda", keep(n)))
        loss, g, dt, launches = grads(False)
    peak = torch.cuda.max_memory_allocated() / 1e9
    if launches != want:
        fail(f"{arch} train: launches {launches}, want {want} (2 a "
             f"checkpointed layer, 1 a tail / encoder layer, K4's reverse 1 "
             f"a RG-LRU layer, x {accum} microbatches)")
    ref_loss, ref_g, ref_dt, ref_launches = grads(True)
    if any(ref_launches.values()):
        fail(f"{arch} train: the plain path launched {ref_launches}")
    rels, bad = [], []
    top = max(float(b.float().abs().max()) for b in optim.leaves(ref_g))
    for (name, a), b in zip(named_leaves(g), optim.leaves(ref_g)):
        if a is None or not bool(torch.isfinite(a).all()):
            bad.append(f"{name}: missing or not finite")
        elif not bool((a != 0).any()):
            bad.append(f"{name}: zero")
        elif name.endswith("/bk"):
            # a key bias shifts every logit of a query alike and softmax
            # ignores the shift: its gradient is 0 in exact arithmetic,
            # rounding on both paths, held to the model's largest instead
            small = max(float(a.float().abs().max()),
                        float(b.float().abs().max()))
            if not small <= TRAIN_GRAD_TOL * top:
                bad.append(f"{name}: max {small:.3g} > {TRAIN_GRAD_TOL} x "
                           f"the largest ({top:.3g})")
        else:
            rels.append((rel_l2(a, b), name))
            if not rels[-1][0] <= TRAIN_GRAD_TOL:
                bad.append(f"{name}: rel. L2 {rels[-1][0]:.4g}")
    rels.sort(reverse=True)
    worst = ", ".join(f"{n} {r:.3g}" for r, n in rels[:3])
    del g, ref_g
    print(f"train grads: {arch} {cfg.num_layers} layers d_model "
          f"{cfg.d_model} {dtype}, {n_params / 1e9:.2f} B params, B={B} "
          f"S={S} x "
          f"{accum} microbatches: loss {loss:.4f} (plain {ref_loss:.4f}), "
          f"worst leaves' rel. L2 {worst} (tol {TRAIN_GRAD_TOL}; "
          f"{len(rels)} leaves), kernel path {dt:.2f} s, plain path "
          f"{ref_dt:.2f} s, launches {launches}, peak {peak:.1f} GB")
    if bad:
        fail(f"{arch} train: {len(bad)} gradient leaves fail against the "
             f"plain path: " + "; ".join(bad[:40]))
    state = {"params": params, "opt_state": optim.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    losses, secs = [], []
    for i in range(GRAD_STEPS):
        zero_launches(mods)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        secs.append(time.perf_counter() - t0)
        if launch_counts(mods) != want:
            fail(f"{arch} train step {i}: launches differ from {want}")
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        fail(f"{arch} train steps: losses {losses} not finite or not falling")
    idle = reverse_share = None
    if arch == "proxy-8b":
        idle = profile_step(torch, f"{arch} train step",
                            lambda: step(state, batch))
    elif arch == "recurrentgemma-9b":      # and K4's reverse in it
        idle, reverse_share = profile_step(
            torch, f"{arch} train step", lambda: step(state, batch),
            share_of="rglru_bwd_kernel")
    print(f"train steps: {arch} losses {[round(x, 4) for x in losses]}, "
          f"step seconds {[round(x, 3) for x in secs]}, peak "
          f"{step_peak:.1f} GB with fp32 moments")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "calls": calls, "step_s": secs,
            "peak_gb": step_peak, "idle": idle,
            "k4_reverse_share": reverse_share, "grads_s": dt,
            "plain_grads_s": ref_dt}


def train_path(torch, errs):
    """The training phase: ``launch_run`` then ``grad_cell`` for each of
    GRAD_CELLS; K2, K4 and K5 timed at the train path's launches with
    the most work.  Returns their kernels-line rows."""
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
    t0 = time.perf_counter()
    run = launch_run(torch)
    cells = {arch: grad_cell(torch, arch, *shape)
             for arch, shape in GRAD_CELLS.items()}
    card = card_line()
    print(f"train: phase took {time.perf_counter() - t0:.1f} s on {card}; "
          f"launch/train.py proxy-8b step {run['step_s']:.3f} s (median), "
          f"peak {run['peak_gb']:.1f} GB")
    for arch, cell in cells.items():
        idle = "not measured" if cell["idle"] is None else \
            f"{cell['idle']:.3f}"
        share = ("" if cell["k4_reverse_share"] is None else
                 f", K4's reverse {cell['k4_reverse_share']:.4f} of the busy "
                 "time")
        print(f"train: {arch} step {statistics.median(cell['step_s']):.3f} "
              f"s (median of {GRAD_STEPS}), peak {cell['peak_gb']:.1f} GB, "
              f"idle share {idle}{share}; one backward {cell['grads_s']:.2f} "
              f"s (plain path {cell['plain_grads_s']:.2f} s); {card}")
    rows = []
    for arch, cell in cells.items():
        for name, launched in cell["launches"].items():
            if not launched or name == "rglru_scan_bwd":
                continue        # its row is made beside K4's forward's
            (args, kw), = cell["calls"][name]
            if name == "flash_attention":
                t = time_flash(torch, flash_ops, *args, **kw, iters=20)
                err = gate_err("K2", t.pop("max_abs_err"), args[0].dtype)
            elif name == "rglru_scan":
                t, t_bwd = time_rglru(torch, rglru_ops, "train", *args,
                                      iters=20)
                err = t.pop("max_abs_err")
                errs["rglru_scan_bwd"] = max(errs["rglru_scan_bwd"],
                                             t_bwd["max_abs_err"])
                rows.append(kernel_row(
                    "rglru_scan_bwd", cell["launches"]["rglru_scan_bwd"],
                    t_bwd.pop("max_abs_err"), t_bwd, path=f"train {arch}",
                    step_s=statistics.median(cell["step_s"]),
                    peak_gb=cell["peak_gb"], idle_share=cell["idle"],
                    k4_reverse_share=cell["k4_reverse_share"]))
            else:
                t = time_rwkv(torch, rwkv_ops, "train", *args)
                err = t.pop("max_abs_err")
            errs[name] = max(errs[name], err)
            if arch == "proxy-8b":
                launched += run["flash_attention"]
            rows.append(kernel_row(
                name, launched, err, t, path=f"train {arch}",
                step_s=statistics.median(cell["step_s"]),
                peak_gb=cell["peak_gb"], idle_share=cell["idle"]))
    return rows


def most_work(calls, work):
    """The launch among ``calls`` with the most ``work(args)``."""
    return max(calls, key=lambda c: work(c[0]))


def kernel_row(name, launches, err, t, **extra):
    """A row of the kernels line for ``name`` (a key of KERNEL_FILES)."""
    src, tpu = KERNEL_FILES[name]
    return {"name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": launches, "max_abs_err": err, **t, **extra}


def rglru_bounds(a, needs=RGLRU_NEEDS):
    """K4's bounds (ms, by) forward and in reverse: a, b read in their
    type, hs written in fp32, h0 read and hT written; in reverse a, d_hs
    and (for da) hs read, da and db written in a's type, d_hT (and h0)
    read, dh0 written where asked for."""
    B, S, W = a.shape
    es, n = a.element_size(), B * S * W
    fwd = bound(2 * es * n + 4 * (n + 2 * B * W), 2.0 * n, "float32")
    bwd = bound((es + 4 + needs[0] * (4 + es) + needs[1] * es) * n
                + 4 * (1 + needs[0] + needs[2]) * B * W,
                (2.0 + needs[0]) * n + needs[2] * B * W, "float32")
    return fwd, bwd


def time_rglru(torch, rglru_ops, what, a, b, h0, iters=50):
    """K4 forward and in reverse (the gradients the model asks for,
    RGLRU_NEEDS) at one shape: each held to its plain version bit for bit,
    timed by events and by the profiler's device time, beside its plain
    version and its bound; the reverse also beside the plain recompute
    that was the backward before it (autograd of the plain forward).
    Returns the forward's and the reverse's timings."""
    from repro_torch.kernels.autograd import recompute_grads
    from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,
                                                    rglru_scan_ref)
    out = rglru_ops.rglru_scan_cuda(a, b, h0)
    ref = rglru_ops.rglru_scan(a, b, h0, impl="reference")
    err = max(max_err(out[0], ref[0]), max_err(out[1], ref[1]))
    if err != 0.0:
        fail(f"K4 {what}: differs from its plain version by {err}")
    B, S, W = a.shape
    gen = torch.Generator(device=a.device).manual_seed(SEED + 9)
    d_hs = torch.randn((B, S, W), generator=gen, device=a.device)
    d_hT = torch.randn((B, W), generator=gen, device=a.device)
    needs = RGLRU_NEEDS

    def reverse():
        return rglru_ops.rglru_scan_bwd_cuda(a, out[0], h0, d_hs, d_hT, needs)

    got = reverse()
    want = rglru_scan_bwd_ref(a, ref[0], h0, d_hs, d_hT)
    bwd_err = max(max_err(g, w) for g, w, n in zip(got, want, needs) if n)
    if bwd_err != 0.0:
        fail(f"K4 {what}: the reverse differs from the plain reverse by "
             f"{bwd_err}")
    del got, want
    ms = cuda_time_ms(lambda: rglru_ops.rglru_scan_cuda(a, b, h0), iters)
    dev_ms = device_ms(lambda: rglru_ops.rglru_scan_cuda(a, b, h0))
    plain_ms = cuda_time_ms(lambda: rglru_ops.rglru_scan(
        a, b, h0, impl="reference"), 3, warmup=1)
    bwd_ms = cuda_time_ms(reverse, iters)
    bwd_dev_ms = device_ms(reverse)
    bwd_plain_ms = cuda_time_ms(lambda: rglru_scan_bwd_ref(
        a, out[0], h0, d_hs, d_hT), 2, warmup=1)
    recompute_ms = cuda_time_ms(lambda: recompute_grads(
        rglru_scan_ref, (a, b, h0), needs, (d_hs, d_hT)), 2, warmup=1)
    (b_ms, b_by), (bb_ms, bb_by) = rglru_bounds(a)
    dt = str(a.dtype).split('.')[-1]
    print(f"time K4 rglru {what} B={B} S={S} W={W} {dt}: kernel {ms:.4f} "
          f"ms (device {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, library "
          f"none, bound {b_ms:.5f} ms ({b_by}); max|err| {err:.3g}")
    print(f"time K4 rglru reverse {what} B={B} S={S} W={W} {dt} (da, db): "
          f"kernel {bwd_ms:.4f} ms (device {fmt_ms(bwd_dev_ms)}), plain "
          f"reverse {bwd_plain_ms:.4f} ms, plain recompute (the backward "
          f"before) {recompute_ms:.4f} ms, library none, bound "
          f"{bb_ms:.5f} ms ({bb_by}); max|err| {bwd_err:.3g}")
    return ({"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
             "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
             "max_abs_err": err},
            {"ms": bwd_ms, "device_ms": bwd_dev_ms, "plain_ms": bwd_plain_ms,
             "recompute_ms": recompute_ms, "bound_ms": bb_ms,
             "bound_by": bb_by, "library_ms": None, "max_abs_err": bwd_err})


def time_rwkv(torch, rwkv_ops, what, r, k, v, w, u, s0, iters=20):
    out = rwkv_ops.rwkv6_scan_cuda(r, k, v, w, u, s0)
    ref = rwkv_ops.rwkv6_scan(r, k, v, w, u, s0, impl="reference")
    err = max(max_err(out[0], ref[0]), max_err(out[1], ref[1]))
    rel = max(rel_err(out[0], ref[0]), rel_err(out[1], ref[1]))
    if not rel <= TOL["float32"]:
        fail(f"K5 {what}: relative error {rel} against its plain version")
    B, S, H, hd = r.shape
    ms = cuda_time_ms(lambda: rwkv_ops.rwkv6_scan_cuda(r, k, v, w, u, s0),
                      iters)
    plain_ms = cuda_time_ms(lambda: rwkv_ops.rwkv6_scan(
        r, k, v, w, u, s0, impl="reference"), 2, warmup=1)
    dev_ms = device_ms(lambda: rwkv_ops.rwkv6_scan_cuda(r, k, v, w, u, s0))
    b_ms, b_by = rwkv_bound(r)
    print(f"time K5 rwkv6 {what} B={B} S={S} H={H} hd={hd} "
          f"{str(r.dtype).split('.')[-1]}: kernel {ms:.4f} ms (device "
          f"{fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, library none, bound "
          f"{b_ms:.5f} ms ({b_by}); max|err| {err:.3g}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "max_abs_err": err}


def rwkv_path(torch, errs):
    """rwkv6-1.6b served at full width; K5 timed at the served launch with
    the most work and at the full shape.  Returns K5's kernels-line row."""
    from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
    L = 24
    eng, calls, launches, _ = serve_static(
        torch, "rwkv6-1.6b", {"rwkv6_scan": (rwkv_ops, "rwkv6_scan_cuda")},
        {"rwkv6_scan": L}, {"rwkv6_scan": L})
    if eng.cfg.num_layers != L or eng.cfg.d_model != 2048:
        fail("rwkv6-1.6b is not at full width and depth")
    args, _ = most_work(calls["rwkv6_scan"], lambda a: a[0].numel())
    t = time_rwkv(torch, rwkv_ops, "served", *args)
    dev = args[0].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    B, S, H, hd = 8, 384, 32, 64
    r, k, v = (torch.randn((B, S, H, hd), generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    full = time_rwkv(torch, rwkv_ops, "full", r, k, v,
                     decays(torch, gen, (B, S, H, hd), dev),
                     torch.randn((H, hd), generator=gen, device=dev) * 0.1,
                     torch.zeros((B, H, hd, hd), device=dev))
    err = max(errs["rwkv6_scan"], t.pop("max_abs_err"),
              full.pop("max_abs_err"))
    errs["rwkv6_scan"] = err
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return [kernel_row("rwkv6_scan", launches["rwkv6_scan"], err, t,
                       path="rwkv6-1.6b", full_ms=full["ms"],
                       full_device_ms=full["device_ms"])]


def recurrentgemma_path(torch, errs):
    """recurrentgemma-9b served at full width; K4 and K2 / K1 at hd 256
    timed at the served launches with the most work and at the full
    shapes.  Returns their kernels-line rows."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    n_lru, n_local = 26, 12
    eng, calls, launches, _ = serve_static(
        torch, "recurrentgemma-9b",
        {"rglru_scan": (rglru_ops, "rglru_scan_cuda"),
         "flash_attention": (flash_ops, "flash_attention_cuda"),
         "decode_attention": (dec_ops, "decode_attention_cuda")},
        {"rglru_scan": n_lru, "flash_attention": n_local,
         "decode_attention": 0},
        {"rglru_scan": 0, "flash_attention": 0, "decode_attention": n_local})
    cfg = eng.cfg
    if (cfg.num_layers != 38 or cfg.d_model != 4096
            or cfg.block_pattern.count("rglru") != n_lru
            or cfg.block_pattern.count("local") != n_local):
        fail("recurrentgemma-9b is not at full width and depth")
    rows = []
    a_args, _ = most_work(calls["rglru_scan"], lambda a: a[0].numel())
    t, t_bwd = time_rglru(torch, rglru_ops, "served", *a_args)
    dev = a_args[0].device
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    B, S, W = 8, 384, 4096
    full, full_bwd = time_rglru(
        torch, rglru_ops, "full", decays(torch, gen, (B, S, W), dev),
        torch.randn((B, S, W), generator=gen, device=dev),
        torch.zeros((B, W), device=dev))
    err = max(errs["rglru_scan"], t.pop("max_abs_err"),
              full.pop("max_abs_err"))
    errs["rglru_scan"] = err
    errs["rglru_scan_bwd"] = max(errs["rglru_scan_bwd"], t_bwd["max_abs_err"],
                                 full_bwd["max_abs_err"])
    rows.append(kernel_row(
        "rglru_scan", launches["rglru_scan"], err, t,
        path="recurrentgemma-9b", full_ms=full["ms"],
        full_device_ms=full["device_ms"], reverse_ms=t_bwd["ms"],
        reverse_device_ms=t_bwd["device_ms"],
        reverse_bound_ms=t_bwd["bound_ms"],
        full_reverse_ms=full_bwd["ms"],
        full_reverse_device_ms=full_bwd["device_ms"],
        full_reverse_bound_ms=full_bwd["bound_ms"]))

    def r(*shape):
        return torch.randn(shape, generator=gen,
                           device=dev).to(torch.bfloat16)

    f_args, f_kw = most_work(calls["flash_attention"],
                             lambda a: a[0].numel())
    t = time_flash(torch, flash_ops, *f_args, **f_kw)
    full = time_flash(torch, flash_ops, r(8, 384, 16, 256),
                      r(8, 384, 1, 256), r(8, 384, 1, 256), window=2048,
                      iters=20)
    err = max(errs["flash_attention@hd256"],
              gate_err("K2", t.pop("max_abs_err"), f_args[0].dtype),
              gate_err("K2", full.pop("max_abs_err"), torch.bfloat16))
    rows.append(kernel_row("flash_attention", launches["flash_attention"],
                           err, t, path="recurrentgemma-9b",
                           full_ms=full["ms"],
                           full_device_ms=full["device_ms"]))
    d_args, _ = most_work(calls["decode_attention"],
                          lambda a: int(a[3].clamp(max=a[1].shape[1]).sum()))
    t = time_decode(torch, dec_ops, *d_args)
    full = time_decode(torch, dec_ops, r(8, 1, 16, 256), r(8, 2048, 1, 256),
                       r(8, 2048, 1, 256),
                       torch.full((8,), 2048, dtype=torch.int32, device=dev))
    err = max(errs["decode_attention@hd256"],
              gate_err("K1", t.pop("max_abs_err"), d_args[0].dtype),
              gate_err("K1", full.pop("max_abs_err"), torch.bfloat16))
    rows.append(kernel_row("decode_attention", launches["decode_attention"],
                           err, t, path="recurrentgemma-9b",
                           full_ms=full["ms"],
                           full_device_ms=full["device_ms"]))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# K3: similarity top-k, and the semantic index over the served engine
# ---------------------------------------------------------------------------


def topk_gate(torch, what, vals, idx, rv, ri, exact=False):
    """Hold K3's (vals, idx) [Q,k] to the plain version's (rv, ri), which
    carries one column more unless ``exact``.  Prints each id flip with
    its margin and fails on a flip outside TOPK_TOL (any flip if
    ``exact``) or a value off by more; returns max |value error|."""
    from repro_torch.kernels.similarity_topk.ref import topk_flips
    vals, idx, rv, ri = (torch.as_tensor(x).cpu() for x in (vals, idx, rv,
                                                           ri))
    k = idx.shape[1]
    want = rv[:, :k].double()
    both_inf = torch.isinf(want) & (vals.double() == want)
    err = torch.where(both_inf, torch.zeros_like(want),
                      (vals.double() - want).abs())
    err = float(err.max()) if err.numel() else 0.0
    flips = topk_flips(idx, rv, ri)
    for r, pos, got, exp, margin in flips:
        print(f"  K3 flip {what}: query {r} position {pos}: kernel id "
              f"{got}, plain id {exp}, plain margin {margin:.3g}")
    if exact and (flips or err):
        fail(f"K3 {what}: {len(flips)} ids / values differ from the plain "
             "version on exact scores")
    bad = [f for f in flips if not f[-1] < TOPK_TOL]
    if bad or not err <= TOPK_TOL:
        fail(f"K3 {what}: max |err| {err:.3g}, {len(bad)} flips outside "
             f"margin {TOPK_TOL}")
    return err, len(flips)


def topk_case(torch, topk_ops, what, q, c, k, exact=False):
    """K3 on (q, c) against its plain version on the same inputs, and
    against itself: a second launch must give the same bits."""
    vals, idx = topk_ops.similarity_topk(q, c, k)
    again = topk_ops.similarity_topk(q, c, k)
    rv, ri = topk_ops.similarity_topk(q, c, k + (not exact),
                                      impl="reference")
    torch.cuda.synchronize()
    if not (torch.equal(vals, again[0]) and torch.equal(idx, again[1])):
        fail(f"K3 {what}: two launches on the same inputs differ")
    err, flips = topk_gate(torch, what, vals, idx, rv, ri, exact=exact)
    print(f"K3 topk {what}: max|vals-plain|={err:.3g} (tol {TOPK_TOL}), "
          f"{flips} id flips within margin, repeat bitwise equal")
    return err


def check_topk(torch, topk_ops, dev):
    """K3 at the shapes of tests/test_kernels.py (fp32 and bf16 inputs), a
    k > N case, both selection paths, and sign vectors whose scores are
    exact: there every tie is decided by the tie rule alone."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for Q, N, D, k in ((13, 201, 48, 5), (32, 512, 64, 17),
                           (1, 1000, 32, 1), (64, 64, 128, 64),
                           (3, 4, 16, 7), (24, 5000, 64, 300)):
            q = torch.randn((Q, D), generator=gen, device=dev).to(dtype)
            c = torch.randn((N, D), generator=gen, device=dev).to(dtype)
            err = max(err, topk_case(torch, topk_ops,
                                     f"{name} Q={Q} N={N} D={D} k={k}",
                                     q, c, k))
    signs = (torch.randint(0, 2, (2000, 16), generator=gen, device=dev)
             * 2 - 1).float()
    signs[1000:1020] = signs[7]                    # exact duplicate rows
    q = torch.cat([signs[:8], (torch.randint(
        0, 2, (56, 16), generator=gen, device=dev) * 2 - 1).float()])
    for k in (1, 8, 32, 100, 128, 129, 2000):
        err = max(err, topk_case(torch, topk_ops,
                                 f"sign vectors Q=64 N=2000 D=16 k={k}",
                                 q, signs, k, exact=True))
    return err


def index_texts(n, seed):
    """``n`` distinct short catalog-like texts, from ``seed``."""
    import random
    rng = random.Random(seed)
    items = ["laptop", "headphones", "kettle", "bicycle", "novel", "camera",
             "jacket", "printer", "guitar", "lamp", "backpack", "monitor"]
    traits = ["quiet", "cheap", "sturdy", "broken on arrival", "light",
              "fast", "late", "well made", "overpriced", "excellent"]
    out = set()
    while len(out) < n:
        out.add(f"review {rng.randrange(10 ** 6)}: the {rng.choice(items)} "
                f"was {rng.choice(traits)}")
    return sorted(out)


def index_path(torch, eng, errs):
    """Drive the semantic index on the served engine at full width, hold
    every search to a plain-path manager sharing the store, and check K3's
    launch count.  Returns the kernels-line row of K3."""
    from repro_torch.inference.api import CortexClient
    from repro_torch.inference.pipeline import PipelineConfig
    from repro_torch.inference.scheduler import Scheduler
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.semindex import SemanticIndexManager, SemIndexConfig
    from repro_torch.semindex.index import _normalize
    # make_engine_client's three steps, over the engine already loaded;
    # EMBED goes to the served model, not the default embedder name
    sched = Scheduler()
    sched.register(eng)
    client = CortexClient(sched, default_model="proxy-8b",
                          proxy_model="proxy-8b", embed_model="proxy-8b",
                          pipeline=PipelineConfig())
    cfg = SemIndexConfig(dim=64)
    texts = index_texts(512, SEED + 3)
    queries = index_texts(576, SEED + 4)[-64:]
    queries = [f"looking for: {t}" for t in queries]
    mgr = SemanticIndexManager(cfg)
    col = "reviews.text"
    k_flat, k_cand = 8, 32

    topk_ops.LAUNCHES = 0
    flash_ops.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = mgr.ensure_index(client, col, texts)
    t_build = time.perf_counter() - t0
    qv = mgr.embed_texts(client, queries)
    corpus = mgr.embed_texts(client, texts)
    k2_embed = flash_ops.LAUNCHES
    k3_before = topk_ops.LAUNCHES
    t0 = time.perf_counter()
    flat = mgr.search(col, qv, k_flat)
    ivf = mgr.search(col, qv, k_flat, exact=False)
    cand = mgr.topk_candidates(qv, corpus, k_cand)
    torch.cuda.synchronize()
    t_search = time.perf_counter() - t0
    launches = topk_ops.LAUNCHES
    # the probe set, from the same kernel (reads done after the counts)
    _, probe = index._topk(index._tensor(_normalize(qv)), index._centroids,
                           cfg.nprobe)
    cells = {int(c) for c in set(probe.ravel().tolist())
             if len(index.cells[c])}
    expect = 1 + (1 + len(cells)) + 1
    print(f"index: {len(texts)} texts embedded by {eng.cfg.name} at full "
          f"width and indexed in {t_build:.2f} s (nlist {index.nlist}, "
          f"{sum(len(c) for c in index.cells)} vectors, cells of "
          f"{min(len(c) for c in index.cells)}-"
          f"{max(len(c) for c in index.cells)}); {len(queries)} queries; "
          f"flat k={k_flat}, IVF k={k_flat} nprobe {cfg.nprobe} over "
          f"{len(cells)} probed cells, topk_candidates k={k_cand} in "
          f"{t_search * 1e3:.1f} ms")
    print(f"index launches: K3 {launches} (before the searches "
          f"{k3_before}), expected {expect} (flat 1, IVF 1 probe + "
          f"{len(cells)} cells, candidates 1); K2 {k2_embed} over the "
          "EMBED passes")
    if launches != expect or k3_before != 0:
        fail("K3 launch count differs from the searches' calls")
    if k2_embed == 0 or k2_embed % eng.cfg.num_layers:
        fail(f"the index's EMBED passes launched K2 {k2_embed} times")
    if not (index.vectors.is_cuda and qv.shape == (64, cfg.dim)
            and bool(torch.isfinite(torch.from_numpy(qv)).all())):
        fail("the index corpus is not on the card or the queries are bad")

    # the plain path: a second manager on the same store, plain top-k
    calls = dict(client.calls_by_model)
    ref = SemanticIndexManager(SemIndexConfig(dim=64, impl="reference"),
                               store=mgr.store)
    ref_index = ref.ensure_index(client, col, texts)
    ref_qv = ref.embed_texts(client, queries)
    if (ref.snapshot()["embed_llm_calls"] != 0
            or client.calls_by_model != calls):
        fail("the plain-path manager dispatched EMBED: the store is cold")
    if not ((ref_qv == qv).all() and (ref_index.centroids
                                      == index.centroids).all()):
        fail("the two managers disagree on vectors or centroids")
    err = 0.0
    for what, got, want in (
            ("served flat search", flat, ref.search(col, qv, k_flat + 1)),
            ("served IVF search", ivf,
             ref.search(col, qv, k_flat + 1, exact=False)),
            ("served topk_candidates", cand,
             ref.topk_candidates(qv, corpus, k_cand + 1))):
        e, n_flips = topk_gate(torch, what, *got, *want)
        print(f"K3 {what}: max|vals-plain|={e:.3g} (tol {TOPK_TOL}), "
              f"{n_flips} id flips within margin; top-1 cosine mean "
              f"{float(got[0][:, 0].mean()):.6f}, k-th "
              f"{float(got[0][:, -1].mean()):.6f}")
        err = max(err, e)
    print(f"index snapshot: {mgr.snapshot()}")
    print(f"plain-path snapshot: {ref.snapshot()}")
    print(f"client: {client.snapshot()}")

    # time K3 at the served flat search's shape
    q = topk_ops.l2_normalize(index._tensor(_normalize(qv)))
    c = topk_ops.l2_normalize(index.vectors)
    t = time_topk(torch, topk_ops, "served flat search", q, c, k_flat)
    errs["similarity_topk"] = max(errs["similarity_topk"], err,
                                  t.pop("max_abs_err"))
    return kernel_row("similarity_topk", launches, errs["similarity_topk"],
                      t)


# ---------------------------------------------------------------------------
# AISQL: the SQL layer on the card over the cascade pair and the index
# ---------------------------------------------------------------------------


def aisql_catalog():
    """256 IMDB-style reviews (the cascade), 64 NYT-style articles
    (CLASSIFY, COMPLETE, the index) and an AG-News-style join pair cut to
    96 articles and 4 topics, so that the rewrite's CLASSIFY calls stay
    near a hundred and each call's 4 label continuations fit the card's
    logits beside both models' weights.  Returns the catalog and the join
    predicate's prompt."""
    from repro_torch.core import Catalog
    from repro_torch.data import datasets as D
    spec = dataclasses.replace(D.JOIN_DATASETS["AGNEWS_100"],
                               name="AGNEWS_4", left_rows=96, right_rows=4)
    left, right, _ = D.join_tables(spec=spec)
    cat = Catalog({"reviews": D.cascade_table("IMDB", rows=256),
                   "articles": D.nyt_articles(64), "l": left, "r": right})
    return cat, D.JOIN_PROMPTS["AGNEWS_100"]


def aisql_queries(join_prompt):
    return [
        ("filter_cascade",
         "SELECT r.id, r.text FROM reviews AS r WHERE "
         "AI_FILTER(PROMPT('Is this review positive? {0}', r.text))"),
        ("classify_groupby",
         "SELECT AI_CLASSIFY(PROMPT('Which section does this article "
         "belong to? {0}', a.body), ['politics','business','technology',"
         "'sports']) AS section, COUNT(*) AS n FROM articles AS a "
         "GROUP BY section"),
        ("complete_limit",
         "SELECT a.id, AI_COMPLETE(PROMPT('Summarize: {0}', a.body), "
         "max_tokens => 8) AS summary FROM articles AS a LIMIT 4"),
        ("semantic_join",
         "SELECT l.id, r.label FROM l JOIN r ON "
         f"AI_FILTER(PROMPT('{join_prompt}', l.content, r.label))"),
        ("similarity_topk",
         "SELECT a.id FROM articles AS a ORDER BY "
         "AI_SIMILARITY(a.body, 'database query engines') DESC LIMIT 10"),
    ]


class EngineTap:
    """Wraps each engine's ``submit_batch``: times every call and keeps
    each result by (model, kind, prompt); the oracle's
    ``_sequence_logprob`` keeps each label continuation's logprob, and its
    continuous batcher the top TOPS logits (values, ids) of every token
    it picks for a COMPLETE, by (prompt, step)."""

    def __init__(self, engines, oracle):
        self.engines, self.oracle = engines, oracle
        self.results, self.logprobs, self.tops = {}, {}, {}
        self.seconds = 0.0

    def __enter__(self):
        import torch
        for e in self.engines:
            real = e.submit_batch

            def tapped(reqs, real=real):
                t = time.perf_counter()
                out = real(reqs)
                self.seconds += time.perf_counter() - t
                for r, res in zip(reqs, out):
                    self.results[(res.model, r.kind, r.prompt)] = res
                return out
            e.submit_batch = tapped
        real_lp = self.oracle._sequence_logprob

        def lp(prompts, conts):
            out = real_lp(prompts, conts)
            self.logprobs.update(zip(zip(prompts, conts), out[0]))
            return out
        self.oracle._sequence_logprob = lp
        # the first token comes from the prefill's logits row, each next
        # one from a decode step's logits (slot rows, read in logits_of)
        b = self.batcher = self.oracle._batcher
        self.model = b.model
        real_fin, real_step = b._finish_prefill, b._decode_step
        stepping = []

        def finish(s, row, *a):
            if s.req.kind == "complete":
                v, i = torch.from_numpy(row).topk(TOPS)
                self.tops[(s.req.prompt, 0)] = (v.tolist(), i.tolist())
            return real_fin(s, row, *a)

        def step(active, *a):
            stepping[:] = [(s.slot, s.req.prompt, len(s.out))
                           for s in active
                           if s is not None and s.state == "decode"]
            try:
                return real_step(active, *a)
            finally:
                stepping.clear()

        def logits_of(params, h):
            out = self.model.logits_of(params, h)
            if stepping:
                v, i = out.float().topk(TOPS, dim=-1)
                v, i = v.cpu().tolist(), i.cpu().tolist()
                for slot, prompt, t in stepping:
                    self.tops[(prompt, t)] = (v[slot], i[slot])
                stepping.clear()
            return out
        b._finish_prefill, b._decode_step = finish, step
        b.model = dataclasses.replace(self.model, logits_of=logits_of)
        return self

    def __exit__(self, *exc):
        for e in self.engines:
            e.__dict__.pop("submit_batch", None)
        self.oracle.__dict__.pop("_sequence_logprob", None)
        for name in ("_finish_prefill", "_decode_step"):
            self.batcher.__dict__.pop(name, None)
        self.batcher.model = self.model


def most_work_recorder(work):
    """A Spy recorder keeping only the launch with the most
    ``work(args)`` (the first among equals) in ``best[0]``."""
    best = [None, -1]

    def record(args, kw, out):
        w = work(args)
        if w > best[1]:
            best[0], best[1] = (args, kw), w
    return best, record


def aisql_run(torch, engines, oracle, impl):
    """The five queries through a fresh client, index manager and
    ``AisqlEngine`` over ``engines``, every kernel at ``impl`` ("auto":
    the kernels; "reference": their plain versions).  Returns one record
    per query, with what the engines returned for it."""
    from repro_torch.core import (AisqlEngine, CascadeConfig, ExecConfig,
                                  SemanticIndexManager, SemIndexConfig)
    from repro_torch.inference.api import CortexClient
    from repro_torch.inference.pipeline import PipelineConfig
    from repro_torch.inference.scheduler import Scheduler
    catalog, join_prompt = aisql_catalog()
    sched = Scheduler()
    for e in engines:
        sched.register(e)
    # EMBED goes to proxy-8b, the hosted model (no embedder is served)
    client = CortexClient(sched, default_model="oracle-70b",
                          proxy_model="proxy-8b", embed_model="proxy-8b",
                          pipeline=PipelineConfig())
    mgr = SemanticIndexManager(SemIndexConfig(impl=impl))
    eng = AisqlEngine(catalog, client, semindex=mgr,
                      executor=ExecConfig(use_cascade=True,
                                          cascade=CascadeConfig(seed=SEED)))
    records = []
    for e in engines:
        e._batcher.decode_impl = impl
    try:
        with kernel_impls(impl), EngineTap(engines, oracle) as tap:
            for name, sql in aisql_queries(join_prompt):
                calls0, credits0 = client.ai_calls, client.ai_credits
                by_model0 = dict(client.calls_by_model)
                served0 = sum(e.total_credits for e in engines)
                searches0 = mgr.snapshot()["index_searches"]
                engine_s0 = tap.seconds
                tap.results, tap.logprobs, tap.tops = {}, {}, {}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = eng.sql(sql)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                rep = eng.last_report
                cols = list(out.column_names)
                rows = [tuple(_plain(out.column(c)[i]) for c in cols)
                        for i in range(out.num_rows)]
                records.append({
                    "name": name, "cols": cols, "rows": rows, "wall": wall,
                    "engine_s": tap.seconds - engine_s0,
                    "ai_calls": rep.ai_calls, "credits": rep.ai_credits,
                    "client_calls": client.ai_calls - calls0,
                    "client_credits": client.ai_credits - credits0,
                    "served_credits": sum(e.total_credits for e in engines)
                    - served0,
                    "by_model": {m: n - by_model0.get(m, 0) for m, n in
                                 client.calls_by_model.items()
                                 if n != by_model0.get(m, 0)},
                    "searches": mgr.snapshot()["index_searches"] - searches0,
                    "trace": list(rep.optimizer_trace),
                    "reopt": list(rep.reoptimizations),
                    "cascades": {k: c.stats for k, c in
                                 eng.exec.cascades.items()},
                    "results": tap.results, "logprobs": tap.logprobs,
                    "tops": tap.tops})
    finally:
        for e in engines:
            e._batcher.decode_impl = "auto"
    return records


def _plain(v):
    return v.item() if hasattr(v, "item") else v


def check_aisql_tables(rec, catalog_labels):
    """Each query's table is well formed, and its report agrees with the
    client's meter and with what the engines served."""
    name, rows = rec["name"], rec["rows"]
    if not (rec["ai_calls"] == rec["client_calls"] > 0
            and abs(rec["credits"] - rec["client_credits"]) <= 1e-12
            and math.isclose(rec["credits"], rec["served_credits"],
                             rel_tol=1e-9)):
        fail(f"aisql {name}: report {rec['ai_calls']} calls / "
             f"{rec['credits']} credits, client {rec['client_calls']} / "
             f"{rec['client_credits']}, engines {rec['served_credits']}")
    ok = {
        "filter_cascade": rec["cols"] == ["r.id", "r.text"]
        and 0 <= len(rows) <= 256 and len({r[0] for r in rows}) == len(rows),
        "classify_groupby": rec["cols"] == ["section", "n"]
        and {r[0] for r in rows} <= {"politics", "business", "technology",
                                     "sports"}
        and sum(r[1] for r in rows) == 64,
        "complete_limit": rec["cols"] == ["a.id", "summary"]
        and len(rows) == 4 and all(isinstance(r[1], str) for r in rows),
        "semantic_join": rec["cols"] == ["l.id", "r.label"]
        and all(0 <= r[0] < 96 and r[1] in catalog_labels for r in rows),
        "similarity_topk": rec["cols"] == ["a.id"] and len(rows) == 10
        and len({r[0] for r in rows}) == 10
        and all(0 <= r[0] < 64 for r in rows),
    }[name]
    if not ok:
        fail(f"aisql {name}: malformed table {rec['cols']} {rows[:4]}")


def filter_flips(k_rec, p_rec):
    """The cascade query's rows that one path kept and the other did not,
    each with its plain-path margin: the smallest distance of a plain
    SCORE of the row to the threshold it was held to (0.5 for the
    oracle's label, the cascade's learned taus for the proxy's score)."""
    (stats,) = p_rec["cascades"].values()
    kept_k, kept_p = set(k_rec["rows"]), set(p_rec["rows"])
    flips = []
    for row in sorted(kept_k ^ kept_p):
        margins = []
        for (model, kind, prompt), res in p_rec["results"].items():
            if kind != "score" or row[1] not in prompt:
                continue
            taus = ((0.5,) if model == "oracle-70b"
                    else (stats.tau_low, stats.tau_high))
            margins += [abs(res.score - t) for t in taus]
        flips.append((row[0], row in kept_k, min(margins)))
    return flips


def _shares(lp):
    """ln of each label's softmax share of the mean logprobs ``lp``."""
    top = max(lp.values())
    z = math.log(sum(math.exp(v - top) for v in lp.values()))
    return {lb: v - top - z for lb, v in lp.items()}


def classify_flips(k_rec, p_rec, labels, multi):
    """The CLASSIFY prompts whose chosen labels differ between the paths,
    {prompt: (kernel labels, plain labels, margin)}, the margin being how
    far the plain path's mean logprobs lie from the decision that would
    explain the difference.  One label: the plain top label's logprob
    over the kernel's choice.  Several (the engine keeps each label whose
    softmax share reaches 1.5 / n, else the top one): for each label
    chosen on one path only, |ln(share / threshold)|, or, where a path
    fell back to its top label, the logprob gap to the plain top label if
    smaller; the margin is the largest of these."""
    thr = math.log(1.5 / max(len(labels), 2))
    flips = {}
    for key, res in p_rec["results"].items():
        if key[1] != "classify":
            continue
        kres = k_rec["results"][key]
        if (set(kres.labels) == set(res.labels) if multi
                else kres.label == res.label):
            continue
        cont = key[2] + "\nanswer: "
        lp = {lb: p_rec["logprobs"][(cont, lb)] for lb in labels}
        top = max(lp, key=lp.get)
        if not multi:
            flips[key[2]] = (kres.labels, res.labels, lp[top] - lp[kres.label])
            continue
        k_lp = {lb: k_rec["logprobs"][(cont, lb)] for lb in labels}
        fell_back = (max(_shares(lp).values()) < thr
                     or max(_shares(k_lp).values()) < thr)
        second = max(v for lb, v in lp.items() if lb != top)
        margins = []
        for lb in set(kres.labels) ^ set(res.labels):
            m = abs(_shares(lp)[lb] - thr)
            if fell_back:
                m = min(m, lp[top] - (second if lb == top else lp[lb]))
            margins.append(m)
        flips[key[2]] = (kres.labels, res.labels, max(margins))
    return flips


def classify_table(rec, catalog):
    """The table a CLASSIFY query's rows should give, rebuilt from the
    labels the engines returned for it: the GROUP BY's counts, or the
    join's (left id, label) pairs."""
    got = [(prompt, res) for (_, kind, prompt), res in rec["results"].items()
           if kind == "classify"]
    if rec["name"] == "classify_groupby":
        counts = {}
        for _, res in got:
            counts[res.label] = counts.get(res.label, 0) + 1
        return sorted(counts.items()), sorted(rec["rows"])
    left = catalog.table("l")
    ids = {str(c): int(i) for i, c in zip(left.column("id"),
                                          left.column("content"))}
    pairs = {(ids[prompt.rsplit("\ninput: ", 1)[1]], lb)
             for prompt, res in got for lb in res.labels}
    return sorted(pairs), sorted(rec["rows"])


# ---------------------------------------------------------------------------
# HTTP: the AISQL service on the card (AisqlHttpServer -> ServingEngine ->
# Scheduler -> both engines), queries 1-3 of the AISQL phase
# ---------------------------------------------------------------------------

HTTP_TENANTS = ("acme", "globex", "initech")
SECTIONS = ["politics", "business", "technology", "sports"]


def k1_work(args):
    """Valid keys of a K1 launch (its rows' lengths within the cache)."""
    return int(args[3].clamp(max=args[1].shape[1]).sum())


def k2_work(args):
    return args[0].numel()


def chunk_recorder():
    """A Spy recorder of K2's chunked entry keeping a copy of the call
    with the widest cache view (the first among equals) in ``best[0]``:
    the call appends to the step's cache view, which the batcher frees
    after the step."""
    best = [None, -1]

    def record(args, kw, out):
        w = args[3].shape[1] * args[0].shape[1]
        if w > best[1]:
            copy = [a.clone() for a in args]
            best[0], best[1] = (copy, dict(kw)), w
    return best, record


def token_ids(tops, prompt):
    """The tokens a run picked for a COMPLETE prompt, from its tops."""
    ids = []
    while (prompt, len(ids)) in tops:
        ids.append(tops[(prompt, len(ids))][1][0])
    return ids


def complete_flips(k_rec, p_rec):
    """The COMPLETE prompts whose texts differ between two runs,
    {prompt: (step, margin)}: the first step at which the runs picked
    different tokens, and there the reference run's (``p_rec``'s) top
    logit over its logit of the token the other run picked (inf when that
    token is not among its TOPS best)."""
    flips = {}
    for key, res in p_rec["results"].items():
        if key[1] != "complete" or k_rec["results"][key].text == res.text:
            continue
        k_ids = token_ids(k_rec["tops"], key[2])
        p_ids = token_ids(p_rec["tops"], key[2])
        t = next((i for i, (a, b) in enumerate(zip(k_ids, p_ids))
                  if a != b), min(len(k_ids), len(p_ids)))
        margin = math.inf
        if t < len(k_ids) and (key[2], t) in p_rec["tops"]:
            vals, ids = p_rec["tops"][(key[2], t)]
            if k_ids[t] in ids:
                margin = vals[0] - vals[ids.index(k_ids[t])]
        flips[key[2]] = (t, margin)
    return flips


def run_diffs(k_rec, p_rec):
    """The largest differences between two runs on the same inputs:
    SCOREs, label logprobs (nats), and the top logit of each COMPLETE
    step whose context (the tokens picked before it) both runs share."""
    def scores(rec):
        return {key: res.score for key, res in rec["results"].items()
                if key[1] == "score"}
    ks, ps = scores(k_rec), scores(p_rec)
    d_score = max((abs(ks[key] - ps[key]) for key in ks.keys() & ps.keys()),
                  default=0.0)
    d_lp = max((abs(k_rec["logprobs"][key] - v)
                for key, v in p_rec["logprobs"].items()
                if key in k_rec["logprobs"]), default=0.0)
    d_logit, steps = 0.0, 0
    for (prompt, t), (vals, _) in p_rec["tops"].items():
        if (prompt, t) not in k_rec["tops"]:
            continue
        if (token_ids(k_rec["tops"], prompt)[:t]
                == token_ids(p_rec["tops"], prompt)[:t]):
            d_logit = max(d_logit, abs(k_rec["tops"][(prompt, t)][0][0]
                                       - vals[0]))
            steps += 1
    return {"score": d_score, "scores": len(ks.keys() & ps.keys()),
            "logprob": d_lp, "logit": d_logit, "steps": steps}


def hold_rows(what, rec, ref, catalog, bad):
    """Hold ``rec``'s rows, and what the engines computed for them, to
    the reference run ``ref``'s under the HTTP bands, printing every flip
    with the reference's margin; what breaks a band goes to ``bad``.
    Each table must be the one its own per-row answers give."""
    name = rec["name"]
    if rec["cols"] != ref["cols"]:
        fail(f"http {what} {name}: columns {rec['cols']} != {ref['cols']}")
    if name == "filter_cascade":
        flips = filter_flips(rec, ref)
        for rid, kept, margin in flips:
            print(f"  http {what} filter flip: review {rid} kept by "
                  f"{'this' if kept else 'the reference'} run only, "
                  f"reference margin {margin:.3g}")
            if not margin <= HTTP_SCORE_TOL:
                bad.append(f"{what} {name} review {rid}")
    elif name == "classify_groupby":
        flips = classify_flips(rec, ref, SECTIONS, False)
        for prompt, (kl, pl, margin) in flips.items():
            print(f"  http {what} label flip: {kl} vs the reference's {pl},"
                  f" reference margin {margin:.3g} nats ({prompt[-48:]!r})")
            if not margin <= HTTP_LOGPROB_TOL:
                bad.append(f"{what} {name}")
        want, got = classify_table(rec, catalog)
        if want != got:
            fail(f"http {what} {name}: the table is not the one its labels "
                 f"give: {got} vs {want}")
    else:
        flips = complete_flips(rec, ref)
        for prompt, (t, margin) in flips.items():
            print(f"  http {what} COMPLETE flip at token {t}: reference "
                  f"margin {margin:.3g} ({prompt[:48]!r})")
            if not margin <= HTTP_LOGIT_TOL:
                bad.append(f"{what} {name}")
        body = dict(zip(catalog.table("articles").column("id").tolist(),
                        catalog.table("articles").column("body")))
        for r in (rec, ref):
            for rid, text in r["rows"]:
                res = r["results"].get(
                    ("oracle-70b", "complete", f"Summarize: {body[rid]}"))
                if res is None or res.text != text:
                    fail(f"http {what} {name}: row {rid}'s summary is not "
                         f"its COMPLETE's text")
        if [r[0] for r in rec["rows"]] != [r[0] for r in ref["rows"]]:
            fail(f"http {what} {name}: ids {rec['rows']} vs {ref['rows']}")
    d = run_diffs(rec, ref)
    print(f"http {what} {name}: {len(flips)} flips, rows equal "
          f"{sorted(rec['rows']) == sorted(ref['rows'])}; max |diff| SCORE "
          f"{d['score']:.3g} over {d['scores']} prompts, label logprob "
          f"{d['logprob']:.3g} nats, COMPLETE top logit {d['logit']:.3g} "
          f"over {d['steps']} steps with a shared context")
    if not (d["score"] <= HTTP_SCORE_TOL and d["logprob"] <= HTTP_LOGPROB_TOL
            and d["logit"] <= HTTP_LOGIT_TOL):
        bad.append(f"{what} {name} beyond the bands")


def expect_status(status, code, fn):
    """The error body of ``fn()``'s HTTP call, which must fail with
    ``status`` and ``code``."""
    from repro_torch.serve.http import HttpStatusError
    try:
        fn()
    except HttpStatusError as e:
        if (e.status, e.code) != (status, code):
            fail(f"http: expected {status} {code}, got {e.status} {e.code}:"
                 f" {e.body}")
        return e.body
    fail(f"http: expected {status} {code}, the call succeeded")


def thread_kind():
    t = threading.current_thread()
    if t is threading.main_thread():
        return "main"
    return "worker" if t.name.startswith("aisql-serve-") else "handler"


class HttpPhase:
    """Queries 1-3 of the AISQL phase over HTTP: a buffered pass, one
    query at a time from three tenants, against the in-process kernel run;
    NL2SQL and the error paths; then, on a fresh ``ServingEngine``, the
    three streamed at once, against the buffered pass."""

    def __init__(self, torch, engines, oracle):
        from repro_torch.inference.scheduler import Scheduler
        from repro_torch.serve import HttpConfig
        self.torch, self.engines, self.oracle = torch, engines, oracle
        self.catalog, join_prompt = aisql_catalog()
        self.queries = aisql_queries(join_prompt)[:3]
        self.sched = Scheduler()
        for e in engines:
            self.sched.register(e)
        self.http_cfg = HttpConfig(
            tokens={f"tok-{t}": t for t in HTTP_TENANTS},
            request_timeout_s=600.0)

    def serving(self):
        from repro_torch.core import (CascadeConfig, ExecConfig,
                                      ServingConfig, ServingEngine,
                                      TenantPolicy)
        return ServingEngine(
            self.catalog, self.sched,
            cfg=ServingConfig(workers=4, executor=ExecConfig(
                use_cascade=True, cascade=CascadeConfig(seed=SEED))),
            tenants={t: TenantPolicy() for t in HTTP_TENANTS})

    @staticmethod
    def client(srv, tenant, token=None):
        from repro_torch.serve import AisqlHttpClient
        return AisqlHttpClient(srv.host, srv.port, timeout=600.0,
                               token=token or f"tok-{tenant}")

    def served(self):
        return sum(e.total_credits for e in self.engines)

    def check_service(self, what, eng, srv, served, recs):
        """After a pass: the wire report per tenant is the library's, the
        tenant meters sum to what the engines served and to the queries'
        credits, and no request was retried or failed."""
        from repro_torch.serve.http import _dumps
        eng.drain()
        report = eng.report()
        lib = json.loads(_dumps(dataclasses.asdict(report)))
        for t in HTTP_TENANTS:
            if self.client(srv, t).report()["tenants"][t] != \
                    lib["tenants"][t]:
                fail(f"http {what}: /v1/report for {t} is not report()")
        spent = sum(t.credits_spent for t in report.tenants.values())
        queries = sum(r["credits"] for r in recs)
        if not (math.isclose(spent, report.total_credits, rel_tol=1e-9)
                and math.isclose(spent, served, rel_tol=1e-9)
                and math.isclose(spent, queries, rel_tol=1e-9)):
            fail(f"http {what}: tenants spent {spent}, report "
                 f"{report.total_credits}, engines {served}, queries "
                 f"{queries}")
        for rec in recs:
            tr = report.tenants[rec["tenant"]]
            if (tr.completed, tr.failed, tr.rejected) != (1, 0, 0) or \
                    not math.isclose(tr.credits_spent, rec["credits"],
                                     rel_tol=1e-9):
                fail(f"http {what}: tenant {rec['tenant']}'s meter {tr}")
        if (report.retries, report.failed_requests, report.scheduler_retries,
                eng.pipeline.stats.retries,
                eng.pipeline.stats.failures) != (0,) * 5:
            fail(f"http {what}: retries or failures in the pipeline "
                 f"({report.retries}, {report.failed_requests}, "
                 f"{report.scheduler_retries})")
        waits = {t: round(r.queue_wait_p50_s, 4)
                 for t, r in report.tenants.items()}
        print(f"http {what}: tenants spent {spent:.6g} credits = engines "
              f"{served:.6g}; {report.dispatched_requests} requests "
              f"dispatched of {report.submitted_requests}; 0 retries, 0 "
              f"failures; queue wait p50 by tenant {waits} s")

    def buffered(self, k_recs, bad):
        """The buffered pass, traces, metrics, the error paths and
        NL2SQL on one server."""
        from repro_torch.serve import (AisqlHttpServer, NL2SQLOperator,
                                       SemanticModel)
        from repro_torch.inference.api import CortexClient
        from repro_torch.obs import parse_prometheus_text
        torch = self.torch
        op = NL2SQLOperator(SemanticModel.from_catalog(self.catalog),
                            self.catalog,
                            CortexClient(self.sched,
                                         default_model="oracle-70b",
                                         proxy_model="proxy-8b"))
        eng = self.serving()
        srv = AisqlHttpServer(eng, nl2sql=op, cfg=self.http_cfg).start()
        try:
            served0 = self.served()
            recs = []
            for tenant, (name, sql) in zip(HTTP_TENANTS, self.queries):
                with EngineTap(self.engines, self.oracle) as tap:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = self.client(srv, tenant).query(sql)
                    wire = time.perf_counter() - t0
                st = out["stats"]
                recs.append({
                    "name": name, "tenant": tenant, "cols": out["columns"],
                    "rows": [tuple(r) for r in out["rows"]], "wire": wire,
                    "serving_s": st["wall_s"], "queue_s": st["queue_wait_s"],
                    "engine_s": tap.seconds, "ai_calls": st["ai_calls"],
                    "credits": st["ai_credits"],
                    "query_id": out["query_id"], "results": tap.results,
                    "logprobs": tap.logprobs, "tops": tap.tops})
            self.check_service("buffered pass", eng, srv,
                               self.served() - served0, recs)
            for rec in recs:
                (session,) = eng._idle_sessions[rec["tenant"]]
                rec["cascades"] = {k: c.stats for k, c in
                                   session.engine.exec.cascades.items()}
                spans = []
                stack = [self.client(srv, rec["tenant"]).trace(
                    rec["query_id"])["trace"]]
                while stack:
                    sp = stack.pop()
                    stack += sp["children"]
                    if sp["kind"] == "dispatch.replica":
                        spans.append(sp["attrs"]["model"])
                models = {key[0] for key in rec["results"]}
                if set(spans) != models:
                    fail(f"http {rec['name']}: trace dispatches to "
                         f"{sorted(set(spans))}, the engines served "
                         f"{sorted(models)}")
                serving = rec["queue_s"] + rec["serving_s"]
                print(f"http {rec['name']} (tenant {rec['tenant']}, "
                      f"buffered): {rec['wire']:.3f} s on the wire, "
                      f"{serving:.3f} s in the ServingEngine (queue "
                      f"{rec['queue_s']:.4f} s), HTTP layer "
                      f"{rec['wire'] - serving:.4f} s; engines "
                      f"{rec['engine_s']:.3f} s; {len(rec['rows'])} rows, "
                      f"{rec['ai_calls']} AI calls, {rec['credits']:.6g} "
                      f"credits; trace: {len(spans)} engine dispatches")
            metrics = parse_prometheus_text(
                self.client(srv, HTTP_TENANTS[0]).metrics())
            if "aisql_pipeline_events_total" not in metrics:
                fail(f"http: /v1/metrics lacks the pipeline's counters: "
                     f"{sorted(metrics)[:8]}")
            print(f"http /v1/metrics: {len(metrics)} families parsed")
            for rec, ref in zip(recs, k_recs):
                hold_rows("buffered pass vs in-process", rec, ref,
                          self.catalog, bad)
            self.error_paths(srv)
            self.nl2sql(srv, op)
        finally:
            srv.stop()
            eng.close()
        return recs

    def error_paths(self, srv):
        c = self.client(srv, HTTP_TENANTS[0])
        body = expect_status(400, "invalid_sql", lambda: c.query(
            "SELECT r.id FROM reviews AS r LIMIT x"))
        line, caret = body["error"]["caret"].splitlines()
        if line[caret.index("^")] != "x":
            fail(f"http 400: the caret is not under the bad token: {body}")
        expect_status(401, "unauthorized", lambda: self.client(
            srv, None, token="bad").query("SELECT COUNT(*) FROM reviews"))
        expect_status(404, "not_found",
                      lambda: c._request("GET", "/v1/nope").read())
        print("http error paths: 400 invalid_sql with its caret, 401 "
              "unauthorized, 404 not_found")

    def nl2sql(self, srv, op):
        """One question: random weights give no valid SQL, so every
        attempt is rejected and the answer is a 422."""
        from repro_torch.inference import tokenizer as tok
        from repro_torch.kernels.decode_attention import ops as dec_ops
        question = "how many positive reviews are there?"
        n_tok = len(tok.encode(op._prompt(question, None)))
        calls = []
        real = self.oracle.submit_batch

        def counted(reqs):
            k0, t0 = dec_ops.LAUNCHES, time.perf_counter()
            out = real(reqs)
            calls.append(([r.kind for r in reqs],
                          dec_ops.LAUNCHES - k0,
                          [(res.tokens_in, res.tokens_out) for res in out],
                          round(time.perf_counter() - t0, 3)))
            return out
        self.oracle.submit_batch = counted
        served0 = self.served()
        try:
            t0 = time.perf_counter()
            body = expect_status(422, "nl2sql_rejected", lambda: self.client(
                srv, HTTP_TENANTS[1]).nl2sql(question))
            wire = time.perf_counter() - t0
        finally:
            self.oracle.__dict__.pop("submit_batch", None)
        n = op.max_attempts
        print(f"http nl2sql: 422 in {wire:.3f} s; prompt {n_tok} tokens "
              f"(the engine keeps {min(n_tok, self.oracle.max_seq)}: BOS and "
              f"the tail); attempts (kinds, K1 launches, tokens in and out, "
              f"s): "
              f"{calls}; rejected_sql "
              f"{body['error'].get('rejected_sql', '')[:60]!r}")
        if not ("rejected_sql" in body["error"] and len(calls) == n
                and all(kinds == ["complete"] and k1 > 0
                        for kinds, k1, _, _ in calls)
                and op.client.calls_by_model == {"oracle-70b": n}
                and op.rejected_attempts == n
                and math.isclose(op.client.ai_credits,
                                 self.served() - served0, rel_tol=1e-9)):
            fail(f"http nl2sql: expected {n} oracle COMPLETEs through K1, "
                 f"each rejected; got {calls}, "
                 f"{op.client.calls_by_model}")

    def concurrent(self, serial, bad):
        """A fresh ServingEngine (a cold cross-query cache); each tenant
        streams its query at the same moment."""
        from repro_torch.serve import AisqlHttpServer
        eng = self.serving()
        srv = AisqlHttpServer(eng, cfg=self.http_cfg).start()
        try:
            served0 = self.served()
            start = threading.Barrier(len(self.queries))
            got, errors = {}, []

            def drive(tenant, name, sql):
                c = self.client(srv, tenant)
                try:
                    start.wait(timeout=60)
                    t0 = time.perf_counter()
                    events = list(c.query_stream(sql))
                    got[name] = (events, time.perf_counter() - t0)
                except Exception as e:       # failed after the join
                    errors.append((tenant, name, e))
            with EngineTap(self.engines, self.oracle) as tap:
                threads = [threading.Thread(target=drive, args=(t, n, q))
                           for t, (n, q) in zip(HTTP_TENANTS, self.queries)]
                t0 = time.perf_counter()
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=900)
                wall = time.perf_counter() - t0
            if errors or any(th.is_alive() for th in threads):
                fail(f"http concurrent pass: {errors}")
            recs = []
            for tenant, (name, _) in zip(HTTP_TENANTS, self.queries):
                events, wire = got[name]
                kinds = [e["kind"] for e in events]
                rows = [tuple(e["values"]) for e in events
                        if e["kind"] == "row"]
                summary = events[-1]
                if not (kinds[0] == "schema" and kinds[-1] == "summary"
                        and set(kinds[1:-1]) <= {"row"}
                        and summary["row_count"] == len(rows)):
                    fail(f"http {name}: a malformed stream {kinds[:4]}..."
                         f"{kinds[-2:]}")
                recs.append({
                    "name": name, "tenant": tenant,
                    "cols": events[0]["columns"], "rows": rows,
                    "wire": wire, "serving_s": summary["wall_s"],
                    "ai_calls": summary["ai_calls"],
                    "credits": summary["ai_credits"],
                    "results": tap.results, "logprobs": tap.logprobs,
                    "tops": tap.tops})
                print(f"http {name} (tenant {tenant}, streamed at once): "
                      f"{wire:.3f} s on the wire, {summary['wall_s']:.3f} s "
                      f"in the ServingEngine's session, outside it (queue, "
                      f"session checkout, HTTP) {wire - summary['wall_s']:.4f}"
                      f" s; {len(rows)}"
                      f" rows, {summary['ai_calls']} AI calls, "
                      f"{summary['ai_credits']:.6g} credits")
            print(f"http concurrent pass: {wall:.3f} s for the three "
                  f"queries (buffered one at a time "
                  f"{sum(r['wire'] for r in serial):.3f} s); engines "
                  f"{tap.seconds:.3f} s")
            self.check_service("concurrent pass", eng, srv,
                               self.served() - served0, recs)
            for rec, ref in zip(recs, serial):
                hold_rows("streamed at once vs buffered", rec, ref,
                          self.catalog, bad)
        finally:
            srv.stop()
            eng.close()


def http_path(torch, engines, oracle, k_recs, errs):
    """The AISQL service on the card over the engines of the AISQL phase
    (``HttpPhase``), with K1 and K2 counted and timed on the launches the
    server's threads made.  Returns the kernels-line rows."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    phase = HttpPhase(torch, engines, oracle)
    threads = {}

    def by_thread(name, record):
        def rec(args, kw, out):
            key = (name, thread_kind())
            threads[key] = threads.get(key, 0) + 1
            record(args, kw, out)
        return rec
    k1_best, k1_rec = most_work_recorder(k1_work)
    k2_best, k2_rec = most_work_recorder(k2_work)
    bad = []
    for mod in (dec_ops, flash_ops):
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    with Spy(dec_ops, "decode_attention_cuda",
             by_thread("decode_attention", k1_rec)), \
            Spy(flash_ops, "flash_attention_cuda",
                by_thread("flash_attention", k2_rec)):
        serial = phase.buffered(k_recs, bad)
        phase.concurrent(serial, bad)
    launches = {"decode_attention": dec_ops.LAUNCHES,
                "flash_attention": flash_ops.LAUNCHES}
    print(f"http phase: {time.perf_counter() - t0:.1f} s; launches "
          f"{launches}, by thread {threads}")
    if min(launches.values()) == 0 or any(
            kind == "main" for _, kind in threads):
        fail("the HTTP phase did not launch K1 and K2 from the server's "
             "threads")
    rows = []
    for name, best, timer in (
            ("decode_attention", k1_best, lambda a, kw: time_decode(
                torch, dec_ops, *a)),
            ("flash_attention", k2_best, lambda a, kw: time_flash(
                torch, flash_ops, *a, **kw))):
        t = timer(*best[0])
        err = gate_err(name, t.pop("max_abs_err"), best[0][0][0].dtype)
        errs[name] = max(errs[name], err)
        rows.append(kernel_row(name, launches[name], err, t, path="http"))
    if bad:
        fail(f"the HTTP phase's rows differ outside the bands: {bad}")
    return rows


def aisql_path(torch, eng, errs):
    """Build oracle-70b at full width (depth cut), serve the five AISQL
    queries through ``AisqlEngine.sql`` over proxy-8b (``eng``) and
    oracle-70b with K1, K2 and K3 in the loop, then again through their
    plain versions, and gate on both.  Returns the kernels-line rows."""
    from repro_torch.configs.base import get_config
    from repro_torch.inference.engine import TorchInferenceEngine
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    full = get_config("oracle-70b")
    cfg = dataclasses.replace(full, num_layers=ORACLE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    oracle = TorchInferenceEngine(cfg, seed=SEED)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(oracle.params))
    print(f"engine: {oracle.arch} {cfg.num_layers} of {full.num_layers} "
          f"layers d_model {cfg.d_model} heads {cfg.num_heads}/"
          f"{cfg.num_kv_heads} hd {cfg.head_dim} d_ff {cfg.d_ff} vocab "
          f"{cfg.vocab_size} {cfg.dtype}, {n_params / 1e9:.2f} B params, "
          f"built in {time.perf_counter() - t0:.1f} s; depth cut to "
          f"{ORACLE_LAYERS} of {full.num_layers} layers (all {full.num_layers}"
          " hold 141 GB of bf16, more than the card holds beside proxy-8b)")
    if (dataclasses.replace(cfg, num_layers=full.num_layers) != full
            or oracle.backend != "continuous"):
        fail("oracle-70b is not at full width on the continuous path")
    warm = requests("oracle-70b")
    oracle.submit_batch([warm[0], warm[8], warm[12], warm[-1]])  # warm-up
    engines = [eng, oracle]
    catalog, _ = aisql_catalog()      # the catalog each run rebuilds
    labels = set(catalog.table("r").column("label").tolist())

    k1_best, k1_rec = most_work_recorder(k1_work)
    k2_best, k2_rec = most_work_recorder(k2_work)
    k3_best, k3_rec = most_work_recorder(
        lambda a: a[0].shape[0] * a[1].shape[0])
    for mod in (dec_ops, flash_ops, topk_ops):
        mod.LAUNCHES = 0
    flash_ops.CHUNKED_LAUNCHES = 0
    kc_best, kc_rec = chunk_recorder()
    with Spy(dec_ops, "decode_attention_cuda", k1_rec), \
            Spy(flash_ops, "flash_attention_cuda", k2_rec), \
            Spy(flash_ops, "chunked_attention_cuda", kc_rec), \
            Spy(topk_ops, "similarity_topk_cuda", k3_rec):
        k_recs = aisql_run(torch, engines, oracle, "auto")
    launches = {"decode_attention": dec_ops.LAUNCHES,
                "flash_attention": flash_ops.LAUNCHES,
                "similarity_topk": topk_ops.LAUNCHES,
                "flash_attention_chunked": flash_ops.CHUNKED_LAUNCHES}
    searches = sum(r["searches"] for r in k_recs)
    for rec in k_recs:
        check_aisql_tables(rec, labels)
        host = rec["wall"] - rec["engine_s"]
        print(f"aisql {rec['name']}: {rec['wall']:.3f} s wall ({host:.3f} s "
              f"in the SQL layer, {rec['engine_s']:.3f} s in the engines), "
              f"{len(rec['rows'])} rows, {rec['ai_calls']} AI calls, "
              f"{rec['credits']:.6g} credits, calls_by_model "
              f"{rec['by_model']}, index searches {rec['searches']}")
        print(f"  optimizer: {rec['trace']}; runtime: {rec['reopt'][:2]}")
    (stats,) = k_recs[0]["cascades"].values()
    print(f"aisql filter_cascade: cascade {stats}, delegation rate "
          f"{stats.delegation_rate:.4f}")
    print(f"aisql launches: {launches}; index searches and "
          f"topk_candidates calls {searches}")
    if not set(k_recs[0]["by_model"]) == {"proxy-8b", "oracle-70b"}:
        fail("the cascade did not call both proxy-8b and oracle-70b")
    if min(launches.values()) == 0 or launches["similarity_topk"] != searches:
        fail("the AISQL phase did not launch K1, K2 (both entries) and K3, "
             "or K3's launches differ from the manager's searches")

    # the same queries through the plain versions, on fresh engines of the
    # SQL layer over the same models and seeds
    p_recs = aisql_run(torch, engines, oracle, "reference")
    if [dec_ops.LAUNCHES, flash_ops.LAUNCHES, topk_ops.LAUNCHES,
            flash_ops.CHUNKED_LAUNCHES] != list(launches.values()):
        fail("the plain path launched a kernel")
    for rec in p_recs:
        check_aisql_tables(rec, labels)
    print(f"aisql plain path: {sum(r['wall'] for r in p_recs):.3f} s for the "
          f"five queries (kernel path {sum(r['wall'] for r in k_recs):.3f} s)"
          f"; peak device memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    k_score = {key: res.score for key, res in k_recs[0]["results"].items()
               if key[1] == "score"}
    p_score = {key: res.score for key, res in p_recs[0]["results"].items()
               if key[1] == "score"}
    d_score = max(abs(k_score[key] - p_score[key])
                  for key in k_score.keys() & p_score.keys())
    lps = [(lp, p["logprobs"][key]) for k, p in zip(k_recs, p_recs)
           for key, lp in k["logprobs"].items() if key in p["logprobs"]]
    d_lp = max(abs(a - b) for a, b in lps)
    print(f"aisql kernel vs plain: SCORE max |diff| {d_score:.3g} over "
          f"{len(k_score.keys() & p_score.keys())} prompts (AISQL_SCORE_TOL "
          f"{AISQL_SCORE_TOL}); CLASSIFY label logprobs max |diff| "
          f"{d_lp:.3g} nats over {len(lps)} continuations (AISQL_LOGPROB_TOL "
          f"{AISQL_LOGPROB_TOL})")
    if not (d_score <= AISQL_SCORE_TOL and d_lp <= AISQL_LOGPROB_TOL):
        fail("the AISQL queries' SCOREs or label logprobs differ between "
             "the kernel path and the plain path beyond their limits")
    bad = []
    for rid, kept, margin in filter_flips(k_recs[0], p_recs[0]):
        print(f"  aisql filter flip: review {rid} kept by the "
              f"{'kernel' if kept else 'plain'} path only, plain margin "
              f"{margin:.3g}")
        if not margin <= AISQL_SCORE_TOL:
            bad.append(f"review {rid}")
    for k, p in zip(k_recs[1:], p_recs[1:]):
        name = k["name"]
        if name in ("classify_groupby", "semantic_join"):
            cands = SECTIONS if name == "classify_groupby" else sorted(labels)
            flips = classify_flips(k, p, cands, name == "semantic_join")
            for prompt, (kl, pl, margin) in flips.items():
                print(f"  aisql {name} label flip: kernel {kl}, plain {pl},"
                      f" plain margin {margin:.3g} nats ({prompt[-48:]!r})")
                if not margin <= AISQL_LOGPROB_TOL:
                    bad.append(name)
            for rec in (k, p):
                want, got = classify_table(rec, catalog)
                if want != got:
                    fail(f"aisql {name}: the table is not the one its "
                         f"labels give: {got[:8]} vs {want[:8]}")
            print(f"aisql {name}: {len(flips)} label flips, tables equal "
                  f"{k['rows'] == p['rows']}")
        elif k["rows"] != p["rows"]:
            print(f"  aisql {name} differs: kernel {k['rows'][:12]} plain "
                  f"{p['rows'][:12]}")
            bad.append(name)
    if bad:
        fail(f"the AISQL kernel-path and plain-path rows differ outside "
             f"the bands: {bad}")

    rows = []
    for name, best, timer in (
            ("decode_attention", k1_best, lambda a, kw: time_decode(
                torch, dec_ops, *a)),
            ("flash_attention", k2_best, lambda a, kw: time_flash(
                torch, flash_ops, *a, **kw)),
            ("similarity_topk", k3_best, lambda a, kw: time_topk(
                torch, topk_ops, "aisql search", *a))):
        t = timer(*best[0])
        err = t.pop("max_abs_err")
        if name != "similarity_topk":
            err = gate_err(name, err, best[0][0][0].dtype)
        errs[name] = max(errs[name], err)
        rows.append(kernel_row(name, launches[name], err, t, path="aisql"))
    t = time_chunked(torch, flash_ops, "aisql served", *kc_best[0])
    del t["launches"]
    rows.append(kernel_row("flash_attention_chunked",
                           launches["flash_attention_chunked"],
                           t.pop("max_abs_err"), t, path="aisql"))
    # 8b. queries 1-3 over HTTP, on the same engines (no plain-path switch
    # is on: kernel_impls and the batchers' decode_impl are back at "auto")
    rows += http_path(torch, engines, oracle, k_recs, errs)
    del oracle, engines
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def topk_bounds(Q, N, D, k):
    """K3's bound: q and c read once, vals and idx written once, against
    the operations of the instruction it runs, three TF32 products of
    2*Q*N*D operations each at the TF32 rate (3xTF32).  Beside it, as in
    earlier runs, the same bytes against 2*Q*N*D fp32 FMA operations at
    the fp32 rate."""
    nbytes = 4.0 * (Q * D + N * D) + 8.0 * Q * k  # q, c in; vals, idx out
    b_ms, b_by = bound(nbytes, 3 * 2.0 * Q * N * D, "tf32")
    f_ms, f_by = bound(nbytes, 2.0 * Q * N * D, "float32")
    return {"bound_ms": b_ms, "bound_by": b_by, "fp32_fma_bound_ms": f_ms,
            "fp32_fma_bound_by": f_by}


def time_topk(torch, topk_ops, what, q, c, k, iters=20, plain_rows=None):
    """K3 on unit fp32 rows beside its plain version, its bound and
    ``torch.topk(q @ c.T, k)``.  ``plain_rows`` cuts the plain version
    (and its comparison) to the first queries, where its [Q, N] sort
    would not fit."""
    Q, D = q.shape
    N = c.shape[0]
    qp = q[:plain_rows] if plain_rows else q
    vals, idx = topk_ops.similarity_topk_cuda(q, c, k)
    rv, ri = topk_ops.similarity_topk(qp, c, k + 1, impl="reference")
    torch.cuda.synchronize()
    err, flips = topk_gate(torch, what, vals[:qp.shape[0]],
                           idx[:qp.shape[0]], rv, ri)
    ms = cuda_time_ms(lambda: topk_ops.similarity_topk_cuda(q, c, k), iters)
    plain_ms = cuda_time_ms(lambda: topk_ops.similarity_topk(
        qp, c, k, impl="reference"), max(iters // 4, 3), warmup=1)
    lib_ms = cuda_time_ms(lambda: torch.topk(q @ c.T, k), iters)
    dev_ms = device_ms(lambda: topk_ops.similarity_topk_cuda(q, c, k),
                       min(iters, 20))
    b = topk_bounds(Q, N, D, k)
    cut = f" (plain on the first {qp.shape[0]} queries)" if plain_rows else ""
    print(f"time K3 {what} Q={Q} N={N} D={D} k={k} fp32: kernel {ms:.4f} "
          f"ms (device {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms{cut}, "
          "torch.topk(q@c.T) "
          f"{lib_ms:.4f} ms, bound {b['bound_ms']:.5f} ms ({b['bound_by']}"
          f", 3xTF32), fp32 FMA bound {b['fp32_fma_bound_ms']:.5f} ms "
          f"({b['fp32_fma_bound_by']}); max|err| {err:.3g}, {flips} flips "
          "within margin")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, **b, "max_abs_err": err}


def topk_full_shapes(torch, topk_ops, dev):
    """K3 at two production shapes over a one-million-row corpus: join
    blocking at the default dim (A) and ORDER BY ... LIMIT 100 at a wide
    embedder's width (B)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    for what, Q, N, D, k, rows in (("full A", 1024, 1 << 20, 64, 8, 64),
                                   ("full B", 16, 1 << 20, 1024, 100, None)):
        q = topk_ops.l2_normalize(torch.randn((Q, D), generator=gen,
                                              device=dev))
        c = topk_ops.l2_normalize(torch.randn((N, D), generator=gen,
                                              device=dev))
        time_topk(torch, topk_ops, what, q, c, k, iters=10, plain_rows=rows)
        del q, c
        torch.cuda.empty_cache()


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the port "
              "on the card", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dryrun_") as tmp:
        dry = {"tmp": tmp, "procs": {}}
        try:
            return phases(torch, card, dev, kind, dry)
        finally:
            for proc, log in dry["procs"].values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                log.close()


def phases(torch, card, dev, kind, dry) -> int:
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.rglru_scan import ops as rglru_ops
    from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.inference.engine import TorchInferenceEngine

    # 1-2. build, then hold each kernel against its plain version
    build_kernels(dec_ops, flash_ops, topk_ops, rglru_ops, rwkv_ops)
    errs = check_kernels(torch, dec_ops, flash_ops, dev)
    errs["similarity_topk"] = check_topk(torch, topk_ops, dev)
    check_scans(torch, rglru_ops, rwkv_ops, dev, errs)
    chunk_rows = chunked_shapes(torch, flash_ops, dev)

    # 3. serve one mixed batch with proxy-8b at full width
    t0 = time.perf_counter()
    eng = TorchInferenceEngine("proxy-8b", smoke=False, seed=SEED)
    torch.cuda.synchronize()
    cfg = eng.cfg
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"engine: {cfg.name} {cfg.num_layers} layers d_model "
          f"{cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads} hd "
          f"{cfg.head_dim} vocab {cfg.vocab_size} {cfg.dtype}, "
          f"{n_params / 1e9:.2f} B params, built in "
          f"{time.perf_counter() - t0:.1f} s; depth not cut "
          f"({cfg.num_layers} of {N_LAYERS} layers)")
    if cfg.num_layers != N_LAYERS or cfg.d_model != 4096:
        fail("proxy-8b is not at full width")
    rows = chunk_rows + [r | {"path": "proxy-8b"}
                         for r in serve_and_check(torch, eng, errs)]
    # 7. the semantic index on the same engine, through K3
    rows.append(index_path(torch, eng, errs) | {"path": "semantic index"})
    # 8. AISQL queries over proxy-8b and oracle-70b (K1, K2, K3)
    rows += aisql_path(torch, eng, errs)
    long_shapes(torch, dec_ops, flash_ops, dev)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    topk_full_shapes(torch, topk_ops, dev)
    # 8b. the device mesh: proxy-8b's decode cell armed on a 1x1 NCCL
    #     mesh, then two gloo ranks on the card (sequence-sharded decode
    #     through K1, expert parallelism, a --model-parallel 2 train step)
    rows += mesh_path(torch, errs)
    # 8c. the dry-run (b): cells on a 1x1 mesh, for real and on meta
    dryrun_cells(torch)
    # 9-10. rwkv6-1.6b (K5), then recurrentgemma-9b (K4; K2, K1 at hd 256)
    rows += rwkv_path(torch, errs)
    rows += recurrentgemma_path(torch, errs)
    # 11. the zoo: qk-norm, parallel blocks, mixtures of experts and hd 160
    #     (K1, K2)
    rows += zoo_path(torch, errs)
    # 12. whisper-base (encoder-decoder) and qwen2-vl-7b (patches, M-RoPE)
    #     on the static path (K1, K2)
    rows += whisper_path(torch, errs)
    rows += qwen2_vl_path(torch, errs)
    # 13. training: launch/train.py with a checkpoint and a resume, and
    #     gradients through K2, K4 and K5 against the plain path
    rows += train_path(torch, errs)
    # 14. the dry-run (a): launch/dryrun.py on the production meshes, on
    #     the host, after the last timed phase
    dryrun_meshes(dry)

    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def time_decode(torch, dec_ops, q, kc, vc, lengths, iters=200, lse=False):
    import torch.nn.functional as F
    out = dec_ops.decode_attention_cuda(q, kc, vc, lengths, return_lse=lse)
    ref = dec_ops.flash_decode(q, kc, vc, lengths, impl="reference",
                               return_lse=lse)
    if lse:
        (out, out_lse), (ref, ref_lse) = out, ref
        fin = torch.isfinite(ref_lse)
        if not bool((torch.isfinite(out_lse) | (out_lse <= -1e29))[
                ~fin].all()) or max_err(out_lse[fin], ref_lse[fin]) > 1e-2:
            fail("K1's lse disagrees with its plain version")
    err = max_err(out, ref)
    B, _, H, hd = q.shape
    Smax = kc.shape[1]
    mask = (torch.arange(Smax, device=q.device)[None]
            < lengths[:, None])[:, None, None]            # [B,1,1,Smax]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    ms = cuda_time_ms(lambda: dec_ops.decode_attention_cuda(
        q, kc, vc, lengths, return_lse=lse), iters)
    plain_ms = cuda_time_ms(lambda: dec_ops.flash_decode(
        q, kc, vc, lengths, impl="reference", return_lse=lse),
        max(iters // 10, 5))
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
    dev_ms = device_ms(lambda: dec_ops.decode_attention_cuda(
        q, kc, vc, lengths, return_lse=lse))
    b_ms, b_by = decode_bound(q, kc, lengths, lse)
    print(f"time K1 decode B={B} H={H} KV={kc.shape[2]} hd={hd} Smax={Smax} "
          f"lengths={lengths.tolist()} {str(q.dtype).split('.')[-1]}: "
          f"kernel {ms:.4f} ms (device {fmt_ms(dev_ms)}), plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}); max|err| {err:.3g}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "max_abs_err": err}


def time_flash(torch, flash_ops, q, k, v, causal=True, window=0, iters=50,
               rel_tol=None):
    """K2 timed beside its plain version, its bound and SDPA; with
    ``rel_tol``, it fails where ||out-plain|| / ||plain|| exceeds it."""
    import torch.nn.functional as F
    out = flash_ops.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window)
    ref = flash_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    impl="reference")
    err = max_err(out, ref)
    if rel_tol is not None:
        rel = rel_l2(out, ref)
        print(f"K2 flash B={q.shape[0]} Sq={q.shape[1]} Skv={k.shape[1]} "
              f"causal={causal}: rel. L2 err {rel:.3g} (tol {rel_tol})")
        if not rel <= rel_tol:
            fail(f"K2 Sq={q.shape[1]} Skv={k.shape[1]} causal={causal} "
                 f"disagrees with its plain version: rel. L2 {rel} > "
                 f"{rel_tol}")
    B, Sq, H, hd = q.shape
    Skv = k.shape[1]
    qp = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    kp = torch.arange(Skv, device=q.device)[None]
    mask = (kp <= qp) if causal else torch.ones_like(kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    ms = cuda_time_ms(lambda: flash_ops.flash_attention_cuda(
        q, k, v, causal=causal, window=window), iters)
    plain_ms = cuda_time_ms(lambda: flash_ops.flash_attention(
        q, k, v, causal=causal, window=window, impl="reference"),
        max(iters // 5, 5))
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
    dev_ms = device_ms(lambda: flash_ops.flash_attention_cuda(
        q, k, v, causal=causal, window=window))
    b_ms, b_by = flash_bound(q, k, causal, window)
    print(f"time K2 flash B={B} Sq={Sq} Skv={Skv} H={H} KV={k.shape[2]} "
          f"hd={hd} causal={causal} window={window} "
          f"{str(q.dtype).split('.')[-1]}: kernel {ms:.4f} ms (device "
          f"{fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} "
          f"ms, bound {b_ms:.5f} ms ({b_by}); max|err| {err:.3g}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "max_abs_err": err}


def time_chunked(torch, flash_ops, what, args, kw):
    """K2's chunked entry on one input (args: q, k, v, cache_k, cache_v,
    lengths; kw: the norm scales and RoPE tables): checked against its
    plain version on copies of the cache views (rel. L2 of the output and
    of the caches within CHUNK_REL_TOL), timed by events and by the
    profiler's device time beside its plain version, its bound and SDPA
    (over the cache view, with the per-row causal mask: the yardstick
    leaves out the qk-norm, RoPE and the append).  Returns the timings,
    ``max_abs_err``, ``rel_l2`` and the launches of the checked call."""
    import torch.nn.functional as F
    q, k, v, ck, cv, lens = args
    B, T, H, hd = q.shape
    S, KV = ck.shape[1], ck.shape[2]
    kc, vc, kr, vr = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    n = flash_ops.CHUNKED_LAUNCHES
    out = flash_ops.chunked_attention_cuda(q, k, v, kc, vc, lens, **kw)
    launches = flash_ops.CHUNKED_LAUNCHES - n
    ref = flash_ops.chunked_attention(q, k, v, kr, vr, lens, **kw,
                                      impl="reference")
    torch.cuda.synchronize()
    rel, err = rel_l2(out, ref), max_err(out, ref)
    rel_k = max(rel_l2(kc, kr), rel_l2(vc, vr))
    norm = kw.get("q_norm") is not None
    if not (rel <= CHUNK_REL_TOL and rel_k <= CHUNK_REL_TOL):
        fail(f"K2 chunked {what} (H={H} KV={KV} hd={hd} S={S}) disagrees "
             f"with its plain version: rel. L2 out {rel:.3g}, cache "
             f"{rel_k:.3g} > {CHUNK_REL_TOL}")

    def kernel():
        flash_ops.chunked_attention_cuda(q, k, v, kc, vc, lens, **kw)

    ms = cuda_time_ms(kernel, 50)
    dev_ms = device_ms(kernel)
    plain_ms = cuda_time_ms(lambda: flash_ops.chunked_attention(
        q, k, v, kr, vr, lens, **kw, impl="reference"), 10)
    pos = lens[:, None] - T + torch.arange(T, dtype=torch.int32,
                                           device=q.device)[None]
    kp = torch.arange(S, device=q.device)[None, None]
    mask = (kp <= pos[:, :, None])[:, None]              # [B, 1, T, S]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, enable_gqa=True), 50)
    flops, nbytes = flash_ops.chunked_work(q, kc, lens)
    b_ms, b_by = bound(nbytes, flops, "bfloat16")
    print(f"time K2 chunked {what} B={B} T={T} H={H} KV={KV} hd={hd} "
          f"norm={norm} S={S} lengths={lens.tolist()}: kernel {ms:.4f} ms "
          f"(device {fmt_ms(dev_ms)}), plain {plain_ms:.4f} ms, sdpa "
          f"{lib_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}); rel. L2 out "
          f"{rel:.3g}, cache {rel_k:.3g} (tol {CHUNK_REL_TOL}), "
          f"max|err| {err:.3g}")
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "max_abs_err": err, "rel_l2": rel, "launches": launches}


def chunked_shapes(torch, flash_ops, dev):
    """K2's chunked entry at CHUNK_SHAPES (``time_chunked``).  Returns
    kernels-line rows, each with the launches of its checked call."""
    from repro_torch.models.common import rope_cos_sin
    gen = torch.Generator(device=dev).manual_seed(SEED + 29)
    B, T = 8, 32
    rows = []
    for what, H, KV, hd, norm, nb in CHUNK_SHAPES:
        S = 32 * nb
        lengths = [T, T, S, max(S - 5, T), min(77, S + 3), S + 31,
                   max(S // 2, T), 40]

        def r(*shape):
            return torch.randn(shape, generator=gen,
                               device=dev).to(torch.bfloat16)

        args = (r(B, T, H, hd), r(B, T, KV, hd), r(B, T, KV, hd),
                r(B, S, KV, hd), r(B, S, KV, hd),
                torch.tensor(lengths, dtype=torch.int32, device=dev))
        pos = args[5][:, None] - T + torch.arange(T, dtype=torch.int32,
                                                  device=dev)[None]
        cos, sin = rope_cos_sin(pos, hd, 1e6)
        kw = dict(cos=cos, sin=sin, eps=1e-6)
        if norm:
            kw.update(q_norm=1 + 0.2 * r(hd), k_norm=1 + 0.2 * r(hd))
        t = time_chunked(torch, flash_ops, what, args, kw)
        rows.append(kernel_row("flash_attention_chunked", t.pop("launches"),
                               t.pop("max_abs_err"), t,
                               path=f"{what} nb={nb}"))
    return rows


def long_shapes(torch, dec_ops, flash_ops, dev):
    """The model's attention at a full 512-token cache (decode) and a
    384-token prefill of 8 rows, for comparison across PRs."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    B, H, KV, hd = 8, 32, 8, 128

    def r(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)

    time_decode(torch, dec_ops, r(B, 1, H, hd), r(B, 512, KV, hd),
                r(B, 512, KV, hd),
                torch.full((B,), 512, dtype=torch.int32, device=dev))
    time_flash(torch, flash_ops, r(B, 384, H, hd), r(B, 384, KV, hd),
               r(B, 384, KV, hd), iters=20)


def profile_served(torch, eng, reqs):
    """Profile one served batch: the card's busy time (the union of the
    intervals of every kernel and copy it ran, from ``device_events``)
    against the batch's wall time, and the kernels that took most of it."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as flash_ops
    torch.cuda.synchronize()
    launched = dec_ops.LAUNCHES + flash_ops.LAUNCHES
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.submit_batch(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = dec_ops.LAUNCHES + flash_ops.LAUNCHES - launched
    events = device_events(prof)
    busy_ns, by_name = device_busy(events)
    if not events:
        print("profile: no device time recorded (not measured)")
        return
    ours = sum(n for name, (n, _) in by_name.items()
               if any(k in name for k in ("decode_bf16_kernel",
                                          "decode_f32_kernel",
                                          "flash_attention_kernel",
                                          "flash_attention_wgmma_kernel")))
    print(f"profile: served batch wall {wall * 1e3:.1f} ms (profiler on), "
          f"device busy {busy_ns / 1e6:.1f} ms, idle share "
          f"{1 - busy_ns / 1e9 / wall:.3f}; {len(events)} device events, "
          f"K1 / K2 launches recorded {ours} of {launched}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    for name, (n, total) in top[:12]:
        print(f"  {total / 1e6:9.3f} ms {n:6d}x  {name[:90]}")


# ---------------------------------------------------------------------------
# the device mesh
# ---------------------------------------------------------------------------


def fill_mesh_cache(torch, cache, rank):
    """Fill this rank's sequence chunk of a [P, B, MESH_SLOTS, KV, hd]
    cache (DTensors placed by the cache specs) from seeds: slots
    [c * half, (c + 1) * half) of layer p take the same numbers on every
    mesh, so a two-rank cache holds (a)'s values.  Sets the lengths."""
    half = MESH_SLOTS // 2
    dev = torch.device("cuda")
    for name in ("k", "v"):
        loc = cache["periods"]["b0"][name].to_local()
        per = loc.shape[2]
        for p in range(loc.shape[0]):
            for c in range(per // half):
                glob = rank * per // half + c
                gen = torch.Generator(device=dev).manual_seed(
                    SEED * 1000 + 4 * p + 2 * glob + (name == "v"))
                blk = torch.randn((loc.shape[1], half) + tuple(loc.shape[3:]),
                                  generator=gen, device=dev)
                loc[p, :, c * half:(c + 1) * half] = blk.to(loc.dtype)
    cache["len"].to_local().copy_(torch.tensor(MESH_LENGTHS,
                                               dtype=torch.int32))


def mesh_decode(torch, cell, params, cache, tokens, dec_ops):
    """MESH_STEPS decode steps of ``cell``, fed ``tokens`` [STEPS, B, 1]:
    (logits [STEPS, B, V] fp32 on the host, step ms, K1 launches, calls of
    flash_decode_sharded)."""
    calls = []
    logits, ms = [], []
    dec_ops.LAUNCHES = 0
    with Spy(dec_ops, "flash_decode_sharded", lambda a, k, o: calls.append(1)):
        for t in range(MESH_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, cache, lg = cell.run(params, cache, {"tokens": tokens[t]})
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            logits.append(lg.float().cpu())
    return torch.stack(logits), ms, dec_ops.LAUNCHES, len(calls)


def hold_mesh_logits(torch, what, got, ref, tol):
    """Each row's relative L2 within ``tol`` of the reference's, and its
    greedy token equal except within MESH_TOKEN_MARGIN of a tie.  Returns
    the largest relative L2."""
    rel = ((got - ref).norm(dim=-1) / ref.norm(dim=-1)).max().item()
    top2 = ref.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]
    differ = got.argmax(-1) != ref.argmax(-1)
    close = differ & (margin < MESH_TOKEN_MARGIN)
    print(f"mesh {what}: max row rel. L2 {rel:.4g} (tol {tol}),"
          f" greedy tokens differing {int(differ.sum())} of "
          f"{differ.numel()} ({int(close.sum())} within "
          f"{MESH_TOKEN_MARGIN} of a tie)")
    if not rel <= tol:
        fail(f"mesh {what}: logits rel. L2 {rel} > {tol}")
    if bool((differ & ~close).any()):
        fail(f"mesh {what}: greedy tokens differ away from a tie")
    return rel


def mesh_configs():
    """proxy-8b at full width as served (bf16), and in fp32 at
    MESH_FP32_LAYERS layers."""
    import dataclasses
    from repro_torch.configs import base as cfgs
    cfg = cfgs.get_config("proxy-8b")
    return {"bf16": cfg, "fp32": dataclasses.replace(
        cfg, dtype="float32", num_layers=MESH_FP32_LAYERS)}


def mesh_unarmed(torch, cfg, mesh, dev):
    """proxy-8b's decode cell on the 1x1 ``mesh`` with its seeded cache,
    and MESH_STEPS greedy steps of the unarmed one-rank path on the same
    storage: (params, cell, cache, tokens [STEPS, B, 1], logits
    [STEPS, B, V] fp32 on the host, step ms)."""
    from repro_torch.configs import base as cfgs
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    model = model_zoo.build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    shape = cfgs.ShapeSpec("decode_32k_b4", MESH_SLOTS, MESH_B, "decode")
    cell = steps.build_cell(cfg, shape, mesh)
    cache = cell.zeros_cache(dev)
    fill_mesh_cache(torch, cache, 0)
    print(f"mesh (a): proxy-8b {cfg.num_layers} layers d_model "
          f"{cfg.d_model} {cfg.dtype}, cache {MESH_B} x {MESH_SLOTS} slots "
          f"({2 * cache['periods']['b0']['k'].to_local().nbytes / 1e9:.1f}"
          f" GB), lengths {list(MESH_LENGTHS)}")
    plain = {"periods": {"b0": {n: cache["periods"]["b0"][n].to_local()
                                for n in ("k", "v")}},
             "len": torch.tensor(MESH_LENGTHS, dtype=torch.int32, device=dev)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    tok = torch.randint(3, cfg.vocab_size, (MESH_B, 1), generator=gen,
                        device=dev, dtype=torch.int32)
    toks, ref, ms = [], [], []
    with torch.no_grad():
        for _ in range(MESH_STEPS):
            toks.append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.apply(params, {"tokens": tok}, mode="decode",
                              cache=plain)
            lg = model.logits_of(params, out["hidden"][:, 0])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            ref.append(lg.float().cpu())
            tok = lg.argmax(-1, keepdim=True).to(torch.int32)
    cache["len"].to_local().copy_(torch.tensor(MESH_LENGTHS,
                                               dtype=torch.int32))
    return params, cell, cache, torch.stack(toks), torch.stack(ref), ms


def mesh_one_card(torch, dec_ops, tmp):
    """(a) proxy-8b's decode cell on a 1x1 mesh over NCCL, armed, against
    the unarmed path on the same weights and cache; then the unarmed path
    in fp32.  Writes the tokens and the logits that (b) is held to into
    ``tmp``/mesh_<bf16|fp32>.pt: (a)'s armed logits, the fp32 unarmed
    ones.  Returns K1's timing at the sharded chunk shape and the phase's
    numbers."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats()
    store = dist.FileStore(str(Path(tmp) / "nccl_store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = make_host_mesh(model=1, device_type="cuda")
        conf = mesh_configs()
        cfg = conf["bf16"]
        params, cell, cache, tokens, ref, plain_ms = mesh_unarmed(
            torch, cfg, mesh, dev)
        # armed: the decode cell on the placed weights and cache
        params, = cell.place(params)
        got, ms, k1, sharded = mesh_decode(torch, cell, params, cache,
                                           tokens, dec_ops)
        print(f"mesh (a): K1 launches {k1} through flash_decode_sharded "
              f"({sharded} calls; expected {cfg.num_layers * MESH_STEPS}); "
              f"decode step median {statistics.median(ms):.3f} ms armed, "
              f"{statistics.median(plain_ms):.3f} ms unarmed")
        if k1 != cfg.num_layers * MESH_STEPS or sharded != k1:
            fail("mesh (a): K1 did not run once a layer a step through "
                 "flash_decode_sharded")
        rel = hold_mesh_logits(torch, "(a) 1x1 NCCL vs unarmed", got, ref,
                               MESH_LOGITS_REL)
        torch.save({"tokens": tokens.cpu(), "logits": got},
                   str(Path(tmp) / "mesh_bf16.pt"))
        # K1 at the sharded chunk shape: half the cache, lse on, the
        # chunk's local lengths (rank 0's on two ranks)
        half = MESH_SLOTS // 2
        kc = cache["periods"]["b0"]["k"].to_local()[0, :, :half]
        vc = cache["periods"]["b0"]["v"].to_local()[0, :, :half]
        gen = torch.Generator(device=dev).manual_seed(SEED + 8)
        q = torch.randn((MESH_B, 1, cfg.num_heads, cfg.head_dim),
                        generator=gen, device=dev).to(kc.dtype)
        loc = torch.tensor(MESH_LENGTHS, dtype=torch.int32,
                           device=dev).clamp(0, half)
        t = time_decode(torch, dec_ops, q, kc, vc, loc, lse=True)
        peak = torch.cuda.max_memory_allocated() / 1e9
        del params, cell, cache, kc, vc
        gc.collect()
        torch.cuda.empty_cache()
        # the fp32 reference of (b)'s fp32 run
        torch.cuda.reset_peak_memory_stats()
        params, cell, cache, tokens, ref, ms32 = mesh_unarmed(
            torch, conf["fp32"], mesh, dev)
        torch.save({"tokens": tokens.cpu(), "logits": ref},
                   str(Path(tmp) / "mesh_fp32.pt"))
        print(f"mesh (a): fp32 unarmed decode step median "
              f"{statistics.median(ms32):.3f} ms, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del params, cell, cache
        return {"k1_launches": k1, "rel": rel, "step_ms": ms,
                "plain_ms": plain_ms, "chunk": t, "peak_gb": peak}
    finally:
        dist.destroy_process_group()


def mesh_rank(rank, tmp, n_ranks):
    """One rank of (b): two gloo ranks on the one card, proxy-8b's decode
    cell on (data=1, model=2) in bf16 and in fp32, then qwen2-moe-a2.7b
    expert-parallel.  Writes its results to ``tmp``/rank<r>.pt."""
    import faulthandler
    import traceback
    import torch
    import torch.distributed as dist
    faulthandler.enable()
    sys.path.insert(0, str(ROOT / "src"))
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    store = dist.FileStore(str(Path(tmp) / "gloo_store"), n_ranks)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=n_ranks)
    res = {}
    try:
        from repro_torch.launch.mesh import make_host_mesh
        mesh = make_host_mesh(model=n_ranks, device_type="cuda")
        for tag, cfg in mesh_configs().items():
            res[tag] = mesh_rank_proxy(torch, mesh, rank, n_ranks, tmp, cfg,
                                       tag)
            gc.collect()
            torch.cuda.empty_cache()
        res["moe"] = mesh_rank_moe(torch, mesh, rank)
    except BaseException:
        res["error"] = traceback.format_exc()
    torch.save(res, str(Path(tmp) / f"rank{rank}.pt"))
    dist.destroy_process_group()


def mesh_rank_proxy(torch, mesh, rank, n_ranks, tmp, cfg, tag):
    """This rank's part of proxy-8b's decode cell, fed the tokens of
    ``tmp``/mesh_<tag>.pt.  The ranks draw the full weights one at a time
    (each keeps its slice), so that two full fp32 copies never share the
    card."""
    import torch.distributed as dist
    from repro_torch.configs import base as cfgs
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.launch import steps
    from repro_torch.models import model_zoo
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = model_zoo.build(cfg)
    shape = cfgs.ShapeSpec("decode_32k_b4", MESH_SLOTS, MESH_B, "decode")
    cell = steps.build_cell(cfg, shape, mesh)
    params = None
    for r in range(n_ranks):
        if r == rank:
            params, = cell.place(model.init_params(
                torch.Generator(device=dev).manual_seed(SEED)))
            gc.collect()
            torch.cuda.empty_cache()
        dist.barrier()
    w_gb = sum(t.to_local().nbytes for t in _leaves(params)) / 1e9
    cache = cell.zeros_cache(dev)
    fill_mesh_cache(torch, cache, rank)
    c_gb = sum(t.to_local().nbytes for t in _leaves(cache)) / 1e9
    built = time.perf_counter() - t0
    ref = torch.load(str(Path(tmp) / f"mesh_{tag}.pt"))
    got, ms, k1, sharded = mesh_decode(torch, cell, params, cache,
                                       ref["tokens"].to(dev), dec_ops)
    out = {"logits": got, "step_ms": ms, "k1": k1, "sharded": sharded,
           "weights_gb": w_gb, "cache_gb": c_gb, "built_s": built,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, cache
    return out


def full_tree(tree):
    """A tree of DTensors as full tensors (a collective on every rank)."""
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [full_tree(v) for v in tree]
    return tree.full_tensor() if hasattr(tree, "full_tensor") else tree


def mesh_rank_moe(torch, mesh, rank):
    """qwen2-moe-a2.7b at full width: rank 0 runs the one-rank pass, then
    both ranks the expert-parallel one; rank 0 holds them together."""
    import torch.distributed as dist
    from repro_torch.configs import base as cfgs
    from repro_torch.launch import sharding
    from repro_torch.models import model_zoo, shardctx
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg = cfgs.get_config("qwen2-moe-a2.7b")
    model = model_zoo.build(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(SEED))
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    tokens = torch.randint(3, cfg.vocab_size, (MESH_MOE_B, MESH_MOE_S),
                           generator=gen, device=dev, dtype=torch.int32)
    tap = RouterTap(cfg)
    one, one_recs = None, []
    if rank == 0:
        with tap.installed(), tap.into(one_recs, "train"), torch.no_grad():
            o = model.apply(params, {"tokens": tokens}, mode="train")
            one = model.logits_of(params, o["hidden"]).float()
    dist.barrier()
    params = sharding.distribute(mesh, params, sharding.param_specs(
        mesh, params, fsdp=None, cfg=cfg))
    experts_local = params["layers"][0]["moe"]["experts"]["wi"].to_local()
    batch = sharding.distribute(mesh, {"tokens": tokens},
                                sharding.batch_specs(mesh, {"tokens": tokens}))
    ep_recs, seen = [], []
    from repro_torch.models import blocks

    def per_layer(args, kw, out):
        # each MoE layer: its routing on full values, and its input and
        # expert-parallel output for the one-rank MoE below
        p, x, ctx = args
        if ctx.mode != "train":
            return
        full = {"router": {"w": p["router"]["w"].full_tensor()}}
        xf = x.full_tensor()
        ep_recs.append(routing(full, xf, ctx))
        y, aux = out
        aux = aux.full_tensor() if hasattr(aux, "full_tensor") else aux
        seen.append((xf, y.full_tensor(), float(aux), ctx))
    ep_calls = []
    with Spy(blocks, "moe_apply", per_layer), \
            Spy(blocks, "_moe_ep", lambda a, k, o: ep_calls.append(1)), \
            shardctx.armed(mesh), torch.no_grad():
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        o = model.apply(params, batch, mode="train")
        got = model.logits_of(params, o["hidden"]).full_tensor().float()
        torch.cuda.synchronize()
        ep_s = time.perf_counter() - t1
    res = {"experts_local": tuple(experts_local.shape),
           "ep_layers": len(ep_calls), "ep_s": ep_s,
           "seconds": time.perf_counter() - t0,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params, o, experts_local
    if rank == 0:
        rel = ((got - one).norm(dim=-1) / one.norm(dim=-1))     # [B, S]
        flips = expert_flips(ep_recs, one_recs, cfg.num_layers)
        first = first_flips(flips)
        res.update(rel=float(rel.max()), flips=len(flips),
                   first=fmt_flips(first), explained=explained(first),
                   rows_over=int((rel > SERVE_TOL["qwen2-moe-a2.7b"][
                       "decode_logits_rel"]).sum()))
        # each layer's one-rank MoE on the expert-parallel pass's input
        # (the same routing), on the full weights drawn again from the seed
        # once the sharded ones are freed
        gc.collect()
        torch.cuda.empty_cache()
        params = model.init_params(
            torch.Generator(device=dev).manual_seed(SEED))
        layers = []
        with torch.no_grad():
            for i, (xf, yf, aux, ctx) in enumerate(seen):
                y1, aux1 = blocks.moe_apply(params["layers"][i]["moe"], xf,
                                            ctx)
                y1 = y1.float()
                layers.append((float((yf.float() - y1).norm() / y1.norm()),
                               abs(aux - float(aux1)) / abs(float(aux1))))
        res["layers"] = layers
        del params
    return res


def run_ranks(fn, args, n):
    """Start n spawned processes of ``fn(rank, *args)`` and wait for them
    (MESH_RANK_TIMEOUT); a rank that fails or hangs fails the phase."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=n, join=False,
                             start_method="spawn")
    deadline = time.time() + MESH_RANK_TIMEOUT
    try:
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                fail(f"mesh ranks did not finish in {MESH_RANK_TIMEOUT} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def mesh_train(torch):
    """(b) MESH_TRAIN_STEPS launch/train.py steps of proxy-8b at
    TRAIN_LAYERS layers on one rank, then with --model-parallel 2
    --backend gloo (the launcher starts its two ranks); and --backend
    nccl with two ranks on one card must refuse."""
    import tempfile
    from repro_torch.launch import train
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        argv = ["--no-smoke", "--arch", "proxy-8b", "--layers",
                str(TRAIN_LAYERS), "--steps", str(MESH_TRAIN_STEPS),
                "--batch", str(TRAIN_B), "--seq", str(TRAIN_S), "--lr",
                str(TRAIN_LR), "--ckpt-every", "0", "--ckpt-dir", d]
        try:
            train.run(argv + ["--model-parallel", "2"])
        except ValueError as e:
            print(f"mesh train: --backend nccl with 2 ranks on "
                  f"{torch.cuda.device_count()} card(s) refused: {e}")
        else:
            fail("mesh train: --backend nccl ran two ranks on one card")
        t0 = time.perf_counter()
        one = train.run(argv)
        one_s = time.perf_counter() - t0
        del one["state"]
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        two = train.run(argv + ["--model-parallel", "2", "--backend",
                                "gloo"])
        two_s = time.perf_counter() - t0
    h1, h2 = one["history"], two["history"]
    if len(h1) != MESH_TRAIN_STEPS or len(h2) != MESH_TRAIN_STEPS:
        fail(f"mesh train: {len(h1)} / {len(h2)} steps recorded")

    def rel(a, b):
        return abs(a - b) / abs(b)
    loss = rel(h2[0]["loss"], h1[0]["loss"])
    grad = rel(h2[0]["grad_norm"], h1[0]["grad_norm"])
    fall1 = h1[0]["loss"] - h1[1]["loss"]
    fall2 = h2[0]["loss"] - h2[1]["loss"]
    drop = rel(fall2, fall1)
    print(f"mesh train: proxy-8b {TRAIN_LAYERS} layers, {TRAIN_B} x "
          f"{TRAIN_S} tokens, {MESH_TRAIN_STEPS} steps, one rank / "
          f"--model-parallel 2: losses {[round(h['loss'], 6) for h in h1]}"
          f" / {[round(h['loss'], 6) for h in h2]}; step 1 loss rel. "
          f"{loss:.3g} (tol {MESH_TRAIN_LOSS_REL}), grad norm "
          f"{h1[0]['grad_norm']:.6g} / {h2[0]['grad_norm']:.6g} (rel. "
          f"{grad:.3g}, tol {MESH_TRAIN_GRAD_REL}); the update's fall in "
          f"loss {fall1:.6f} / {fall2:.6f} (rel. {drop:.3g}, tol "
          f"{MESH_TRAIN_DROP_REL}); step {h1[-1]['seconds']:.3f} s / "
          f"{h2[-1]['seconds']:.3f} s, runs {one_s:.1f} s / {two_s:.1f} s")
    if not loss <= MESH_TRAIN_LOSS_REL:
        fail(f"mesh train: loss {h2[0]['loss']} vs one rank's "
             f"{h1[0]['loss']}")
    if not grad <= MESH_TRAIN_GRAD_REL:
        fail(f"mesh train: grad norm {h2[0]['grad_norm']} vs one rank's "
             f"{h1[0]['grad_norm']}")
    if not drop <= MESH_TRAIN_DROP_REL:
        fail(f"mesh train: the first update lowered the loss by {fall2}, "
             f"one rank's by {fall1}")


def mesh_path(torch, errs):
    """The mesh phase: (a) proxy-8b's decode cell armed on a 1x1 NCCL
    mesh, held to the unarmed path; (b) two gloo ranks on the card:
    proxy-8b TP / sequence-sharded in bf16 and fp32, qwen2-moe-a2.7b
    expert-parallel, and --model-parallel 2 train steps.  Returns K1's row
    at the sharded chunk shape."""
    import tempfile
    from repro_torch.kernels.decode_attention import ops as dec_ops
    t0 = time.perf_counter()
    card = card_line()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        a = mesh_one_card(torch, dec_ops, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        ta = time.perf_counter()
        run_ranks(mesh_rank, (tmp, 2), 2)
        ranks = [torch.load(str(Path(tmp) / f"rank{r}.pt")) for r in (0, 1)]
        refs = {tag: torch.load(str(Path(tmp) / f"mesh_{tag}.pt"))
                for tag in ("bf16", "fp32")}
    for r, res in enumerate(ranks):
        if "error" in res:
            fail(f"mesh rank {r}:\n{res['error']}")
    tb = time.perf_counter()
    tols = {"bf16": (MESH_TP_LOGITS_REL, "(a)"),
            "fp32": (MESH_FP32_REL, "one rank unarmed")}
    for tag, cfg in mesh_configs().items():
        L = cfg.num_layers
        tol, against = tols[tag]
        for r, res in enumerate(ranks):
            p = res[tag]
            print(f"mesh (b) rank {r} {tag}: proxy-8b weights "
                  f"{p['weights_gb']:.2f} GB, cache {p['cache_gb']:.2f} GB, "
                  f"built in {p['built_s']:.1f} s; K1 launches {p['k1']} "
                  f"({p['sharded']} sharded calls), decode step median "
                  f"{statistics.median(p['step_ms']):.1f} ms, peak "
                  f"{p['peak_gb']:.1f} GB; {card}")
            if p["k1"] != L * MESH_STEPS or p["sharded"] != L * MESH_STEPS:
                fail(f"mesh (b) rank {r} {tag}: K1 ran {p['k1']} times, "
                     f"expected {L * MESH_STEPS}")
            hold_mesh_logits(torch, f"(b) rank {r} {tag} two gloo ranks vs "
                             f"{against}", p["logits"], refs[tag]["logits"],
                             tol)
    for r, res in enumerate(ranks):
        m = res["moe"]
        print(f"mesh (b) rank {r}: qwen2-moe-a2.7b experts a rank "
              f"{m['experts_local'][0]}, {m['ep_layers']} expert-parallel "
              f"layers, pass {m['ep_s']:.2f} s, peak {m['peak_gb']:.1f} GB")
        if m["experts_local"][0] != 32 or m["ep_layers"] != 24:
            fail(f"mesh (b) rank {r}: qwen2-moe not expert-parallel "
                 f"({m['experts_local']}, {m['ep_layers']} layers)")
    m = ranks[0]["moe"]
    layer_rel = max(t for t, _ in m["layers"])
    aux_rel = max(x for _, x in m["layers"])
    print(f"mesh (b): qwen2-moe expert-parallel MoE layers vs the one-rank "
          f"MoE on the same inputs: {len(m['layers'])} layers, largest "
          f"rel. L2 {layer_rel:.4g} (tol {MESH_MOE_LAYER_REL}), aux "
          f"rel. {aux_rel:.3g} (tol {MESH_MOE_AUX_REL}); by layer "
          f"{[float(f'{t:.3g}') for t, _ in m['layers']]}")
    if len(m["layers"]) != 24 or not (layer_rel <= MESH_MOE_LAYER_REL
                                      and aux_rel <= MESH_MOE_AUX_REL):
        fail("mesh (b): qwen2-moe's expert-parallel MoE layers differ from "
             "the one-rank MoE on the same inputs")
    tol = SERVE_TOL["qwen2-moe-a2.7b"]["decode_logits_rel"]
    print(f"mesh (b): qwen2-moe expert-parallel vs one rank: max rel. L2 "
          f"{m['rel']:.4g} (tol {tol}), {m['rows_over']} positions over, "
          f"{m['flips']} router flips; first {m['first'] or 'none'}")
    if m["rel"] > tol and not m["explained"]:
        fail("mesh (b): qwen2-moe expert-parallel logits differ past "
             "SERVE_TOL without a router flip within ROUTER_MARGIN_TOL")
    mesh_train(torch)
    tc = time.perf_counter()
    print(f"mesh: phase {tc - t0:.1f} s ((a) {ta - t0:.1f} s, (b) ranks "
          f"{tb - ta:.1f} s, train {tc - tb:.1f} s); (a) peak "
          f"{a['peak_gb']:.1f} GB; {card}")
    t = a["chunk"]
    err = gate_err("decode_attention", t.pop("max_abs_err"), torch.bfloat16)
    errs["decode_attention"] = max(errs["decode_attention"], err)
    return [kernel_row("decode_attention", a["k1_launches"], err, t,
                       path="mesh: sharded chunk (a)",
                       shape=f"B={MESH_B} slots={MESH_SLOTS // 2} lse")]


# ---------------------------------------------------------------------------
# the dry-run phase
# ---------------------------------------------------------------------------


def dryrun_start(dry):
    """(a) starts: ``python -m repro_torch.launch.dryrun`` in a process a
    job of DRY_JOBS (each of DRY_SHAPES of every arch but DRY_LEFT_OUT on
    the single-pod mesh, proxy-8b's cells on both meshes), on the host
    (they see no card).  Fills ``dry["procs"]`` with {name: (process,
    log file)} and ``dry["t0"]``; the JSON records go to ``dry["tmp"]``."""
    import os
    from repro_torch.configs import base as cfgs
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    for name, (archs, shape) in DRY_JOBS.items():
        archs = archs or [a for a in cfgs.ARCH_IDS
                          if (a, shape) not in DRY_LEFT_OUT]
        args = ["--arch", ",".join(archs)]
        if shape:
            args += ["--shape", shape, "--single-pod-only"]
        log = open(Path(dry["tmp"]) / f"{name}.log", "w+")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args,
             "--json", str(Path(dry["tmp"]) / f"{name}.json")],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=str(ROOT))
        dry["procs"][name] = (proc, log)
    dry["t0"] = time.perf_counter()


def dryrun_wait(dry):
    """(a) ends: each process's records, after it exited 0 within
    DRY_TIMEOUT s of their start with every cell [OK]."""
    t0 = dry["t0"]
    recs = {}
    for name, (proc, log) in dry["procs"].items():
        left = max(1.0, DRY_TIMEOUT - (time.perf_counter() - t0))
        try:
            rc = proc.wait(timeout=left)
        except subprocess.TimeoutExpired:
            fail(f"dry-run (a) {name}: not done {DRY_TIMEOUT} s after its "
                 "start")
        log.seek(0)
        text = log.read()
        if rc != 0:
            fail(f"dry-run (a) {name}: exit code {rc}:\n{text[-6000:]}")
        path = Path(log.name).with_suffix(".json")
        recs[name] = json.loads(path.read_text())
        print(f"dry-run (a) {name}: {text.strip().splitlines()[-1]}, done "
              f"by {time.perf_counter() - t0:.0f} s after its start")
    return recs


def dry_cell(arch, layers, kind, S, B):
    import dataclasses
    from repro_torch.configs import base as cfgs
    cfg = cfgs.get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    return cfg, cfgs.ShapeSpec(f"{kind}_{S}_b{B}", S, B, kind)


def dry_real_args(torch, cell, dev):
    """The cell's arguments on the card, drawn from SEED and placed: full
    prompts; a decode cache of zeros holding seq_len - 1 tokens."""
    from repro_torch.train.train_step import init_state
    cfg, shape = cell.model.cfg, cell.shape
    gen = torch.Generator(device=dev).manual_seed(SEED)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tok = torch.randint(3, cfg.vocab_size, (B, S), generator=gen,
                            device=dev, dtype=torch.int32)
        batch = {"tokens": tok, "labels": tok.clone(),
                 "loss_mask": torch.ones((B, S), device=dev)}
        return cell.place(init_state(cell.model, SEED, dev).tree(), batch)
    params = cell.model.init_params(gen)
    if shape.kind == "prefill":
        batch = {"tokens": torch.randint(3, cfg.vocab_size, (B, S),
                                         generator=gen, device=dev,
                                         dtype=torch.int32),
                 "lengths": torch.full((B,), S, dtype=torch.int32,
                                       device=dev)}
        return cell.place(params, batch)
    cache = cell.zeros_cache(dev)
    cache["len"].to_local().fill_(S - 1)
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (B, 1),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    from repro_torch.launch import sharding as shd
    return (shd.distribute(cell.mesh, params, cell.in_specs[0]), cache,
            shd.distribute(cell.mesh, batch, cell.in_specs[2]))


def dry_meta_cells():
    """(b) on meta: each cell of DRY_CELLS through ``dryrun.run_cell`` on
    a 1x1 mesh of a fake world of one rank (before the NCCL world)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch import dryrun
    dryrun.fake_world(1)
    try:
        mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
        return [dryrun.run_cell(*dry_cell(a, n, *c), mesh=mesh,
                                grad_accum=1, verbose=False)
                for a, n, c in DRY_CELLS]
    finally:
        dist.destroy_process_group()


def dry_real_cells(torch, metas):
    """(b) on the card: each cell of DRY_CELLS run once on a 1x1 NCCL mesh
    under the counter (``roofline.analyze_cell``), held to its meta
    record."""
    import torch.distributed as dist
    import tempfile
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.launch import roofline as rl
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line()
    mods = train_kernels() | {"decode_attention": dec_ops}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dry_") as tmp:
        store = dist.FileStore(str(Path(tmp) / "nccl_store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=dev)
        try:
            mesh = make_host_mesh(model=1, device_type="cuda")
            for (arch, n, c), meta in zip(DRY_CELLS, metas):
                cfg, shape = dry_cell(arch, n, *c)
                cell = steps.build_cell(cfg, shape, mesh, grad_accum=1)
                args = dry_real_args(torch, cell, dev)
                gc.collect()
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                zero_launches(mods)
                t0 = time.perf_counter()
                real = rl.analyze_cell(cell, *args).to_dict()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                peak = torch.cuda.max_memory_allocated() - before
                launches = {k: v for k, v in launch_counts(mods).items()
                            if v}
                dry_hold(arch, n, shape, meta, real, launches, peak, ms,
                         card)
                del args, cell
                gc.collect()
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()


def dry_hold(arch, n, shape, meta, real, launches, peak, ms, card):
    """Print one pair (meta, card) and fail where they differ."""
    what = (f"dry-run (b) {arch}{f' at {n} layers' if n else ''} "
            f"{shape.kind} B={shape.global_batch} S={shape.seq_len}")
    mm, mr = meta["memory_per_device"], real["memory_per_device"]
    meta_l = meta["detail"]["kernel_launches"]
    slack = max(DRY_PEAK_REL * peak, DRY_PEAK_SLACK)
    print(f"{what}: FLOPs {meta['hlo_flops_per_dev']:.6g} meta / "
          f"{real['hlo_flops_per_dev']:.6g} card, bytes "
          f"{meta['hlo_bytes_per_dev']:.6g} / {real['hlo_bytes_per_dev']:.6g}"
          f", collectives {meta['collectives']} / {real['collectives']}, "
          f"launches {meta_l} / {launches}; arguments "
          f"{mm['argument_bytes'] / 2**30:.3f} / "
          f"{mr['argument_bytes'] / 2**30:.3f} GiB; peak above the "
          f"arguments {mm['temp_bytes'] / 2**30:.3f} GiB dry-run, "
          f"{peak / 2**30:.3f} GiB max_memory_allocated "
          f"(gap {(mm['temp_bytes'] - peak) / 2**30:+.3f} GiB, allowed "
          f"{slack / 2**30:.3f}); step {ms:.0f} ms under the counter; "
          f"{card}")
    for key in ("hlo_flops_per_dev", "hlo_bytes_per_dev", "collectives"):
        if meta[key] != real[key]:
            fail(f"{what}: {key} {meta[key]} on meta, {real[key]} on the "
                 "card")
    if mm["argument_bytes"] != mr["argument_bytes"]:
        fail(f"{what}: arguments of {mm['argument_bytes']} bytes on meta, "
             f"{mr['argument_bytes']} on the card")
    if meta_l != launches or real["detail"]["kernel_launches"] != launches:
        fail(f"{what}: launches {meta_l} on meta, {launches} on the card")
    if abs(mm["temp_bytes"] - peak) > slack:
        fail(f"{what}: the dry-run's peak above the arguments "
             f"({mm['temp_bytes']} bytes) is not within {slack:.0f} bytes "
             f"of the card's ({peak} bytes)")


def dryrun_cells(torch):
    """The dry-run phase's (b): DRY_CELLS on meta, then for real."""
    t0 = time.perf_counter()
    metas = dry_meta_cells()
    dry_real_cells(torch, metas)
    print(f"dry-run (b): {time.perf_counter() - t0:.1f} s; {card_line()}")


def dryrun_meshes(dry):
    """The dry-run phase's (a): its processes started, then each record
    checked and printed."""
    from repro_torch.configs import base as cfgs
    dryrun_start(dry)
    recs = dryrun_wait(dry)
    for name, rs in recs.items():
        for r in rs:
            if r.get("skipped"):
                print(f"dry-run (a) {r['arch']} x {r['shape']}: "
                      f"{r['skipped']}")
                continue
            if not r.get("ok"):
                fail(f"dry-run (a) {r['arch']} x {r['shape']}: "
                     f"{r.get('error')}")
            m = r["memory_per_device"]
            print(f"dry-run (a) {r['arch']} x {r['shape']} x {r['mesh']}: "
                  f"arguments {m['argument_bytes'] / 2**30:.2f} GiB, peak "
                  f"{m['peak_bytes'] / 2**30:.2f} GiB "
                  f"({'fits' if m['fits'] else 'does not fit'}), C "
                  f"{r['t_compute_s'] * 1e3:.2f} ms M "
                  f"{r['t_memory_s'] * 1e3:.2f} ms X "
                  f"{r['t_collective_s'] * 1e3:.2f} ms ({r['bottleneck']}),"
                  f" traced in {r['compile_s']:.1f} s")
    for name, (archs, shape) in DRY_JOBS.items():
        if shape is None:           # every cell (skips apart), two meshes
            want = 2 * sum(len(cfgs.cells(a)) for a in archs)
        else:
            want = len(archs or [a for a in cfgs.ARCH_IDS
                                 if (a, shape) not in DRY_LEFT_OUT])
        got = sum(1 for r in recs[name] if r.get("ok")
                  and not r.get("skipped"))
        if got != want:
            fail(f"dry-run (a) {name}: {got} cells traced, expected {want}")
    print(f"dry-run (a): {time.perf_counter() - dry['t0']:.1f} s for "
          f"{sum(len(r) for r in recs.values())} records in "
          f"{len(DRY_JOBS)} processes")


if __name__ == "__main__":
    sys.exit(main())
