#!/usr/bin/env python3
"""Smoke run of blocksparse_tpu_torch, the PyTorch port, on one NVIDIA GPU.

    python3 chip_smoke.py [--profile-out PATH]

Builds the port's CUDA kernels from ``blocksparse_tpu_torch/csrc`` (one
nvcc per source, all at once) and holds each against its plain PyTorch
version in f32, bf16 and f16: the serving kernels at the serving path's
shapes, the training kernels (block-sparse matmul bprop and updat,
attention training forward, dq and dk/dv) at the training step's, each
line naming the kernel the product took.  The block-sparse matmul's
fprop and bprop run on the tensor cores in bf16 and f16:
``bsmm_xprop_sparse.cu`` (``wgmma`` fed by a TMA x box of two input
blocks and one bulk copy of the stage's weight blocks, packed a call by
its own small kernel) at b32 and ``bsmm_xprop_wgmma.cu`` (``wgmma`` fed
by TMA, column groups) at b64/b128 where the route rule ``xprop_kernel``
picks them, ``bsmm_xprop_mma.cu`` elsewhere and on the split route (two
runs must agree bit for bit; all are held against their plain version
at every block size they take, for fprop, bprop and the split route's
partial tiles and fused split, the latter bit for bit against the
partials merged, the sparse kernel bit for bit against the wgmma one);
``bsmm_fprop.cu`` in f32; their times come with TFLOP/s.  The launches
of the train step, the conv and the packed stores on the sparse kernel
are counted against what ``kernel_of`` names.  The weight gradient
(updat) runs ``bsmm_updat_sparse.cu`` (``wgmma`` fed by TMA over bundles
of the wider operand's block-rows that share the narrower one's tiles:
the conv's and the LM's), ``bsmm_updat_wgmma.cu`` or ``bsmm_updat_mma.cu``
(``updat_kernel``) on the tensor cores in bf16 and f16, over the
layout's blocks in groups that share a staged tile, with N split into
runs where the groups alone would leave SMs idle and the runs' partials
summed in order by ``bsmm_updat_mma.cu``'s second kernel
(``bsmm_updat_reduce``); all are held against their plain version at
every block size they take, split and unsplit, two runs equal bit for
bit, and ``bsmm_updat.cu`` in f32.  The wgmma phase then times the
kernels of each direction in turns (the three xprop kernels at b32, the
three updat kernels at b32 and b64) at the main path's shapes (the LM's
products at N 1,024-16,384, the conv's at C 512, 1024 and 2048, the
MoE's bsmm1, bench.py's random 8192² op) beside the bound, the library
call, a call's host time and each source's registers and spills; the
captured train step is also timed against the same step with the updat
on ``bsmm_updat_wgmma.cu`` (the route before ``bsmm_updat_sparse.cu``),
in turns.  The f32
kernels (``bsmm_fprop.cu``: an SGEMM-style kernel over the op's column
groups at an N-tile chosen by N, each output one fmaf chain in LUT
order; ``bsmm_updat.cu`` over ``updat_plan``'s groups, one chain over N)
are held at every block size 8-128, on a random layout with an empty
output column, a full one whose columns group and one a block wide, at
N 1, 4 and 1000: fprop, bprop and the split route's partials against
their plain versions, the same bits in every configuration built (full
column groups, one column a thread block at each N-tile), and twice; the updat on each layout and its transpose, twice equal,
against its plain version; at the MoE and LSTM shapes each direction
twice equal; and each configuration's registers, spilled bytes, shared
memory a block and blocks an SM are printed, the MoE's and LSTM's
marked.  The attention forward (serving, and training with the lse) runs
``bst_attn_fwd_wgmma.cu`` at block size 64 (``wgmma`` fed by TMA, a
thread block two query block-rows over the union of their key blocks;
``attn_kernel`` is the rule: hs 64 and 128, at least 16 key block-rows)
and ``bst_attn_fwd_mma.cu`` elsewhere, both on the tensor cores in bf16
and f16 (two runs equal bit for bit at the LM's shape, the tables'
launch order and CSR order equal; each held against its plain version at
the LM's shape, at every (bs, hs) and on layouts with a fully masked
query row and an odd block-row count; their device time in turns,
TFLOP/s, a call's host time, registers, spills and shared memory beside
the bound and SDPA's forward) and ``bst_attn_fwd.cu`` in f32.  dq runs
``bst_attn_dq_wgmma.cu`` at bs 64, hs 64 and 128 (the forward's pair
plan; both epilogues, dq rounded to the input type and stored in f32,
the latter rounding to the former bit for bit), dk/dv
``bst_attn_dkv_wgmma.cu`` at bs 64, hs 64 (the same pair plan over key
block-rows), both ``bst_attn_bwd_mma.cu`` elsewhere, in bf16 and f16
(held and timed as the forward), and ``bst_attn_bwd.cu`` in f32; the
three wgmma kernels are also timed against the mma.sync ones at the
pipeline's microbatch, an sp-4 gather shard and ring pair (dq in f32)
and 4 heads of 128, and dq is held at a ring pair whose rows see no key
(``attn_wgmma_phase``).  The sizes the
reference fuses beyond the kernels' own go through the op's route to the
kernels: block size 8 as the kernels' bs-16 view of the layout, head
sizes 8, 48 and 96 zero-padded to 16, 64 and 128; forward, lse, dq and
dk/dv held against the plain versions at the op's own sizes in bf16, f16
and f32 (two runs equal bit for bit, a fully masked row at bs 8), and
the padding's cost timed at the LM's shape with 8 heads of 48.  The embedding
backward (a sorted segment sum) runs twice at the LM's shape for equal
bits.  Then it drives the repo's enwik8 Sparse Transformer at full width (512-d, 6
layers, 8 heads, ctx 2048, 64-blocks, fixed layout, block-sparse b32
d0.5 MLP, bf16 compute, f32 masters, recompute, weights drawn from a
seed) down two paths, each with the kernels' launch counts set to 0 just
before and read just after:

- serving: one full-context forward at batch 8, and ``generate_cached``
  of 64 tokens after 4 prompts of 1024 random bytes;
- training: one train step (loss, backward, global-norm clip, Adam,
  dynamic loss scale) on 8 x 2048 random bytes, the step that
  ``make_train_step`` returns, captured as one CUDA graph at its first
  call (counted there: the warm-up's eager step and the captured step),
  held against the eager step of the same model and against the same
  step of the model run on the plain versions, then eight steps, graph
  replays, that must lower the loss; the replay's step time against the
  eager step's, in turns.

The serving path's decode also runs off the host: ``generate_cached_scan``
(one CUDA graph a token, replayed) at the same 4 x (1024 + 64), its
capture counted, its tokens equal to ``generate_cached``'s for the same
seed, a replayed token equal to the eager step bit for bit, and its
decode tokens/s, host time a token and the card's busy share against the
loop's, in turns; ``generate`` (a full-context forward a token) emits
``generate_cached``'s tokens on the plain model in f32.

Then two cut-down LMs that reach the attention kernels only through
the view and the padding, blk_size 8 and 8 heads of 48, each down its
serving forward and one train step, counted, against its plain-version
model.

With the MLP's products at decode below the card's SM count, the
serving path's ``generate_cached`` runs them on the split route, one
fused ``bsmm_split`` launch a product (``bsmm_xprop_mma.cu``'s split
flag: the runs of an output column are the thread blocks of one cluster,
which sum their f32 tiles through distributed shared memory; no
``bsmm_merge``); its decode logits are held step by step against the
plain model on the same tokens, and decode tokens/s is timed with the
MLP on ``mode="auto"`` and pinned to ``mode="grouped"``, in turns.
Before the paths the fused split is held at the decode's shapes and at
every block size bit for bit against the parent route (``bsmm_partials``
then ``bsmm_merge``), and timed against it in turns.

Then the block-sparse conv, ``BlocksparseConv(impl="bsmm")``, at the
repo's conv benchmark configuration (``benchmarks/conv_bench.py``: 3x3
SAME filters, 32x32 channel blocks, NCHW 32x32 images, batch 32, bf16,
C = K in {512, 1024, 2048}, block densities 0.25 and 0.0625, the loss
sum(square(y))): im2col (``im2col.cu``, reading the NCHW image in place)
and col2im (``col2im_tma.cu``, dX read by TMA tile loads, written into
the channel-major array and into the NCHW image) held against their
plain versions at C=512 in f32, bf16 and f16, both also in bf16 at C
1024 and 2048, and timed beside ``F.unfold`` / ``F.fold`` and their
bound; the C=512 forward and both gradients held against the plain
path, counted, with no copy of the image's size in the kernel path's
forward or backward (the profiler's op records); every configuration's
forward held against a dense cuDNN conv of the scattered filter and
timed beside it.

Then ``BlocksparseMatMul``'s schedule modes.  ``bsmm_fine`` and
``bsmm_window`` run in bf16 and f16 on the tensor cores, on the kernel
the rules ``fine_kernel`` and ``window_kernel`` pick: the wgmma ones,
``bsmm_fine_wgmma.cu`` (b16 and b32) and ``bsmm_window_wgmma.cu`` (with
its weights' packing, where its tiles fill the card), or the mma.sync
ones, ``bsmm_fine_mma.cu`` and ``bsmm_window_mma.cu`` (each of the four
pinned in turn and held against the plain version at every block size,
fprop and bprop, two runs equal bit for bit, counted on the kernel
pinned), and ``bsmm_fine.cu`` and ``bsmm_window.cu`` in f32.  The wgmma
mode kernels are timed in turns (20 calls a CUDA graph) against the
mma.sync ones, mode "grouped"'s unsplit kernel and a dense
``torch.matmul`` at the canonical rows (fine b8-b32, window b8; N 64)
and the window's regime (N 256 and 2048, fprop and bprop), beside their
bound, the window's packing alone and bit for bit against its plain
version, with their registers, spills and shared memory and ptxas'
C7520 check.  ``bsmm_fine``,
``bsmm_window`` and ``bsmm_merge`` against their plain versions in f32,
bf16 and f16 at the path's shapes (fine and window also against the
unsplit kernel, bit for bit in f32; their device time and the unsplit
kernel's from the profiler; the fused split bit for bit against partials
and merge at the canonical hidden-2560 split, and timed against them),
then, counted: the canonical small-block bench row
(``benchmarks/canonical_bench.py``: hidden 7680 at 11.25% with
Barabasi-Albert layouts from the port's ``make_mask`` at b8, b16 and b32,
and hidden 2560 dense at b32; N = 64, bf16, feature_axis 0; depth-8
chains y = bsmm(y, w), forward and forward + backward) in modes "fine",
"window" and "auto", each held against the same chain on
``impl="xla"`` and timed per application beside a dense ``torch.matmul``
control (the hidden-2560 row's auto chains also in f32, where the
split route is partial tiles and ``bsmm_merge``); and the window's own
regime (``bench.py``'s random 8192^2, b32, d 0.25 layout at N 256 and
2048), window against grouped in turns, by CUDA events and by the
profiler's device time, counted on the kernel the rule picks.

The unfused attention ops (``nt_op``, ``nn_op``, ``tn_op``), which the
LM runs past a head size of 128: ``bst_nt`` and ``bst_xn`` run
``bst_nt_mma.cu`` and ``bst_xn_mma.cu`` on the tensor cores in bf16 and
f16 and ``bst_nt.cu`` and ``bst_xn.cu`` in f32, each held against its
plain version (the op's ``impl="xla"`` twin) at every block size 8-64,
on shared and per-head layouts with an empty query row and key row and
q/k/v sliced from one packed qkv, and at the LM's shapes (batch 8 x 2048,
blk 64, fixed layout, causal sub-block masks) with 2 heads of 256 and 8
heads of 64, two runs equal bit for bit, timed beside their bound and a
batched ``torch.matmul`` over the gathered blocks; NT also at head sizes
8, 72, 136, 264 and 512, NN/TN at 320 (two column groups), and all three
on layouts whose longest query and key rows the launch plan cuts in two
(35 entries at b64, 67 at b8).  At the LM's hs-256 shape their times
are device times (20 calls captured as one CUDA graph, its replay between
CUDA events: a call's host work outlasts these kernels) beside the
eager calls' and the first tensor-core kernels' record, and the bf16/f16
kernels' registers and spills (ptxas) are printed.  Then the enwik8 LM
with n_head 2 (hs 256: the head count at which the JAX package takes the
unfused ops; the published widths are kept) down its forward (8 x 2048),
prefill (4 x 2048), ``generate_cached_scan`` (4 x 64 tokens after 1024)
and captured train step (with falling loss over its replays), each
counted and held against the same model on the plain versions; and the
trio (``use_fused=False``) timed against the fused kernels at the
flagship's 8 heads of 64, forward and forward + backward, in turns.  The
kernels line's ``bst_xn`` row counts every launch of its wrapper (NN and
TN) and times NN; ``bst_xn_tn`` counts and times the TN direction.

Then the training surface around the kernels: the flagship's
captured train step with bfloat16 and packed16 Adam slots, counted, each
equal to its eager step bit for bit and held against the plain model's
step with the same slots at the f32-slot step's tolerances, its state's
bytes and its step time beside the f32-slot step's, in turns; packed16 on
the card (all 65,536 codes unpacked, and every code's value, its
neighbours and a seeded spread packed) equal to the CPU's bits; the LM
with residual dropout 0.1 (one generator seed gives one loss twice, the
gradients with recompute on equal those with it off bit for bit, the
loss and gradients given one set of masks within the train step's
tolerances of the plain model's given the same masks, the masks keep a
binomial share); three Adafactor and EMA updates of the
LM's parameters on the card against the CPU; and the enwik8 entry point
(``blocksparse_tpu_torch.examples.enwik8``) at the flagship's width for
100 steps on the synthetic stream, counted, its loss falling, with a
checkpoint at step 60 restored into a fresh model bit for bit and the
restored model's next step equal to the uninterrupted run's bit for bit.

Then the LM with Mixture-of-Experts MLPs at full width (the enwik8 LM
with ``--moe_experts 8 --moe_k 1``: 8 experts of 512 -> 2048 -> 512 at
b32, density 1.0, top-1, capacity factor 1.25, C = 2,560 slots an expert
at 8 x 2048 tokens; bf16 compute with the experts' products in f32, as
the JAX layer leaves its expert weights): one layer against the plain
layer at 16,384 tokens (forward, VJP and the dtypes), the experts'
products at N = C against their plain versions with device time, bound
and a dense f32 ``torch.matmul``; the forward, counted, against the plain
model on the kernel model's routing (a token whose top expert or drop the
two models' roundings would choose otherwise changes by O(1): the plain
model takes the kernel model's routing tables, and the flips without
them are printed); ``generate``, counted, each token the sample of its
step's forward and each step's logits against the plain model; the train
step's first call, counted, then three captured steps, each equal to the
eager step bit for bit and within tolerance of the plain model's step
(loss and grad norm; the gradients and the first update), with falling
loss; ms and kernels a step, the graph's memory.  After the conv path,
the rest of the conv (plain torch, as the JAX package's XLA lowerings) at
C = 512, f32 and bf16: a ragged BCK, ``impl="matmul"`` and the deconv,
forward and both gradients against the dense cuDNN ``conv2d`` /
``conv_transpose2d`` of the scattered filter, timed beside it; the edge
bias and both l2 norms against the CPU; the ragged conv and deconv
against the NumPy goldens at a small size.

Then parallelism (after the MoE LM): the flagship attention (8 x 2048,
bf16, b64, 8 heads of 64, the fixed layout) cut into sp 2 and 4 context
shards in one process, through ``parallel.sequence``'s functions on each
shard's tables: gather mode (a shard's fwd_lse, dq and dk/dv, q sliced
and K/V whole) and the ring (n² pair launches merged by (out, lse), dq
stored in f32), counted; the gather shards' y, lse and dq equal the
unsharded kernels' bit for bit and their summed dk/dv within f32
rounding, the ring within the bf16 tolerance, each also against its
plain version on the same tables; a shard launch's device time beside
the unsharded launch's, its bound and a shard's SDPA.  Then the
flagship's sharded train step (``make_train_step(mesh=)``) on an NCCL
process group of world size 1 (``make_mesh(dp=1)``, a FileStore in a
temporary directory), captured as one CUDA graph with its all-reduces,
three steps against the single-device captured step from the same
params, its ms beside that step's in turns.

Then pipeline and expert parallelism: the flagship at full width with
its six blocks cut into 2 and 3 pipeline stages, run in turn in one
process through ``parallel.pipeline``'s ``stage_forward`` and
``stage_backward`` (``tests/torch_one_process.py``'s drivers; 4
microbatches of 2 x 2048, the activations handed
over by tensor, the microbatches backwards in reverse), and ``gpipe``
itself through the LM's ``loss_pp`` on an NCCL group of world size 1
(``make_mesh(pp=1)``, 4 microbatches), counted; the loss, grad norm and
every gradient against the single-device step's at the train step's
tolerances; each stage's device time and launches beside the
unpipelined step's; every kernel the stages launch at the microbatch's
shapes (the attention's serving and training forwards, dq and dk/dv;
bsmm1's and bsmm2's fprop, bprop and updat and the updat's reduce)
against its plain version, timed.  Then the
full-width MoE LM's layer (8 experts, top-1, capacity factor 1.25) at ep
2 and 4, shard by shard in one process (``run_ep_shards`` of
``tests/torch_one_process.py``, through the layer's ``dispatch``,
``experts`` and ``combine``: each shard
routes its own 16,384/ep tokens, the all-to-all by slicing, the local
experts' f32 products at N = ep·C), counted, forward and gradients
against the ep 1 layer on each shard's tokens (whether bit for bit
printed), and the experts' products at N = ep·C (f32 fprop, bprop and
updat; bsmm1's bf16 updat and its reduce) against their plain versions,
timed beside their bound and a dense ``torch.matmul``.

Then the ``fprop_packed`` store (after the modes): ``bench.py``'s four
headline bsmm ops (8192², N 2048, bf16: random b32, banded b32 and b64,
the R-aligned band at b64 with ``dense_tile_R=4``; ``make_layout`` and
``aligned_band_layout`` copied, as ``bench.py`` imports JAX), each built
with ``w_layout="fprop_packed"`` from one canonical weight draw that the
port packs (on the card, equal to the NumPy pack), its forward counted
and bit for bit the canonical op's, and within TOL of the plain op's;
random b32's backward too (dX bit for bit, dW unpacked bit for bit the
canonical dW, the store's padding exactly zero); each store's shape, and
the device time of the store's gather and dW's repack beside the fprop
and updat kernels'.  The canonical row's layouts (hidden 7680 at 11.25%,
b8/b16/b32): the host library ``csrc/bs_host.cpp`` loaded, the packed
op's host build time, at b32 the order by the NumPy builders equal to the
library's, and the depth-8 chains in modes auto and window on packed
stores, counted, bit for bit the canonical chains.  Then the examples at
full size: ``simple.py`` (counted, against the plain op) and ``mnist.py``
at its defaults, then with ``--quantize`` (falling loss, the accuracy).

Prints the card's name and power limit, the build times, every check
with its tolerance, the timings, a ``{"kernels": [...]}`` line (each
kernel with its bound on this card and the time of a library call that
computes the same function, where there is one), and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero; so does a host without CUDA.  Imports no JAX.  One train
step (a replay of its graph, then the eager step), the decode's graph
replays and one full-context forward also run under ``torch.profiler``:
their device time by kernel is printed, and with ``--profile-out`` the
replayed train step's full table is written to PATH.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as nnf

SEED = 0
BATCH, PROMPTS, PROMPT_LEN, NEW_TOKENS = 8, 4, 1024, 64
GENERATE_TOKENS = 4
TRAIN_STEPS, TIMED_STEPS = 8, 5
LR, CLIP, LOSS_SCALE = 3e-4, 1.0, 2.0 ** 15
SOURCES = ("bsmm_xprop_mma", "bsmm_fprop", "bsmm_updat_mma", "bsmm_updat",
           "bst_attn_fwd", "bst_attn_fwd_mma", "bst_attn_bwd_mma",
           "bst_attn_bwd", "im2col", "col2im_tma",
           "bsmm_fine_mma", "bsmm_fine", "bsmm_window_mma", "bsmm_window",
           "bsmm_merge", "bst_nt_mma", "bst_nt", "bst_xn_mma", "bst_xn",
           "bsmm_xprop_wgmma", "bsmm_updat_wgmma", "bst_attn_fwd_wgmma",
           "bst_attn_dkv_wgmma", "bst_attn_dq_wgmma", "bsmm_xprop_sparse",
           "bsmm_updat_sparse", "bsmm_window_wgmma", "bsmm_fine_wgmma")
# the flagship LM (enwik8's widths, the repo's fixed layout at 2048 tokens)
FLAGSHIP = dict(n_vocab=256, n_embd=512, n_layer=6, n_head=8, ctx=2048,
                blk_size=64, attn_layout="fixed", local_blocks=8,
                mlp_ratio=4, mlp_block_size=32, mlp_density=0.5,
                dtype="bfloat16", recompute=True)
DTYPES = (torch.bfloat16, torch.float32, torch.float16)
# |kernel - plain| <= TOL * max(1, max|plain|); f16 held at bf16 level
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2, torch.float16: 1e-2}
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 2e-2}
# dw is f32 from the same inputs on both sides (bf16/f16 products exact in
# f32 on the tensor cores too): only the order of the sums differs
UPDAT_TOL = 1e-4
LSE_TOL = 1e-4         # f32 log-sum-exp, absolute
# The attention forward's out, beside its f32 lse: |kernel - plain| <=
# ATTN_TOL absolute (no max|plain| scaling: a typical |out| is far below
# max|out|), and ||kernel - plain|| / ||plain|| <= ATTN_NORM_TOL
ATTN_NORM_TOL = 1e-2
MODEL_TOL = 2e-2       # bf16 logits, kernel model against plain model
DECODE_TOL = 5e-2      # bf16 logits, cached decode against full forward
# Train step, kernel model against plain model (bf16 compute, f32
# masters): loss 1e-2 relative; each gradient 5e-2 of its tensor's
# max|plain grad| (bf16 activations round differently on the two paths);
# each parameter update the same, where
# |plain grad| > 5e-2 max (elsewhere the gradient is within the noise
# and its sign, hence Adam's first step of ~lr, may flip: |diff| <= 2 lr).
STEP_LOSS_TOL, GRAD_TOL = 1e-2, 5e-2
# The conv benchmark's configuration (benchmarks/conv_bench.py:65-73,
# 91-133) and the dense control's tolerance: both sides bf16 operands,
# f32 sums of C*9 terms in other orders, one rounding of the output.
CONV_BATCH, CONV_HW, CONV_BLOCK = 32, 32, 32
CONV_CHANNELS, CONV_DENSITIES = (512, 1024, 2048), (0.25, 0.0625)
CONV_TIMED = 5
DENSE_TOL = 2e-2
# The least time the card could take for a kernel's work: the larger of
# its operations over the peak rate for their type and its bytes (each
# input read once, each output written once) over the memory rate.
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate (every row of
# the kernels line is bf16), f32 rate outside the tensor cores (the
# merge's adds) and HBM3 rate.
PEAK_FLOPS, PEAK_F32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# The canonical bsmm bench (benchmarks/canonical_bench.py:42-65): (hidden
# multiplier k of 2560, target density %, block sizes); N 64, bf16,
# feature_axis 0, depth-8 chains; the modes run on each row.
CANON_UNIT, CANON_ROWS = 2560, ((3, 11.25, (8, 16, 32)), (1, 100.0, (32,)))
CANON_N, CANON_DEPTH, CANON_TIMED = 64, 8, 10
CANON_MODES = ("fine", "window", "auto", "grouped")
# Chains of the kernel op against the plain op, bf16: each application
# rounds its output once on both sides, in other summation orders, and
# eight of them (then eight back) compound: 3e-2 of max|plain|.  In f32
# (the split route's f32 form) the same sums in other orders, unrounded:
# 1e-4 of max|plain|.
CHAIN_TOL, F32_CHAIN_TOL = 3e-2, 1e-4
# col2im's and im2col's targets at the conv's C=512 shape (bf16), ms on
# the H100 (im2col's: 60% of its bound), and the previous im2col kernel's
# time there (CUDA events, mean of 20, two runs), measured by this script
# before the kernel was redesigned
COL2IM_TARGET, IM2COL_TARGET = 0.20, 0.167
IM2COL_PREV_MS = {512: (0.2372, 0.2356)}
IM2COL_PREV_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
# the xprop kernel's template flag OUT (bsmm_xprop_mma.cu): the fused split
# (OUT_SPLIT = 2) and the partial tiles (OUT_PARTIAL = 1), in the
# profiler's demangled names and in ptxas' mangled ones
SPLIT_KERNEL = re.compile(r"bsmm_xprop_mma_kernel<.*, (?:true|false), 2, ")
PARTIAL_KERNEL = re.compile(r"bsmm_xprop_mma_kernel<.*, (?:true|false), 1, ")
SPLIT_MANGLED = re.compile(r"bsmm_xprop_mma_kernel.*Lb[01]ELi2E")
# The tensor-core xprop kernel at every block size: a random hidden² layout
# at this density (diagonal set), N rows (not a multiple of any TM).
XPROP_HIDDEN, XPROP_DENSITY, XPROP_N = 1024, 0.3, 1000
# The tensor-core updat at every block size, on that layout: N rows
# unsplit (XPROP_N, below two runs of the split) and split (UPDAT_SPLIT_N).
UPDAT_SPLIT_N = 8192
# The window's regime: bench.py's headline layout (make_layout("random",
# 256, 0.25) from RandomState(0), feature_axis 0, W in +-0.1), at N 256
# and 2048 (benchmarks/results_window.json's two shapes).
WIN_HIDDEN, WIN_BSIZE, WIN_DENSITY, WIN_NS = 8192, 32, 0.25, (256, 2048)
# The mode kernels at every block size also at this N (the fine wgmma
# kernel's 66 N-tiles, the window kernels' N-tile 128)
MODE_LONG_N = 4224


class CheckFailed(RuntimeError):
    pass


def check(ok, what):
    print(("ok    " if ok else "FAIL  ") + what, flush=True)
    if not ok:
        raise CheckFailed(what)


def card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def flagship_config(bt, **kw):
    """The flagship LM's TransformerConfig, ``kw`` changing its fields."""
    return bt.TransformerConfig(**{**FLAGSHIP, **kw})


def time_ms(fn, iters):
    """Mean device time of fn() over iters calls, after two warm-ups."""
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device time of fn(): iters calls captured as one CUDA graph,
    its replay timed by CUDA events (for kernels that run shorter than a
    call's host work, where events around the calls time the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def compare(name, got, ref, tol, norm_tol=None):
    """got against ref: max|got - ref| <= tol * max(1, max|ref|) and, given
    norm_tol, ||got - ref|| / ||ref|| <= norm_tol (the attention's
    gradients: a typical |dq| is far below max|dq|, so the max limit alone
    would pass a dropped entry)."""
    diff, ref = got.float() - ref.float(), ref.float()
    err = diff.abs().max().item()
    scale = max(1.0, ref.abs().max().item())
    rel = diff.norm().item() / max(ref.norm().item(), 1e-30)
    check(bool(torch.isfinite(got).all()) and err <= tol * scale
          and (norm_tol is None or rel <= norm_tol),
          f"{name}: max_abs_err {err:.3e} (max|plain| {scale:.3e}, "
          f"tol {tol:g} x max(1, max|plain|))"
          + ("" if norm_tol is None else
             f", ||err|| / ||plain|| {rel:.3e} (tol {norm_tol:g}); "
             f"mean|plain| {ref.abs().mean().item():.3e}"))
    return err


def compare_fwd(name, got, ref, dtype):
    """The attention forward's out against its plain version: the max
    error absolute, and the error's norm relative to the plain out's."""
    diff, ref = got.float() - ref.float(), ref.float()
    err = diff.abs().max().item()
    rel = diff.norm().item() / max(ref.norm().item(), 1e-30)
    check(bool(torch.isfinite(got).all()) and err <= ATTN_TOL[dtype]
          and rel <= ATTN_NORM_TOL,
          f"{name}: max_abs_err {err:.3e} (tol {ATTN_TOL[dtype]:g}), "
          f"||err|| / ||plain|| {rel:.3e} (tol {ATTN_NORM_TOL:g}); "
          f"mean|plain| {ref.abs().mean().item():.3e}, max|plain| "
          f"{ref.abs().max().item():.3e}")
    return err


def timed(rows, key, err, fn, plain_fn, iters, card_line=None, flops=None):
    ms = time_ms(fn, iters)
    plain_ms = time_ms(plain_fn, max(iters // 4, 5))
    print(f"      kernel {ms:.4f} ms"
          + (f" ({flops / ms / 1e9:.2f} TFLOP/s)" if flops else "")
          + f", plain {plain_ms:.4f} ms"
          + (f" [{card_line}]" if card_line else ""), flush=True)
    rows[key] = (err, ms, plain_ms)


def same_bits(what, fn):
    """Two runs of fn() give identical bits (fixed-order sums, no
    atomics)."""
    check(torch.equal(fn(), fn()), f"{what}: two runs equal bit for bit")


@contextlib.contextmanager
def attn_on_mma(kinds=("FWD", "DQ", "DKV")):
    """The attention's route with the wgmma kernels' head sizes emptied for
    ``kinds`` (by default every bf16/f16 forward, dq and dk/dv): those on
    the mma.sync kernels (bst_attn_fwd_mma.cu, bst_attn_bwd_mma.cu), as
    before the wgmma ones, the others where the rule sends them."""
    from blocksparse_tpu_torch.kernels import bst_attn
    names = tuple(f"{k}_WGMMA_HEAD_SIZES" for k in kinds)
    saved = [getattr(bst_attn, n) for n in names]
    for n in names:
        setattr(bst_attn, n, ())
    try:
        yield
    finally:
        for n, v in zip(names, saved):
            setattr(bst_attn, n, v)


@contextlib.contextmanager
def forced_wgmma():
    """The attention's route with the forward's key-context clause lifted
    (FWD_WGMMA_MIN_KEY_BLOCKS 0): the forward on its wgmma kernel at every
    bs-64 shape of its head sizes, to time it where the rule keeps
    mma.sync."""
    from blocksparse_tpu_torch.kernels import bst_attn
    saved = bst_attn.FWD_WGMMA_MIN_KEY_BLOCKS
    bst_attn.FWD_WGMMA_MIN_KEY_BLOCKS = 0
    try:
        yield
    finally:
        bst_attn.FWD_WGMMA_MIN_KEY_BLOCKS = saved


def csr_order(tab):
    """The attention tables with both launch orders replaced by CSR order
    (the mma.sync kernels launch their rows in it; the wgmma kernels read
    the pair plan, which no order changes)."""
    out = dict(tab)
    for name in ("order", "order_t"):
        lh, rows = tab[name].shape
        out[name] = torch.arange(rows, dtype=torch.int32,
                                 device=tab[name].device).repeat(lh, 1)
    return out


def xprop_flops(op, N):
    return 2 * N * op.blocks * op.bsize ** 2


def kernel_of(op, N, d, dtype=torch.bfloat16):
    """(the profiler's name fragment, the source file) of the kernel
    direction d ("f", "b", "u") of ``op`` launches at N rows in ``dtype``
    (bf16 and f16: each source's kernel is named <source>_kernel)."""
    src = op.kernel_of(N, d, dtype)
    return f"{src}_kernel", f"{src}.cu"


def serving_kernel_checks(model, plain, dev, g, rows):
    """The serving kernels against their plain versions at the serving
    path's shapes."""
    for name, op, ref_op in (("bsmm1", model.bsmm1, plain.bsmm1),
                             ("bsmm2", model.bsmm2, plain.bsmm2)):
        for N in (BATCH * model.config.ctx, PROMPTS):
            for dtype in DTYPES:
                x = torch.randn((N, op.C), device=dev, generator=g).to(dtype)
                w = (torch.randn(op.w_shape, device=dev, generator=g)
                     * 0.02).to(dtype)
                what = (f"bsmm_fprop {name} N={N} C={op.C} K={op.K} {dtype} "
                        f"(on {op.kernel_of(N, 'f', dtype)})")
                err = compare(what, op(x, w), ref_op(x, w), TOL[dtype])
                same_bits(what, lambda: op(x, w))
                timed(rows, ("fprop", name, N, dtype), err,
                      lambda: op(x, w), lambda: ref_op(x, w),
                      20 if N > 1000 else 200, flops=xprop_flops(op, N))
    c = model.config
    bst = model.bst
    scale = 1.0 / np.sqrt(model.hs)
    for dtype in DTYPES:
        qkv = torch.randn((BATCH, c.ctx, 3 * c.n_embd), device=dev,
                          generator=g).to(dtype)
        q, k, v = qkv.split(c.n_embd, dim=-1)
        err = compare_fwd(f"bst_attn_fwd batch {BATCH} ctx {c.ctx} heads "
                          f"{c.n_head} hs {model.hs} {dtype}",
                          bst.attention(q, k, v, scale=scale),
                          plain.bst.attention(q, k, v, scale=scale), dtype)
        if dtype != torch.float32:
            same_bits(f"bst_attn_fwd batch {BATCH} ctx {c.ctx} {dtype}",
                      lambda: bst.attention(q, k, v, scale=scale))
        timed(rows, ("attn_fwd", dtype), err,
              lambda: bst.attention(q, k, v, scale=scale),
              lambda: plain.bst.attention(q, k, v, scale=scale), 20)
        del qkv, q, k, v


def training_kernel_checks(model, plain, dev, g, rows):
    """The training kernels against their plain versions at the train
    step's shapes: bprop and updat of both MLP layouts at N = 8 x 2048,
    the attention training forward (out and lse), dq and dk/dv."""
    N = BATCH * model.config.ctx
    for name, op, ref_op in (("bsmm1", model.bsmm1, plain.bsmm1),
                             ("bsmm2", model.bsmm2, plain.bsmm2)):
        for dtype in DTYPES:
            x = torch.randn((N, op.C), device=dev, generator=g).to(dtype)
            dy = torch.randn((N, op.K), device=dev, generator=g).to(dtype)
            w = (torch.randn(op.w_shape, device=dev, generator=g)
                 * 0.02).to(dtype)
            what = (f"bsmm_bprop {name} N={N} K={op.K} -> C={op.C} {dtype} "
                    f"(on {op.kernel_of(N, 'b', dtype)})")
            err = compare(what, op._xprop(dy, w, "b"),
                          ref_op._xprop(dy, w, "b"), TOL[dtype])
            same_bits(what, lambda: op._xprop(dy, w, "b"))
            timed(rows, ("bprop", name, dtype), err,
                  lambda: op._xprop(dy, w, "b"),
                  lambda: ref_op._xprop(dy, w, "b"), 20,
                  flops=xprop_flops(op, N))
            what = (f"bsmm_updat {name} N={N} {op.blocks} blocks {dtype} "
                    f"({op.updat_splits(N, dtype)} runs of N, on "
                    f"{op.kernel_of(N, 'u', dtype)})")
            err = compare(what, op._updat(x, dy), ref_op._updat(x, dy),
                          UPDAT_TOL)
            same_bits(what, lambda: op._updat(x, dy))
            timed(rows, ("updat", name, dtype), err,
                  lambda: op._updat(x, dy), lambda: ref_op._updat(x, dy), 20,
                  flops=xprop_flops(op, N))
            del x, dy, w
    updat_reduce_checks(model.bsmm1, N, dev, g, rows)
    c = model.config
    # the embedding gradient at the LM's shape: a sorted segment sum
    from blocksparse_tpu_torch import embedding_lookup
    ids = torch.randint(0, c.n_vocab, (BATCH, c.ctx), device=dev, generator=g)
    d_emb = torch.randn((BATCH, c.ctx, c.n_embd), device=dev,
                        generator=g).to(torch.bfloat16)
    emb = torch.randn((c.n_vocab, c.n_embd), device=dev,
                      generator=g).to(torch.bfloat16)

    def emb_grad():
        e = emb.clone().requires_grad_()
        embedding_lookup(e, ids).backward(d_emb)
        return e.grad
    same_bits(f"embedding_lookup backward, {BATCH} x {c.ctx} ids into "
              f"{c.n_vocab} x {c.n_embd} bf16", emb_grad)
    del ids, d_emb, emb
    attn_training_checks(model, dev, g, rows)


def attn_training_checks(model, dev, g, rows):
    """The attention's training kernels at the train step's shape (batch
    8 x 2048): the forward with lse, dq (both epilogues) and dk/dv on the
    route's kernels and on the mma.sync ones, against the plain versions,
    two runs equal bit for bit; in bf16 their device time in turns and a
    call's host time."""
    from blocksparse_tpu_torch.kernels import bst_attn
    c, bst = model.config, model.bst
    heads, bs = bst.heads, bst.blk_size
    scale = 1.0 / np.sqrt(model.hs)
    tab = bst._tables(dev)
    plain_args = (tab["q_blk"], tab["k_blk"], tab["mask"], heads, bs, scale)
    what = f"batch {BATCH} ctx {c.ctx} heads {heads} hs {model.hs}"
    for dtype in DTYPES:
        qkv = torch.randn((BATCH, c.ctx, 3 * c.n_embd), device=dev,
                          generator=g).to(dtype)
        q, k, v = qkv.split(c.n_embd, dim=-1)
        do = torch.randn((BATCH, c.ctx, c.n_embd), device=dev,
                         generator=g).to(dtype)

        def fwd_lse(t=tab):
            return bst_attn.attention_fwd_lse(q, k, v, t, heads, scale)

        def fwd(t=tab):
            return bst_attn.attention_fwd(q, k, v, t, heads, scale)

        def fwd_lse_plain():
            return bst_attn.attention_fwd_lse_plain(q, k, v, *plain_args)
        src = bst_attn.attn_kernel("fwd", dtype, bs, model.hs, c.ctx // bs)
        (out, lse), (out_ref, lse_ref) = fwd_lse(), fwd_lse_plain()
        err = compare_fwd(f"bst_attn_fwd_lse out {what} {dtype} (on {src})",
                          out, out_ref, dtype)
        lse_err = (lse - lse_ref).abs().max().item()
        check(bool(torch.isfinite(lse).all()) and lse_err <= LSE_TOL,
              f"bst_attn_fwd_lse lse: max_abs_err {lse_err:.3e} (tol "
              f"{LSE_TOL:g})")
        timed(rows, ("fwd_lse", dtype), max(err, lse_err), fwd_lse,
              fwd_lse_plain, 20)
        if dtype != torch.float32:
            same_bits(f"bst_attn_fwd_lse {what} {dtype} (out, lse)",
                      lambda: torch.cat([t.float().flatten()
                                         for t in fwd_lse()]))
            check(torch.equal(torch.cat([t.float().flatten()
                                         for t in fwd_lse()]),
                              torch.cat([t.float().flatten()
                                         for t in fwd_lse(csr_order(tab))]))
                  and torch.equal(fwd(), fwd(csr_order(tab)))
                  and torch.equal(fwd(), out),
                  f"bst_attn_fwd(_lse) {what} {dtype}: the tables' launch "
                  f"order and CSR order equal bit for bit; serving out "
                  f"equal to training out")
            with attn_on_mma():
                err_mma = compare_fwd(
                    f"bst_attn_fwd_lse out {what} {dtype} (on "
                    f"bst_attn_fwd_mma)", fwd_lse()[0], out_ref, dtype)
                same_bits(f"bst_attn_fwd_lse {what} {dtype} on "
                          f"bst_attn_fwd_mma", lambda: fwd_lse()[0])
            rows[("fwd_lse_mma_err", dtype)] = err_mma
        if dtype == torch.bfloat16:
            attn_fwd_device_times(fwd, fwd_lse, rows)
            rows["attn_host"] = {
                "fwd_lse": host_ms(fwd_lse)}
            with attn_on_mma():
                rows["attn_host"]["fwd_lse_mma"] = host_ms(fwd_lse)
        dvec = (do.float() * out_ref.float()).reshape(
            BATCH, c.ctx, heads, -1).sum(-1).transpose(1, 2).contiguous()

        def dq(out_dtype=None):
            return bst_attn.attention_dq(q, k, v, do, lse_ref, dvec, tab,
                                         heads, scale, out_dtype=out_dtype)

        def dkv(t=tab):
            return bst_attn.attention_dkv(q, k, v, do, lse_ref, dvec, t,
                                          heads, scale)

        def bwd_plain():
            return bst_attn.attention_bwd_plain(q, k, v, do, lse_ref, dvec,
                                                *plain_args)
        dq_ref, dk_ref, dv_ref = bwd_plain()
        src = bst_attn.attn_kernel("dq", dtype, bs, model.hs, c.ctx // bs)
        err = compare(f"bst_attn_dq {what} {dtype} (on {src})", dq(), dq_ref,
                      ATTN_TOL[dtype], norm_tol=ATTN_NORM_TOL)
        timed(rows, ("dq", dtype), err, dq, bwd_plain, 20)
        if dtype != torch.float32:
            # the f32 epilogue (the ring's) stores the sum the default one
            # rounds
            dq32 = dq(torch.float32)
            check(dq32.dtype == torch.float32
                  and torch.equal(dq32.to(dtype), dq()),
                  f"bst_attn_dq {what} {dtype} (on {src}): dq stored in f32 "
                  f"rounds to the default output bit for bit")
            compare(f"bst_attn_dq {what} {dtype} (on {src}), f32 epilogue",
                    dq32, bst_attn.attention_bwd_plain(
                        q, k, v, do, lse_ref, dvec, *plain_args,
                        dq_dtype=torch.float32)[0], ATTN_TOL[dtype],
                    norm_tol=ATTN_NORM_TOL)
            same_bits(f"bst_attn_dq {what} {dtype} (on {src}), f32 "
                      f"epilogue", lambda: dq(torch.float32))
            del dq32
        dk, dv = dkv()
        src = bst_attn.attn_kernel("dkv", dtype, bs, model.hs, c.ctx // bs)
        err = max(compare(f"bst_attn_dkv dk {what} {dtype} (on {src})", dk,
                          dk_ref, ATTN_TOL[dtype], norm_tol=ATTN_NORM_TOL),
                  compare(f"bst_attn_dkv dv {what} {dtype} (on {src})", dv,
                          dv_ref, ATTN_TOL[dtype], norm_tol=ATTN_NORM_TOL))
        if dtype != torch.float32:
            same_bits(f"bst_attn_dq {what} {dtype}", dq)
            same_bits(f"bst_attn_dkv {what} {dtype} (dk, dv)",
                      lambda: torch.stack(dkv()))
            check(torch.equal(torch.stack(dkv()),
                              torch.stack(dkv(csr_order(tab)))),
                  f"bst_attn_dkv {what} {dtype}: the tables' launch order "
                  f"and CSR order equal bit for bit")
            with attn_on_mma():
                rows[("dq_mma_err", dtype)] = compare(
                    f"bst_attn_dq {what} {dtype} (on bst_attn_bwd_mma)", dq(),
                    dq_ref, ATTN_TOL[dtype], norm_tol=ATTN_NORM_TOL)
                same_bits(f"bst_attn_dq {what} {dtype} on bst_attn_bwd_mma",
                          dq)
                dk_m, dv_m = dkv()
                err_mma = max(
                    compare(f"bst_attn_dkv dk {what} {dtype} (on "
                            f"bst_attn_bwd_mma)", dk_m, dk_ref,
                            ATTN_TOL[dtype], norm_tol=ATTN_NORM_TOL),
                    compare(f"bst_attn_dkv dv {what} {dtype} (on "
                            f"bst_attn_bwd_mma)", dv_m, dv_ref,
                            ATTN_TOL[dtype], norm_tol=ATTN_NORM_TOL))
                same_bits(f"bst_attn_dkv {what} {dtype} on bst_attn_bwd_mma",
                          lambda: torch.stack(dkv()))
            rows[("dkv_mma_err", dtype)] = err_mma
        # the plain backward computes dq, dk and dv in one call: its time
        # stands beside both kernels
        timed(rows, ("dkv", dtype), err, dkv, bwd_plain, 20)
        if dtype == torch.bfloat16:
            attn_bwd_device_times(dq, dkv, rows)
            rows["attn_host"]["dq"] = host_ms(dq)
            rows["attn_host"]["dkv"] = host_ms(dkv)
            with attn_on_mma():
                rows["attn_host"]["dq_mma"] = host_ms(dq)
                rows["attn_host"]["dkv_mma"] = host_ms(dkv)
        del qkv, q, k, v, do, out, lse, out_ref, lse_ref, dvec
        del dq_ref, dk_ref, dv_ref, dk, dv
        torch.cuda.empty_cache()


def attn_turns(fn, kernels, n=20):
    """fn's device time (the profiler, mean of n launches) on the wgmma
    kernel and on the mma.sync one, in turns: mma, wgmma, wgmma, mma.
    kernels: (the wgmma kernel's name, the mma.sync kernel's)."""
    out = {"wgmma": [], "mma": []}
    for side in ("mma", "wgmma", "wgmma", "mma"):
        if side == "mma":
            with attn_on_mma():
                out[side].append(kernel_device_ms(fn, kernels[1], n))
        else:
            out[side].append(kernel_device_ms(fn, kernels[0], n))
    return out


def attn_kernel_key(kind, bs=64, hs=64, key_blocks=32):
    """The profiler's name of the kernel a bf16 attention launch of
    ``kind`` ("fwd", "dq", "dkv") at (bs, hs) over ``key_blocks`` key
    block-rows runs, by the route rule ``attn_kernel``:
    bst_attn_<kind>_wgmma_kernel or _mma_kernel."""
    from blocksparse_tpu_torch.kernels import bst_attn
    src = bst_attn.attn_kernel(kind, torch.bfloat16, bs, hs, key_blocks)
    return f"bst_attn_{kind}_{src.rsplit('_', 1)[1]}_kernel"


def short_key(key):
    """bst_attn_<kind>_<route>_kernel -> <kind>_<route>."""
    return key[len("bst_attn_"):-len("_kernel")]


FWD_KERNELS = ("bst_attn_fwd_wgmma_kernel", "bst_attn_fwd_mma_kernel")
DQ_KERNELS = ("bst_attn_dq_wgmma_kernel", "bst_attn_dq_mma_kernel")
DKV_KERNELS = ("bst_attn_dkv_wgmma_kernel", "bst_attn_dkv_mma_kernel")


def attn_fwd_device_times(fwd, fwd_lse, rows):
    """Both forward entry points' device time at the LM's shape (bf16) on
    bst_attn_fwd_wgmma.cu and on bst_attn_fwd_mma.cu, in turns."""
    rows["fwd_dev"] = attn_turns(fwd, FWD_KERNELS)
    rows["fwd_lse_dev"] = attn_turns(fwd_lse, FWD_KERNELS)


def attn_bwd_device_times(dq, dkv, rows):
    """dq's device time at the LM's shape (bf16) on bst_attn_dq_wgmma.cu
    and on bst_attn_bwd_mma.cu, and dk/dv's on bst_attn_dkv_wgmma.cu and
    on bst_attn_bwd_mma.cu, each in turns."""
    rows["dq_dev"] = attn_turns(dq, DQ_KERNELS)
    rows["dkv_dev"] = attn_turns(dkv, DKV_KERNELS)


def attn_wgmma_phase(bt, model, dev, g, card_line, rows):
    """The wgmma attention kernels against the mma.sync ones beyond the
    LM's shape (whose turns run in ``training_kernel_checks``), bf16: the
    pipeline's microbatch (BATCH / PP_MICRO x 2048), the sp-4 gather shard
    and ring pair of the last query rows (the most entries; dq stored in
    f32 there, as the ring stores it), and 4 heads of 128 at BATCH x 2048
    (dk/dv there runs bst_attn_bwd_mma.cu by the rule, so only the forward
    and dq have two kernels to time).  Each forward with lse, dq and dk/dv
    held against its plain version on both kernels, then timed by the
    profiler's device time in turns (mma, wgmma, wgmma, mma), the route
    ``attn_kernel`` takes printed beside.  Last, a ring pair whose query
    rows see no key (query chunk 0, key chunk n - 1): dq zero on both
    kernels, in both epilogues."""
    from blocksparse_tpu_torch.kernels import bst_attn
    from blocksparse_tpu_torch.models.sparse_transformer import (
        causal_subblock_mask, fixed_layout)
    from blocksparse_tpu_torch.parallel import sequence as seq
    bf, c, bst = torch.bfloat16, model.config, model.bst
    T, n = c.ctx, SP_SHARDS[-1]
    L = T // n
    wide = bt.BlocksparseTransformer(
        fixed_layout(T // 64, local_blocks=8), block_size=64, heads=4,
        mask_callback=causal_subblock_mask)

    def rand(*shape):
        return torch.randn(shape, device=dev, generator=g).to(bf)
    cases = (  # (what, op, tables, batch, query rows, key rows, dq dtype)
        (f"pipeline microbatch {BATCH // PP_MICRO} x {T}", bst,
         bst._tables(dev), BATCH // PP_MICRO, T, T, None),
        (f"sp {n} gather shard {n - 1}", bst,
         seq.shard_tables(bst, n, n - 1, None, dev), BATCH, L, T, None),
        (f"sp {n} ring pair ({n - 1}, {n - 1})", bst,
         seq.shard_tables(bst, n, n - 1, n - 1, dev), BATCH, L, L,
         torch.float32),
        (f"4 heads of 128, {BATCH} x {T}", wide, wide._tables(dev), BATCH, T,
         T, None))
    out_rows = {}
    for what, op, tab, B, Tq, Tk, dq_dtype in cases:
        H, state = op.heads, c.n_embd
        hs = state // H
        scale = 1.0 / np.sqrt(hs)
        q, do = rand(B, Tq, state), rand(B, Tq, state)
        k, v = rand(B, Tk, state), rand(B, Tk, state)
        args = (tab["q_blk"], tab["k_blk"], tab["mask"], H, 64, scale)
        out_ref, lse_ref = bst_attn.attention_fwd_lse_plain(q, k, v, *args)
        dvec = (do.float() * out_ref.float()).reshape(
            B, Tq, H, hs).sum(-1).transpose(1, 2).contiguous()
        dq_ref, dk_ref, dv_ref = bst_attn.attention_bwd_plain(
            q, k, v, do, lse_ref, dvec, *args, dq_dtype=dq_dtype)

        def fwd_lse():
            return bst_attn.attention_fwd_lse(q, k, v, tab, H, scale)

        def dq():
            return bst_attn.attention_dq(q, k, v, do, lse_ref, dvec, tab, H,
                                         scale, out_dtype=dq_dtype)

        def dkv():
            return bst_attn.attention_dkv(q, k, v, do, lse_ref, dvec, tab, H,
                                          scale)
        routes = tuple(bst_attn.attn_kernel(kind, bf, 64, hs, Tk // 64)
                       for kind in ("fwd", "dq", "dkv"))
        for side in ("wgmma", "mma"):
            with attn_on_mma() if side == "mma" else forced_wgmma():
                out, lse = fwd_lse()
                compare_fwd(f"{what}: fwd_lse out on the {side} kernel", out,
                            out_ref, bf)
                live = torch.isfinite(lse_ref)
                check(torch.equal(live, torch.isfinite(lse)) and (
                    not live.any() or (lse[live] - lse_ref[live]).abs().max()
                    .item() <= LSE_TOL),
                      f"{what}: fwd_lse lse on the {side} kernel within "
                      f"{LSE_TOL:g}, -inf where the plain lse is")
                compare(f"{what}: dq{' (f32)' if dq_dtype else ''} on the "
                        f"{side} kernel", dq(), dq_ref, ATTN_TOL[bf],
                        norm_tol=ATTN_NORM_TOL)
                same_bits(f"{what}: dq on the {side} kernel", dq)
                dk, dv = dkv()
                for name, a, r in (("dk", dk, dk_ref), ("dv", dv, dv_ref)):
                    compare(f"{what}: {name} on the {side} route", a, r,
                            ATTN_TOL[bf], norm_tol=ATTN_NORM_TOL)
        # both kernels timed, whichever the rule takes (bs 64: the route is
        # the head size's and, for the forward, the key context's)
        with forced_wgmma():
            f = attn_turns(fwd_lse, FWD_KERNELS)
            dqt = attn_turns(dq, DQ_KERNELS)
            d = attn_turns(dkv, DKV_KERNELS) if hs in \
                bst_attn.DKV_WGMMA_HEAD_SIZES else None
        out_rows[what] = {"fwd_lse": f, "dq": dqt, "dkv": d,
                          "routes": routes}

        def fmt(t):
            return (f"{t['mma'][0]:.4f} / {t['wgmma'][0]:.4f} / "
                    f"{t['wgmma'][1]:.4f} / {t['mma'][1]:.4f}")
        print(f"attention wgmma against mma.sync, {what} [{card_line}]: "
              f"device ms mma / wgmma / wgmma / mma: fwd_lse {fmt(f)}; dq"
              f"{' (f32)' if dq_dtype else ''} {fmt(dqt)}"
              + (f"; dk/dv {fmt(d)}" if d else
                 "; dk/dv on bst_attn_bwd_mma.cu only")
              + f"; the route: {', '.join(r + '.cu' for r in routes)}",
              flush=True)
        del q, k, v, do, out_ref, lse_ref, dvec, dq_ref, dk_ref, dv_ref
        torch.cuda.empty_cache()
    rows["attn_wgmma_phase"] = out_rows
    # a ring pair whose query rows see no key of the chunk: dq stores zeros
    tab = seq.shard_tables(bst, n, 0, n - 1, dev)
    H, hs = bst.heads, c.n_embd // bst.heads
    q, k, v, do = (rand(BATCH, L, c.n_embd) for _ in range(4))
    lse = torch.full((BATCH, H, L), float("-inf"), device=dev)
    dvec = torch.zeros((BATCH, H, L), device=dev)
    for side in ("wgmma", "mma"):
        with attn_on_mma() if side == "mma" else forced_wgmma():
            for dt in (None, torch.float32):
                got = bst_attn.attention_dq(q, k, v, do, lse, dvec, tab, H,
                                            1.0 / np.sqrt(hs), out_dtype=dt)
                check(bool((got == 0).all()),
                      f"sp {n} ring pair (0, {n - 1}), no key a query row "
                      f"sees: dq{' (f32)' if dt else ''} zero on the {side} "
                      f"kernel")
    del q, k, v, do, lse, dvec
    torch.cuda.empty_cache()


def f1_mask(blk_shape, head, qry, key, blk):
    """The causal sub-block mask, except that query row 3 of block-row 1
    sees no key at all (a fully masked row: F1)."""
    from blocksparse_tpu_torch.models.sparse_transformer import (
        causal_subblock_mask)
    mask = causal_subblock_mask(blk_shape, head, qry, key, blk)
    if qry == 1:
        mask[3, :] = False
    return mask


def attn_block_size_checks(bt, dev, g):
    """The attention kernels at every size the op takes, through its route
    to them (``_kernel_fwd``, ``_kernel_bwd``), on a small case (the fixed
    layout with 2 local blocks, the causal sub-block mask, batch 2, 2
    heads; q, k, v column slices of one qkv): in bf16 and f16 every (bs,
    hs) the kernels are built for, and in bf16, f16 and f32 the sizes the
    op carries onto them, block size 8 (the kernels' bs-16 view; ctx 40
    pads one hidden 8-row) and head sizes 8, 48 and 96 (zero-padded to 16,
    64 and 128).  The serving forward, the training forward's out and lse,
    dq, dk and dv against the plain versions at the op's own sizes, each
    kernel launched once a run, two runs equal bit for bit; and layouts
    with a fully masked query row (F1) at b64, b16 and b8: zero out and dq
    there, lse -inf, no NaN anywhere.  At b64 the forward, dq and dk/dv
    run their wgmma kernels where ``attn_kernel`` sends them (the launches on
    them counted), also at an odd number of block-rows (a pair half
    empty), and each such case runs again with the attention on the
    mma.sync kernels (``attn_on_mma``)."""
    from blocksparse_tpu_torch.kernels import bst_attn
    from blocksparse_tpu_torch.models.sparse_transformer import (
        causal_subblock_mask, fixed_layout)
    names = ("bst_attn_fwd", "bst_attn_fwd_lse", "bst_attn_dq",
             "bst_attn_dkv")

    def case(layout, bs, hs, dtype, mask_callback, what, heads=2, batch=2):
        op = bt.BlocksparseTransformer(layout, block_size=bs, heads=heads,
                                       mask_callback=mask_callback)
        ctx = layout.shape[-1] * bs
        qkv = torch.randn((batch, ctx, 3 * heads * hs), device=dev,
                          generator=g).to(dtype)
        q, k, v = qkv.split(heads * hs, dim=-1)
        do = torch.randn((batch, ctx, heads * hs), device=dev,
                         generator=g).to(dtype)
        tab, scale = op._tables(dev), 1.0 / np.sqrt(hs)
        args = (tab["q_blk"], tab["k_blk"], tab["mask"], heads, bs, scale)
        out, lse = bst_attn.attention_fwd_lse_plain(q, k, v, *args)
        dvec = (do.float() * out.float()).reshape(
            batch, ctx, heads, hs).sum(-1).transpose(1, 2).contiguous()
        refs = bst_attn.attention_bwd_plain(q, k, v, do, lse, dvec, *args)

        khs = bst_attn.kernel_head_size(hs)
        want_wg = {n: int(bst_attn.attn_kernel(
            kind, dtype, tab["kbs"], khs,
            tab["kctx_k"] // tab["kbs"]).endswith("wgmma"))
            for n, kind in zip(ATTN_WGMMA_WRAPPERS,
                               ("fwd", "fwd", "dq", "dkv"))}

        def run():
            before, wg0 = read_counts(), read_attn_wgmma()
            got = (op._kernel_fwd(q, k, v, scale, with_lse=False)[0],
                   *op._kernel_fwd(q, k, v, scale, with_lse=True),
                   *op._kernel_bwd(q, k, v, do, out, lse, scale))
            after, wg1 = read_counts(), read_attn_wgmma()
            check(all(after[n] == before[n] + 1 for n in names)
                  and all(wg1[n] - wg0[n] == want_wg[n] for n in wg0),
                  f"{what}: each attention kernel launched once, on the "
                  f"wgmma kernels {dict((n, wg1[n] - wg0[n]) for n in wg0)}")
            return got
        serve, fo, flse, *grads = run()
        for name, a in (("serving out", serve), ("training out", fo)):
            compare_fwd(f"{what} {name}", a, out, dtype)
        live = torch.isfinite(lse)
        lse_err = (flse[live] - lse[live]).abs().max().item()
        check(torch.equal(live, torch.isfinite(flse)) and lse_err <= LSE_TOL,
              f"{what} lse: max_abs_err {lse_err:.3e} (tol {LSE_TOL:g}), "
              f"-inf where the plain lse is")
        for name, a, r in zip(("dq", "dk", "dv"), grads, refs):
            compare(f"{what} {name}", a, r, ATTN_TOL[dtype],
                    norm_tol=ATTN_NORM_TOL)
        same_bits(f"{what} out, lse, dq, dk, dv", lambda: torch.cat(
            [t.float().flatten() for t in run()]))
        return (fo, flse) + tuple(grads)

    built = [(bs, hs, 4) for bs in bst_attn.BLOCK_SIZES
             for hs in bst_attn.HEAD_SIZES]
    carried = [(8, 16, 5), (8, 64, 8), (16, 8, 4), (16, 48, 4), (64, 48, 4),
               (32, 96, 4), (64, 64, 17), (64, 128, 17)]
    for dtype in DTYPES:
        for bs, hs, blks in (carried if dtype == torch.float32
                             else built + carried):
            for route in (("wgmma", "mma") if bs == 64 and hs > 32
                          and dtype != torch.float32 else ("",)):
                with attn_on_mma() if route == "mma" else \
                        contextlib.nullcontext():
                    case(fixed_layout(blks, local_blocks=2), bs, hs, dtype,
                         causal_subblock_mask,
                         f"attention b{bs} hs{hs} ctx {blks * bs} (kernels "
                         f"at b{max(bs, 16)} "
                         f"hs{bst_attn.kernel_head_size(hs)}"
                         f"{', ' + route if route else ''}) {dtype}")
        for bs, hs, blks in ((64, 64, 16), (16, 32, 4), (8, 48, 5)):
            out, lse, dq, dk, dv = case(
                np.tril(np.ones((blks, blks), np.int32)), bs, hs, dtype,
                f1_mask, f"attention b{bs} hs{hs} F1 layout {dtype}")
            dead = bs + 3
            check(bool((out[:, dead] == 0).all() and (dq[:, dead] == 0).all()
                       and torch.isneginf(lse[:, :, dead]).all()) and all(
                bool(torch.isfinite(t).all()) for t in (out, dq, dk, dv)),
                  f"attention b{bs} {dtype}: the fully masked query row's "
                  f"out and dq are zero and its lse -inf, no NaN in out, dq, "
                  f"dk, dv")
    torch.cuda.empty_cache()


# the attention kernels' mangled names (after the anonymous namespace's
# file prefix): kernel, dtype, BS, HS
_PTXAS_NAME = re.compile(r"(bst_attn_(?:fwd|dq|dkv)(?:_mma)?_kernel)I"
                         r"(13__nv_bfloat16|6__half|f)Li(\d+)ELi(\d+)E")


def ptxas_entries(source):
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} of the kernels of ``csrc/<source>.cu``, from the ``-Xptxas -v``
    log that the build left beside the library."""
    from blocksparse_tpu_torch.kernels import _build
    lib = _build.library_path(source)
    out, name, spill = {}, None, (0, 0)
    for line in lib.with_name(lib.name + ".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name] = (int(m.group(1)), *spill)
            name = None
    return out


def ptxas_resources(source):
    """{(kernel, dtype, bs, hs): (registers, spill store bytes, spill load
    bytes)} of the attention kernels of ``csrc/<source>.cu``."""
    out = {}
    for entry, res in ptxas_entries(source).items():
        name = _PTXAS_NAME.search(entry)
        if name:
            kernel, dt, bs, hs = name.groups()
            dt = {"13__nv_bfloat16": "bf16", "6__half": "f16"}.get(dt, "f32")
            out[(kernel, dt, int(bs), int(hs))] = res
    return out


def ptxas_report(source, label, pattern):
    """Registers and spills of the kernels of ``csrc/<source>.cu`` whose
    mangled names match ``pattern``; fails if there are none."""
    mine = {k: v for k, v in ptxas_entries(source).items()
            if pattern.search(k)}
    check(bool(mine), f"{source}.cu: {label} kernels built")
    regs = [v[0] for v in mine.values()]
    spills = sum(1 for v in mine.values() if v[1] or v[2])
    print(f"{source}.cu, {label}: {len(mine)} kernels, {min(regs)}-"
          f"{max(regs)} registers, spills in {spills}", flush=True)


def attn_report(model, rows, card_line, marks=None):
    """The attention kernels at the LM's shape (bf16): the forward (serving
    and lse), dq and dk/dv on their wgmma kernels and on the mma.sync ones
    (device time in turns, TFLOP/s, a call's host time) beside, given
    ``marks`` (``yardsticks``), the bound and SDPA's forward or backward;
    each wgmma instantiation's registers, spills, shared memory and
    resident blocks and what ptxas warned of, and each mma.sync one's
    registers and spills (ptxas)."""
    from blocksparse_tpu_torch.kernels import bst_attn
    c, bst = model.config, model.bst
    e = bst.blocks * BATCH * c.n_head * bst.blk_size ** 2 * model.hs
    host = rows["attn_host"]
    for name, dev_key, host_key, flops in (
            ("bst_attn_fwd", "fwd_dev", None, 4 * e),
            ("bst_attn_fwd_lse", "fwd_lse_dev", "fwd_lse", 4 * e),
            ("bst_attn_dq", "dq_dev", "dq", 6 * e),
            ("bst_attn_dkv", "dkv_dev", "dkv", 8 * e)):
        t = rows[dev_key]
        wg, mm = (float(np.mean(t[k])) for k in ("wgmma", "mma"))
        lib = ("SDPA forward" if "fwd" in name
               else "SDPA backward (dq, dk, dv)")
        print(f"{name} (bf16, batch {BATCH} x {c.ctx}) [{card_line}]: "
              f"device ms, in turns mma / wgmma / wgmma / mma: "
              f"{t['mma'][0]:.4f} / {t['wgmma'][0]:.4f} / {t['wgmma'][1]:.4f}"
              f" / {t['mma'][1]:.4f}: wgmma {flops / wg / 1e9:.1f} TFLOP/s, "
              f"mma.sync {flops / mm / 1e9:.1f} ({mm / wg:.2f}x)"
              + (f"; bound {marks[name][0]:.4f} ms ({marks[name][1]}); "
                 f"{lib} {marks[name][2]:.4f} ms" if marks else "")
              + (f"; host ms a call (eager) wgmma {host[host_key]:.4f}, "
                 f"mma.sync {host[host_key + '_mma']:.4f}" if host_key
                 else ""), flush=True)
    for kind, hs, out in (("fwd", 64, None), ("fwd", 128, None),
                          ("dq", 64, None), ("dq", 128, None),
                          ("dq", 64, torch.float32),
                          ("dq", 128, torch.float32), ("dkv", 64, None)):
        for dtype in (torch.bfloat16, torch.float16):
            i = bst_attn.wgmma_kernel_info(kind, dtype, hs, out)
            what = (f"bst_attn_{kind}_wgmma.cu <{str(dtype)[6:]}, hs {hs}"
                    f"{', dq in f32' if out else ''}>")
            print(f"{what}: {i['registers']} registers at entry (consumers "
                  f"raised by setmaxnreg), {i['local_bytes']} local bytes, "
                  f"{i['smem_bytes']} bytes of shared memory, "
                  f"{i['blocks_per_sm']} block(s) an SM, {i['stages']} ring "
                  f"slots", flush=True)
            check(i["local_bytes"] == 0 and i["blocks_per_sm"] >= 1,
                  f"{what}: no spill, resident")
    for kind in ("fwd", "dq", "dkv"):
        ptxas_warnings(f"bst_attn_{kind}_wgmma")
    for source in ("bst_attn_fwd_mma", "bst_attn_bwd_mma"):
        mine = ptxas_resources(source)
        spills = {k: v for k, v in mine.items() if v[1] or v[2]}
        regs = [v[0] for v in mine.values()]
        print(f"{source}.cu: {len(mine)} kernels, {min(regs)}-{max(regs)} "
              f"registers, spills in {len(spills)}: " + (", ".join(
                  f"{k[0][9:]}<{k[1]},{k[2]},{k[3]}> {v[0]} registers, "
                  f"{v[1]}/{v[2]} bytes" for k, v in sorted(spills.items()))
                  or "none"), flush=True)


def xprop_block_size_checks(bt, dev, g):
    """The bf16/f16 xprop kernels against their plain version at every
    block size, in bf16 and f16, for fprop and bprop: the op's unsplit
    route, bsmm_xprop_mma.cu unsplit ("mma"), bsmm_xprop_wgmma.cu over
    its column groups ("wgmma", the block sizes it takes),
    bsmm_xprop_sparse.cu over its pairs of input blocks ("sparse", b32;
    also bit for bit against "wgmma", and its packing of the weights
    against the plain packing), the split route's partial tiles (merged
    by merge_plain) and the fused split (bsmm_split, clusters of 8
    blocks; also bit for bit against bsmm_merge over the partials), each
    also run twice for equal bits."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    rng = np.random.RandomState(SEED)
    for b in bk.BLOCK_SIZES:
        n = XPROP_HIDDEN // b
        lay = (rng.rand(n, n) < XPROP_DENSITY).astype(np.int32)
        lay[np.arange(n), np.arange(n)] = 1
        op = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=1,
                                  mode="grouped")
        plain = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=1,
                                     impl="xla")
        lut = op._lut(dev)
        for dtype in (torch.bfloat16, torch.float16):
            w = (torch.randn(op.w_shape, device=dev, generator=g)
                 * 0.1).to(dtype)
            for d in "fb":
                x = torch.randn((XPROP_N, op.C if d == "f" else op.K),
                                device=dev, generator=g).to(dtype)
                ref = plain._xprop(x, w, d)
                split = op._plan_tensors(dev, "split", d, bk.SPLIT_MAX_PHASES)
                ents = (lut[f"{d}_ent_in"], lut[f"{d}_ent_w"])
                n_out = op.KB if d == "f" else op.CB
                kern = bk.bsmm_bprop if d == "b" else bk.bsmm_fprop
                csr = (lut[f"{d}_row_ptr"], *ents, b, n_out)
                runs = {
                    "unsplit": lambda: op._xprop(x, w, d),
                    "mma": lambda: kern(x, w, *csr),
                    "wgmma": lambda: kern(
                        x, w, *csr, plan=op._plan_tensors(dev, "wgmma", d)),
                    "sparse": lambda: kern(
                        x, w, *csr, plan=op._plan_tensors(dev, "sparse", d)),
                    "partials": lambda: bk.bsmm_partials(
                        x, w, split["tile_ptr"], *ents, b,
                        split["tile_ptr"].numel() - 1, d == "b"),
                    "split": lambda: bk.bsmm_split(
                        x, w, split["tile_ptr"], *ents, split["merge_idx"], b,
                        n_out, d == "b")}
                if b not in bk.WGMMA_BLOCK_SIZES:
                    del runs["wgmma"]
                if b not in bk.XPROP_SP_BLOCK_SIZES:
                    del runs["sparse"]
                else:
                    sp = op._plan_tensors(dev, "sparse", d)
                    check(torch.equal(
                        bk.xprop_sparse_pack(w, sp["w_order"], b),
                        bk.xprop_sparse_pack_plain(w, sp["w_order"], b)),
                        f"xprop_sparse_pack b{b} {d}prop {dtype}: equal bit "
                        f"for bit to its plain version")
                for route, fn in runs.items():
                    what = (f"bsmm_xprop b{b} {d}prop {route} "
                            f"({op.kernel_of(XPROP_N, d, dtype)} on the "
                            f"op's route) N={XPROP_N} {op.blocks} blocks "
                            f"{dtype}")
                    same_bits(what, fn)
                    y = fn()
                    if route == "partials":
                        y = bk.merge_plain(y, split["merge_idx"].long(), b,
                                           dtype)
                        merged = bk.bsmm_merge(runs["partials"](),
                                               split["merge_idx"], b, dtype)
                    if route == "split":
                        check(torch.equal(y, merged), f"{what}: equal bit "
                              f"for bit to bsmm_partials + bsmm_merge (P "
                              f"{split['merge_idx'].shape[1]})")
                    if route == "sparse":
                        check(torch.equal(y, runs["wgmma"]()), f"{what}: "
                              f"equal bit for bit to bsmm_xprop_wgmma.cu")
                    compare(what, y, ref, TOL[dtype])
    torch.cuda.empty_cache()


def updat_block_size_checks(bt, dev, g):
    """The bf16/f16 updat kernels against their plain version at every
    block size, in bf16 and f16, unsplit and split, on the layout of the
    xprop sweep and its transpose (groups by x block-row and by dy
    block-column), each run twice for equal bits: the op's route, and
    bsmm_updat_mma.cu, bsmm_updat_wgmma.cu and bsmm_updat_sparse.cu (the
    block sizes they take) each with its own plan and split."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    sms = bk.device_sm_count(dev)
    rng = np.random.RandomState(SEED + 1)
    for b in (8, 16, 32, 64, 128):
        n = XPROP_HIDDEN // b
        lay = (rng.rand(n, n // 2) < XPROP_DENSITY).astype(np.int32)
        lay[np.arange(n // 2), np.arange(n // 2)] = 1
        for layout in (lay, lay.T.copy()):
            op = bt.BlocksparseMatMul(layout, block_size=b, feature_axis=1)
            plain = bt.BlocksparseMatMul(layout, block_size=b,
                                         feature_axis=1, impl="xla")
            lut = op._lut(dev)
            kernels = ("mma", "wgmma") if b in bk.WGMMA_BLOCK_SIZES \
                else ("mma",)
            kernels += ("sparse",) if b in bk.UPDAT_SP_BUNDLES else ()
            for dtype in (torch.bfloat16, torch.float16):
                for N in (XPROP_N, UPDAT_SPLIT_N):
                    x = torch.randn((N, op.C), device=dev,
                                    generator=g).to(dtype)
                    dy = torch.randn((N, op.K), device=dev,
                                     generator=g).to(dtype)
                    ref = plain._updat(x, dy)
                    for kernel in (None, *kernels):
                        name = op.kernel_of(N, "u", dtype) if kernel is None \
                            else f"bsmm_updat_{kernel}"
                        kind = "updat_sparse" if name.endswith("_sparse") \
                            else "updat"
                        plan = op._plan(kind, "u")
                        planned = op._plan_tensors(dev, kind, "u")
                        groups = len(plan["grp_q"])
                        if kernel is None:      # the op's route
                            runs = op.updat_splits(N, dtype)

                            def fn():
                                return op._updat(x, dy)
                        else:
                            runs = bk.updat_splits(N, groups, b, sms, kernel)

                            def fn(kernel=kernel, runs=runs):
                                return bk.bsmm_updat(
                                    x, dy, lut["u_c32"], lut["u_k32"], b,
                                    planned, runs, kernel)
                        check((runs > 1) == (N == UPDAT_SPLIT_N),
                              f"updat b{b} N={N} on {name}: {runs} runs of N "
                              f"(split only at N={UPDAT_SPLIT_N})")
                        what = (f"{name}{'' if kernel else ' (route)'} b{b} "
                                f"{op.C} -> {op.K} {op.blocks} blocks, "
                                f"{groups} groups by "
                                f"{'x' if plan['by_c'] else 'dy'} block"
                                + (f" (bundles of {plan['R']})"
                                   if "R" in plan else "") + ", "
                                f"N={N} in {runs} runs {dtype}")
                        same_bits(what, fn)
                        compare(what, fn(), ref, UPDAT_TOL)
                    del x, dy, ref
    torch.cuda.empty_cache()


# The wgmma phase: the wgmma kernels against the mma.sync kernels they
# replace, in turns (mma, wgmma, sparse, sparse, wgmma, mma: at b32 the
# xprop on bsmm_xprop_sparse.cu too, its weights' packing included), each
# a CUDA graph of WG_CALLS calls timed by CUDA events (device time; a
# call's host time beside it, eager), at the main path's shapes: the LM's
# two MLP products at the train step's N and below (prefill 8192
# (PROMPTS x PROMPT_LEN is 4096), the pipeline microbatch 4096, 2048,
# 1024: where the route rule turns), the conv's at C 512, 1024 and 2048
# (d 0.25, N 32 x 32 x 32), the MoE's bsmm1 at N = C = 2560 (dense b32;
# its updat takes bf16 inputs), bench.py's random 8192^2 b32 op at N
# 2048.
WG_CALLS = 20
WG_NS = (16384, 8192, 4096, 2048, 1024)
WG_PLAIN_BYTES = 2 ** 31
WG_SOURCES = ("bsmm_xprop_wgmma", "bsmm_updat_wgmma", "bsmm_xprop_sparse",
              "bsmm_updat_sparse")
# the wgmma kernels' dynamic shared memory a thread block by block size
# (the sparse updat's by its bundle size R = 1, 2, ...), as their sources'
# smem_bytes() count it (1 KB of alignment, the ring, the xprop's staged
# output tile, two mbarriers a stage, and the sparse xprop's slot mask a
# stage)
WG_SMEM = {"bsmm_xprop_wgmma": {32: 216160, 64: 216112, 128: 216112},
           "bsmm_updat_wgmma": {32: 185424, 64: 164928, 128: 197696},
           "bsmm_xprop_sparse": {32: 216124},
           "bsmm_updat_sparse": {32: (185424, 164928, 181312, 197696),
                                 64: (164928, 197696)}}


def wgmma_cases(bt, model):
    """(label, op, N, directions) of the wgmma phase; the conv's ops as
    its BlocksparseConv builds them (feature_axis 0: the kernels see X's
    NC transpose, as the conv hands it)."""
    cases = [(f"{name} N={N}", op, N, "fbu")
             for name, op in (("bsmm1", model.bsmm1), ("bsmm2", model.bsmm2))
             for N in WG_NS]
    for C, d, bck in conv_configs():
        if d == 0.25:
            conv = bt.BlocksparseConv(bck, (3, 3), (CONV_HW, CONV_HW),
                                      padding="SAME", impl="bsmm")
            cases.append((f"conv C={C}", conv._bsmm_op,
                          CONV_BATCH * CONV_HW ** 2, "fbu"))
    cases.append(("moe bsmm1 N=2560", bt.BlocksparseMatMul(
        np.ones((16, 64), np.int32), block_size=32, feature_axis=1), 2560,
        "fbu"))
    lay = make_layout("random", PACKED_HIDDEN // 32, PACKED_DENSITY,
                      np.random.RandomState(0))
    cases.append(("packed random b32 N=2048", bt.BlocksparseMatMul(
        lay, block_size=32, feature_axis=0), PACKED_N, "fbu"))
    return cases


def updat_plain_chunked(x, dy, ent_c, ent_k, b):
    """``updat_plain`` (NC orientation) over the layout's blocks in chunks
    whose gathered (N, chunk, b) f32 x and dy take at most WG_PLAIN_BYTES
    together: the same function, each block the same sum."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    step = max(1, WG_PLAIN_BYTES // (8 * x.shape[0] * b))
    return torch.cat([bk.updat_plain(x, dy, ent_c[i:i + step],
                                     ent_k[i:i + step], b, 1)
                      for i in range(0, ent_c.numel(), step)])


def wgmma_pair(op, N, d, dev, g):
    """{"mma": fn, "wgmma": fn[, "sparse": fn]} of direction d ("f", "b",
    "u") of ``op`` at N rows, bf16, on the two kernels (the updat each
    with its own split and the reduce), at b32 the xprop's sparse one
    (its weights' packing and the kernel) and at b32 and b64 the updat's
    (over its own plan, with its split and the reduce), the route's plain
    version, the bound's (flops, bytes) and the library call."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    bf, b, sms = torch.bfloat16, op.bsize, bk.device_sm_count(dev)
    lut = op._lut(dev)
    cin, cout = (op.C, op.K) if d != "b" else (op.K, op.C)
    x = torch.randn((N, cin), device=dev, generator=g).to(bf)
    w = (torch.randn(op.w_shape, device=dev, generator=g) * 0.05).to(bf)
    flops = 2 * N * op.blocks * b * b
    wd = dense_weight(op, w)
    if d == "u":
        dy = torch.randn((N, op.K), device=dev, generator=g).to(bf)

        def run(kernel):
            plan = op._plan_tensors(
                dev, "updat_sparse" if kernel == "sparse" else "updat", "u")
            runs = bk.updat_splits(N, plan["grp_q"].shape[0], b, sms, kernel)
            return lambda: bk.bsmm_updat(x, dy, lut["u_c32"], lut["u_k32"],
                                         b, plan, runs, kernel)
        kernels = ("mma", "wgmma") + (
            ("sparse",) if b in bk.UPDAT_SP_BUNDLES else ())
        fns = {k: run(k) for k in kernels}
        plain = lambda: updat_plain_chunked(x, dy, lut["u_c"], lut["u_k"], b)
        nbytes = 2 * N * (op.C + op.K) + 4 * op.blocks * b * b
        lib = lambda: x.t() @ dy
        tol = UPDAT_TOL
    else:
        kern = bk.bsmm_fprop if d == "f" else bk.bsmm_bprop
        csr = (lut[f"{d}_row_ptr"], lut[f"{d}_ent_in"], lut[f"{d}_ent_w"], b,
               cout // b)
        wplan = op._plan_tensors(dev, "wgmma", d)
        fns = {"mma": lambda: kern(x, w, *csr),
               "wgmma": lambda: kern(x, w, *csr, plan=wplan)}
        if b in bk.XPROP_SP_BLOCK_SIZES:
            splan = op._plan_tensors(dev, "sparse", d)
            fns["sparse"] = lambda: kern(x, w, *csr, plan=splan)
        plain = lambda: bk.xprop_plain(
            x, w, lut[f"{d}_in"], lut[f"{d}_w"], lut[f"{d}_out"], cout // b,
            b, 1, trans_w=d == "b")
        nbytes = 2 * (N * (op.C + op.K) + op.blocks * b * b)
        lib = (lambda: x @ wd) if d == "f" else (lambda: x @ wd.t())
        tol = TOL[bf]
    return fns, plain, (flops, nbytes), lib, tol


def pack_row(op, d, dev, g, card_line, rows, label=""):
    """xprop_sparse_pack of direction d of ``op``'s weights (bf16; the
    case's ``label`` printed): its
    kernel against its plain version (bit for bit), the kernel's device
    time (a CUDA graph of WG_CALLS calls) and the plain version's;
    rows["sparse_pack"] = (err, ms, plain ms), rows["sparse_pack_mark"] =
    (bound ms, "bytes", None): the bytes the kernel moves, a read of each
    block of W it copies and a write of every packed block (a pair's
    absent block is written as zeros and reads nothing); no PyTorch call
    computes the packing."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    w = (torch.randn(op.w_shape, device=dev, generator=g) * 0.05).to(
        torch.bfloat16)
    order = op._plan_tensors(dev, "sparse", d)["w_order"]
    got = bk.xprop_sparse_pack(w, order, op.bsize)
    check(torch.equal(got, bk.xprop_sparse_pack_plain(w, order, op.bsize)),
          f"xprop_sparse_pack at {op.blocks} blocks of b{op.bsize}: equal "
          f"bit for bit to its plain version")
    ms = graph_ms(lambda: bk.xprop_sparse_pack(w, order, op.bsize), WG_CALLS)
    plain_ms = time_ms(lambda: bk.xprop_sparse_pack_plain(w, order,
                                                          op.bsize), WG_CALLS)
    block = op.bsize ** 2 * got.element_size()
    mark = bound(0, (int((order >= 0).sum()) + order.numel()) * block)
    rows["sparse_pack"] = (0.0, ms, plain_ms)
    rows["sparse_pack_mark"] = (*mark, None)
    print(f"xprop_sparse_pack {label} {'fprop' if d == 'f' else 'bprop'} "
          f"{op.blocks} blocks of b{op.bsize} bf16 "
          f"[{card_line}]: {ms:.4f} ms (device, a CUDA graph of {WG_CALLS}), "
          f"plain {plain_ms:.4f} ms, bound {mark[0]:.4f} ms ({mark[1]})",
          flush=True)


def host_ms(fn, n=50):
    """A call's host time: n eager calls back to back, the clock stopped
    before the device is waited for (the enqueue, not the kernels)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / n
    torch.cuda.synchronize()
    return ms


def wgmma_turns(bt, model, dev, g, card_line, rows, dirs="fbu"):
    """The wgmma phase (see WG_CALLS) over the directions in ``dirs``: at
    each case the kernels (two, or at a b32 xprop and a b32 or b64 updat
    three) held against the plain version (TOL, UPDAT_TOL)
    and each run twice bit-equal, then timed in turns; printed beside the
    bound, the library call (dense torch.matmul of the scattered W, or
    x^T . dy) and the route the op takes, and at the train step's shape
    the profiler's device time a launch; the sparse route also split into
    its packing (``pack_row``) and its kernel alone (the profiler) at the
    step's shape and the cases past the LM's, the sparse updat's kernel
    alone (without its split's reduce) there too; rows[("wg", label, d)] =
    {kernel: [device ms, ...], "host": {kernel: ms}, ...}.  Then the
    sources' registers, spills and shared memory (ptxas)."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    bf, sms = torch.bfloat16, bk.device_sm_count(dev)
    t0 = time.perf_counter()
    for label, op, N, case_dirs in wgmma_cases(bt, model):
        for d in (d for d in case_dirs if d in dirs):
            name = {"f": "fprop", "b": "bprop", "u": "updat"}[d]
            fns, plain, (flops, nbytes), lib, tol = wgmma_pair(op, N, d, dev,
                                                               g)
            src = "bsmm_updat" if d == "u" else "bsmm_xprop"
            # the plain version gathers (N, blocks, b) f32: past
            # WG_PLAIN_BYTES the xprop's wgmma kernels are held against the
            # mma one (itself held against the plain version at the other
            # shapes); the updat's plain version runs in block chunks
            small = d == "u" or N * op.blocks * op.bsize * 4 <= WG_PLAIN_BYTES
            ref = plain() if small else fns["mma"]()
            errs = {}
            for k, fn in fns.items():
                what = f"wgmma phase {label} {name} on {src}_{k}"
                same_bits(what, fn)
                if small or k != "mma":
                    errs[k] = compare(
                        f"{what} against "
                        f"{'the plain version' if small else src + '_mma'}",
                        fn(), ref, tol)
            del ref
            dev_ms = in_turns(fns, lambda fn: graph_ms(fn, WG_CALLS))
            host = {k: host_ms(fn) for k, fn in fns.items()}
            lib_ms = time_ms(lib, WG_CALLS)
            mark = bound(flops, nbytes)
            route = op.kernel_of(N, d, bf, sms)
            rows[("wg", label, d)] = {**dev_ms, "host": host, "bound": mark,
                                      "lib": lib_ms, "route": route,
                                      "err": errs}
            at_step = N == BATCH * model.config.ctx and \
                label.startswith("bsmm")
            if "sparse" in fns and d != "u" and (
                    at_step or not label.startswith("bsmm")):
                # the sparse route split into its weights' packing and
                # its kernel, at the step's shape and the other cases
                pack_row(op, d, dev, g, card_line,
                         rows if at_step and label.startswith("bsmm1") and
                         d == "f" else {}, label)
            if at_step or "sparse" in fns and not label.startswith("bsmm"):
                # the profiler's device time a launch of each kernel (the
                # updat's without its split's reduce, the sparse one's
                # without its packing), in turns; at the step's shape every
                # kernel, elsewhere the sparse one
                kern = {id(fn): f"bsmm_{'updat' if d == 'u' else 'xprop'}_"
                                f"{k}_kernel" for k, fn in fns.items()}
                prof = in_turns(fns if at_step else
                                {"sparse": fns["sparse"]},
                                lambda fn: kernel_device_ms(
                                    fn, kern[id(fn)], WG_CALLS))
                rows[("wg", label, d)]["profiler"] = prof
                print(f"      {label} {name}: profiler device time a launch "
                      + ", ".join(f"{k} {' / '.join(f'{v:.4f}' for v in t)}"
                                  f" ms" for k, t in prof.items())
                      + " (turns" + ("; the sparse kernel's without its "
                                     + ("split's reduce" if d == "u" else
                                        "packing")
                                     if "sparse" in prof else "")
                      + ")", flush=True)
            mean = {k: float(np.mean(t)) for k, t in dev_ms.items()}
            best = min(mean, key=mean.get)
            print(f"{label} {name} bf16 [{card_line}]: "
                  + ", ".join(f"{k} {' / '.join(f'{v:.4f}' for v in t)} ms"
                              for k, t in dev_ms.items())
                  + f" (device, in turns; wgmma/mma "
                  f"{mean['wgmma'] / mean['mma']:.3f}"
                  + (f", sparse/mma {mean['sparse'] / mean['mma']:.3f}, "
                     f"sparse/wgmma {mean['sparse'] / mean['wgmma']:.3f}"
                     if "sparse" in mean else "")
                  + f"; {best} {flops / mean[best] / 1e9:.1f} TFLOP/s); host "
                  f"a call " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in host.items())
                  + f" ms; bound {mark[0]:.4f} ms ({mark[1]}); library "
                  f"{lib_ms:.4f} ms; the op's route: {route}", flush=True)
            del fns, plain, lib
        torch.cuda.empty_cache()
    print(f"wgmma phase: {time.perf_counter() - t0:.1f} s", flush=True)
    wgmma_ptxas_report()


def wgmma_ptxas_report():
    """Registers, spills and static shared memory of the wgmma kernels,
    from ptxas' log, their dynamic shared memory (WG_SMEM), and what
    ptxas warned of; and the sparse kernel's as the runtime reports them."""
    from blocksparse_tpu_torch.kernels import _build
    from blocksparse_tpu_torch.kernels import bsmm as bk
    for dtype in (torch.bfloat16, torch.float16):
        for trans in (False, True):
            i = bk.sparse_kernel_info(dtype, trans)
            what = (f"bsmm_xprop_sparse.cu {dtype} "
                    f"{'bprop' if trans else 'fprop'}: {i['registers']} "
                    f"registers, {i['local_bytes']} local bytes, "
                    f"{i['smem_bytes']} bytes of shared memory, "
                    f"{i['blocks_per_sm']} block(s) an SM, {i['stages']} "
                    f"ring slots")
            check(i["local_bytes"] == 0 and i["blocks_per_sm"] >= 1 and
                  i["smem_bytes"] == WG_SMEM["bsmm_xprop_sparse"][32],
                  f"{what}: no spill, resident")
    for source in ("bsmm_xprop_sparse", "bsmm_updat_sparse"):
        lib = _build.library_path(source)
        serial = [line for line in lib.with_name(lib.name + ".log")
                  .read_text().splitlines() if "C7520" in line]
        check(not serial, f"{source}.cu: ptxas serializes no wgmma "
                          f"({len(serial)} warnings)")
    spilled = {k: v for k, v in ptxas_entries("bsmm_updat_sparse").items()
               if v[1] or v[2]}
    check(not spilled, f"bsmm_updat_sparse.cu: no instantiation spills "
                       f"({len(spilled)} do)")
    for source in WG_SOURCES:
        entries = ptxas_entries(source)
        check(bool(entries), f"{source}.cu: kernels built")
        lib = _build.library_path(source)
        log = lib.with_name(lib.name + ".log").read_text()
        smem = sorted(set(re.findall(r"(\d+) bytes smem", log)))
        print(f"{source}.cu: {len(entries)} kernels, "
              + ", ".join(f"{k.split('Li')[1] if 'Li' in k else k}"
                          f"{'/bf16' if '13__nv_bfloat16' in k else '/f16'}"
                          f"{'/T' if 'Lb1E' in k else ''} {v[0]} registers, "
                          f"spills {v[1]}/{v[2]} bytes"
                          for k, v in sorted(entries.items()))
              + f"; static shared memory {smem} bytes, dynamic by block "
              f"size {WG_SMEM[source]} bytes", flush=True)
        ptxas_warnings(source)


def ptxas_warnings(source):
    """Prints what ptxas warned of building csrc/<source>.cu (a wgmma
    serialized, setmaxnreg ignored)."""
    from blocksparse_tpu_torch.kernels import _build
    lib = _build.library_path(source)
    for line in lib.with_name(lib.name + ".log").read_text().splitlines():
        if "warning" in line.lower() or "serializ" in line.lower() \
                or "setmaxnreg" in line.lower():
            print(f"      ptxas ({source}.cu): {line.strip()}", flush=True)


def f32_layouts(b, rng):
    """The f32 kernels' layouts at block size b: the xprop sweep's random
    hidden² layout with an empty output column; a full one whose output
    columns share their entry lists (3 · gn + 1 of them, gn = 128 / b the
    columns of a group of bsmm_fprop.cu), but for an empty block-row and
    block-column; and one block wide."""
    n = XPROP_HIDDEN // b
    lay = (rng.rand(n, n) < XPROP_DENSITY).astype(np.int32)
    lay[np.arange(n), np.arange(n)] = 1
    lay[:, 1] = 0
    m = 3 * max(1, 128 // b) + 1
    full = np.ones((m, m), np.int32)
    full[2, :] = full[:, 2] = 0
    return {"random": lay, "grouped": full,
            "one block wide": np.ones((n, 1), np.int32)}


def f32_block_size_checks(bt, dev, g):
    """bsmm_fprop.cu and bsmm_updat.cu (f32, CUDA cores) at every block
    size on f32_layouts' three layouts and at N = 1, 4 and XPROP_N: fprop,
    bprop (TRANS) and the split route's partials (PARTIAL, merged by
    merge_plain) against their plain versions, in the configuration
    xprop_tile picks; the same bits in both configurations the kernel is
    built for and with one column a thread block in index order; two runs
    equal bit for bit; the updat on each
    layout and its transpose, twice equal, against its plain version."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    rng = np.random.RandomState(SEED + 3)
    f32 = torch.float32
    for b in bk.BLOCK_SIZES:
        for kind, lay in f32_layouts(b, rng).items():
            op = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=1,
                                      mode="grouped")
            plain = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=1,
                                         impl="xla")
            lut = op._lut(dev)
            w = torch.randn(op.w_shape, device=dev, generator=g) * 0.1
            for d, route in (("f", "fprop"), ("b", "bprop"),
                             ("f", "partials"), ("b", "partials")):
                trans = d == "b"
                ents = (lut[f"{d}_ent_in"], lut[f"{d}_ent_w"])
                phases = bk.SPLIT_MAX_PHASES if route == "partials" else 0
                if route == "partials":
                    split = op._plan_tensors(dev, "split", d, phases)
                    ptr = split["tile_ptr"]
                    n_out = ptr.numel() - 1
                    fn = functools.partial(bk.bsmm_partials, trans_w=trans)
                else:
                    ptr, n_out = lut[f"{d}_row_ptr"], (op.KB, op.CB)[trans]
                    fn = bk.bsmm_bprop if trans else bk.bsmm_fprop
                plan = op._plan_tensors(dev, "xgroup", d, phases)
                launches = [bk.xprop_launch(plan, t)
                            for t in bk.xprop_f32_tiles(b)
                            if t[0] == 1 or t[0] == plan["gn"]]
                launches.append({"grp_col": torch.arange(
                    n_out, dtype=torch.int32, device=dev)[:, None],
                    "gn": 1, "tm": bk.XPROP_F32_TM})
                for N in (1, 4, XPROP_N):
                    x = torch.randn((N, op.C if d == "f" else op.K),
                                    device=dev, generator=g)

                    def run(pl=op._xlaunch(dev, d, N, phases)):
                        return fn(x, w, ptr, *ents, b, n_out, plan=pl)
                    what = (f"bsmm_fprop.cu b{b} {kind} {d}prop {route} N={N}"
                            f" {op.blocks} blocks, {plan['grp_col'].shape[0]}"
                            f" groups of {plan['gn']}")
                    same_bits(what, run)
                    y = run()
                    check(all(torch.equal(run(pl), y) for pl in launches),
                          f"{what}: every configuration ({len(launches)}: "
                          f"grouped, one column a thread block, in plan and "
                          f"index order) equal bit for bit")
                    if route == "partials":
                        y = bk.merge_plain(y, split["merge_idx"].long(), b)
                    compare(what, y, plain._xprop(x, w, d), TOL[f32])
                    del x
            for layout in (lay, lay.T.copy()):
                op = bt.BlocksparseMatMul(layout, block_size=b,
                                          feature_axis=1)
                plain = bt.BlocksparseMatMul(layout, block_size=b,
                                             feature_axis=1, impl="xla")
                plan = op._plan("updat", "u")
                for N in (1, 4, XPROP_N):
                    x = torch.randn((N, op.C), device=dev, generator=g)
                    dy = torch.randn((N, op.K), device=dev, generator=g)
                    what = (f"bsmm_updat.cu b{b} {kind} {op.C} -> {op.K} "
                            f"{op.blocks} blocks, {len(plan['grp_q'])} groups"
                            f" by {'x' if plan['by_c'] else 'dy'} block, "
                            f"N={N}")
                    same_bits(what, lambda: op._updat(x, dy))
                    compare(what, op._updat(x, dy), plain._updat(x, dy),
                            UPDAT_TOL)
                    del x, dy
    torch.cuda.empty_cache()


def f32_configs(op, N, label, sms):
    """{label: (source, args of its info function)}: the f32 kernel
    configurations an op's fprop, bprop and updat of N rows take on a card
    of ``sms`` SMs."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    out = {}
    for d in "fb":
        route = op._route(N, d, sms)
        phases = op._phases(N, d, sms) if route == "phased" else 0
        gn, tm = bk.xprop_tile(N, op.bsize, op._plan("xgroup", d, phases),
                               sms)
        out[f"{label} {d}prop (route {route})"] = (
            "bsmm_fprop", (op.bsize, int(d == "b"), gn, tm))
    out[f"{label} updat"] = ("bsmm_updat", (
        op.bsize, int(op._plan("updat", "u")["by_c"])))
    return out


def f32_kernel_report(shapes):
    """Each f32 kernel configuration's registers, spilled bytes, shared
    memory a thread block and thread blocks an SM holds (the CUDA runtime's
    function attributes and occupancy), the configurations the MoE and
    LSTM shapes take (``shapes``: {label: (source, args)}) marked."""
    from blocksparse_tpu_torch.kernels import _build
    from blocksparse_tpu_torch.kernels import bsmm as bk
    out = (ctypes.c_int * 5)()
    ptr = ctypes.cast(out, ctypes.c_void_p)
    xinfo = _build.function("bsmm_fprop", "bsmm_xprop_nc_info",
                            [ctypes.c_int] * 4 + [ctypes.c_void_p])
    uinfo = _build.function("bsmm_updat", "bsmm_updat_nc_info",
                            [ctypes.c_int] * 2 + [ctypes.c_void_p])
    used = {}
    for label, config in shapes.items():
        used[config] = f"{used[config]}; {label}" if config in used else label
    spills = 0
    for b in bk.BLOCK_SIZES:
        configs = [("bsmm_fprop", (b, t, gn, tm)) for t in (0, 1)
                   for gn, tm in bk.xprop_f32_tiles(b)]
        configs += [("bsmm_updat", (b, by_c)) for by_c in (0, 1)]
        for source, args in configs:
            fn = xinfo if source == "bsmm_fprop" else uinfo
            check(fn(*args, ptr) == 0 and out[4] >= 1,
                  f"{source}.cu {args}: fits on the card")
            spills += out[3] > 0
            names = ("b", "trans", "gn", "tm") if source == "bsmm_fprop" \
                else ("b", "by_c")
            mark = used.get((source, args))
            print(f"{source}.cu " + ", ".join(
                f"{k} {v}" for k, v in zip(names, args))
                + f": {out[0]} threads, {out[2]} registers, {out[3]} bytes "
                f"spilled a thread, {out[1]} bytes of shared memory a block,"
                f" {out[4]} blocks an SM" + (f"  <- {mark}" if mark else ""),
                flush=True)
    print(f"f32 kernels: {spills} configurations spill", flush=True)


@contextlib.contextmanager
def mode_on(kernel):
    """The fine and window modes' bf16/f16 kernel pinned to ``kernel``
    ("wgmma" or "mma") in place of the rules fine_kernel and
    window_kernel, which are restored after."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    rules = bk.fine_kernel, bk.window_kernel
    bk.fine_kernel = bk.window_kernel = lambda *_: kernel
    try:
        yield
    finally:
        bk.fine_kernel, bk.window_kernel = rules


def read_mode_wgmma():
    """Of the fine and window wrappers' launches, those of the wgmma
    kernels, and the window kernel's weights' packings."""
    from blocksparse_tpu_torch.kernels import bsmm
    return {"bsmm_fine": bsmm.bsmm_fine.launches_wgmma,
            "bsmm_window": bsmm.bsmm_window.launches_wgmma,
            "window_wgmma_pack": bsmm.window_wgmma_pack.launches}


def mode_block_size_checks(bt, dev, g):
    """The fine (b8-b32) and window (b8-b128) kernels, the wgmma ones
    (bsmm_fine_wgmma.cu, bsmm_window_wgmma.cu) and the mma.sync ones
    (bsmm_fine_mma.cu, bsmm_window_mma.cu) each pinned in turn, against
    their plain versions at every block size, in bf16 and f16, fprop and
    bprop, on a random layout of the xprop sweep's size and density with
    an empty output column, at N = XPROP_N, CANON_N and MODE_LONG_N (the
    mma.sync window kernel's N-tile changes), each run twice for equal
    bits and counted on the kernel pinned."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    rng = np.random.RandomState(SEED + 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for b in bk.BLOCK_SIZES:
        n = XPROP_HIDDEN // b
        lay = (rng.rand(n, n) < XPROP_DENSITY).astype(np.int32)
        lay[np.arange(n), np.arange(n)] = 1
        lay[:, 1] = 0
        plain = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=1,
                                     impl="xla")
        kinds = ("fine", "window") if b in bk.FINE_BLOCK_SIZES \
            else ("window",)
        for kind in kinds:
            op = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=1,
                                      mode=kind)
            for dtype in (torch.bfloat16, torch.float16):
                w = (torch.randn(op.w_shape, device=dev, generator=g)
                     * 0.1).to(dtype)
                for d in "fb":
                    for N in (XPROP_N, CANON_N, MODE_LONG_N):
                        x = torch.randn((N, op.C if d == "f" else op.K),
                                        device=dev, generator=g).to(dtype)
                        ref = plain._xprop(x, w, d)
                        for kernel in ("wgmma", "mma"):
                            tn = bk.WINDOW_WG_TN if kernel == "wgmma" else \
                                bk.window_tn(N, -(-n // bk.WINDOW_SG[b]), sms)
                            tile = f" TN {tn}" if kind == "window" else ""
                            what = (f"bsmm_{kind}_{kernel} b{b} {d}prop "
                                    f"N={N}{tile} {op.blocks} blocks {dtype}")
                            before = read_mode_wgmma()[f"bsmm_{kind}"]
                            with mode_on(kernel):
                                same_bits(what, lambda: op._xprop(x, w, d))
                                y = op._xprop(x, w, d)
                            moved = read_mode_wgmma()[f"bsmm_{kind}"] - before
                            check(moved == 3 * (kernel == "wgmma"),
                                  f"{what}: {moved} of 3 launches on wgmma")
                            compare(what, y, ref, TOL[dtype])
                        del x, ref
    torch.cuda.empty_cache()


def mode_fns(op, kind, xn, w, d):
    """The bf16/f16 product of ``op``'s direction d on xn (N, C) by each
    route, as callables: "wgmma" (the mode's wgmma kernel, the window's
    with its weights' packing), "mma" (its mma.sync kernel), "grouped"
    (the unsplit kernel mode "grouped" takes); for the window also
    "kernel" (the wgmma kernel alone, on weights packed once), "pack" (the
    packing alone), "plain_pack" (its plain version); and the weights
    packed once (None for fine, whose kernel reads W where it lies)."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    dev, b, N, trans = xn.device, op.bsize, xn.shape[0], d == "b"
    n_out = op.KB if d == "f" else op.CB
    lut = op._lut(dev)
    if kind == "fine":
        p = op._plan_tensors(dev, "fine", d)
        args = (p["chunk_ptr"], p["slot_in"], p["slot_w"], b, n_out, trans)
        packed = None
        fns = {"wgmma": lambda: bk.bsmm_fine(xn, w, *args, "wgmma"),
               "mma": lambda: bk.bsmm_fine(xn, w, *args, "mma")}
    else:
        p = op._plan_tensors(dev, "window", d)
        wp = op._plan_tensors(dev, "window_wgmma", d)
        args = (p["ptr"], p["ent_slot"], p["ent_w"], b, n_out, trans)

        def pack():
            return bk.window_wgmma_pack(w, wp["cell_w"], b, trans)
        packed = pack()
        fns = {"wgmma": lambda: bk.bsmm_window(xn, w, *args, wp),
               "mma": lambda: bk.bsmm_window(xn, w, *args),
               "kernel": lambda: bk.bsmm_window(xn, w, *args, wp, packed)}
        fns["plain_pack"] = lambda: bk.window_wgmma_pack_plain(
            w, wp["cell_w"], b, trans)
        fns["pack"] = pack
    xk = op._xkernel(N, d, bk.device_sm_count(dev))
    plan = None if xk == "mma" else op._plan_tensors(dev, xk, d)
    unsplit = bk.bsmm_bprop if trans else bk.bsmm_fprop
    fns["grouped"] = lambda: unsplit(
        xn, w, lut[f"{d}_row_ptr"], lut[f"{d}_ent_in"], lut[f"{d}_ent_w"], b,
        n_out, plan=plan)
    return fns, packed


def mode_turns(label, op, kind, N, dev, g, card_line, rows, d="f"):
    """The mode's wgmma kernel at one shape (bf16): held against the plain
    version beside the mma.sync kernel and mode "grouped"'s unsplit
    kernel, two runs bit-equal (the window's also on weights packed once,
    bit-equal to the route, its packing bit for bit against the plain
    packing); then device time, 20 calls a CUDA graph, in turns: the wgmma
    route (the window's with its packing), the mma.sync kernel, grouped's
    kernel and a dense torch.matmul of the scattered layout; the window's
    kernel and packing alone in turns; the bound.  rows[("mode", kind,
    label, d)] keeps them."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    bf, b = torch.bfloat16, op.bsize
    n_in, n_out = (op.C, op.KB) if d == "f" else (op.K, op.CB)
    lut = op._lut(dev)
    xn = (torch.rand((N, n_in), device=dev, generator=g) * 2 - 1).to(bf)
    w = (torch.randn(op.w_shape, device=dev, generator=g) * 0.1).to(bf)
    fns, packed = mode_fns(op, kind, xn, w, d)

    def plain():
        return bk.xprop_plain(xn, w, lut[f"{d}_in"], lut[f"{d}_w"],
                              lut[f"{d}_out"], n_out, b, 1, trans_w=d == "b")
    ref = plain()
    what = f"{label} {d}prop {kind}"
    errs = {k: compare(f"{what} on {k} against plain", fns[k](), ref,
                       TOL[bf]) for k in ("wgmma", "mma", "grouped")}
    same_bits(f"{what} on wgmma", fns["wgmma"])
    alone, pack_mark, plain_pack_ms = {}, None, None
    if packed is not None:
        check(torch.equal(fns["kernel"](), fns["wgmma"]()),
              f"{what}: the wgmma kernel on weights packed once, bit for "
              f"bit the route")
        check(torch.equal(packed, fns["plain_pack"]().reshape(packed.shape)),
              f"{what}: the packing bit for bit its plain version "
              f"({packed.numel() * 2 / 1e6:.2f} MB)")
        alone = in_turns({"kernel": fns["kernel"], "pack": fns["pack"]},
                         lambda fn: graph_ms(fn, 20))
        pack_mark = bound(0, 2 * (op.blocks * b * b + packed.numel()))
        plain_pack_ms = time_ms(fns["plain_pack"], 5)
    wd = dense_weight(op, w)
    wd = wd if d == "f" else wd.t().contiguous()
    times = in_turns({"wgmma": fns["wgmma"], "mma": fns["mma"],
                      "grouped": fns["grouped"], "dense": lambda: xn @ wd},
                     lambda fn: graph_ms(fn, 20))
    flops = 2 * N * op.blocks * b * b
    mark = bound(flops, 2 * (N * n_in + op.blocks * b * b + N * n_out * b))
    plain_ms = time_ms(plain, 5)
    rows[("mode", kind, label, d)] = {
        "err": errs, "times": times, "alone": alone, "bound": mark,
        "plain_ms": plain_ms, "pack_bound": pack_mark,
        "plain_pack_ms": plain_pack_ms}
    fmt = lambda v: " / ".join(f"{t:.4f}" for t in v)   # noqa: E731
    grouped = "bsmm_xprop_" + op._xkernel(N, d, bk.device_sm_count(dev))
    print(f"{what}: device time, 20 calls a CUDA graph, in turns "
          f"[{card_line}]: wgmma{' (packing + kernel)' if alone else ''} "
          f"{fmt(times['wgmma'])} ms "
          f"({flops / min(times['wgmma']) / 1e9:.2f} TFLOP/s), mma.sync "
          f"{fmt(times['mma'])}, grouped ({grouped}.cu) "
          f"{fmt(times['grouped'])}, dense torch.matmul "
          f"{fmt(times['dense'])}"
          + (f"; the wgmma kernel alone {fmt(alone['kernel'])}, its packing "
             f"{fmt(alone['pack'])} (plain {plain_pack_ms:.4f}, bound "
             f"{pack_mark[0]:.4f})" if alone else "")
          + f"; bound {mark[0]:.4f} ms ({mark[1]}); plain {plain_ms:.4f}; "
          f"max err wgmma {errs['wgmma']:.3g}, mma.sync {errs['mma']:.3g}; "
          f"the rule: {op.kernel_of(N, d)}.cu", flush=True)
    del xn, w, fns, packed, ref, wd
    torch.cuda.empty_cache()


def mode_wgmma_phase(bt, dev, g, card_line, rows, canon=None, win=None):
    """The wgmma mode kernels in turns (``mode_turns``) at the main path's
    shapes: fine at the canonical hidden-7680 rows (b8, b16, b32; N 64,
    fprop and, at b8, bprop), window at the canonical b8 row (N 64) and
    at its regime (N 256 and 2048, fprop and bprop); then their
    registers, spills and shared memory."""
    t0 = time.perf_counter()
    canon = canon or canonical_rows(bt, dev)
    win = win or window_op(bt)[0]
    small = CANON_ROWS[0][0] * CANON_UNIT
    for b in CANON_ROWS[0][2]:
        op = canon[(small, b)][0]["fine"]
        for d in ("fb" if b == 8 else "f"):
            mode_turns(f"canonical hidden {small} b{b} N={CANON_N}", op,
                       "fine", CANON_N, dev, g, card_line, rows, d)
    mode_turns(f"canonical hidden {small} b8 N={CANON_N}",
               canon[(small, 8)][0]["window"], "window", CANON_N, dev, g,
               card_line, rows)
    for N in WIN_NS:
        for d in "fb":
            mode_turns(f"window regime N={N}", win["window"], "window", N,
                       dev, g, card_line, rows, d)
    print(f"mode wgmma phase: {time.perf_counter() - t0:.1f} s", flush=True)
    mode_ptxas_report()


def mode_ptxas_report():
    """Registers, spills and shared memory of the wgmma mode kernels, from
    ptxas' log and as the runtime reports them (no spill, resident), and
    that ptxas serializes none of their wgmma (C7520)."""
    from blocksparse_tpu_torch.kernels import _build
    from blocksparse_tpu_torch.kernels import bsmm as bk
    for source in ("bsmm_window_wgmma", "bsmm_fine_wgmma"):
        fine = source == "bsmm_fine_wgmma"
        # the window kernel's cell depths (16, 32, 64) and one direction
        # for both; the fine kernel's block sizes and directions
        sizes = bk.FINE_BLOCK_SIZES if fine else (16, 32, 64)
        for dtype in (torch.bfloat16, torch.float16):
            for b in sizes:
                for v in ((False, True) if fine else (False,)):
                    i = bk.mode_kernel_info(source, dtype, b, trans_w=v)
                    what = (f"{source}.cu {dtype} b{b}"
                            + ((" bprop" if v else " fprop") if fine else "")
                            + f": {i['registers']} registers, "
                            f"{i['local_bytes']} local bytes, "
                            f"{i['smem_bytes']} bytes of shared memory, "
                            f"{i['blocks_per_sm']} block(s) an SM, "
                            f"{i['stages']} ring slots")
                    check(i["local_bytes"] == 0 and i["blocks_per_sm"] >= 1,
                          f"{what}: no spill, resident")
        lib = _build.library_path(source)
        serial = [line for line in lib.with_name(lib.name + ".log")
                  .read_text().splitlines() if "C7520" in line]
        check(not serial, f"{source}.cu: ptxas serializes no wgmma "
                          f"({len(serial)} warnings)")
        entries = ptxas_entries(source)
        print(f"{source}.cu: {len(entries)} kernels (ptxas), "
              + ", ".join(f"{v[0]} registers spills {v[1]}/{v[2]}"
                          for v in entries.values()), flush=True)
        ptxas_warnings(source)


def kernel_device_ms(fn, key, n=20):
    """Mean device time a launch of the kernel whose name holds ``key``,
    over n calls of fn() under the profiler (the launches it recorded):
    the kernel's own time where the host's enqueue of a launch takes
    longer.  CUDA events' time of a call where no window recorded one."""
    _, kernels = device_events(lambda: [fn() for _ in range(n)],
                               lambda ks: any(key in e.key for e in ks))
    hits = [e for e in kernels if key in e.key]
    count = sum(e.count for e in hits)
    if not count:
        return events_instead(fn, n, key)
    if count != n:
        print(f"      profiler: {count} launches of {key} recorded for "
              f"{n} calls", flush=True)
    return sum(e.self_device_time_total for e in hits) / count / 1e3


def device_ms_per_call(fn, match, n=20):
    """Mean device time a call of fn() spends in the kernels whose names
    ``match`` accepts, over n calls under the profiler; CUDA events' time
    of a call where no window recorded one."""
    _, kernels = device_events(lambda: [fn() for _ in range(n)],
                               lambda ks: any(match(e.key) for e in ks))
    hits = [e for e in kernels if match(e.key)]
    if not hits:
        return events_instead(fn, n, "the call's kernels")
    return sum(e.self_device_time_total for e in hits) / n / 1e3


def in_turns(fns, times):
    """{name: [values]}: times(fn) for each fn in turns (a, b, b, a)."""
    names = list(fns)
    out = {k: [] for k in names}
    for k in names + names[::-1]:
        out[k].append(times(fns[k]))
    return out


def split_checks(model, dev, g, card_line, rows):
    """The fused split (bsmm_split: bsmm_xprop_mma.cu's OUT_SPLIT, the runs
    of a column a thread-block cluster) at the decode's shapes, the LM's
    two MLP products at N = PROMPTS, in bf16 and f16: two runs bit-equal,
    bit for bit against the parent's route (bsmm_partials, then
    bsmm_merge), within TOL of the plain split route.  In bf16 its device
    time a product (profiler) and by CUDA events against the parent
    route's, in turns, beside the plain version, the bound and a dense
    torch.matmul of the scattered layout."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    sms = bk.device_sm_count(dev)
    for name, op in (("bsmm1", model.bsmm1), ("bsmm2", model.bsmm2)):
        N, b = PROMPTS, op.bsize
        phases = op._phases(N, "f", sms)
        check(phases > 0, f"{name} at decode (N={N}) takes the split route "
                          f"({phases} runs) on {sms} SMs")
        p = op._plan_tensors(dev, "split", "f", phases)
        lut = op._lut(dev)
        ents = (lut["f_ent_in"], lut["f_ent_w"])
        P, n_tiles = p["merge_idx"].shape[1], p["tile_ptr"].numel() - 1
        for dtype in (torch.bfloat16, torch.float16):
            x = torch.randn((N, op.C), device=dev, generator=g).to(dtype)
            w = (torch.randn(op.w_shape, device=dev, generator=g)
                 * 0.02).to(dtype)

            def fused():
                return bk.bsmm_split(x, w, p["tile_ptr"], *ents,
                                     p["merge_idx"], b, op.KB)

            def parent():
                return bk.bsmm_merge(bk.bsmm_partials(
                    x, w, p["tile_ptr"], *ents, b, n_tiles),
                    p["merge_idx"], b, dtype)
            what = (f"bsmm_split {name} decode N={N} {op.C} -> {op.K} "
                    f"{op.blocks} blocks, clusters of P={P} {dtype}")
            same_bits(what, fused)
            check(torch.equal(fused(), parent()), f"{what}: equal bit for "
                  f"bit to bsmm_partials + bsmm_merge")
            err = compare(f"{what} against the plain split route", fused(),
                          op.xprop_split_plain(x, w, "f", sms), TOL[dtype])
            if dtype != torch.bfloat16:
                continue
            routes = {"fused": fused, "parent": parent}
            dev_ms = in_turns(routes, lambda fn: device_ms_per_call(
                fn, lambda k: "bsmm_xprop" in k or "bsmm_merge" in k))
            ev_ms = in_turns(routes, lambda fn: time_ms(fn, 200))
            plain_ms = time_ms(lambda: op.xprop_split_plain(x, w, "f", sms),
                               50)
            wd = dense_weight(op, w)
            lib = time_ms(lambda: x @ wd, 200)
            mark = bound(2 * N * op.blocks * b * b,
                         2 * (N * op.C + op.blocks * b * b + N * op.K))
            rows[("split", name)] = (err, float(np.mean(dev_ms["fused"])),
                                     plain_ms)
            rows[("split_mark", name)] = (*mark, lib)
            print(f"{name} split at decode [{card_line}]: fused device "
                  f"{' / '.join(f'{v:.4f}' for v in dev_ms['fused'])} ms a "
                  f"product (profiler, mean of 20), parent partials + merge "
                  f"{' / '.join(f'{v:.4f}' for v in dev_ms['parent'])}; by "
                  f"events fused {' / '.join(f'{v:.4f}' for v in ev_ms['fused'])}"
                  f", parent {' / '.join(f'{v:.4f}' for v in ev_ms['parent'])}"
                  f" (in turns); plain {plain_ms:.4f} ms; bound "
                  f"{mark[0]:.5f} ms ({mark[1]}); dense torch.matmul "
                  f"{lib:.4f} ms", flush=True)
            del wd
    torch.cuda.empty_cache()


def updat_reduce_checks(op, N, dev, g, rows, key="reduce"):
    """The updat split's second pass at ``op``'s split of N rows (the train
    step's bsmm1 by default): equal to its plain version bit for bit, and
    timed; rows[key], its library call's time and its partials' shape."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    runs = op.updat_splits(N)
    check(runs > 1, f"the updat at N={N} takes the split ({runs} runs)")
    parts = torch.randn((runs,) + op.w_shape, device=dev, generator=g)
    err = compare(f"bsmm_updat_reduce {runs} partials of {op.blocks} blocks "
                  f"(exact)", bk.bsmm_updat_reduce(parts),
                  bk.updat_reduce_plain(parts), 0.0)
    timed(rows, key, err, lambda: bk.bsmm_updat_reduce(parts),
          lambda: bk.updat_reduce_plain(parts), 50)
    rows[f"{key}_lib"] = time_ms(lambda: parts.sum(0), 50)
    rows[f"{key}_shape"] = tuple(parts.shape)
    del parts


def reduce_mark(rows, key):
    """The bound and library call of rows[key]'s updat reduce: the runs'
    f32 partials read once and dW written, (runs - 1) adds an element."""
    runs = rows[f"{key}_shape"][0]
    parts = int(np.prod(rows[f"{key}_shape"][1:]))
    return (*bound((runs - 1) * parts, 4 * (runs + 1) * parts,
                   PEAK_F32_FLOPS), rows[f"{key}_lib"])


def bound(flops, nbytes, peak_flops=PEAK_FLOPS):
    """(ms, "operations" or "bytes"): the least time this work could take
    on the card (bf16 operations unless another peak is given), and which
    limit sets it."""
    ops_ms = flops / peak_flops * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def dense_weight(op, w):
    """A (blocks, b, b) block-sparse weight scattered into the dense (C, K)
    matrix of the same product (feature_axis 1: y = x . W)."""
    b = op.bsize
    cs, ks = (torch.as_tensor(op.updat_lut[:, i], device=w.device)
              for i in (0, 1))
    wd = torch.zeros((op.CB, op.KB, b, b), dtype=w.dtype, device=w.device)
    wd[cs, ks] = w
    return wd.permute(0, 2, 1, 3).reshape(op.C, op.K)


def dense_attention_mask(bst, dev):
    """The layout and its sub-block masks expanded to one (ctx, ctx) boolean
    mask of the elements a query may see (head 0: the layout is shared)."""
    bs = bst.blk_size
    mask = np.zeros((bst.ctx_blks_q * bs, bst.ctx_blks_k * bs), bool)
    for i, (q, k) in enumerate(bst.nt_list[0]):
        mask[q * bs:(q + 1) * bs, k * bs:(k + 1) * bs] = bst._mask_blocks[0, i]
    return torch.as_tensor(mask, device=dev)


def yardsticks(model, dev, g, rows):
    """Bound and library-call time of each serving and training kernel at
    the shapes of its row in the kernels line (bf16; bsmm1 at N = 8 x
    2048; attention at batch 8 x 2048).  Library calls: a dense
    ``torch.matmul`` with the layout scattered into W for fprop and bprop;
    for updat the dense cuBLAS product xᵀ·dy (the gather of the layout's
    blocks out of it timed beside); ``scaled_dot_product_attention`` with
    the layout expanded to an element mask for the attention forward, and
    its backward (``torch.autograd.grad`` of that forward: dq, dk and dv in
    one call) for dq and dk/dv; ``sum`` over the runs for the updat
    split's reduce."""
    bf, c, op, bst = torch.bfloat16, model.config, model.bsmm1, model.bst
    N, b2 = BATCH * c.ctx, op.bsize ** 2
    x = torch.randn((N, op.C), device=dev, generator=g).to(bf)
    dy = torch.randn((N, op.K), device=dev, generator=g).to(bf)
    wd = dense_weight(op, (torch.randn(op.w_shape, device=dev, generator=g)
                           * 0.02).to(bf))
    lib_f = time_ms(lambda: x @ wd, 20)
    lib_b = time_ms(lambda: dy @ wd.t(), 20)
    lib_u = time_ms(lambda: x.t() @ dy, 20)
    dense = x.t() @ dy
    cs, ks = (torch.as_tensor(op.updat_lut[:, i], device=dev) for i in (0, 1))
    gather_ms = time_ms(lambda: dense.view(op.CB, op.bsize, op.KB, op.bsize)
                        .permute(0, 2, 1, 3)[cs, ks], 20)
    print(f"bsmm_updat library: cuBLAS x^T . dy {lib_u:.4f} ms "
          f"({2 * N * op.C * op.K / lib_u / 1e9:.2f} TFLOP/s dense), the "
          f"layout's {op.blocks} blocks gathered out of it {gather_ms:.4f} ms",
          flush=True)
    del x, dy, wd, dense
    flops = 2 * N * op.blocks * b2
    xprop_bytes = 2 * (N * op.C + op.blocks * b2 + N * op.K)
    out = {"bsmm_fprop": (*bound(flops, xprop_bytes), lib_f),
           "bsmm_bprop": (*bound(flops, xprop_bytes), lib_b),
           "bsmm_updat": (*bound(flops, 2 * N * (op.C + op.K)
                                 + 4 * op.blocks * b2), lib_u),
           "bsmm_updat_reduce": reduce_mark(rows, "reduce")}

    B, T, H, hs, bs = BATCH, c.ctx, c.n_head, model.hs, bst.blk_size
    mask = dense_attention_mask(bst, dev)
    check(bool(mask.any(dim=1).all()),
          "attention mask: every query row sees a key (no fully masked "
          "row to exclude from the library call)")
    q, k, v = (torch.randn((B, H, T, hs), device=dev, generator=g).to(bf)
               for _ in range(3))
    lib_attn = time_ms(lambda: nnf.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=1.0 / np.sqrt(hs)), 20)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = nnf.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                         scale=1.0 / np.sqrt(hs))
    do = torch.randn(o.shape, device=dev, generator=g).to(bf)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o, (q, k, v), do,
                                                  retain_graph=True), 20)
    print(f"scaled_dot_product_attention forward {lib_attn:.4f} ms, its "
          f"backward (dq, dk, dv) {lib_bwd:.4f} ms", flush=True)
    del q, k, v, mask, o, do
    e = bst.blocks * B * H * bs * bs * hs      # one product over the blocks
    one, lse = B * T * H * hs * 2, B * H * T * 4   # a (B, T, H*hs) bf16; lse
    out.update({
        "bst_attn_fwd": (*bound(4 * e, 4 * one), lib_attn),
        "bst_attn_fwd_lse": (*bound(4 * e, 4 * one + lse), lib_attn),
        # q, k, v, dO, lse, D in; dq (bf16) out
        "bst_attn_dq": (*bound(6 * e, 5 * one + 2 * lse), lib_bwd),
        # q, k, v, dO, lse, D in; dk, dv (f32) out
        "bst_attn_dkv": (*bound(8 * e, 4 * one + 2 * lse + 4 * one),
                         lib_bwd)})
    for name, (ms, by, lib) in out.items():
        print(f"{name}: bound {ms:.4f} ms ({by}); library call "
              f"{lib:.4f} ms", flush=True)
    torch.cuda.empty_cache()
    return out


def make_bck(nb_c, nb_k, bC, bK, density, rng):
    """Random block-sparse channel connectivity, diagonal guaranteed (the
    conv benchmark's draw, benchmarks/conv_bench.py:51-59)."""
    BCK = []
    for kb in range(nb_k):
        for cb in range(nb_c):
            if cb == kb % nb_c or rng.rand() < density:
                BCK.append((tuple(range(cb * bC, (cb + 1) * bC)),
                            tuple(range(kb * bK, (kb + 1) * bK))))
    return BCK


def conv_configs():
    """The benchmark's (C, density, BCK) in its order, all drawn from one
    RandomState(0) as it draws them."""
    rng = np.random.RandomState(0)
    b = CONV_BLOCK
    return [(ck, d, make_bck(ck // b, ck // b, b, b, d, rng))
            for ck in CONV_CHANNELS for d in CONV_DENSITIES]


def conv_kernel_checks(dev, g, rows):
    """im2col and col2im against their plain versions at the C=512 conv's
    shapes (N 32, 32x32, b32, 3x3 SAME): im2col from the NCHW image, as
    the conv calls it (``im2col_image``), bit for bit (a copy); col2im
    into the channel-major (C, N*H*W) exactly in f32 and within one output
    rounding in bf16 and f16, and into the NCHW image (``col2im_image``,
    as the conv's backward calls it) bit for bit; F.unfold / F.fold (the
    same taps in another row order) timed beside.  Then both in bf16 at
    C = 1024 and 2048, held and timed the same way, each beside its bound
    and F.unfold / F.fold; C=512's against its target, im2col's also
    beside the previous kernel's time."""
    from blocksparse_tpu_torch.kernels import im2col as ic
    C, N, H, W, b = CONV_CHANNELS[0], CONV_BATCH, CONV_HW, CONV_HW, CONV_BLOCK
    NP, args, taps = N * H * W, (H, W, 3, 3, 1, 1, b), (3, 3, 1, 1, b)
    what = f"C={C} N={N} {H}x{W} 3x3 b{b}"
    for dtype in DTYPES:
        x = torch.randn((N, C, H, W), device=dev, generator=g).to(dtype)
        xc = x.transpose(0, 1).reshape(C, NP)
        X, ref = ic.im2col_image(x, *taps), ic.im2col_plain(xc, *args)
        err = compare(f"im2col {what} {dtype} (from the NCHW image)", X, ref,
                      0.0)
        check(torch.equal(X, ref), f"im2col {what} {dtype}: equal to "
                                   f"im2col_plain bit for bit")
        del X, ref
        timed(rows, ("im2col", dtype), err, lambda: ic.im2col_image(x, *taps),
              lambda: ic.im2col_plain(xc, *args), 20)
        # dX as bsmm_bprop gives it: the (C*9, N*H*W) view of an NC array
        dX = torch.randn((NP, C * 9), device=dev, generator=g).to(dtype).t()
        tol = 0.0 if dtype == torch.float32 else torch.finfo(dtype).eps
        ref = ic.col2im_plain(dX, *args)
        err = compare(f"col2im {what} {dtype} (one rounding: eps "
                      f"{tol:g})", ic.col2im(dX, *args), ref, tol)
        check(torch.equal(ic.col2im_image(dX, N, *args),
                          ref.reshape(C, N, H, W).transpose(0, 1)),
              f"col2im {what} {dtype} into the NCHW image: equal to "
              f"col2im_plain bit for bit")
        del ref
        timed(rows, ("col2im", dtype), err, lambda: ic.col2im(dX, *args),
              lambda: ic.col2im_plain(dX, *args), 20)
        if dtype == torch.bfloat16:
            cols = dX.reshape(C * 9, N, H * W).transpose(0, 1).contiguous()
            rows["unfold"] = time_ms(lambda: nnf.unfold(x, 3, padding=1), 20)
            rows[("cm_copy", C)] = time_ms(
                lambda: x.transpose(0, 1).reshape(C, NP), 20)
            rows["fold"] = time_ms(
                lambda: nnf.fold(cols, (H, W), 3, padding=1), 20)
            print(f"      F.unfold {rows['unfold']:.4f} ms, F.fold "
                  f"{rows['fold']:.4f} ms (another row order)", flush=True)
            del cols
        del x, xc, dX
    torch.cuda.empty_cache()
    bf = torch.bfloat16
    rows[("im2col_c", C)] = (rows[("im2col", bf)][1], rows["unfold"])
    rows[("col2im_c", C)] = (rows[("col2im", bf)][1], rows["fold"])
    for c in CONV_CHANNELS[1:]:
        what = f"C={c} N={N} {H}x{W} 3x3 b{b} {bf}"
        x = torch.randn((N, c, H, W), device=dev, generator=g).to(bf)
        xc = x.transpose(0, 1).reshape(c, NP)
        check(torch.equal(ic.im2col_image(x, *taps),
                          ic.im2col_plain(xc, *args)),
              f"im2col {what} (from the NCHW image): equal to im2col_plain "
              f"bit for bit")
        rows[("im2col_c", c)] = (
            time_ms(lambda: ic.im2col_image(x, *taps), 20),
            time_ms(lambda: nnf.unfold(x, 3, padding=1), 20))
        rows[("cm_copy", c)] = time_ms(
            lambda: x.transpose(0, 1).reshape(c, NP), 20)
        del x, xc
        torch.cuda.empty_cache()
        dX = torch.randn((NP, c * 9), device=dev, generator=g).to(bf).t()
        compare(f"col2im {what} (one rounding: eps {torch.finfo(bf).eps:g})",
                ic.col2im(dX, *args), ic.col2im_plain(dX, *args),
                torch.finfo(bf).eps)
        ms = time_ms(lambda: ic.col2im(dX, *args), 20)
        cols = dX.reshape(c * 9, N, H * W).transpose(0, 1).contiguous()
        fold = time_ms(lambda: nnf.fold(cols, (H, W), 3, padding=1), 20)
        rows[("col2im_c", c)] = (ms, fold)
        del dX, cols
        torch.cuda.empty_cache()
    for name, src, key, lib, target in (
            ("im2col", "im2col.cu", "im2col_c", "F.unfold", IM2COL_TARGET),
            ("col2im", "col2im_tma.cu", "col2im_c", "F.fold", COL2IM_TARGET)):
        for c in CONV_CHANNELS:
            ms, lib_ms = rows[(key, c)]
            mark = bound(0, (1 + 9) * c * NP * 2)
            prev = ""
            if name == "im2col":
                prev = "; the previous kernel " + (
                    " / ".join(f"{t:.4f}" for t in IM2COL_PREV_MS[c])
                    + f" ms ({IM2COL_PREV_CARD})" if c in IM2COL_PREV_MS
                    else "not measured") + (
                    f", after the channel-major copy of the image it "
                    f"read, which the conv no longer makes: "
                    f"{rows[('cm_copy', c)]:.4f} ms")
            print(f"{name} ({src}) C={c} N={N} {H}x{W} 3x3 b{b} bf16 "
                  f"[{card()}]: {ms:.4f} ms (CUDA events, mean of 20), bound "
                  f"{mark[0]:.4f} ms ({mark[1]}, {mark[0] / ms:.0%} of it), "
                  f"{lib} {lib_ms:.4f} ms{prev}" + (
                      f"; target <= {target} ms: "
                      f"{'met' if ms <= target else 'missed'}"
                      if c == C else ""), flush=True)


def image_copies(conv, F, x):
    """The copies (``aten::copy_``) of at least as many elements as the
    image x in the conv's forward (no gradient) and in its backward from a
    gradient laid out as the forward's output: [(phase, input shapes)],
    from torch.profiler's op records."""
    from torch.profiler import ProfilerActivity, profile
    n = x.numel()

    def copies(fn, phase):
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            fn()
            torch.cuda.synchronize()
        return [(phase, e.input_shapes) for e in prof.events()
                if e.name == "aten::copy_" and any(
                    int(np.prod(sh)) >= n for sh in e.input_shapes if sh)]
    with torch.no_grad():
        found = copies(lambda: conv(F, x), "forward")
    Fr, xr = F.detach().requires_grad_(), x.detach().requires_grad_()
    y = conv(Fr, xr)
    dy = torch.randn_like(y)
    found += copies(lambda: torch.autograd.grad(y, (xr, Fr), dy),
                    "backward")
    return found


def conv_inputs(bt, conv, dev, g):
    """The bench's operands in bf16: the filter uniform in [-0.1, 0.1) from
    the seed (drawn with NumPy, as the CPU tests draw it), the images
    uniform in [-1, 1) on the card."""
    F = bt.conv_filter_from_jax(bt.random_jax_conv_filter(conv, seed=SEED),
                                conv, dev).to(torch.bfloat16)
    x = torch.rand((CONV_BATCH, conv.C, CONV_HW, CONV_HW), device=dev,
                   generator=g)
    return F, (x * 2 - 1).to(torch.bfloat16)


def conv_fwd_bwd(conv, F, x):
    """y, and dI and dF of the bench's loss sum(square(y)) in f32."""
    Fr = F.detach().requires_grad_()
    xr = x.detach().requires_grad_()
    y = conv(Fr, xr)
    dI, dF = torch.autograd.grad(y.float().square().sum(), (xr, Fr))
    return y.detach(), dI, dF


def dense_filter(conv, F):
    """The block filter scattered into the dense (K, C, 3, 3) weight of the
    same conv: the bench's dense control, holding this conv's blocks."""
    b = CONV_BLOCK
    cb = torch.as_tensor(conv._lutC[:, 0] // b, device=F.device)
    kb = torch.as_tensor(conv._lutK[:, 0] // b, device=F.device)
    wd = torch.zeros((conv.K // b, conv.C // b, b, b, 3, 3), dtype=F.dtype,
                     device=F.device)
    wd[kb, cb] = F.reshape(conv.blocks, b, b, 3, 3)
    return wd.permute(0, 2, 1, 3, 4, 5).reshape(conv.K, conv.C, 3, 3)


def unsplit_xprop(trans):
    """A profiler name's test for the unsplit bf16/f16 xprop of one
    direction: bsmm_xprop_mma_kernel<T, B, TRANS, OUT = 0, ...>,
    bsmm_xprop_wgmma_kernel<T, B, TRANS> or bsmm_xprop_sparse_kernel<T, B,
    TRANS> and its weights' packing (one a launch, no direction in its
    name: the packings of both directions go to the fprop's part)."""
    flag = "true" if trans else "false"
    return lambda k: (f"bsmm_xprop_mma_kernel" in k and f", {flag}, 0, " in k) \
        or (("bsmm_xprop_wgmma_kernel" in k or "bsmm_xprop_sparse_kernel"
             in k) and f", {flag}>" in k) \
        or (not trans and "bsmm_xprop_sparse_pack" in k)


# a profiler name's source (csrc/<name>.cu) among the conv's matmul kernels
CONV_SOURCE = re.compile(r"bsmm_(?:xprop|updat)_(?:mma|wgmma|sparse)")


CONV_PARTS = (("im2col", lambda k: "im2col_kernel" in k),
              ("bsmm fprop", unsplit_xprop(False)),
              ("bsmm bprop", unsplit_xprop(True)),
              ("bsmm updat", lambda k: "bsmm_updat_mma_kernel" in k
               or "bsmm_updat_wgmma_kernel" in k
               or "bsmm_updat_sparse_kernel" in k),
              ("updat reduce", lambda k: "bsmm_updat_reduce_kernel" in k),
              ("col2im", lambda k: "col2im_tma_kernel" in k))


def profile_conv(fn, ms, label):
    """One conv forward + backward under torch.profiler: device time by
    port kernel (fprop and bprop told apart by the kernel's template
    flag), then the largest other kernels (copies, casts, the loss).
    CUPTI now and then drops a kernel's record: a window that lacks one of
    the kernels every forward + backward launches is profiled again, and
    a part still without a record is printed as not measured."""
    def missing(kernels):
        return [name for name, match in CONV_PARTS
                if name != "updat reduce" and not any(
                    match(e.key) for e in kernels)]
    _, kernels = device_events(fn, lambda ks: not missing(ks))
    rest, parts = list(kernels), []
    for name, match in CONV_PARTS:
        hits = [e for e in rest if match(e.key)]
        rest = [e for e in rest if e not in hits]
        n = sum(e.count for e in hits)
        srcs = sorted({m.group(0) for e in hits
                       for m in [CONV_SOURCE.search(e.key)] if m})
        parts.append(f"{name}{' (' + ', '.join(srcs) + ')' if srcs else ''} "
                     f"{sum(e.self_device_time_total for e in hits) / 1e3:.3f} ms "
                     f"({n})" if n or name == "updat reduce" else
                     f"{name} not measured (no record in {PROFILE_TRIES} "
                     f"windows)")
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    rest.sort(key=lambda e: -e.self_device_time_total)
    parts += [f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms "
              f"({e.count})" for e in rest[:5]]
    print(f"{label} profile: {total:.3f} ms of device time, "
          f"{total / ms:.0%} of the unprofiled {ms:.3f} ms: "
          + "; ".join(parts), flush=True)


def conv_path(bt, dev, g, card_line, rows):
    """The block-sparse conv at the bench's configurations.  C=512 d=0.25:
    kernels against plain path (forward, dI, dF), the forward + backward
    counted.  Every configuration: the forward against the dense conv of
    the scattered filter, a counted forward, and the times.  Each counted
    run's xprop launches on bsmm_xprop_sparse.cu are those kernel_of
    names; so are each configuration's updat launches on
    bsmm_updat_sparse.cu, in one more counted forward + backward.  Returns
    the counted forward + backward's launches, and the sparse kernels'
    (the xprop's with its packings; "bsmm_updat": the updat's) over all
    the counted runs."""
    bf = torch.bfloat16
    configs = conv_configs()
    launches = None
    sparse_total = dict.fromkeys((*SPARSE_WRAPPERS, "pack", "bsmm_updat"), 0)
    N = CONV_BATCH * CONV_HW ** 2

    def sparse_as_named(conv, what, dirs):
        """The counted run's sparse launches against kernel_of's names."""
        got = read_sparse()
        want = {k: int(k in dirs and conv._bsmm_op.kernel_of(N, d)
                       == "bsmm_xprop_sparse")
                for k, d in zip(SPARSE_WRAPPERS, "fb")}
        want["pack"] = sum(want.values())
        check(got == want, f"{what}: launches on bsmm_xprop_sparse.cu "
                           f"{got}, as kernel_of names them {want}")
        for k in got:
            sparse_total[k] += got[k]
    for i, (ck, d, BCK) in enumerate(configs):
        torch.cuda.reset_peak_memory_stats()
        conv = bt.BlocksparseConv(BCK, (3, 3), (CONV_HW, CONV_HW),
                                  padding="SAME", impl="bsmm")
        F, x = conv_inputs(bt, conv, dev, g)
        what = (f"conv C=K={ck} d={d} ({conv.blocks} blocks of "
                f"{(ck // CONV_BLOCK) ** 2}, {conv._bsmm_op.blocks} tiled) "
                f"N={CONV_BATCH} {CONV_HW}x{CONV_HW} bf16")
        conv_fwd_bwd(conv, F, x)                 # warm-up: LUT upload
        torch.cuda.synchronize()
        if i == 0:
            reset_counts()
            y, dI, dF = conv_fwd_bwd(conv, F, x)
            torch.cuda.synchronize()
            launches = read_counts()
            want = dict.fromkeys(launches, 0)
            want.update({"im2col": 1, "bsmm_fprop": 1, "bsmm_bprop": 1,
                         "bsmm_updat": 1, "col2im": 1,
                         "bsmm_updat_reduce": int(conv._bsmm_op.updat_splits(
                             N) > 1)})
            check(launches == want, f"{what}: forward + backward launches "
                                    f"{launches}, expected {want}")
            sparse_as_named(conv, what, SPARSE_WRAPPERS)
            plain = bt.BlocksparseConv(BCK, (3, 3), (CONV_HW, CONV_HW),
                                       padding="SAME", impl="bsmm",
                                       bsmm_impl="xla")
            for name, got, ref in zip(("y", "dI", "dF"), (y, dI, dF),
                                      conv_fwd_bwd(plain, F, x)):
                check(got.dtype == ref.dtype == bf, f"{name} is bf16")
                compare(f"{what}: {name} against the plain path", got, ref,
                        TOL[bf])
            del y, dI, dF
            conv_bsmm_checks(conv, plain, x, dev, g, rows)
            found = image_copies(conv, F, x)
            check(not found, f"{what}: the kernel path copies nothing of the "
                             f"image's size (no channel-major copy before "
                             f"im2col, none of dI after col2im): {found}")
            control = [p for p, _ in image_copies(plain, F, x)]
            print(f"      image-sized copies: kernel path none; the plain "
                  f"path (channel-major, for comparison) {len(control)} "
                  f"({', '.join(control)})", flush=True)
            plain_ms = time_ms(lambda: conv_fwd_bwd(plain, F, x), 3)
            print(f"      plain path forward + backward {plain_ms:.3f} ms",
                  flush=True)
            del plain
            torch.cuda.empty_cache()
        with torch.no_grad():
            reset_counts()
            y = conv(F, x)
            torch.cuda.synchronize()
            fwd_launches = read_counts()
            want = dict.fromkeys(fwd_launches, 0)
            want.update({"im2col": 1, "bsmm_fprop": 1})
            check(fwd_launches == want, f"{what}: forward (no grad) "
                                        f"launches im2col 1, bsmm_fprop 1")
            sparse_as_named(conv, f"{what}: forward (no grad)",
                            ("bsmm_fprop",))
            wd = dense_filter(conv, F)
            ref = nnf.conv2d(x, wd, padding=1)
            check(tuple(y.shape) == (CONV_BATCH, ck, 1, CONV_HW, CONV_HW),
                  f"{what}: output {tuple(y.shape)}")
            compare(f"{what}: forward against the dense conv of the "
                    f"scattered filter", y.reshape(ref.shape), ref, DENSE_TOL)
            del y, ref
            fwd_ms = time_ms(lambda: conv(F, x), CONV_TIMED)
            dense_ms = time_ms(lambda: nnf.conv2d(x, wd, padding=1),
                               CONV_TIMED)
        fb_ms = time_ms(lambda: conv_fwd_bwd(conv, F, x), CONV_TIMED)

        def dense_fb():
            xr, wr = x.detach().requires_grad_(), wd.detach().requires_grad_()
            y = nnf.conv2d(xr, wr, padding=1)
            return torch.autograd.grad(y.float().square().sum(), (xr, wr))
        dense_fb_ms = time_ms(dense_fb, CONV_TIMED)
        # the updat's launches on bsmm_updat_sparse.cu, as kernel_of names
        # them
        reset_counts()
        conv_fwd_bwd(conv, F, x)
        torch.cuda.synchronize()
        got = counters()["bsmm_updat"].launches_sparse
        src = conv._bsmm_op.kernel_of(N, "u")
        check(got == int(src == "bsmm_updat_sparse"),
              f"{what}: the backward's updat launches on "
              f"bsmm_updat_sparse.cu {got}, as kernel_of names it ({src})")
        sparse_total["bsmm_updat"] += got
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"{what} [{card_line}]: forward {fwd_ms:.3f} ms, forward + "
              f"backward {fb_ms:.3f} ms; dense cuDNN conv forward "
              f"{dense_ms:.3f} ms, forward + backward {dense_fb_ms:.3f} ms "
              f"(mean of {CONV_TIMED}, CUDA events); {conv.flops * CONV_BATCH / fwd_ms / 1e9:.2f} "
              f"TFLOP/s forward; peak device memory {peak:.2f} GiB",
              flush=True)
        if d == CONV_DENSITIES[0] and ck in (CONV_CHANNELS[0],
                                            CONV_CHANNELS[-1]):
            profile_conv(lambda: conv_fwd_bwd(conv, F, x), fb_ms,
                         f"conv C={ck} d={d} forward + backward")
        del conv, F, x, wd
        torch.cuda.empty_cache()
    return launches, sparse_total


def conv_bsmm_checks(conv, plain, x, dev, g, rows):
    """The conv's three bsmm directions against their plain versions at the
    C=512 conv's shapes (X of C*9 rows by N*1024 pixels, feature_axis 0),
    and the time a copy of X into the kernels' NC orientation would take."""
    from blocksparse_tpu_torch.kernels import im2col as ic
    bf = torch.bfloat16
    op, ref = conv._bsmm_op, plain._bsmm_op
    X = ic.im2col_image(x, 3, 3, 1, 1, CONV_BLOCK)
    w = (torch.randn(op.w_shape, device=dev, generator=g) * 0.1).to(bf)
    dy = torch.randn((op.K, X.shape[1]), device=dev, generator=g).to(bf)
    what = f"C*9={op.C} -> K={op.K}, N={X.shape[1]}, {op.blocks} blocks bf16"
    for d, a in (("f", X), ("b", dy)):
        name = {"f": "bsmm_fprop", "b": "bsmm_bprop"}[d]
        err = compare(f"{name} at the conv's shapes {what}",
                      op._xprop(a, w, d), ref._xprop(a, w, d), TOL[bf])
        timed(rows, ("conv", name), err, lambda: op._xprop(a, w, d),
              lambda: ref._xprop(a, w, d), 10,
              flops=xprop_flops(op, X.shape[1]))
    err = compare(f"bsmm_updat at the conv's shapes {what}",
                  op._updat(X, dy), ref._updat(X, dy), UPDAT_TOL)
    timed(rows, ("conv", "bsmm_updat"), err, lambda: op._updat(X, dy),
          lambda: ref._updat(X, dy), 10)
    # what the NC orientation saves: the copy a channel-major X would need
    Xc = ic.im2col_plain(x.transpose(0, 1).reshape(conv.C, -1), CONV_HW,
                         CONV_HW, 3, 3, 1, 1, CONV_BLOCK)
    check(X.t().is_contiguous() and Xc.is_contiguous(),
          "im2col writes X in the NC orientation (the plain version "
          "channel-major)")
    copy_ms = time_ms(lambda: Xc.t().contiguous(), 10)
    print(f"      a channel-major X's copy into the NC orientation (which "
          f"the kernel path does not make) {copy_ms:.4f} ms", flush=True)
    del X, Xc, w, dy
    torch.cuda.empty_cache()


def counters():
    from blocksparse_tpu_torch.kernels import bsmm, bst_attn, bst_trio, im2col
    return {"bsmm_fprop": bsmm.bsmm_fprop, "bsmm_bprop": bsmm.bsmm_bprop,
            "bsmm_updat": bsmm.bsmm_updat,
            "bsmm_updat_reduce": bsmm.bsmm_updat_reduce,
            "bsmm_fine": bsmm.bsmm_fine,
            "bsmm_window": bsmm.bsmm_window, "bsmm_merge": bsmm.bsmm_merge,
            "bsmm_split": bsmm.bsmm_split,
            "bst_attn_fwd": bst_attn.attention_fwd,
            "bst_attn_fwd_lse": bst_attn.attention_fwd_lse,
            "bst_attn_dq": bst_attn.attention_dq,
            "bst_attn_dkv": bst_attn.attention_dkv,
            "im2col": im2col.im2col, "col2im": im2col.col2im,
            "bst_nt": bst_trio.bst_nt, "bst_xn": bst_trio.bst_xn}


def reset_counts():
    from blocksparse_tpu_torch.kernels import bsmm
    for fn in counters().values():
        fn.launches = 0
    counters()["bst_xn"].launches_tn = 0
    for name in WGMMA_WRAPPERS + ATTN_WGMMA_WRAPPERS:
        counters()[name].launches_wgmma = 0
    for name in (*SPARSE_WRAPPERS, "bsmm_updat"):
        counters()[name].launches_sparse = 0
    bsmm.xprop_sparse_pack.launches = 0
    for fn in (bsmm.bsmm_fine, bsmm.bsmm_window):
        fn.launches_wgmma = 0
    bsmm.window_wgmma_pack.launches = 0


# the wrappers whose bf16/f16 launches go to bsmm_xprop_wgmma.cu or
# bsmm_updat_wgmma.cu, each counting those in launches_wgmma too
WGMMA_WRAPPERS = ("bsmm_fprop", "bsmm_bprop", "bsmm_updat")
# the wrappers whose bf16 launches go to bsmm_xprop_sparse.cu, each
# counting those in launches_sparse too (and each launch one of the
# weights' packing, xprop_sparse_pack)
SPARSE_WRAPPERS = ("bsmm_fprop", "bsmm_bprop")


# the attention wrappers whose bf16/f16 launches go to bst_attn_fwd_wgmma.cu,
# bst_attn_dq_wgmma.cu or bst_attn_dkv_wgmma.cu, each counting those in
# launches_wgmma too
ATTN_WGMMA_WRAPPERS = ("bst_attn_fwd", "bst_attn_fwd_lse", "bst_attn_dq",
                       "bst_attn_dkv")


def read_wgmma():
    """Of each wrapper's launches, those of the wgmma kernels (the sparse
    xprop's among them)."""
    return {name: counters()[name].launches_wgmma
            + getattr(counters()[name], "launches_sparse", 0)
            for name in WGMMA_WRAPPERS}


def read_sparse():
    """Of each xprop wrapper's launches, those of bsmm_xprop_sparse.cu, and
    "pack": the launches of its weights' packing."""
    from blocksparse_tpu_torch.kernels import bsmm
    return {**{name: counters()[name].launches_sparse
               for name in SPARSE_WRAPPERS},
            "pack": bsmm.xprop_sparse_pack.launches}


def on_wgmma(src):
    """Whether a source (kernel_of's name) is one of the wgmma kernels."""
    return src.endswith(("_wgmma", "_sparse"))


def read_attn_wgmma():
    """Of each attention wrapper's launches, those of the wgmma kernels."""
    return {name: counters()[name].launches_wgmma
            for name in ATTN_WGMMA_WRAPPERS}


def read_counts():
    """Each wrapper's launches, and "bst_xn_tn": the TN direction's share
    of bst_xn's."""
    out = {name: fn.launches for name, fn in counters().items()}
    out["bst_xn_tn"] = counters()["bst_xn"].launches_tn
    return out


def serving_path(bt, model, plain, cfg, dev, card_line):
    """Forward and generate_cached, counted; returns the launch counts."""
    L = cfg.n_layer
    rng = np.random.RandomState(SEED)
    tokens = torch.from_numpy(
        rng.randint(0, cfg.n_vocab, (BATCH, cfg.ctx))).to(dev)
    prompts = torch.from_numpy(
        rng.randint(0, cfg.n_vocab, (PROMPTS, PROMPT_LEN))).to(dev)
    # warm-up of the path outside the counted run (cuBLAS handles, LUTs)
    model(tokens[:1])
    bt.generate_cached(model, prompts[:, :64], 2)
    torch.cuda.synchronize()

    reset_counts()
    t = time.perf_counter()
    logits = model(tokens)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t = time.perf_counter()
    out = bt.generate_cached(model, prompts, NEW_TOKENS, generator=gen)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = read_counts()
    attn_wg = read_attn_wgmma()
    check(attn_wg["bst_attn_fwd"] == launches["bst_attn_fwd"] > 0,
          f"serving path: every attention forward on bst_attn_fwd_wgmma.cu "
          f"({attn_wg['bst_attn_fwd']} of {launches['bst_attn_fwd']})")

    print(f"forward batch {BATCH} x {cfg.ctx}, counted run: "
          f"{fwd_s * 1e3:.2f} ms", flush=True)
    # forward + prefill: 2 bsmm and 1 attention a layer each; every decode
    # step: 2 bsmm a layer (decode attention is plain torch by design),
    # each MLP product on the split route at batch PROMPTS one fused
    # bsmm_split launch (no partials, no merge); no training kernel
    def n_split(N):
        return [op.dispatch_mode(N) for op in (model.bsmm1, model.bsmm2)
                ].count("phased")
    routes = [op.dispatch_mode(PROMPTS) for op in (model.bsmm1, model.bsmm2)]
    print(f"decode MLP routes at N = {PROMPTS}: bsmm1 {routes[0]}, bsmm2 "
          f"{routes[1]}", flush=True)
    want = dict.fromkeys(launches, 0)
    splits = L * (n_split(BATCH * cfg.ctx) + n_split(PROMPTS * cfg.ctx)
                  + NEW_TOKENS * n_split(PROMPTS))
    want.update({"bsmm_fprop": 2 * L + 2 * L + NEW_TOKENS * 2 * L - splits,
                 "bsmm_split": splits, "bst_attn_fwd": L + L})
    check(launches == want and launches["bsmm_split"] > 0
          and launches["bsmm_merge"] == 0,
          f"serving launches {launches}, expected {want} (bsmm_fprop + "
          f"bsmm_split 2L + 2L + {NEW_TOKENS} x 2L, bsmm_split > 0: one a "
          f"product on the split route, bsmm_merge 0 in bf16, "
          f"bst_attn_fwd 2L, L = {L})")
    check(tuple(logits.shape) == (BATCH, cfg.ctx, cfg.n_vocab)
          and bool(torch.isfinite(logits).all()),
          f"forward logits {tuple(logits.shape)} finite")
    ref_logits = plain(tokens)
    err = (logits - ref_logits).abs().max().item()
    scale = max(1.0, ref_logits.abs().max().item())
    check(err <= MODEL_TOL * scale,
          f"forward logits against the plain-version model: max_abs_diff "
          f"{err:.3e} (max|plain| {scale:.3e}, tol {MODEL_TOL:g} x "
          f"max(1, max|plain|))")
    check(tuple(out.shape) == (PROMPTS, PROMPT_LEN + NEW_TOKENS)
          and torch.equal(out[:, :PROMPT_LEN], prompts)
          and bool(((out >= 0) & (out < cfg.n_vocab)).all()),
          f"generate_cached tokens {tuple(out.shape)} in range")

    # timings outside the counted run
    fwd_ms = time_ms(lambda: model(tokens), 3)
    print(f"forward batch {BATCH} x {cfg.ctx}: {fwd_ms:.2f} ms (mean of 3, "
          f"CUDA events) [{card_line}]", flush=True)
    full = torch.zeros((PROMPTS, cfg.ctx), dtype=torch.int64, device=dev)
    full[:, :PROMPT_LEN] = prompts
    t = time.perf_counter()
    _, caches = model.prefill(full)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    decode_s = gen_s - prefill_s
    print(f"serving [{card_line}]: generate_cached {PROMPTS} x "
          f"({PROMPT_LEN} + {NEW_TOKENS}) in {gen_s:.3f} s = "
          f"{PROMPTS * NEW_TOKENS / gen_s:.1f} tokens/s end to end; "
          f"prefill {PROMPTS} x {cfg.ctx} {prefill_s * 1e3:.2f} ms; "
          f"decode {PROMPTS * NEW_TOKENS / decode_s:.1f} tokens/s",
          flush=True)

    # cached decode agrees with the full forward (teacher forced)
    nxt = out[:, PROMPT_LEN]
    d_logits, _ = model.decode_forward(nxt, caches, PROMPT_LEN)
    full[:, PROMPT_LEN] = nxt
    f_logits = model(full)[:, PROMPT_LEN]
    err = (d_logits - f_logits).abs().max().item()
    scale = max(1.0, f_logits.abs().max().item())
    check(err <= DECODE_TOL * scale,
          f"decode_forward logits against the full forward at position "
          f"{PROMPT_LEN}: max_abs_diff {err:.3e} (tol {DECODE_TOL:g} x "
          f"max(1, max|forward|))")
    del caches, logits, ref_logits
    torch.cuda.empty_cache()
    decode_split(bt, model, plain, cfg, dev, card_line, prompts, out)
    decode_scan(bt, model, cfg, dev, card_line, prompts, out)
    generate_full(bt, model, cfg, dev, prompts)
    # the profiler last: the decode turns are timed without it, as before
    profile_port_kernels(f"forward batch {BATCH} x {cfg.ctx}",
                         lambda: model(tokens), fwd_ms)
    return launches


def decode_split(bt, model, plain, cfg, dev, card_line, prompts, out):
    """The decode that ran on the split route (one fused bsmm_split
    launch a product), held step by step against the plain model on the
    same tokens, and its tokens/s with the MLP on mode "auto" and pinned
    to "grouped", in turns (auto, grouped, grouped, auto, three times: the
    host-bound loop's times spread)."""
    full = torch.zeros((PROMPTS, cfg.ctx), dtype=torch.int64, device=dev)
    full[:, :PROMPT_LEN] = prompts
    worst = 0.0
    (_, c0), (_, c1) = model.prefill(full), plain.prefill(full)
    for i in range(NEW_TOKENS):
        tok = out[:, PROMPT_LEN + i]
        got, _ = model.decode_forward(tok, c0, PROMPT_LEN + i)
        ref, _ = plain.decode_forward(tok, c1, PROMPT_LEN + i)
        worst = max(worst, (got - ref).abs().max().item()
                    / (MODEL_TOL * max(1.0, ref.abs().max().item())))
    check(worst <= 1.0,
          f"decode logits on the split route against the plain model, fed "
          f"the generated tokens, {NEW_TOKENS} steps: worst step at "
          f"{worst:.3f} of its tolerance ({MODEL_TOL:g} x max(1, "
          f"max|plain|))")
    del c0, c1
    t = time.perf_counter()
    model.prefill(full)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    ops = (model.bsmm1, model.bsmm2)
    rates = {"auto": [], "grouped": []}
    for mode in ("auto", "grouped", "grouped", "auto") * 3:
        for op in ops:
            op.mode = mode
        gen = torch.Generator(device=dev).manual_seed(SEED)
        reset_counts()
        t = time.perf_counter()
        bt.generate_cached(model, prompts, NEW_TOKENS, generator=gen)
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        n = read_counts()
        rates[mode].append(PROMPTS * NEW_TOKENS / (gen_s - prefill_s))
        print(f"      decode, MLP mode {mode}: {rates[mode][-1]:.1f} "
              f"tokens/s ({n['bsmm_split']} fused split launches, "
              f"{n['bsmm_merge']} merges)", flush=True)
    for op in ops:
        op.mode = "auto"
    print(f"decode tokens/s [{card_line}]: MLP on the split route (auto) "
          f"median {np.median(rates['auto']):.1f} of "
          f"{' '.join(f'{r:.1f}' for r in rates['auto'])}; pinned to "
          f"grouped median {np.median(rates['grouped']):.1f} of "
          f"{' '.join(f'{r:.1f}' for r in rates['grouped'])} (prefill "
          f"{prefill_s * 1e3:.2f} ms subtracted)", flush=True)
    decode_step_split(model, full, out, card_line)
    torch.cuda.empty_cache()


def decode_step_split(model, full, out, card_line, steps=10):
    """Where a decode step's time goes (MLP on the split route): the
    host's time to enqueue one ``decode_forward`` against the device time
    of its kernels (profiler), and the device time a launch of the fused
    split (bsmm_xprop_mma.cu's OUT_SPLIT), of any unsplit xprop, and of
    the merge (none in bf16)."""
    tok = out[:, PROMPT_LEN]
    _, caches = model.prefill(full)
    model.decode_forward(tok, caches, PROMPT_LEN)            # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(steps):
        model.decode_forward(tok, caches, PROMPT_LEN + 1 + i)
    host_ms = (time.perf_counter() - t) / steps * 1e3
    torch.cuda.synchronize()
    _, kernels = device_events(lambda: [
        model.decode_forward(tok, caches, PROMPT_LEN + 1 + steps + i)
        for i in range(steps)], lambda ks: any(
            SPLIT_KERNEL.search(e.key) for e in ks))
    dev_ms = sum(e.self_device_time_total for e in kernels) / steps / 1e3
    per_launch = []
    for name, match in (
            ("fused split", lambda k: bool(SPLIT_KERNEL.search(k))),
            ("unsplit xprop", lambda k: "bsmm_xprop" in k
             and not SPLIT_KERNEL.search(k)),
            ("bsmm_merge", lambda k: "bsmm_merge" in k)):
        hits = [e for e in kernels if match(e.key)]
        n = sum(e.count for e in hits)
        us = sum(e.self_device_time_total for e in hits) / max(n, 1)
        per_launch.append(f"{name} {us:.2f} us a launch ({n // steps} a "
                          f"step)")
    print(f"decode step [{card_line}]: host enqueue {host_ms:.2f} ms, "
          f"device {dev_ms:.3f} ms ({dev_ms / host_ms:.0%} of it; mean of "
          f"{steps}, profiler); " + ", ".join(per_launch), flush=True)


def decode_scan(bt, model, cfg, dev, card_line, prompts, out):
    """``generate_cached_scan``: its capture counted (the prefill, then the
    warm-up's eager step and the captured step, one token each; a later
    call's replays launch through no wrapper), its tokens equal to
    ``generate_cached``'s for the same seed, one replayed step equal to
    the eager step bit for bit; then decode tokens/s of the graph against
    the loop in turns (loop, scan, scan, loop, three times; the decode
    alone, after its prefill), host time a token, the device time a
    token by the profiler over the replays and the card's busy share, the
    MLP on "auto" against "grouped" (one capture each), and peak memory."""
    from blocksparse_tpu_torch.models import sparse_transformer as lm
    L = cfg.n_layer
    full = torch.zeros((PROMPTS, cfg.ctx), dtype=torch.int64, device=dev)
    full[:, :PROMPT_LEN] = prompts
    model._decode_graphs.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_reserved()
    reset_counts()
    model.prefill(full)
    torch.cuda.synchronize()
    prefill = read_counts()
    reset_counts()
    t = time.perf_counter()
    scan = bt.generate_cached_scan(model, prompts, NEW_TOKENS,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    captured = read_counts()
    graph = model._decode_graph(PROMPTS, 1.0)
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - held0) / 2 ** 30
    n_split = L * [op.dispatch_mode(PROMPTS) for op in (
        model.bsmm1, model.bsmm2)].count("phased")
    want = {k: prefill[k] + 2 * {"bsmm_split": n_split,
                                 "bsmm_fprop": 2 * L - n_split}.get(k, 0)
            for k in prefill}
    check(captured == want and captured["bsmm_split"] > 0,
          f"generate_cached_scan's first call launches {captured}, expected "
          f"{want} (the prefill's, then 2L MLP products a token, bsmm_split "
          f"on the split route, for the warm-up's step and the captured "
          f"step; the {NEW_TOKENS} replays through no wrapper)")
    check(torch.equal(scan, out),
          f"generate_cached_scan tokens {tuple(scan.shape)} equal "
          f"generate_cached's for seed {SEED}")
    reset_counts()
    again = bt.generate_cached_scan(model, prompts, NEW_TOKENS,
                                    generator=torch.Generator(
                                        device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    replayed = read_counts()
    check(torch.equal(again, out) and replayed == prefill
          and len(model._decode_graphs) == 1,
          f"a second generate_cached_scan replays the kept graph: the same "
          f"tokens, launches {replayed} = the prefill's")
    print(f"decode graph [{card_line}]: first call {first_s:.3f} s "
          f"(prefill, warm-up {graph.warmup_s:.3f} s, capture "
          f"{graph.capture_s:.3f} s, {NEW_TOKENS} replays); the graph holds "
          f"{held:.3f} GiB after it (static state and private pool)",
          flush=True)

    # one replayed token against the eager step, bit for bit
    s = lm._prompt_state(model, prompts, NEW_TOKENS,
                         torch.Generator(device=dev).manual_seed(SEED + 1))
    ref = {k: [{kk: vv.clone() for kk, vv in c.items()} for c in v]
           if k == "caches" else v.clone() for k, v in s.items()}
    graph.run(s, 1)
    lm._token_step(model, ref, 1.0)
    torch.cuda.synchronize()
    check(all(torch.equal(graph.state[k], ref[k])
              for k in ("tokens", "logits", "pos", "step"))
          and all(torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])
                  for a, b in zip(graph.state["caches"], ref["caches"])),
          f"a replayed decode token equals the eager step bit for bit "
          f"(token, logits, position, every K/V cache)")
    del s, ref

    def decode(kind):
        s = lm._prompt_state(model, prompts, NEW_TOKENS,
                             torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        t = time.perf_counter()
        if kind == "scan":
            model._decode_graph(PROMPTS, 1.0).run(s, NEW_TOKENS)
        else:
            for _ in range(NEW_TOKENS):
                lm._token_step(model, s, 1.0)
        host = time.perf_counter() - t
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return PROMPTS * NEW_TOKENS / wall, host / NEW_TOKENS * 1e3, \
            wall / NEW_TOKENS * 1e3
    turns = {"loop": [], "scan": []}
    for kind in ("loop", "scan", "scan", "loop") * 3:
        turns[kind].append(decode(kind))
    for kind, runs in turns.items():
        print(f"      decode, {kind}: " + "; ".join(
            f"{r:.1f} tokens/s (host {h:.3f} ms a token, wall {w:.3f})"
            for r, h, w in runs), flush=True)
    med = {k: [float(np.median([r[i] for r in v])) for i in range(3)]
           for k, v in turns.items()}

    # the device time a token, over the replays
    s = lm._prompt_state(model, prompts, NEW_TOKENS,
                         torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    _, kernels = device_events(lambda: graph.run(s, NEW_TOKENS),
                               lambda ks: any(SPLIT_KERNEL.search(e.key)
                                              for e in ks))
    found = any(SPLIT_KERNEL.search(e.key) for e in kernels)
    if found:
        dev_ms = sum(e.self_device_time_total for e in kernels) \
            / NEW_TOKENS / 1e3
        split_n = sum(e.count for e in kernels if SPLIT_KERNEL.search(e.key))
        busy = (f"device {dev_ms:.3f} ms a token (profiler over the "
                f"replays, {split_n // NEW_TOKENS} fused split launches a "
                f"token recorded), busy {dev_ms / med['scan'][2]:.0%} of "
                f"the wall time")
        n_kernels = sum(e.count for e in kernels) / NEW_TOKENS
        print(f"      decode token's device time by kernel [{card_line}] "
              f"({n_kernels:.0f} kernels a token; us a token, launches a "
              f"token): {by_kernel(kernels, NEW_TOKENS)}", flush=True)
    else:
        busy = (f"device time not measured: the profiler recorded no "
                f"kernel inside the replays in {PROFILE_TRIES} windows")
    del s
    print(f"decode tokens/s [{card_line}]: generate_cached_scan (one CUDA "
          f"graph a token) median {med['scan'][0]:.1f}, host "
          f"{med['scan'][1]:.3f} ms a token, wall {med['scan'][2]:.3f} ms a "
          f"token; generate_cached (the loop) median {med['loop'][0]:.1f}, "
          f"host {med['loop'][1]:.3f} ms a token, wall {med['loop'][2]:.3f} "
          f"ms; {med['scan'][0] / med['loop'][0]:.2f}x; scan {busy} "
          f"({PROMPTS} x {NEW_TOKENS} tokens after {PROMPT_LEN}, turns of "
          f"loop, scan, scan, loop x 3)", flush=True)

    # the MLP pinned to grouped: a second capture, its own graph
    ops = (model.bsmm1, model.bsmm2)
    rates = {"auto": [], "grouped": []}
    for mode in ("auto", "grouped", "grouped", "auto") * 2:
        for op in ops:
            op.mode = mode
        if mode == "grouped" and len(model._decode_graphs) == 1:
            reset_counts()
            model._decode_graph(PROMPTS, 1.0)
            n = read_counts()
            check(n["bsmm_split"] == 0 and n["bsmm_fprop"] == 2 * 2 * L
                  and len(model._decode_graphs) == 2,
                  f"mode grouped recaptures the decode step: warm-up and "
                  f"capture launch bsmm_fprop 2L each, no split ({n})")
        rates[mode].append(decode("scan")[0])
    for op in ops:
        op.mode = "auto"
    print(f"decode tokens/s, scan [{card_line}]: MLP on the split route "
          f"(auto) median {np.median(rates['auto']):.1f} of "
          f"{' '.join(f'{r:.1f}' for r in rates['auto'])}; pinned to "
          f"grouped median {np.median(rates['grouped']):.1f} of "
          f"{' '.join(f'{r:.1f}' for r in rates['grouped'])}", flush=True)

    # peak memory of one call each
    peaks = {}
    for kind, fn in (("loop", bt.generate_cached),
                     ("scan", bt.generate_cached_scan)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fn(model, prompts, NEW_TOKENS,
           generator=torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        peaks[kind] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"serving peak device memory [{card_line}]: generate_cached "
          f"{peaks['loop']:.2f} GiB, generate_cached_scan {peaks['scan']:.2f} "
          f"GiB (its two graphs' static state held)", flush=True)
    torch.cuda.empty_cache()


def kernel_name(key):
    """A profiler kernel record's function name: template arguments,
    parameters and the return type dropped."""
    if key.startswith(("Memcpy", "Memset")):
        return key
    out, depth = [], 0
    for ch in key:
        if ch == "<":
            depth += 1
        elif ch == ">" and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    name = "".join(out).replace("(anonymous namespace)::", "")
    return name.split("(")[0].split()[-1]


def by_kernel(kernels, n, top=10):
    """The device time of n calls' kernel records summed by function name,
    largest first: us a call and launches a call."""
    agg = {}
    for e in kernels:
        name = kernel_name(e.key)
        t, c = agg.get(name, (0.0, 0))
        agg[name] = (t + e.self_device_time_total, c + e.count)
    ranked = sorted(agg.items(), key=lambda kv: -kv[1][0])[:top]
    return ", ".join(f"{k} {t / n:.1f} ({c / n:.0f})"
                     for k, (t, c) in ranked)


def generate_full(bt, model, cfg, dev, prompts):
    """``generate`` (a full-context forward a token) against
    ``generate_cached`` on the plain-version model in f32, the same
    weights and seed: the same tokens."""
    import dataclasses
    c32 = dataclasses.replace(cfg, dtype="float32")
    plain32 = bt.SparseTransformerLM(c32, device=dev, impl="xla")
    plain32.load_state_dict(model.state_dict())
    outs = [fn(plain32, prompts, GENERATE_TOKENS,
               generator=torch.Generator(device=dev).manual_seed(SEED))
            for fn in (bt.generate, bt.generate_cached)]
    check(torch.equal(outs[0], outs[1])
          and tuple(outs[0].shape) == (PROMPTS, PROMPT_LEN + GENERATE_TOKENS),
          f"generate ({GENERATE_TOKENS} tokens, a full forward each) equals "
          f"generate_cached on the plain model in f32, seed {SEED}")
    del plain32, outs
    torch.cuda.empty_cache()


# The LMs the kernels serve through the view and the padding: the enwik8
# LM's layout, MLP and dtype cut to VIEW_LM_LAYERS layers, ctx
# VIEW_LM_CTX and batch VIEW_LM_BATCH, at block size 8 (the kernels run
# its bs-16 view) and with 8 heads of 48 (n_embd 384; the kernels run hs
# 64), each against the same model on the plain versions.
VIEW_LMS = (("LM blk_size 8", dict(blk_size=8)),
            ("LM n_embd 384, 8 heads of 48", dict(n_embd=384)))
VIEW_LM_LAYERS, VIEW_LM_CTX, VIEW_LM_BATCH = 2, 1024, 2


def view_lm_paths(bt, dev):
    """Each of VIEW_LMS down its two paths, counted: the serving forward
    (bst_attn_fwd once a layer) and one train step (bst_attn_fwd_lse, dq
    and dk/dv once a layer; no recompute), held against the plain-version
    model: logits within MODEL_TOL, the step's loss and grad norm within
    STEP_LOSS_TOL.  Returns {name: (serving launches, step launches, and
    of each the attention launches on the wgmma kernels)}."""
    out = {}
    for what, kw in VIEW_LMS:
        cfg = flagship_config(bt, n_layer=VIEW_LM_LAYERS, ctx=VIEW_LM_CTX,
                              recompute=False, **kw)
        model = bt.SparseTransformerLM(cfg, device=dev)
        plain = bt.SparseTransformerLM(cfg, device=dev, impl="xla")
        sd = bt.params_from_jax(bt.random_jax_params(model, seed=SEED),
                                model)
        model.load_state_dict(sd)
        plain.load_state_dict(sd)
        L = cfg.n_layer
        rng = np.random.RandomState(SEED)
        seq = torch.from_numpy(rng.randint(
            0, cfg.n_vocab, (VIEW_LM_BATCH, cfg.ctx + 1))).to(dev)
        tokens, targets = seq[:, :-1], seq[:, 1:]
        what = (f"{what} ({L} layers, ctx {cfg.ctx}, batch {VIEW_LM_BATCH}, "
                f"bf16)")
        model(tokens[:1])                        # warm-up: tables, handles
        torch.cuda.synchronize()
        reset_counts()
        logits = model(tokens)
        torch.cuda.synchronize()
        serve = read_counts()
        serve_wg = read_attn_wgmma()
        check(serve["bst_attn_fwd"] == L and serve["bst_attn_fwd_lse"] == 0
              and serve["bst_attn_dq"] == serve["bst_attn_dkv"] == 0,
              f"{what}: serving forward launches bst_attn_fwd {L} "
              f"({serve})")
        compare(f"{what}: forward logits against the plain model", logits,
                plain(tokens), MODEL_TOL)
        opt = bt.AdamOptimizer(learning_rate=LR, zero_nans=True,
                               zero_infs=True)
        ls = torch.tensor(LOSS_SCALE, device=dev)
        steps = []
        for m in (model, plain):
            step = m.make_train_step(opt, clip_norm=CLIP)
            state = opt.init(dict(m.named_parameters()))
            torch.cuda.synchronize()
            reset_counts()
            # the kernel model's step is captured (its first call: the
            # warm-up's eager step, the capture, one replay); the plain
            # model's runs eagerly, as the reference
            _, metrics, _ = (step if m is model else step._eager)(
                state, tokens, targets, ls)
            torch.cuda.synchronize()
            steps.append((read_counts(), metrics, read_attn_wgmma()))
        (train, m0, train_wg), (train_plain, m1, _) = steps
        check(train["bst_attn_fwd_lse"] == train["bst_attn_dq"]
              == train["bst_attn_dkv"] == 2 * L and train["bst_attn_fwd"] == 0
              and not any(train_plain.values()),
              f"{what}: captured train step's first call launches "
              f"bst_attn_fwd_lse, dq, dk/dv 2L each, L = {L} (the warm-up "
              f"and the capture, one step each) ({train}); the plain model "
              f"none")
        for k in ("loss", "grad_norm"):
            a, b = m0[k].item(), m1[k].item()
            check(np.isfinite(a) and abs(a - b) <= STEP_LOSS_TOL * abs(b),
                  f"{what}: train step {k} {a:.6f} vs plain {b:.6f} (tol "
                  f"{STEP_LOSS_TOL:g} relative)")
        print(f"{what}: attention launches on the wgmma kernels: serving "
              f"{serve_wg}, train step {train_wg}", flush=True)
        out[what] = (serve, train, serve_wg, train_wg)
        del model, plain, logits, steps
        torch.cuda.empty_cache()
    return out


def pad_cost(bt, dev, g, card_line):
    """What the head-size padding costs at the LM's shape with 8 heads of
    48 (batch 8 x 2048, n_embd 384, the LM's fixed layout at b64, bf16):
    the op's route (pad q, k, v (and dO) to hs 64, run the kernels, crop)
    against the kernels alone on inputs padded beforehand, serving
    forward and training (forward with lse, dq, dk/dv), in turns by CUDA
    events, and by the device time of all their kernels (the profiler)."""
    from blocksparse_tpu_torch.kernels import bst_attn
    from blocksparse_tpu_torch.models.sparse_transformer import (
        causal_subblock_mask, fixed_layout)
    from blocksparse_tpu_torch.ops.transformer import _pad
    heads, hs, bs, ctx = 8, 48, 64, 2048
    op = bt.BlocksparseTransformer(fixed_layout(ctx // bs, local_blocks=8),
                                   block_size=bs, heads=heads,
                                   mask_callback=causal_subblock_mask)
    qkv = torch.randn((BATCH, ctx, 3 * heads * hs), device=dev,
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv.split(heads * hs, dim=-1)
    do = torch.randn((BATCH, ctx, heads * hs), device=dev,
                     generator=g).to(torch.bfloat16)
    scale = 1.0 / np.sqrt(hs)
    tab = op._tables(dev)
    qp, kp, vp, dop = (_pad(t, ctx, heads, 64) for t in (q, k, v, do))
    out, lse = op._kernel_fwd(q, k, v, scale, with_lse=True)
    dvec = (do.float() * out.float()).reshape(
        BATCH, ctx, heads, hs).sum(-1).transpose(1, 2).contiguous()
    fns = {
        "serving route": lambda: op._kernel_fwd(q, k, v, scale, False),
        "serving kernel": lambda: bst_attn.attention_fwd(
            qp, kp, vp, tab, heads, scale),
        "training route": lambda: (
            op._kernel_fwd(q, k, v, scale, True),
            op._kernel_bwd(q, k, v, do, out, lse, scale)),
        "training kernels": lambda: (
            bst_attn.attention_fwd_lse(qp, kp, vp, tab, heads, scale),
            bst_attn.attention_dq(qp, kp, vp, dop, lse, dvec, tab, heads,
                                  scale),
            bst_attn.attention_dkv(qp, kp, vp, dop, lse, dvec, tab, heads,
                                   scale))}
    for route, kern in (("serving route", "serving kernel"),
                        ("training route", "training kernels")):
        t = in_turns({route: fns[route], kern: fns[kern]},
                     lambda fn: time_ms(fn, 20))
        r, kk = t[route], t[kern]
        dev_r, dev_k = (device_ms_per_call(fns[n], lambda key: True)
                        for n in (route, kern))
        print(f"attention hs 48 padded to 64, batch {BATCH} x {ctx}, 8 heads, "
              f"b{bs}, bf16 [{card_line}]: {route} {r[0]:.4f} / {r[1]:.4f} "
              f"ms, the kernels alone on padded inputs {kk[0]:.4f} / "
              f"{kk[1]:.4f} ms (CUDA events, mean of 20, in turns): the "
              f"padding costs {np.mean(r) - np.mean(kk):.4f} ms; device "
              f"time (profiler, mean of 20) {dev_r:.4f} against "
              f"{dev_k:.4f} ms: {dev_r - dev_k:.4f} ms", flush=True)
    del qkv, q, k, v, do, qp, kp, vp, dop, out, lse, dvec
    torch.cuda.empty_cache()


def compare_tensors(what, got, ref, tol, live=None, flip_bound=None):
    """Per-tensor check: |got - ref| <= tol * max|ref| (only where ``live``,
    if given; there every element must also be within ``flip_bound``).
    Returns the worst ratio of error to tolerance."""
    worst, worst_flip = 0.0, 0.0
    for k in ref:
        scale = ref[k].abs().max().item()
        diff = (got[k].float() - ref[k].float()).abs()
        if live is not None:
            flip = diff.max().item()
            worst_flip = max(worst_flip, flip)
            if flip > flip_bound:
                check(False, f"{what} {k}: max|diff| {flip:.3e} > "
                             f"{flip_bound:.1e}")
            diff = diff[live[k]]
        err = diff.max().item() if diff.numel() else 0.0
        ratio = err / max(tol * scale, 1e-30)
        worst = max(worst, ratio)
        if ratio > 1.0:
            check(False, f"{what} {k}: max_abs_err {err:.3e} > tol {tol:g} "
                         f"x max|plain| {scale:.3e}")
    extra = ("" if live is None else
             f"; elsewhere max|diff| {worst_flip:.2e} <= {flip_bound:.1e}")
    check(True, f"{what}: {len(ref)} tensors, each within {tol:g} x its "
                f"max|plain| (worst at {worst:.3f} of its tolerance){extra}")
    return worst


def training_path(bt, model, plain, cfg, dev, card_line, profile_out):
    """Grads and one step against the plain model, the counted step, eight
    steps with falling loss, and the step time."""
    L = cfg.n_layer
    rng = np.random.RandomState(SEED)
    seq = torch.from_numpy(rng.randint(0, cfg.n_vocab,
                                       (BATCH, cfg.ctx + 1))).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    ls = torch.tensor(LOSS_SCALE, device=dev)

    # (a) loss and every gradient, kernel model against plain model
    grads, losses = [], []
    for m in (model, plain):
        names, params = zip(*m.named_parameters())
        loss = m.loss(tokens, targets)
        grads.append(dict(zip(names, (g / ls for g in torch.autograd.grad(
            loss * ls, params)))))
        losses.append(loss.item())
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    check(np.isfinite(losses[0]) and rel <= STEP_LOSS_TOL,
          f"train loss {losses[0]:.6f} vs plain {losses[1]:.6f} (rel diff "
          f"{rel:.2e}, tol {STEP_LOSS_TOL:g})")
    grad_worst = compare_tensors("gradients against the plain model",
                                 grads[0], grads[1], GRAD_TOL)
    gn = [bt.global_norm(g).item() for g in grads]
    check(abs(gn[0] - gn[1]) <= GRAD_TOL * gn[1],
          f"grad_norm {gn[0]:.6f} vs plain {gn[1]:.6f} (tol {GRAD_TOL:g} "
          f"relative)")
    live = {k: g.abs() > GRAD_TOL * g.abs().max() for k, g in
            grads[1].items()}
    del grads
    torch.cuda.empty_cache()

    # (b) + (d): the first step of the kernel model, eagerly and captured
    # (its first call: the warm-up, one eager step on a side stream whose
    # effects are undone, then the capture, then one replay), counted,
    # from the same weights and state; and the same step on the plain
    # model, eager as before
    opt = bt.AdamOptimizer(learning_rate=LR, zero_nans=True, zero_infs=True)
    step = model.make_train_step(opt, clip_norm=CLIP)
    eager = step._eager
    before = snapshot(model)
    _, m_eager, sc_eager = eager(opt.init(dict(model.named_parameters())),
                                 tokens, targets, ls)
    d_eager = {k: v - before[k] for k, v in model.state_dict().items()}
    restore(model, before)
    state0 = opt.init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t = time.perf_counter()
    state, m0, scale = step(state0, tokens, targets, ls)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    launches = read_counts()
    wgmma, sparse = read_wgmma(), read_sparse()
    attn_wg = read_attn_wgmma()
    peak_first = torch.cuda.max_memory_allocated() / 2 ** 30
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - held0) / 2 ** 30
    d0 = {k: v - before[k] for k, v in model.state_dict().items()}
    del before, state0
    warm_s, capture_s = step.captures[0]
    print(f"train step graph [{card_line}]: first call {first_s:.3f} s "
          f"(warm-up {warm_s:.3f} s, capture {capture_s:.3f} s, then one "
          f"replay); its peak device memory {peak_first:.2f} GiB; the "
          f"graph holds {held:.2f} GiB after it (its private pool and "
          f"static buffers, which a replay's peak does not count)",
          flush=True)
    before = snapshot(plain)
    _, m1, _ = plain.make_train_step(opt, clip_norm=CLIP)._eager(
        opt.init(dict(plain.named_parameters())), tokens, targets, ls)
    d1 = {k: v - before[k] for k, v in plain.state_dict().items()}
    del before
    want = dict.fromkeys(launches, 0)
    split = [op.updat_splits(tokens.numel()) > 1
             for op in (model.bsmm1, model.bsmm2)]
    want.update({"bsmm_fprop": 4 * L, "bsmm_bprop": 2 * L,
                 "bsmm_updat": 2 * L, "bsmm_updat_reduce": L * sum(split),
                 "bst_attn_fwd_lse": 2 * L, "bst_attn_dq": L,
                 "bst_attn_dkv": L})
    want = {k: 2 * n for k, n in want.items()}
    check(launches == want and launches["bsmm_updat_reduce"] > 0,
          f"train step's first call launches {launches}, expected {want} "
          f"(the warm-up's eager step and the captured step, each: "
          f"recompute: bsmm_fprop 4L, bsmm_bprop 2L, bsmm_updat 2L, "
          f"bsmm_updat_reduce > 0: one an updat on the split, "
          f"bst_attn_fwd_lse 2L, bst_attn_dq L, bst_attn_dkv L, L = {L}; "
          f"the replay through no wrapper)")
    check(wgmma == {k: launches[k] for k in WGMMA_WRAPPERS},
          f"train step's first call: every bsmm product on the wgmma "
          f"kernels ({wgmma} of {launches}; bsmm1 and bsmm2 at N = "
          f"{tokens.numel()}: fprop on "
          f"{model.bsmm1.kernel_of(tokens.numel(), 'f')} and "
          f"{model.bsmm2.kernel_of(tokens.numel(), 'f')}, bprop on "
          f"{model.bsmm1.kernel_of(tokens.numel(), 'b')} and "
          f"{model.bsmm2.kernel_of(tokens.numel(), 'b')}, updat on "
          f"{model.bsmm1.kernel_of(tokens.numel(), 'u')})")
    want_sp = {k: launches[k] * all(
        op.kernel_of(tokens.numel(), d) == "bsmm_xprop_sparse"
        for op in (model.bsmm1, model.bsmm2))
        for k, d in zip(SPARSE_WRAPPERS, "fb")}
    check({k: sparse[k] for k in SPARSE_WRAPPERS} == want_sp and
          sparse["pack"] == sum(want_sp.values()),
          f"train step's first call: the xprop's launches on "
          f"bsmm_xprop_sparse.cu {sparse}, as kernel_of names them "
          f"{want_sp}, each with one packing of its weights")
    sparse["bsmm_updat"] = counters()["bsmm_updat"].launches_sparse
    want_u = launches["bsmm_updat"] * all(
        op.kernel_of(tokens.numel(), "u") == "bsmm_updat_sparse"
        for op in (model.bsmm1, model.bsmm2))
    check(sparse["bsmm_updat"] == want_u,
          f"train step's first call: the updat's launches on "
          f"bsmm_updat_sparse.cu {sparse['bsmm_updat']}, as kernel_of names "
          f"them {want_u}")
    check(attn_wg == {k: launches[k] for k in ATTN_WGMMA_WRAPPERS},
          f"train step's first call: every attention forward with lse on "
          f"bst_attn_fwd_wgmma.cu, every dq on bst_attn_dq_wgmma.cu and "
          f"every dk/dv on bst_attn_dkv_wgmma.cu ({attn_wg} of {launches})")
    bits = all(torch.equal(m0[k], m_eager[k]) for k in m0) and \
        torch.equal(scale, sc_eager) and \
        all(torch.equal(d0[k], d_eager[k]) for k in d0)
    for k in ("loss", "grad_norm"):
        a, b = m0[k].item(), m_eager[k].item()
        check(abs(a - b) <= STEP_LOSS_TOL * abs(b),
              f"step 1 {k}: captured {a:.6f} vs eager {b:.6f} (tol "
              f"{STEP_LOSS_TOL:g} relative)")
    compare_tensors("parameter updates of step 1, captured against eager",
                    d0, d_eager, GRAD_TOL)
    print(f"      captured step 1 equals the eager step bit for bit "
          f"(metrics, scale, every parameter update): {bits}", flush=True)
    for k in ("loss", "grad_norm"):
        a, b = m0[k].item(), m1[k].item()
        check(abs(a - b) <= STEP_LOSS_TOL * abs(b),
              f"step 1 {k} {a:.6f} vs plain {b:.6f} (tol "
              f"{STEP_LOSS_TOL:g} relative)")
    check(m0["norm_scale"].item() > 0 and scale.item() > LOSS_SCALE,
          f"step 1 norm_scale {m0['norm_scale'].item():.4f} > 0, loss scale "
          f"{LOSS_SCALE:g} -> {scale.item():.2f}")
    compare_tensors("parameter updates of step 1 against the plain model",
                    d0, d1, GRAD_TOL, live=live, flip_bound=2 * LR + 1e-6)
    del d0, d1, d_eager, live
    torch.cuda.empty_cache()

    # (c) more steps on the fixed batch, replays of the graph (no wrapper
    # call): finite, falling loss
    losses, norm_scales = [m0["loss"].item()], [m0["norm_scale"].item()]
    reset_counts()
    for _ in range(TRAIN_STEPS - 1):
        state, metrics, scale = step(state, tokens, targets, scale)
        losses.append(metrics["loss"].item())
        norm_scales.append(metrics["norm_scale"].item())
    replayed = read_counts()
    check(not any(replayed.values()),
          f"{TRAIN_STEPS - 1} replays of the captured step launch through "
          f"no wrapper ({replayed})")
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0]
          and min(norm_scales) > 0,
          f"{TRAIN_STEPS} train steps on one batch (captured): loss "
          f"{' '.join(f'{x:.4f}' for x in losses)} (finite, falling), "
          f"norm_scale > 0 in every step (min {min(norm_scales):.4f})")

    # step time: the graph's replay against the eager step, in turns
    holder = {"state": state, "scale": scale}

    def one_step(fn):
        holder["state"], _, holder["scale"] = fn(
            holder["state"], tokens, targets, holder["scale"])

    def timing(fn):
        one_step(fn)                  # the other side's state copied in
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        one_step(fn)
        host_ms = (time.perf_counter() - t) * 1e3
        torch.cuda.synchronize()
        ms = time_ms(lambda: one_step(fn), TIMED_STEPS)
        return ms, host_ms, torch.cuda.max_memory_allocated() / 2 ** 30
    turns = {"graph": [], "eager": []}
    for _ in range(2):
        for side, runs in in_turns({"graph": step, "eager": eager},
                                   timing).items():
            turns[side] += runs
    for side, runs in turns.items():
        print(f"      train step, {side}: "
              + "; ".join(f"{ms:.2f} ms (host {h:.2f} ms to return, peak "
                          f"{gib:.2f} GiB)" for ms, h, gib in runs),
              flush=True)
    ms = {k: float(np.median([r[0] for r in v])) for k, v in turns.items()}
    print(f"train step [{card_line}]: batch {BATCH} x {cfg.ctx}, captured "
          f"{ms['graph']:.2f} ms (median of 4 turns, each the mean of "
          f"{TIMED_STEPS} steps by CUDA events) = "
          f"{BATCH * cfg.ctx / ms['graph'] * 1e3:.0f} tokens/s; eager "
          f"{ms['eager']:.2f} ms = {BATCH * cfg.ctx / ms['eager'] * 1e3:.0f} "
          f"tokens/s; peak device memory graph "
          f"{max(r[2] for r in turns['graph']):.2f} GiB, eager "
          f"{max(r[2] for r in turns['eager']):.2f} GiB; reserved "
          f"{torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB", flush=True)
    profile_port_kernels("train step (graph replay)", lambda: one_step(step),
                         ms["graph"], profile_out)
    profile_port_kernels("train step (eager)", lambda: one_step(eager),
                         ms["eager"])

    # the same captured step with the MLP products' updat on
    # bsmm_updat_wgmma.cu (the parent's route), timed against this one in
    # turns: the step before and after
    old, old_step, old_holder = parent_train_step(bt, model, cfg, dev, opt,
                                                  tokens, targets, scale)

    def old_one():
        old_holder["state"], _, old_holder["scale"] = old_step(
            old_holder["state"], tokens, targets, old_holder["scale"])
    old_one()
    turns = {"sparse": [], "wgmma": []}
    for _ in range(2):
        for k, t in in_turns({"sparse": lambda: one_step(step),
                              "wgmma": old_one},
                             lambda fn: time_ms(fn, TIMED_STEPS)).items():
            turns[k] += t
    ms = {k: " / ".join(f"{v:.2f}" for v in t) for k, t in turns.items()}
    med = {k: float(np.median(t)) for k, t in turns.items()}
    print(f"train step [{card_line}]: captured with the updat on "
          f"{model.bsmm1.kernel_of(tokens.numel(), 'u')}.cu {ms['sparse']} "
          f"ms (median {med['sparse']:.2f}), on bsmm_updat_wgmma.cu "
          f"{ms['wgmma']} ms (median {med['wgmma']:.2f}) (two rounds of "
          f"turns new, parent, parent, new; each the mean of {TIMED_STEPS} "
          f"replays by CUDA events)", flush=True)
    profile_port_kernels("train step with the updat on bsmm_updat_wgmma.cu "
                         "(graph replay)", old_one,
                         float(np.mean(turns["wgmma"])))
    del old, old_step, old_holder
    torch.cuda.empty_cache()
    return launches, wgmma, sparse


@contextlib.contextmanager
def updat_off_sparse():
    """The updat's route with bsmm_updat_sparse.cu's block sizes emptied:
    the bf16 products on bsmm_updat_wgmma.cu and bsmm_updat_mma.cu as
    before it."""
    from blocksparse_tpu_torch.kernels import bsmm
    saved = bsmm.UPDAT_SP_BUNDLES
    bsmm.UPDAT_SP_BUNDLES = {}
    try:
        yield
    finally:
        bsmm.UPDAT_SP_BUNDLES = saved


def parent_train_step(bt, model, cfg, dev, opt, tokens, targets, ls):
    """The flagship's captured train step with the MLP products' updat on
    bsmm_updat_wgmma.cu, as before bsmm_updat_sparse.cu: a second model of
    ``model``'s weights whose step's first call (its warm-up and its
    capture) routes under ``updat_off_sparse()``; the graph keeps those
    launches.  (model, step, {"state", "scale"})."""
    old = bt.SparseTransformerLM(cfg, device=dev)
    old.load_state_dict(model.state_dict())
    step = old.make_train_step(opt, clip_norm=CLIP)
    reset_counts()
    with updat_off_sparse():
        state, _, scale = step(opt.init(dict(old.named_parameters())),
                               tokens, targets, ls)
        torch.cuda.synchronize()
    u = counters()["bsmm_updat"]
    check(u.launches_sparse == 0 < u.launches_wgmma == u.launches,
          f"the step with the updat off bsmm_updat_sparse.cu: every updat "
          f"on bsmm_updat_wgmma.cu ({u.launches_wgmma}, sparse "
          f"{u.launches_sparse} of {u.launches})")
    return old, step, {"state": state, "scale": scale}


def snapshot(m):
    return {k: v.clone() for k, v in m.state_dict().items()}


def restore(m, saved):
    with torch.no_grad():
        for k, v in m.state_dict().items():
            v.copy_(saved[k])


# name fragments of the port's kernels: the xprop's
# bsmm_xprop_sparse_kernel (bf16/f16 at b32) and its weights' packing
# (bsmm_xprop_sparse_pack_kernel), bsmm_xprop_wgmma_kernel
# and bsmm_xprop_mma_kernel (bf16/f16, the latter also the split route's)
# and bsmm_xprop_nc_kernel (f32); the updat's bsmm_updat_sparse_kernel,
# bsmm_updat_wgmma_kernel and bsmm_updat_mma_kernel (bf16/f16),
# bsmm_updat_nc_kernel (f32) and the split's bsmm_updat_reduce_kernel;
# the attention's bf16/f16 kernels by source: bst_attn_fwd_wgmma_kernel,
# bst_attn_dq_wgmma_kernel and bst_attn_dkv_wgmma_kernel,
# bst_attn_fwd_mma_kernel and
# bst_attn_{dq,dkv}_mma_kernel (the f32 bst_attn_*_kernel are not on the
# bf16 paths profiled); "bst_nt" and "bst_xn" the unfused ops' (the same
# names without "_mma" in f32)
# the spin kernels (torch.cuda._sleep) that open a profiled window
PROFILE_SPINS, PROFILE_SPIN_CYCLES = 8, 100000
# windows a profiled measurement takes before it gives up on CUPTI
PROFILE_TRIES = 6
PORT_KERNELS = ("bsmm_xprop_sparse_kernel", "bsmm_xprop_sparse_pack",
                "bsmm_xprop_wgmma", "bsmm_xprop_mma", "bsmm_xprop_nc",
                "bsmm_updat_sparse", "bsmm_updat_wgmma", "bsmm_updat_mma",
                "bsmm_updat_nc",
                "bsmm_updat_reduce", "bst_attn_fwd_wgmma", "bst_attn_fwd_mma",
                "bst_attn_dq_wgmma", "bst_attn_dq_mma", "bst_attn_dkv_wgmma",
                "bst_attn_dkv_mma",
                "bst_nt", "bst_xn")


def device_events(fn, need=bool):
    """fn() under torch.profiler: (all events, the device events).
    Device events only are summed: a host op that launched a kernel
    through ctypes carries that kernel's time as its own "self" device
    time too.  A window's first kernel records go missing (after the
    process's first window, the first one or two kernels were never
    recorded), so PROFILE_SPINS spin kernels and a synchronize open the
    window, and their records are left out.  CUPTI now and then records
    none, or not all, of a window's kernels: a window whose device events
    ``need`` refuses is profiled again, up to PROFILE_TRIES windows, and
    the last one is returned either way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for i in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_SPINS):
                torch.cuda._sleep(PROFILE_SPIN_CYCLES)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and "spin_kernel" not in e.key]
        if need(kernels):
            break
        print(f"      profiler: window {i + 1} lacks kernel records; "
              f"profiling again" if i + 1 < PROFILE_TRIES else
              f"      profiler: {PROFILE_TRIES} windows lacked kernel "
              f"records", flush=True)
    return events, kernels


def events_instead(fn, n, what):
    """CUDA events' mean time of fn() over n calls, where the profiler
    recorded no launch of ``what``: the call's time on the device's clock,
    the host's enqueue included where it is the longer."""
    ms = time_ms(fn, n)
    print(f"      profiler: no launch of {what} recorded in {PROFILE_TRIES} "
          f"windows; {ms:.4f} ms a call by CUDA events instead", flush=True)
    return ms


def profile_port_kernels(label, fn, wall_ms, table_path=None):
    """One fn() (a train step, a forward) under torch.profiler: device time
    in all and by port kernel, against its unprofiled time; the full table
    goes to ``table_path`` when one is given."""
    events, kernels = device_events(fn, lambda ks: any(
        name in e.key for name in PORT_KERNELS for e in ks))
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    if not total:
        print(f"{label} profile: not measured (no kernel record in "
              f"{PROFILE_TRIES} windows)", flush=True)
        return
    ports = {}
    for name in PORT_KERNELS:
        hits = [e for e in kernels if name in e.key]
        ports[name] = (sum(e.self_device_time_total for e in hits) / 1e3,
                       sum(e.count for e in hits))
    ours = sum(ms for ms, _ in ports.values())
    print(f"{label} profile: {total:.2f} ms of device time in one "
          f"profiled run, {total / wall_ms:.0%} of the unprofiled "
          f"{wall_ms:.2f} ms; port kernels {ours:.2f} ms "
          f"({ours / total:.0%}): " + ", ".join(
              f"{name} {ms:.2f} ms ({n})"
              for name, (ms, n) in ports.items()), flush=True)
    print(f"      {label}, every kernel by name ("
          f"{sum(e.count for e in kernels)} launches; us, launches): "
          f"{by_kernel(kernels, 1)}", flush=True)
    if table_path:
        out = Path(table_path)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(events.table(sort_by="self_cuda_time_total",
                                    row_limit=40))


def pick_m(n, target_pct):
    """The canonical bench's Barabasi-Albert bandwidth m for a target
    density (benchmarks/canonical_bench.py:46-57, mask "ba")."""
    if target_pct >= 100.0:
        return n
    for m in range(1, n // 2):
        if 100 * (2 * m * (n - m) + m * m + n - m) / n ** 2 >= target_pct:
            return m
    return n // 2


def chain(op, x, w):
    """The bench's depth-8 chain y = bsmm(y, w)."""
    for _ in range(CANON_DEPTH):
        x = op(x, w)
    return x


def chain_grads(op, x0, w0):
    """The chain and its gradients in x and w for the cotangent y, as the
    bench's fb_step takes them (jax.vjp of the chain at y)."""
    x, w = x0.detach().requires_grad_(), w0.detach().requires_grad_()
    y = chain(op, x, w)
    dx, dw = torch.autograd.grad(y, (x, w), y.detach())
    return y.detach(), dx, dw


def route_launches(op, N, sms, times, dtype=torch.bfloat16):
    """Launches of one fprop (times[0] of them) and one bprop (times[1])
    on the routes op takes for N rows in ``dtype``, with one updat a bprop
    (with its reduce where it splits).  The split route is one fused
    bsmm_split in bf16/f16, partial tiles and a merge in f32."""
    want = dict.fromkeys(read_counts(), 0)
    for d, n in zip("fb", times):
        direct = "bsmm_fprop" if d == "f" else "bsmm_bprop"
        split = ("bsmm_split",) if dtype != torch.float32 else \
            (direct, "bsmm_merge")
        for name in {"fine": ("bsmm_fine",), "window": ("bsmm_window",),
                     "phased": split,
                     "grouped": (direct,)}[op._route(N, d, sms)]:
            want[name] += n
    want["bsmm_updat"] += times[1]
    want["bsmm_updat_reduce"] += times[1] * (op.updat_splits(N, dtype) > 1)
    return want


def add_counts(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def canonical_rows(bt, dev):
    """The canonical bench's rows: per (hidden, b), the op of each mode,
    the plain op and the W scale; with the plans' host times printed."""
    from blocksparse_tpu_torch.models.sparse_lstm import make_mask
    out = {}
    for k, target, bsizes in CANON_ROWS:
        hidden = k * CANON_UNIT
        for b in bsizes:
            n = hidden // b
            m = pick_m(n, target)
            t = time.perf_counter()
            lay = np.ones((n, n), np.int32) if m >= n else \
                make_mask(n, f"ba_{m}", seed=SEED)
            mask_s = time.perf_counter() - t
            ops, build = {}, []
            for mode in CANON_MODES:
                t = time.perf_counter()
                ops[mode] = bt.BlocksparseMatMul(lay, block_size=b,
                                                 feature_axis=0, mode=mode)
                build.append(time.perf_counter() - t)
            plain = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=0,
                                         impl="xla")
            op = ops["auto"]
            t = time.perf_counter()
            for d in "fb":
                for kind in ("fine", "window"):
                    op._plan(kind, d)
                op._plan("split", d, 8)
            plan_s = time.perf_counter() - t
            print(f"canonical hidden {hidden} b{b}: BA m={m}, {op.blocks} "
                  f"blocks ({100 * op.blocks / n ** 2:.2f}%); host: layout "
                  f"{mask_s:.2f} s, op {max(build):.2f} s, fine + window + "
                  f"split plans (fprop and bprop, NumPy) {plan_s:.3f} s",
                  flush=True)
            e = op.blocks / n                    # entries of an output column
            out[(hidden, b)] = (ops, plain, float(np.sqrt(3.0 / (b * e))))
    return out


def canonical_split_checks(op, x, w, dev, g, card_line, rows):
    """The fused split at the canonical hidden-2560 row's split (N 64, b32,
    bf16 or f16 x and w): fprop and bprop two runs bit-equal and bit for
    bit against bsmm_partials + bsmm_merge; in bf16 the fprop's time
    against theirs, in turns, by the profiler and by CUDA events."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    sms = bk.device_sm_count(dev)
    lut = op._lut(dev)
    for d in "fb":
        a = x if d == "f" else torch.randn(
            (CANON_N, op.K), device=dev, generator=g).to(x.dtype)
        n_out = op.KB if d == "f" else op.CB
        phases = op._phases(CANON_N, d, sms)
        check(phases > 1, f"hidden {op.C} b32 N={CANON_N} {d}prop takes the "
                          f"split route ({phases} runs)")
        p = op._plan_tensors(dev, "split", d, phases)
        ents = (lut[f"{d}_ent_in"], lut[f"{d}_ent_w"])

        def fused():
            return bk.bsmm_split(a, w, p["tile_ptr"], *ents, p["merge_idx"],
                                 32, n_out, d == "b")

        def parent():
            return bk.bsmm_merge(bk.bsmm_partials(
                a, w, p["tile_ptr"], *ents, 32, p["tile_ptr"].numel() - 1,
                d == "b"), p["merge_idx"], 32, x.dtype)
        what = (f"bsmm_split hidden {op.C} b32 N={CANON_N} {d}prop, clusters "
                f"of P={p['merge_idx'].shape[1]} {x.dtype}")
        same_bits(what, fused)
        check(torch.equal(fused(), parent()), f"{what}: equal bit for bit "
                                              f"to bsmm_partials + bsmm_merge")
        if x.dtype != torch.bfloat16 or d != "f":
            continue
        routes = {"fused": fused, "parent": parent}
        dev_ms = in_turns(routes, lambda fn: device_ms_per_call(
            fn, lambda k: "bsmm_xprop" in k or "bsmm_merge" in k))
        ev_ms = in_turns(routes, lambda fn: time_ms(fn, 200))
        rows["canon_split"] = (dev_ms, ev_ms)
        print(f"{what} [{card_line}]: fused device "
              f"{' / '.join(f'{v:.4f}' for v in dev_ms['fused'])} ms "
              f"(profiler, mean of 20), parent partials + merge "
              f"{' / '.join(f'{v:.4f}' for v in dev_ms['parent'])}; by events "
              f"fused {' / '.join(f'{v:.4f}' for v in ev_ms['fused'])}, parent "
              f"{' / '.join(f'{v:.4f}' for v in ev_ms['parent'])} (in turns)",
              flush=True)


def mode_kernel_checks(rows_in, win_op, dev, g, card_line, rows):
    """bsmm_fine, bsmm_window and bsmm_merge against their plain versions
    (f32, bf16, f16; fprop and bprop) at the path's shapes: fine at the
    canonical hidden-7680 rows, window at its regime (N 256), merge on the
    canonical hidden-2560 split (its device time also from the profiler:
    at 1 MB the event time is the launch rate).  In f32 fine and window
    also against the unsplit kernel, bit for bit.  On the same split, in
    bf16 and f16, the fused route (bsmm_split) fprop and bprop bit for bit
    against partials + merge, and in bf16 its time against theirs, in
    turns, by the profiler and by CUDA events."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def xprop_cases(op, N, kind):
        lut = op._lut(dev)
        for d in "fb":
            n_out, n_in = (op.KB, op.C) if d == "f" else (op.CB, op.K)
            p = op._plan_tensors(dev, kind, d)
            args = ((p["chunk_ptr"], p["slot_in"], p["slot_w"]) if
                    kind == "fine" else (p["ptr"], p["ent_slot"], p["ent_w"]))
            kern = bk.bsmm_fine if kind == "fine" else bk.bsmm_window
            unsplit = bk.bsmm_bprop if d == "b" else bk.bsmm_fprop
            # the bf16/f16 kernel the op's rule picks (f32: bsmm_<kind>.cu)
            src = op.kernel_of(N, d)
            route = ({"kernel": src.rsplit("_", 1)[1]} if kind == "fine" else
                     {"plan": op._plan_tensors(dev, "window_wgmma", d)
                      if src.endswith("_wgmma") else None})
            for dtype in DTYPES:
                x = torch.randn((N, n_in), device=dev, generator=g).to(dtype)
                w = (torch.randn(op.w_shape, device=dev, generator=g)
                     * 0.1).to(dtype)

                def run():
                    return kern(x, w, *args, op.bsize, n_out, d == "b",
                                **route)

                def plain():
                    return bk.xprop_plain(
                        x, w, lut[f"{d}_in"], lut[f"{d}_w"], lut[f"{d}_out"],
                        n_out, op.bsize, 1, trans_w=d == "b")
                what = (f"bsmm_{kind} {'fprop' if d == 'f' else 'bprop'} "
                        f"b{op.bsize} N={N} {n_in} -> {n_out * op.bsize} "
                        f"{op.blocks} blocks {dtype} on "
                        f"{op.kernel_of(N, d, dtype)}.cu")
                y = run()
                err = compare(what, y, plain(), TOL[dtype])
                same = torch.equal(y, unsplit(
                    x, w, lut[f"{d}_row_ptr"], lut[f"{d}_ent_in"],
                    lut[f"{d}_ent_w"], op.bsize, n_out,
                    plan=op._xlaunch(dev, d, N)))
                if dtype == torch.float32:
                    check(same, f"{what}: equal to the unsplit kernel bit "
                                f"for bit")
                else:
                    print(f"      equal to the unsplit kernel: {same}",
                          flush=True)
                if d == "f":
                    timed(rows, (kind, op.bsize, N, dtype), err, run, plain,
                          50, card_line)
                if d == "f" and dtype == torch.bfloat16:
                    # the kernel's own time: at these shapes the host's
                    # enqueue of a launch can take longer than the kernel
                    ms = kernel_device_ms(run, f"{src}_kernel")
                    grp = kernel_device_ms(lambda: unsplit(
                        x, w, lut[f"{d}_row_ptr"], lut[f"{d}_ent_in"],
                        lut[f"{d}_ent_w"], op.bsize, n_out,
                        plan=op._xlaunch(dev, d, N)),
                        "bsmm_xprop_mma_kernel")     # no wgmma plan given
                    key = (kind, op.bsize, N, dtype)
                    rows[key] = (rows[key][0], ms, rows[key][2])
                    print(f"      device time (profiler, mean of 20): "
                          f"{src} {ms:.4f} ms "
                          f"({xprop_flops(op, N) / ms / 1e9:.2f} TFLOP/s), "
                          f"unsplit (grouped) {grp:.4f} ms [{card_line}]",
                          flush=True)
                del x, w, y

    small, dense = (CANON_ROWS[0][0] * CANON_UNIT, CANON_ROWS[1][0]
                    * CANON_UNIT)
    for b in CANON_ROWS[0][2]:
        xprop_cases(rows_in[(small, b)][0]["fine"], CANON_N, "fine")
    xprop_cases(win_op, WIN_NS[0], "window")

    op = rows_in[(dense, 32)][0]["auto"]
    lut = op._lut(dev)
    phases = op._phases(CANON_N, "f", sms)
    check(phases > 1, f"hidden {dense} b32 N={CANON_N} takes the split route "
                      f"({phases} runs) on {sms} SMs")
    p = op._plan_tensors(dev, "split", "f", phases)
    idx = p["merge_idx"]
    n_tiles = p["tile_ptr"].numel() - 1
    for dtype in DTYPES:
        x = torch.randn((CANON_N, op.C), device=dev, generator=g).to(dtype)
        w = (torch.randn(op.w_shape, device=dev, generator=g) * 0.1).to(dtype)
        tiles = bk.bsmm_partials(x, w, p["tile_ptr"], lut["f_ent_in"],
                                 lut["f_ent_w"], 32, n_tiles,
                                 plan=op._xlaunch(dev, "f", CANON_N, phases))
        if dtype != torch.float32:
            canonical_split_checks(op, x, w, dev, g, card_line, rows)
        what = (f"bsmm_merge hidden {dense} b32 N={CANON_N}, {n_tiles - 1} "
                f"tiles of {op.KB} columns, P={idx.shape[1]}, out {dtype}")
        y = bk.bsmm_merge(tiles, idx, 32, dtype)
        err = compare(what + " (exact)", y,
                      bk.merge_plain(tiles, idx.long(), 32, dtype), 0.0)
        compare(f"split route (partials + merge) {dtype} against "
                f"xprop_plain", y, bk.xprop_plain(
                    x, w, lut["f_in"], lut["f_w"], lut["f_out"], op.KB, 32,
                    1), TOL[dtype])
        timed(rows, ("merge", dtype), err,
              lambda: bk.bsmm_merge(tiles, idx, 32, dtype),
              lambda: bk.merge_plain(tiles, idx.long(), 32, dtype), 200,
              card_line)
        if dtype == torch.bfloat16:
            # one library call of the same sums: index_add_ of every tile
            # into its column (f32, another order, no cast)
            tile_col = torch.repeat_interleave(
                torch.arange(op.KB, device=dev),
                (idx != n_tiles - 1).sum(1))
            t3 = tiles.view(CANON_N, n_tiles, 32)[:, :n_tiles - 1]
            buf = torch.empty((CANON_N, op.KB, 32), device=dev)
            rows["merge_lib"] = time_ms(
                lambda: buf.zero_().index_add_(1, tile_col, t3), 200)
            rows["merge_shape"] = (n_tiles - 1, idx.shape[1])
            dev_ms = device_ms_per_call(
                lambda: bk.bsmm_merge(tiles, idx, 32, dtype),
                lambda k: "bsmm_merge_kernel" in k)
            lib_dev = device_ms_per_call(
                lambda: buf.zero_().index_add_(1, tile_col, t3),
                lambda k: True)
            print(f"      index_add_ of the tiles {rows['merge_lib']:.4f} ms "
                  f"by events, {lib_dev:.4f} ms device (profiler, mean of "
                  f"20; its fill and add kernels); merge device time "
                  f"{dev_ms:.4f} ms [{card_line}]", flush=True)
        del x, w, tiles, y
    torch.cuda.empty_cache()


# name fragments of the kernels each route of a fprop launches
ROUTE_KERNELS = {"fine": ("bsmm_fine",), "window": ("bsmm_window",),
                 "grouped": ("bsmm_xprop",),
                 "phased": ("bsmm_xprop", "bsmm_merge")}


def canonical_path(rows_in, dev, g, card_line, rows):
    """The canonical rows' chains in each mode, counted, held against the
    plain chain and timed per application beside the dense control.
    Returns the launches."""
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    total = {}
    for (hidden, b), (ops, plain, scale) in rows_in.items():
        rng = np.random.RandomState(7)
        x0 = torch.as_tensor(rng.uniform(-1, 1, (hidden, CANON_N)),
                             device=dev).to(bf)
        w0 = ((torch.rand(plain.w_shape, device=dev, generator=g) * 2 - 1)
              * scale).to(bf)
        with torch.no_grad():
            y_ref = chain(plain, x0, w0)
        refs = chain_grads(plain, x0, w0)
        wd = dense_weight(plain, w0).t().contiguous()     # y = wd . x
        with torch.no_grad():
            dense_ms = time_ms(lambda: chain(lambda a, _: wd @ a, x0, None),
                               CANON_TIMED) / CANON_DEPTH
        for mode, op in ops.items():
            what = (f"canonical hidden {hidden} b{b} N={CANON_N} mode "
                    f"{mode} ({op.dispatch_mode(CANON_N)})")
            with torch.no_grad():
                chain(op, x0, w0)                      # warm-up: LUTs, plans
            chain_grads(op, x0, w0)
            torch.cuda.synchronize()
            reset_counts()
            with torch.no_grad():
                y = chain(op, x0, w0)
            got = chain_grads(op, x0, w0)
            torch.cuda.synchronize()
            launches = read_counts()
            want = route_launches(op, CANON_N, sms,
                                  (2 * CANON_DEPTH, CANON_DEPTH))
            check(launches == want, f"{what}: chain fwd + fwd/bwd launches "
                                    f"{launches}, expected {want}")
            add_counts(total, launches)
            if mode in ("fine", "window") and op.dispatch_mode(CANON_N) \
                    == mode:
                # fprop's launches: the chain and the gradients' chain
                wg = read_mode_wgmma()
                want_wg = sum(n for d, n in (("f", 2 * CANON_DEPTH),
                                             ("b", CANON_DEPTH))
                              if op.kernel_of(CANON_N, d).endswith("_wgmma"))
                packs = wg["window_wgmma_pack"] if mode == "window" \
                    else want_wg
                check(wg[f"bsmm_{mode}"] == want_wg == packs,
                      f"{what}: {wg[f'bsmm_{mode}']} launches on "
                      f"bsmm_{mode}_wgmma.cu, expected {want_wg} (the "
                      f"window's packings {wg['window_wgmma_pack']})")
                add_counts(total, {(f"bsmm_{mode}", "wgmma"):
                                   wg[f"bsmm_{mode}"],
                                   "window_wgmma_pack":
                                   wg["window_wgmma_pack"]})
            if mode == "grouped":
                # the unsplit launches by kernel source (wrapper, source)
                wg = read_wgmma()
                for d, key in (("f", "bsmm_fprop"), ("b", "bsmm_bprop"),
                               ("u", "bsmm_updat")):
                    src = op.kernel_of(CANON_N, d)
                    check((wg[key] > 0) == on_wgmma(src),
                          f"{what}: {key} on {src} ({wg[key]} wgmma "
                          f"launches of {launches[key]})")
                    add_counts(total, {(key, src): launches[key]})
            compare(f"{what}: chain output against impl=xla", y, y_ref,
                    CHAIN_TOL)
            for name, a, r in zip(("y", "dx", "dw"), got, refs):
                compare(f"{what}: fwd/bwd {name} against impl=xla", a, r,
                        CHAIN_TOL)
            with torch.no_grad():
                fwd_ms = time_ms(lambda: chain(op, x0, w0),
                                 CANON_TIMED) / CANON_DEPTH
            fb_ms = time_ms(lambda: chain_grads(op, x0, w0),
                            CANON_TIMED) / CANON_DEPTH
            # the route's kernels' own time: below ~0.1 ms an application
            # the chain's time is the host's enqueue
            keys = ROUTE_KERNELS[op.dispatch_mode(CANON_N)]
            with torch.no_grad():
                _, kernels = device_events(
                    lambda: chain(op, x0, w0), lambda ks: any(
                        k in e.key for k in keys for e in ks))
            dev_ms = sum(e.self_device_time_total for e in kernels
                         if any(k in e.key for k in keys)) / CANON_DEPTH / 1e3
            flops = 2 * CANON_N * op.blocks * b * b
            print(f"{what} [{card_line}]: {fwd_ms:.4f} ms forward "
                  f"({flops / fwd_ms / 1e9:.2f} TFLOP/s; kernels' device "
                  f"time {dev_ms:.4f} ms, profiler), {fb_ms:.4f} ms "
                  f"forward + backward a application; dense torch.matmul "
                  f"{hidden}^2 x {CANON_N} {dense_ms:.4f} ms", flush=True)
            del y, got
        del x0, w0, y_ref, refs, wd
        torch.cuda.empty_cache()
    add_counts(total, canonical_f32_split(rows_in, dev, g, card_line))
    return total


def canonical_f32_split(rows_in, dev, g, card_line):
    """The canonical hidden-2560 row's chains in f32, mode "auto": the
    split route's f32 form (bsmm_partials, then bsmm_merge, exact on the
    CUDA cores), counted, held against the same chains on impl="xla" in
    f32.  Returns the launches."""
    hidden = CANON_ROWS[1][0] * CANON_UNIT
    ops, plain, scale = rows_in[(hidden, 32)]
    op = ops["auto"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rng = np.random.RandomState(7)
    x0 = torch.as_tensor(rng.uniform(-1, 1, (hidden, CANON_N)), device=dev,
                         dtype=torch.float32)
    w0 = (torch.rand(plain.w_shape, device=dev, generator=g) * 2 - 1) * scale
    what = (f"canonical hidden {hidden} b32 N={CANON_N} mode auto "
            f"({op.dispatch_mode(CANON_N)}) f32")
    with torch.no_grad():
        y_ref = chain(plain, x0, w0)
        chain(op, x0, w0)                              # warm-up
    refs = chain_grads(plain, x0, w0)
    chain_grads(op, x0, w0)
    torch.cuda.synchronize()
    reset_counts()
    with torch.no_grad():
        y = chain(op, x0, w0)
    got = chain_grads(op, x0, w0)
    torch.cuda.synchronize()
    launches = read_counts()
    want = route_launches(op, CANON_N, sms, (2 * CANON_DEPTH, CANON_DEPTH),
                          torch.float32)
    check(launches == want and launches["bsmm_merge"] > 0,
          f"{what}: chain fwd + fwd/bwd launches {launches}, expected {want}")
    compare(f"{what}: chain output against impl=xla", y, y_ref, F32_CHAIN_TOL)
    for name, a, r in zip(("y", "dx", "dw"), got, refs):
        compare(f"{what}: fwd/bwd {name} against impl=xla", a, r,
                F32_CHAIN_TOL)
    del x0, w0, y_ref, refs, y, got
    torch.cuda.empty_cache()
    return launches


def window_op(bt):
    """bench.py's headline layout: random 8192^2, b32, d 0.25, the
    diagonal set, from RandomState(0); W uniform in +-0.1."""
    nb = WIN_HIDDEN // WIN_BSIZE
    rng = np.random.RandomState(0)
    lay = (rng.rand(nb, nb) < WIN_DENSITY).astype(np.int32)
    lay[np.arange(nb), np.arange(nb)] = 1
    W = rng.uniform(-0.1, 0.1, (int(lay.sum()), WIN_BSIZE, WIN_BSIZE))
    ops = {m: bt.BlocksparseMatMul(lay, block_size=WIN_BSIZE, feature_axis=0,
                                   mode=m) for m in ("window", "grouped")}
    ops["plain"] = bt.BlocksparseMatMul(lay, block_size=WIN_BSIZE,
                                        feature_axis=0, impl="xla")
    return ops, W.astype(np.float32)


def window_path(ops, W, dev, g, card_line):
    """Window against grouped at N 256 and 2048, fprop and bprop, counted,
    each within TOL of the plain op (in bf16 grouped sums on the tensor
    cores, in another order than window); times in turns.  Returns the
    launches."""
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    w = torch.as_tensor(W, device=dev).to(bf)
    total = {}
    for N in WIN_NS:
        x = (torch.rand((WIN_HIDDEN, N), device=dev, generator=g) * 2
             - 1).to(bf)
        for m in ("window", "grouped"):
            ops[m]._xprop(x, w, "f")                     # warm-up
        torch.cuda.synchronize()
        outs = {}
        for m in ("window", "grouped"):
            reset_counts()
            outs[m] = (ops[m]._xprop(x, w, "f"), ops[m]._xprop(x, w, "b"))
            torch.cuda.synchronize()
            launches = read_counts()
            want = route_launches(ops[m], N, sms, (1, 1))
            want["bsmm_updat"] = want["bsmm_updat_reduce"] = 0
            if m == "window":
                wg = read_mode_wgmma()
                on = ops[m].kernel_of(N, "f").endswith("_wgmma")
                check(launches == want and wg["bsmm_window"] == 2 * on ==
                      wg["window_wgmma_pack"],
                      f"window regime N={N}: window launches {launches}, "
                      f"{wg['bsmm_window']} on bsmm_window_wgmma.cu "
                      f"(packings {wg['window_wgmma_pack']})")
                add_counts(total, launches)
                add_counts(total, {("bsmm_window", "wgmma"):
                                   wg["bsmm_window"],
                                   "window_wgmma_pack":
                                   wg["window_wgmma_pack"]})
        for i, d in enumerate("fb"):
            ref = ops["plain"]._xprop(x, w, d)
            for m in ("window", "grouped"):
                compare(f"window regime N={N} {d}prop {m} against impl=xla",
                        outs[m][i], ref, TOL[bf])
        times = {"window": [], "grouped": []}
        for m in ("window", "grouped", "grouped", "window"):
            times[m].append((time_ms(lambda: ops[m]._xprop(x, w, "f"), 10),
                             time_ms(lambda: ops[m]._xprop(x, w, "b"), 10)))
        flops = 2 * N * ops["plain"].blocks * WIN_BSIZE ** 2
        kern = {"window": kernel_of(ops["window"], N, "f")[0],
                "grouped": kernel_of(ops["grouped"], N, "f")[0]}
        dev_ms = {"window": [], "grouped": []}
        for m in ("window", "grouped", "grouped", "window"):
            dev_ms[m].append(kernel_device_ms(
                lambda: ops[m]._xprop(x, w, "f"), kern[m], 10))
        print(f"window regime N={N} fprop device time (profiler, mean of "
              f"10; turns window, grouped, grouped, window) [{card_line}]: "
              + "; ".join(f"{m} " + " ".join(f"{t:.4f}" for t in v)
                          + f" ms ({flops / min(v) / 1e9:.2f} TFLOP/s)"
                          for m, v in dev_ms.items()), flush=True)
        window_tile_sweep(ops, x, w, N, flops, card_line)
        print(f"window regime {WIN_HIDDEN}^2 b{WIN_BSIZE} d{WIN_DENSITY} "
              f"N={N} [{card_line}]: "
              + "; ".join(f"{m} fprop " + " ".join(f"{f:.4f}" for f, _ in t)
                          + " ms, bprop " + " ".join(f"{b:.4f}" for _, b in t)
                          + f" ms ({flops / min(f for f, _ in t) / 1e9:.2f} "
                          f"TFLOP/s fprop)" for m, t in times.items())
              + " (turns window, grouped, grouped, window)", flush=True)
        # the bound and the dense product beside them (a generator of its
        # own: the phases after this one draw what they drew before)
        ms, by, lib = dense_yardstick(
            ops["plain"], N, dev,
            torch.Generator(device=dev).manual_seed(SEED + N))
        print(f"window regime N={N}: bound {ms:.4f} ms ({by}); dense "
              f"torch.matmul of the scattered layout {lib:.4f} ms "
              f"[{card_line}]", flush=True)
        del x, outs
    torch.cuda.empty_cache()
    return total


def window_tile_sweep(ops, x, w, N, flops, card_line):
    """The tensor-core window kernel the rule picks, its fprop at each
    N-tile it is built for (window_tn replaced for the sweep), each within
    TOL of the plain op, with its device time: what the N-tile rule trades
    (W re-read per N-tile against thread blocks to fill the SMs)."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    bf, op = torch.bfloat16, ops["window"]
    src = op.kernel_of(N, "f")
    if src.endswith("_wgmma"):
        print(f"window regime N={N}: {src}.cu keeps one N-tile, "
              f"{bk.WINDOW_WG_TN} rows (its tiles fill the card where the "
              f"rule takes it): no sweep", flush=True)
        return
    n_sg = -(-op.KB // bk.WINDOW_SG[op.bsize])
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    ref = ops["plain"]._xprop(x, w, "f")
    rule, times = bk.window_tn, {}
    try:
        for tn in bk.WINDOW_TNS:
            bk.window_tn = lambda *_: tn
            compare(f"window regime N={N} fprop on {src}.cu, N-tile {tn}",
                    op._xprop(x, w, "f"), ref, TOL[bf])
            times[tn] = kernel_device_ms(lambda: op._xprop(x, w, "f"),
                                         f"{src}_kernel", 10)
    finally:
        bk.window_tn = rule
    print(f"window regime N={N} fprop device time by N-tile [{card_line}]: "
          + ", ".join(f"TN {tn} ({-(-N // tn) * n_sg} thread blocks) "
                      f"{ms:.4f} ms ({flops / ms / 1e9:.2f} TFLOP/s)"
                      for tn, ms in times.items())
          + f"; window_tn picks {rule(N, n_sg, sms)}", flush=True)


def dense_yardstick(op, N, dev, g):
    """(bound ms, "operations" or "bytes", library ms) of ``op``'s bf16
    product at N rows: the bound of the block-sparse product (x and y
    read and written once, each weight block once), the library call a
    dense torch.matmul of the layout scattered into its (C, K) matrix."""
    bf, b2 = torch.bfloat16, op.bsize ** 2
    x = torch.randn((N, op.C), device=dev, generator=g).to(bf)
    wd = dense_weight(op, (torch.randn(op.w_shape, device=dev, generator=g)
                           * 0.1).to(bf))
    lib = time_ms(lambda: x @ wd, 20)
    return (*bound(2 * N * op.blocks * b2,
                   2 * (N * op.C + op.blocks * b2 + N * op.K)), lib)


def mode_yardsticks(rows_in, win, dev, g, card_line, rows):
    """Bound and library call of the three mode kernels at their kernels-
    line shapes: fine at canonical b8 N 64, window at its regime N 256
    (bf16; a dense torch.matmul of the scattered layout for both), merge
    at the canonical hidden-2560 split (f32 out; index_add_ of the
    tiles)."""
    bf = torch.bfloat16
    out = {}
    small, dense = (CANON_ROWS[0][0] * CANON_UNIT, CANON_ROWS[1][0]
                    * CANON_UNIT)
    for name, op, N in (("bsmm_fine", rows_in[(small, 8)][1], CANON_N),
                        ("bsmm_window", win, WIN_NS[0])):
        out[name] = dense_yardstick(op, N, dev, g)
    # the merge's row is its f32 form (the fused split took over bf16/f16)
    n_real, P = rows["merge_shape"]
    K = rows_in[(dense, 32)][1].K
    out["bsmm_merge"] = (*bound(CANON_N * 32 * (n_real - K // 32),
                                4 * CANON_N * 32 * n_real + 4 * CANON_N * K,
                                PEAK_F32_FLOPS), rows["merge_lib"])
    for name, (ms, by, lib) in out.items():
        print(f"{name}: bound {ms:.4f} ms ({by}); library call "
              f"{lib:.4f} ms [{card_line}]", flush=True)
    torch.cuda.empty_cache()
    return out


# The unfused attention ops (kernels/bst_trio.py): their kernels against
# their plain versions at small shapes (every block size, per-head and
# shared layouts, an empty query row and key row, strided q/k/v) and at the
# LM's (batch 8 x 2048, blk 64, fixed layout, causal sub-block masks) with
# 2 heads of 256 and 8 heads of 64, then the enwik8 LM at 2 heads of 256
# (the head count at which the JAX package takes the unfused ops; the
# repo has no public configuration past hs 128, so the published widths
# stay and only n_head changes) down its serving and training paths,
# counted, against the same model on the plain versions; and the trio
# against the fused kernels at the flagship's 8 heads of 64.
WIDE_HEADS = 2
WIDE_STEPS = 4           # captured train steps of the hs-256 LM
TRIO_HEADS = 2
# The redesigned kernels' edges: NT's head sizes around its 64-column
# chunks of the head and at its limit; NN/TN past one 256-column group;
# (block size, blocks) of layouts whose query row 0 and key row 0 hold
# every block, cut in two by the launch plan.
TRIO_NT_HS, TRIO_XN_HS = (8, 72, 136, 264, 512), 320
TRIO_LONG = ((64, 36), (8, 68))
# The first tensor-core trio kernels' times at the LM's hs-256 shape
# (bf16, CUDA events around eager calls, mean of 20; the low ends of three
# runs of this script with those kernels), and the card they ran on
TRIO_PREV_MS = {"bst_nt": 0.1208, "bst_xn": 0.0987, "bst_xn_tn": 0.1140}
TRIO_PREV_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def trio_op(bt, bs, blks, heads, per_head, seed):
    """A random layout (one a head with ``per_head``, the same block count
    in each) whose query row 1 and key row 2 hold no block and whose
    query row 0 holds blks - 1 entries (more than the xn kernels' ring of
    three stages at every block size), under causal sub-block masks."""
    from blocksparse_tpu_torch.models.sparse_transformer import (
        causal_subblock_mask)
    rng = np.random.RandomState(seed)
    lays = []
    for _ in range(heads if per_head else 1):
        lay = (rng.rand(blks, blks) < 0.4).astype(np.int32)
        lay[0, :] = 1
        lay[1, :] = 0
        lay[:, 2] = 0
        lays.append(lay)
    want = min(int(lay.sum()) for lay in lays)
    for lay in lays:
        on = np.argwhere(lay[2:])[:int(lay.sum()) - want] + [2, 0]
        lay[on[:, 0], on[:, 1]] = 0
    return bt.BlocksparseTransformer(
        np.array(lays) if per_head else lays[0], block_size=bs, heads=heads,
        mask_callback=causal_subblock_mask)


def long_row_op(bt, bs, blks, per_head, seed):
    """A sparse random layout (the same block count in each head) whose
    query row 0 and key row 0 hold every block but one, far past twice
    the mean (the launch plan cuts both in two); query row 1 and key row
    2 hold none."""
    from blocksparse_tpu_torch.models.sparse_transformer import (
        causal_subblock_mask)
    rng = np.random.RandomState(seed)
    lays = []
    for _ in range(TRIO_HEADS if per_head else 1):
        lay = (rng.rand(blks, blks) < 0.1).astype(np.int32)
        lay[1, :] = 0
        lay[:, 2] = 0
        lay[0, :] = 1
        lay[:, 0] = 1
        lay[1, 0] = lay[0, 2] = 0
        lays.append(lay)
    want = min(int(lay.sum()) for lay in lays)
    for lay in lays:
        on = np.argwhere(lay[3:, 3:])[:int(lay.sum()) - want] + 3
        lay[on[:, 0], on[:, 1]] = 0
    op = bt.BlocksparseTransformer(
        np.array(lays) if per_head else lays[0], block_size=bs,
        heads=TRIO_HEADS, mask_callback=causal_subblock_mask)
    from blocksparse_tpu_torch.kernels import bst_trio
    tri = bst_trio.trio_tables(op.nt_list, blks, blks)
    for name in ("plan", "plan_t"):
        items = tri[name][op.lut_heads * (blks + 1):]
        check(bool((items[items >= 0] % 4 == bst_trio.FIRST).any()),
              f"b{bs} {blks} blocks: the launch plan ({name}) cuts the "
              f"longest row in two")
    return op


def plain_twin(op):
    """The same attention op on the plain versions (impl="xla")."""
    import copy
    twin = copy.copy(op)
    twin.impl = "xla"
    return twin


def trio_cases(op, dtype, hs, batch, g, dev):
    """(name, fn(op) -> tensor) of nt, nn and tn on q, k, v sliced from one
    packed qkv and random scores w."""
    H, ctx = op.heads, op.ctx_blks_q * op.blk_size
    qkv = torch.randn((batch, ctx, 3 * H * hs), device=dev,
                      generator=g).to(dtype)
    q, k, v = qkv.split(H * hs, dim=-1)
    w = (torch.randn((batch, H, op.blocks, op.blk_size, op.blk_size),
                     device=dev, generator=g) * 0.1).to(dtype)
    return [("bst_nt", lambda o: o.nt_op(q, k)),
            ("bst_xn", lambda o: o.nn_op(w, v)),
            ("bst_xn_tn", lambda o: o.tn_op(w, q))], (q, k, v, w)


def trio_kernel_checks(bt, dev, g, card_line, rows):
    """(a) nt, nn and tn on their kernels against the plain twin: every
    block size, shared and per-head layouts, f32, bf16 and f16, at hs 64;
    then at the LM's shapes at hs 256 (2 heads) and hs 64 (8 heads), two
    runs equal bit for bit, timed (bf16 at hs 256: the kernels line's
    rows) beside the library yardstick (a batched torch.matmul over the
    blocks gathered beforehand, the gather timed separately)."""
    from blocksparse_tpu_torch.models.sparse_transformer import (
        causal_subblock_mask, fixed_layout)
    for dtype in DTYPES:
        for bs in (8, 16, 32, 64):
            for per_head in (False, True):
                op = trio_op(bt, bs, 4 + 3 * 64 // bs, TRIO_HEADS, per_head,
                             SEED + bs)
                cases, _ = trio_cases(op, dtype, 64, 2, g, dev)
                twin = plain_twin(op)
                for name, fn in cases:
                    what = (f"{name} b{bs} hs 64 "
                            f"{'per-head' if per_head else 'shared'} layout "
                            f"(empty query row 1, key row 2) {dtype}")
                    compare(what, fn(op), fn(twin), TOL[dtype])
                    same_bits(what, lambda: fn(op))
    trio_edge_checks(bt, dev, g)
    blks = 2048 // 64
    layout = fixed_layout(blks, local_blocks=8)
    for heads, hs in ((WIDE_HEADS, 512 // WIDE_HEADS), (8, 64)):
        op = bt.BlocksparseTransformer(layout, block_size=64, heads=heads,
                                       mask_callback=causal_subblock_mask)
        twin = plain_twin(op)
        for dtype in DTYPES:
            cases, (q, k, v, w) = trio_cases(op, dtype, hs, BATCH, g, dev)
            for name, fn in cases:
                what = (f"{name} batch {BATCH} ctx 2048 b64 {heads} heads of "
                        f"{hs} (the LM's layout) {dtype}")
                err = compare(what, fn(op), fn(twin), TOL[dtype])
                same_bits(what, lambda: fn(op))
                if dtype == torch.bfloat16 and hs == 256:
                    ms = graph_ms(lambda: fn(op), 20)
                    eager = time_ms(lambda: fn(op), 20)
                    plain_ms = time_ms(lambda: fn(twin), 5)
                    flops = 2 * op.blocks * BATCH * heads * 64 ** 2 * hs
                    print(f"      kernel {ms:.4f} ms of device time (20 "
                          f"calls as one CUDA graph between CUDA events; "
                          f"{flops / ms / 1e9:.2f} TFLOP/s), {eager:.4f} ms "
                          f"a call enqueued eagerly (the host's), plain "
                          f"{plain_ms:.4f} ms [{card_line}]", flush=True)
                    rows[(name, "wide")] = (err, ms, plain_ms)
                    rows[(name, "wide_eager")] = eager
            if dtype == torch.bfloat16 and hs == 256:
                rows["trio_marks"] = trio_marks(op, q, k, v, w, hs)
            del cases, q, k, v, w
        torch.cuda.empty_cache()
    for name, prev in TRIO_PREV_MS.items():
        _, ms, _ = rows[(name, "wide")]
        b, by, lib = rows["trio_marks"][name]
        print(f"{name} (redesigned) at the LM's hs-256 shape, bf16: {ms:.4f} "
              f"ms of device time, {rows[(name, 'wide_eager')]:.4f} ms a call "
              f"enqueued eagerly [{card_line}]; the first kernel's record "
              f"{prev:.4f} ms (eager calls) [{TRIO_PREV_CARD}]; "
              f"{b / ms:.0%} of its bound {b:.4f} ms ({by}); library "
              f"yardstick {lib:.4f} ms (one CUDA graph likewise)", flush=True)


def trio_edge_checks(bt, dev, g):
    """The redesigned kernels' edges against the plain twin, two runs equal
    bit for bit, f32, bf16 and f16: NT at TRIO_NT_HS (b16, per-head
    layout with an empty row); NN and TN at TRIO_XN_HS at every block
    size; all three on TRIO_LONG's layouts, shared and per head."""
    for dtype in DTYPES:
        cases = []
        for hs in TRIO_NT_HS:
            op = trio_op(bt, 16, 6, TRIO_HEADS, True, SEED + hs)
            (nt, _, _), _ = trio_cases(op, dtype, hs, 2, g, dev)
            cases.append((f"b16 hs {hs} per-head layout", op, [nt]))
        for bs in (8, 16, 32, 64):
            op = trio_op(bt, bs, 5, TRIO_HEADS, True, SEED + bs)
            (_, nn, tn), _ = trio_cases(op, dtype, TRIO_XN_HS, 2, g, dev)
            cases.append((f"b{bs} hs {TRIO_XN_HS} per-head layout", op,
                          [nn, tn]))
        for bs, blks in TRIO_LONG:
            for per_head in (False, True):
                op = long_row_op(bt, bs, blks, per_head, SEED + blks)
                fns, _ = trio_cases(op, dtype, 64, 2, g, dev)
                cases.append((f"b{bs} hs 64 rows of {blks - 1} entries cut "
                              f"in two, {'per-head' if per_head else 'shared'}"
                              f" layout", op, fns))
        for what, op, fns in cases:
            twin = plain_twin(op)
            for name, fn in fns:
                label = f"{name} {what} {dtype}"
                compare(label, fn(op), fn(twin), TOL[dtype])
                same_bits(label, lambda: fn(op))
    torch.cuda.empty_cache()


# the trio's tensor-core kernels' mangled names: kernel, dtype, B (none for
# the b64 wgmma kernel bst_xn_wg_kernel), and for xn TRANS and the column
# group
_TRIO_PTXAS = re.compile(r"(bst_(?:nt|xn)_(?:mma|wg)_kernel)I"
                         r"(13__nv_bfloat16|6__half)(?:Li(\d+)E)?"
                         r"(?:Lb([01])ELi(\d+)E)?")


def trio_ptxas_report():
    """Registers and spills of the redesigned kernels' instantiations
    (ptxas): every b64 one by name, the rest summed; fails if none was
    built."""
    for source in ("bst_nt_mma", "bst_xn_mma"):
        found = []
        for entry, (regs, st, ld) in ptxas_entries(source).items():
            m = _TRIO_PTXAS.search(entry)
            if m:
                kernel, dt, bs, trans, cw = m.groups()
                dt = "bf16" if dt.startswith("13") else "f16"
                bs = bs or "64"
                name = (f"{dt} b{bs}" + ("" if trans is None else
                                         f" {'TN' if trans == '1' else 'NN'}"
                                         f" CW {cw}"))
                found.append((int(bs), name, regs, st, ld))
        check(bool(found), f"{source}.cu: its kernels built")
        for bs, name, regs, st, ld in sorted(found):
            if bs == 64:
                print(f"{source}.cu {name}: {regs} registers, spill stores "
                      f"{st} B, spill loads {ld} B", flush=True)
        spilled = [n for _, n, _, st, ld in found if st or ld]
        print(f"{source}.cu: {len(found)} instantiations, "
              f"{min(f[2] for f in found)}-{max(f[2] for f in found)} "
              f"registers, spills in {len(spilled)} {spilled}", flush=True)


def trio_marks(op, q, k, v, w, hs):
    """Bound and library yardstick of nt, nn and tn at the LM's hs-256
    shape (bf16): bytes = each input read once, each output written once;
    operations 2·batch·heads·blocks·bs²·hs.  The yardstick is one batched
    torch.matmul over the layout's blocks gathered beforehand, timed as
    the kernels are (20 calls as one CUDA graph; the gather timed and
    printed beside it)."""
    bs, H, B = op.blk_size, op.heads, q.shape[0]
    tab = op._tables(q.device)
    hidx = torch.arange(H, device=q.device)[:, None]

    def gather(a, blk):
        return a.reshape(B, -1, bs, H, hs).permute(0, 3, 1, 2, 4)[
            :, hidx, blk.expand(H, -1)]
    gather_ms = time_ms(lambda: gather(q, tab["q_blk"]), 20)
    qg, kg, vg = gather(q, tab["q_blk"]), gather(k, tab["k_blk"]), \
        gather(v, tab["k_blk"])
    lib = {"bst_nt": graph_ms(lambda: torch.matmul(qg, kg.transpose(-1, -2)),
                              20),
           "bst_xn": graph_ms(lambda: torch.matmul(w, vg), 20),
           "bst_xn_tn": graph_ms(lambda: torch.matmul(w.transpose(-1, -2),
                                                      qg), 20)}
    act, scores = B * q.shape[1] * H * hs * 2, w.numel() * 2
    flops = 2 * w.numel() * hs
    out = {name: (*bound(flops, scores + 2 * act), lib[name])
           for name in lib}
    print(f"trio library yardstick: batched torch.matmul over the gathered "
          f"blocks nt {lib['bst_nt']:.4f} ms, nn {lib['bst_xn']:.4f} ms, tn "
          f"{lib['bst_xn_tn']:.4f} ms; one gather of q's blocks "
          f"{gather_ms:.4f} ms (not in those)", flush=True)
    for name, (ms, by, lb) in out.items():
        print(f"{name}: bound {ms:.4f} ms ({by}); library call {lb:.4f} ms",
              flush=True)
    return out


def wide_lm(bt, dev):
    """The enwik8 LM with n_head WIDE_HEADS (hs 256) and the same on the
    plain versions, weights from seed 0."""
    cfg = flagship_config(bt, n_head=WIDE_HEADS)
    model = bt.SparseTransformerLM(cfg, device=dev)
    plain = bt.SparseTransformerLM(cfg, device=dev, impl="xla")
    sd = bt.params_from_jax(bt.random_jax_params(model, seed=SEED), model)
    model.load_state_dict(sd)
    plain.load_state_dict(sd)
    return cfg, model, plain


def wide_lm_path(bt, dev, card_line):
    """(b) The hs-256 LM at full width down its paths, each counted: the
    forward (8 x 2048) and the prefill (4 x 2048), nt and nn once a layer
    and no fused kernel, logits against the plain model;
    generate_cached_scan (4 prompts x 64 tokens after 1024) equal to
    generate_cached's tokens, its decode logits held step by step against
    the plain model fed the same tokens; the captured train step (its
    first call: the warm-up's eager step and the captured step, each nt 3L
    and nn/tn 5L with recompute) against the eager step (bit for bit)
    and the plain model, then WIDE_STEPS - 1 replays with falling loss.
    Returns the
    launches summed over the counted runs."""
    cfg, model, plain = wide_lm(bt, dev)
    L = cfg.n_layer
    rng = np.random.RandomState(SEED)
    seq = torch.from_numpy(rng.randint(0, cfg.n_vocab,
                                       (BATCH, cfg.ctx + 1))).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    prompts = tokens[:PROMPTS, :PROMPT_LEN]
    full = torch.zeros((PROMPTS, cfg.ctx), dtype=torch.int64, device=dev)
    full[:, :PROMPT_LEN] = prompts
    what = (f"LM {WIDE_HEADS} heads of {model.hs} ({L} layers, ctx "
            f"{cfg.ctx}, bf16)")
    print(f"{what}: attention blocks {model.bst.blocks}; "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params",
          flush=True)
    model(tokens[:1])                              # warm-up: tables
    torch.cuda.synchronize()
    total = dict.fromkeys(read_counts(), 0)

    reset_counts()
    t = time.perf_counter()
    logits = model(tokens)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t
    fwd = read_counts()
    add_counts(total, fwd)
    fused = [k for k in fwd if k.startswith("bst_attn")]
    check(fwd["bst_nt"] == L and fwd["bst_xn"] == L and fwd["bst_xn_tn"] == 0
          and not any(fwd[k] for k in fused),
          f"{what}: forward {BATCH} x {cfg.ctx} launches bst_nt and bst_xn "
          f"L = {L} each, no fused attention kernel ({fwd}); "
          f"{fwd_s * 1e3:.1f} ms on the host clock")
    compare(f"{what}: forward logits against the plain model", logits,
            plain(tokens), MODEL_TOL)
    del logits

    reset_counts()
    lg, caches = model.prefill(full)
    torch.cuda.synchronize()
    pre = read_counts()
    add_counts(total, pre)
    check(pre["bst_nt"] == L and pre["bst_xn"] == L,
          f"{what}: prefill {PROMPTS} x {cfg.ctx} launches bst_nt and bst_xn "
          f"L each ({pre})")
    lg1, caches1 = plain.prefill(full)
    compare(f"{what}: prefill logits against the plain model", lg, lg1,
            MODEL_TOL)
    compare(f"{what}: prefill K/V caches against the plain model",
            torch.stack([c["v"] for c in caches]),
            torch.stack([c["v"] for c in caches1]), MODEL_TOL)
    del lg, lg1, caches, caches1

    gen = torch.Generator(device=dev).manual_seed(SEED)
    reset_counts()
    t = time.perf_counter()
    scan = bt.generate_cached_scan(model, prompts, NEW_TOKENS, generator=gen)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t
    scanned = read_counts()
    add_counts(total, scanned)
    check(scanned["bst_nt"] == L and scanned["bst_xn"] == L,
          f"{what}: generate_cached_scan ({PROMPTS} prompts x {NEW_TOKENS} "
          f"tokens after {PROMPT_LEN}) launches bst_nt and bst_xn L each in "
          f"its prefill, none in the decode ({scanned}); first call "
          f"{scan_s:.3f} s with the capture")
    out = bt.generate_cached(model, prompts, NEW_TOKENS,
                             generator=torch.Generator(
                                 device=dev).manual_seed(SEED))
    check(torch.equal(scan, out),
          f"{what}: generate_cached_scan tokens equal generate_cached's for "
          f"seed {SEED}")
    (_, c0), (_, c1) = model.prefill(full), plain.prefill(full)
    worst = 0.0
    for i in range(NEW_TOKENS):
        tok = scan[:, PROMPT_LEN + i]
        got, _ = model.decode_forward(tok, c0, PROMPT_LEN + i)
        ref, _ = plain.decode_forward(tok, c1, PROMPT_LEN + i)
        worst = max(worst, (got - ref).abs().max().item()
                    / (MODEL_TOL * max(1.0, ref.abs().max().item())))
    check(worst <= 1.0,
          f"{what}: decode logits against the plain model fed the scan's "
          f"tokens, {NEW_TOKENS} steps: worst step at {worst:.3f} of its "
          f"tolerance ({MODEL_TOL:g} x max(1, max|plain|))")
    del c0, c1
    model._decode_graphs.clear()
    torch.cuda.empty_cache()

    ls = torch.tensor(LOSS_SCALE, device=dev)
    opt = bt.AdamOptimizer(learning_rate=LR, zero_nans=True, zero_infs=True)
    step = model.make_train_step(opt, clip_norm=CLIP)
    before = snapshot(model)
    _, m_eager, sc_eager = step._eager(
        opt.init(dict(model.named_parameters())), tokens, targets, ls)
    d_eager = {k: v - before[k] for k, v in model.state_dict().items()}
    restore(model, before)
    state = opt.init(dict(model.named_parameters()))
    torch.cuda.synchronize()
    reset_counts()
    t = time.perf_counter()
    state, m0, scale = step(state, tokens, targets, ls)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    train = read_counts()
    add_counts(total, train)
    d0 = {k: v - before[k] for k, v in model.state_dict().items()}
    check(all(torch.equal(m0[k], m_eager[k]) for k in m0)
          and torch.equal(scale, sc_eager)
          and all(torch.equal(d0[k], d_eager[k]) for k in d0),
          f"{what}: the captured train step equals the eager step bit for "
          f"bit (metrics, loss scale, every parameter update; the trio's "
          f"kernels and the blocked softmax's row sums add in fixed orders)")
    del before, d0, d_eager
    check(train["bst_nt"] == 2 * 3 * L and train["bst_xn"] == 2 * 5 * L
          and train["bst_xn_tn"] == 2 * 2 * L
          and not any(train[k] for k in fused),
          f"{what}: captured train step's first call launches {train} "
          f"(the warm-up's eager step and the captured step, each: bst_nt "
          f"3L = forward, recompute, nn's backward; bst_xn 5L of which tn "
          f"2L; no fused attention kernel; L = {L})")
    _, m1, _ = plain.make_train_step(opt, clip_norm=CLIP)._eager(
        opt.init(dict(plain.named_parameters())), tokens, targets, ls)
    for k in ("loss", "grad_norm"):
        for other, side in ((m_eager, "the eager step"),
                            (m1, "the plain model")):
            a, b = m0[k].item(), other[k].item()
            check(np.isfinite(a) and abs(a - b) <= STEP_LOSS_TOL * abs(b),
                  f"{what}: train step 1 {k} {a:.6f} (captured) vs {b:.6f} "
                  f"({side}; tol {STEP_LOSS_TOL:g} relative)")
    losses = [m0["loss"].item()]
    reset_counts()
    for _ in range(WIDE_STEPS - 1):
        state, metrics, scale = step(state, tokens, targets, scale)
        losses.append(metrics["loss"].item())
    check(not any(read_counts().values()) and losses[-1] < losses[0]
          and bool(np.isfinite(losses).all()),
          f"{what}: {WIDE_STEPS} train steps (replays launch through no "
          f"wrapper): loss {' '.join(f'{x:.4f}' for x in losses)} (finite, "
          f"falling)")
    holder = {"state": state, "scale": scale}

    def one_step():
        holder["state"], _, holder["scale"] = step(
            holder["state"], tokens, targets, holder["scale"])
    ms = time_ms(one_step, TIMED_STEPS)
    print(f"{what}: train step [{card_line}]: batch {BATCH} x {cfg.ctx}, "
          f"captured {ms:.2f} ms (mean of {TIMED_STEPS}, CUDA events) = "
          f"{BATCH * cfg.ctx / ms * 1e3:.0f} tokens/s; first call "
          f"{first_s:.3f} s with warm-up and capture", flush=True)
    profile_port_kernels(f"{what} train step (graph replay)", one_step, ms)
    del model, plain, step, state, holder
    torch.cuda.empty_cache()
    return total


def route_compare(bt, dev, g, card_line):
    """(c) The trio (use_fused=False: nt, the blocked masked softmax, nn)
    against the fused kernels at the flagship's 8 heads of 64, batch 8 x
    2048, bf16, on the same inputs: forward, and forward + backward, timed
    in turns; outputs held together (the trio rounds the scores and the
    probabilities to bf16 before the next product: ||trio - fused|| /
    ||fused|| <= ATTN_NORM_TOL)."""
    from blocksparse_tpu_torch.models.sparse_transformer import (
        causal_subblock_mask, fixed_layout)
    op = bt.BlocksparseTransformer(fixed_layout(2048 // 64, local_blocks=8),
                                   block_size=64, heads=8,
                                   mask_callback=causal_subblock_mask)
    qkv = torch.randn((BATCH, 2048, 3 * 512), device=dev,
                      generator=g).to(torch.bfloat16)
    q, k, v = qkv.split(512, dim=-1)
    do = torch.randn((BATCH, 2048, 512), device=dev,
                     generator=g).to(torch.bfloat16)
    scale = 64 ** -0.5
    fused = op.attention(q, k, v, scale=scale)
    trio = op.attention(q, k, v, scale=scale, use_fused=False)
    diff = (trio.float() - fused.float())
    rel = diff.norm().item() / fused.float().norm().item()
    check(bool(torch.isfinite(trio).all()) and rel <= ATTN_NORM_TOL,
          f"attention 8 heads of 64: the trio against the fused kernels: "
          f"||diff|| / ||fused|| {rel:.3e} (tol {ATTN_NORM_TOL:g}), max "
          f"{diff.abs().max().item():.3e}")
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd(use_fused):
        return lambda: op.attention(q, k, v, scale=scale, use_fused=use_fused)

    def fwd_bwd(use_fused):
        def run():
            out = op.attention(qr, kr, vr, scale=scale, use_fused=use_fused)
            torch.autograd.grad(out, (qr, kr, vr), do)
        return run
    times = {"fused fwd": [], "trio fwd": [], "fused fwd+bwd": [],
             "trio fwd+bwd": []}
    for _ in range(2):
        for key, fn in (("fused fwd", fwd(True)), ("trio fwd", fwd(False)),
                        ("trio fwd", fwd(False)), ("fused fwd", fwd(True)),
                        ("fused fwd+bwd", fwd_bwd(True)),
                        ("trio fwd+bwd", fwd_bwd(False)),
                        ("trio fwd+bwd", fwd_bwd(False)),
                        ("fused fwd+bwd", fwd_bwd(True))):
            times[key].append(time_ms(fn, 10))
    med = {k: float(np.median(v)) for k, v in times.items()}
    print(f"route comparison [{card_line}]: attention batch {BATCH} x 2048, "
          f"8 heads of 64, bf16 (CUDA events, mean of 10, median of 4 "
          f"turns): fused forward {med['fused fwd']:.4f} ms, trio forward "
          f"{med['trio fwd']:.4f} ms ({med['trio fwd'] / med['fused fwd']:.2f}"
          f"x); fused forward + backward {med['fused fwd+bwd']:.4f} ms, trio "
          f"{med['trio fwd+bwd']:.4f} ms "
          f"({med['trio fwd+bwd'] / med['fused fwd+bwd']:.2f}x)", flush=True)
    del qkv, q, k, v, do, qr, kr, vr
    torch.cuda.empty_cache()


# ---------------- the training surface ----------------

# the entry point's run: steps, the one checkpoint (it is restored and
# its next step taken again), evaluations, and the steps the falling loss
# is averaged over at each end
ENTRY_STEPS, ENTRY_CKPT_AT, ENTRY_EVAL, ENTRY_WINDOW = 100, 60, 50, 10
DROPOUT = 0.1
ADAFACTOR_TOL = 1e-5   # Adafactor's means reduce in another order on the card
SLOT_FORMATS = ("float32", "bfloat16", "packed16")


def state_bytes(state):
    return sum(t.numel() * t.element_size() for k in ("mean", "var")
               for t in state[k].values())


def same_tree(a, b):
    """Every tensor of two trees of dicts equal bit for bit (packed16's
    uint16 slots compared as int16: the same bits)."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_tree(a[k], b[k])
                                            for k in a)
    if a.dtype != b.dtype:
        return False
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)


def slot_steps(bt, model, plain, cfg, dev, card_line):
    """The flagship's captured train step with bfloat16 and packed16 Adam
    slots: each bit for bit its eager step, each against the plain
    model's step with the same slots at the f32-slot phase's tolerances;
    state bytes and step ms beside the f32-slot step, in turns."""
    rng = np.random.RandomState(SEED + 15)
    seq = torch.from_numpy(rng.randint(0, cfg.n_vocab,
                                       (BATCH, cfg.ctx + 1))).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    ls = torch.tensor(LOSS_SCALE, device=dev)
    saved = snapshot(model)
    steps, counts = {}, {}
    names, params = zip(*plain.named_parameters())
    live = {n: g.abs() > GRAD_TOL * g.abs().max() for n, g in zip(
        names, torch.autograd.grad(plain.loss(tokens, targets) * ls,
                                   params))}
    for fmt in SLOT_FORMATS:
        opt = bt.AdamOptimizer(learning_rate=LR, zero_nans=True,
                               zero_infs=True, state_format=fmt)
        step = model.make_train_step(opt, clip_norm=CLIP)
        restore(model, saved)
        s_e, m_e, sc_e = step._eager(opt.init(dict(model.named_parameters())),
                                     tokens, targets, ls)
        d_e = {k: v - saved[k] for k, v in model.state_dict().items()}
        restore(model, saved)
        reset_counts()
        s_g, m_g, sc_g = step(opt.init(dict(model.named_parameters())),
                              tokens, targets, ls)
        torch.cuda.synchronize()
        counts[fmt] = read_counts()
        d_g = {k: v - saved[k] for k, v in model.state_dict().items()}
        restore(model, saved)
        nbytes = state_bytes(s_g)
        slot = s_g["mean"]["h.0.w_qkv"].dtype
        if fmt == "float32":
            steps[fmt] = (step, s_g, ls.clone(), nbytes)
            continue
        bits = same_tree(s_g, s_e) and torch.equal(sc_g, sc_e) \
            and all(torch.equal(m_g[k], m_e[k]) for k in m_e) \
            and all(torch.equal(d_g[k], d_e[k]) for k in d_e)
        check(bits and slot == {"bfloat16": torch.bfloat16,
                                "packed16": torch.uint16}[fmt],
              f"{fmt} slots ({slot}): the captured step equals its eager "
              f"step bit for bit (metrics, scale, every slot, every "
              f"parameter update)")
        pst = plain.make_train_step(opt, clip_norm=CLIP)
        before = snapshot(plain)
        _, m_p, _ = pst._eager(opt.init(dict(plain.named_parameters())),
                               tokens, targets, ls)
        d_p = {k: v - before[k] for k, v in plain.state_dict().items()}
        restore(plain, before)
        del before
        for k in ("loss", "grad_norm"):
            a, b = m_g[k].item(), m_p[k].item()
            check(abs(a - b) <= STEP_LOSS_TOL * abs(b),
                  f"{fmt} slots: step 1 {k} {a:.6f} vs plain {b:.6f} (tol "
                  f"{STEP_LOSS_TOL:g} relative)")
        compare_tensors(f"{fmt} slots: parameter updates of step 1 against "
                        f"the plain model", d_g, d_p, GRAD_TOL, live=live,
                        flip_bound=2 * LR + 1e-6)
        steps[fmt] = (step, s_g, sc_g, nbytes)
        del d_e, d_g, d_p, s_e
        torch.cuda.empty_cache()
    want = {"bsmm_fprop": 8 * cfg.n_layer, "bsmm_bprop": 4 * cfg.n_layer,
            "bsmm_updat": 4 * cfg.n_layer}
    check(all(all(c[k] == n for k, n in want.items()) for c in
              counts.values()),
          f"each slot format's first captured call launches the step's "
          f"kernels twice (warm-up and capture): {want} in all three")

    holder = {fmt: {"state": s, "scale": sc}
              for fmt, (_, s, sc, _) in steps.items()}

    def one_step(fmt):
        h = holder[fmt]
        h["state"], _, h["scale"] = steps[fmt][0](h["state"], tokens,
                                                  targets, h["scale"])

    def timing(fmt):
        return time_ms(lambda: one_step(fmt), TIMED_STEPS)
    turns = {fmt: [] for fmt in SLOT_FORMATS}
    for _ in range(2):
        for fmt, runs in in_turns({f: f for f in SLOT_FORMATS},
                                  timing).items():
            turns[fmt] += runs
    restore(model, saved)
    n_params = sum(p.numel() for p in model.parameters())
    for fmt in SLOT_FORMATS:
        ms = turns[fmt]
        print(f"adam slots {fmt} [{card_line}]: state "
              f"{steps[fmt][3] / 1e6:.2f} MB for {n_params / 1e6:.2f} M "
              f"params; captured step {float(np.median(ms)):.2f} ms "
              f"(median of {len(ms)} turns, each the mean of {TIMED_STEPS} "
              f"steps by CUDA events: "
              f"{' '.join(f'{x:.2f}' for x in ms)})", flush=True)
        profile_port_kernels(f"train step, {fmt} slots (graph replay)",
                             lambda: one_step(fmt), float(np.median(ms)))
    restore(model, saved)
    del steps, holder, saved
    torch.cuda.empty_cache()
    return counts


def packed16_checks(bt):
    """All 65,536 codes unpack on the card to the CPU's bits; every code's
    value, its neighbours and a seeded spread with edge values pack to
    the CPU's codes."""
    codes = torch.arange(65536, dtype=torch.int32).to(torch.uint16)
    g = torch.Generator().manual_seed(SEED)
    spread = torch.randn(100000, generator=g) * torch.pow(
        10.0, torch.rand(100000, generator=g) * 27 - 25)
    edges = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), 16.0,
                          -16.0, 1e-40, 2.0 ** -60, 2.0 ** -61, 2.0 ** -62])
    for fmt in ("mhalf", "vhalf"):
        unpack, pack = getattr(bt, f"{fmt}_unpack"), getattr(bt, f"{fmt}_pack")
        cpu = unpack(codes)
        dev = unpack(codes.cuda()).cpu()
        vals = cpu[torch.isfinite(cpu)]
        x = torch.cat([vals, torch.nextafter(vals, torch.tensor(np.inf)),
                       torch.nextafter(vals, torch.tensor(-np.inf)), spread,
                       edges])
        check(torch.equal(dev.view(torch.int32), cpu.view(torch.int32))
              and torch.equal(pack(x.cuda()).cpu().view(torch.int16),
                              pack(x).view(torch.int16)),
              f"{fmt}: all 65536 codes unpack on the card to the CPU's "
              f"bits; {x.numel()} values pack to the CPU's codes")


def dropout_checks(bt, cfg, sd, dev):
    """loss with resid_pdrop 0.1 at full width: one generator seed gives
    the same loss twice, its gradients with recompute on equal those with
    recompute off, the loss and gradients given one set of masks agree
    with the plain model's given the same masks, and the masks keep a
    binomial share."""
    import dataclasses
    m = bt.SparseTransformerLM(dataclasses.replace(cfg, resid_pdrop=DROPOUT),
                               device=dev)
    m.load_state_dict(sd)
    rng = np.random.RandomState(SEED + 16)
    seq = torch.from_numpy(rng.randint(0, cfg.n_vocab,
                                       (BATCH, cfg.ctx + 1))).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    names, params = zip(*m.named_parameters())
    runs = []
    for recompute in (True, True, False):
        m.config.recompute = recompute
        gen = torch.Generator(device=dev).manual_seed(SEED)
        loss = m.loss(tokens, targets, dropout=gen)
        runs.append((loss.detach(), torch.autograd.grad(loss, params)))
    m.config.recompute = cfg.recompute
    (l0, g0), (l1, _), (l2, g2) = runs
    with torch.no_grad():
        plain_loss = m.loss(tokens, targets).item()
    check(torch.equal(l0, l1) and bool(torch.isfinite(l0))
          and abs(l0.item() - plain_loss) > 1e-4,
          f"dropout {DROPOUT}: loss {l0.item():.6f} twice from one seed "
          f"(no dropout: {plain_loss:.6f})")
    check(torch.equal(l0, l2) and all(torch.equal(a, b)
                                      for a, b in zip(g0, g2)),
          f"dropout {DROPOUT}: loss and all {len(g0)} gradients with "
          f"recompute on equal those with recompute off bit for bit")
    del runs, g0, g2

    # the kernel model against the plain model, both given the same masks
    plain = bt.SparseTransformerLM(
        dataclasses.replace(cfg, resid_pdrop=DROPOUT), device=dev,
        impl="xla")
    plain.load_state_dict(sd)
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    masks = [m._dropout_masks(gen, layer, (BATCH, cfg.ctx, cfg.n_embd), dev)
             for layer in range(cfg.n_layer)]
    ls = torch.tensor(LOSS_SCALE, device=dev)
    grads, losses = [], []
    for mm in (m, plain):
        names, params = zip(*mm.named_parameters())
        loss = mm.loss(tokens, targets, dropout=masks)
        grads.append(dict(zip(names, (g / ls for g in torch.autograd.grad(
            loss * ls, params)))))
        losses.append(loss.item())
    rel = abs(losses[0] - losses[1]) / abs(losses[1])
    check(np.isfinite(losses[0]) and rel <= STEP_LOSS_TOL
          and abs(losses[1] - plain_loss) > 1e-4,
          f"dropout {DROPOUT}, one set of masks: loss {losses[0]:.6f} vs "
          f"the plain model's {losses[1]:.6f} (rel diff {rel:.2e}, tol "
          f"{STEP_LOSS_TOL:g})")
    compare_tensors(f"dropout {DROPOUT}, one set of masks: gradients "
                    f"against the plain model", grads[0], grads[1], GRAD_TOL)
    del plain, grads

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    shares = []
    for layer in range(cfg.n_layer):
        for mask in m._dropout_masks(gen, layer, (BATCH, cfg.ctx,
                                                  cfg.n_embd), dev):
            shares.append(mask.float().mean().item())
    n = BATCH * cfg.ctx * cfg.n_embd
    bound = 5 * np.sqrt((1 - DROPOUT) * DROPOUT / n)
    check(all(abs(s - (1 - DROPOUT)) <= bound for s in shares),
          f"dropout masks keep {min(shares):.5f}-{max(shares):.5f} of "
          f"{n} elements (binomial: {1 - DROPOUT} +- {bound:.5f}, 5 sigma)")
    del m, masks
    torch.cuda.empty_cache()


def adafactor_ema_checks(bt, model, dev):
    """Three Adafactor updates (the LM's 1-D and 2-D parameters: its
    block-sparse MLP weights are 3-D, which Adafactor refuses as JAX's
    does) and three EMA updates (f32 and bf16) of the LM's parameters,
    on the card against the CPU."""
    params = {k: v.detach().float().cpu() for k, v in model.state_dict()
              .items()}
    g = torch.Generator().manual_seed(SEED)
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in
              params.items()} for _ in range(3)]
    flat = {k for k, v in params.items() if v.dim() <= 2}
    ada = bt.AdafactorOptimizer(learning_rate=1e-3)
    out = {}
    for where in ("cpu", dev):
        p = {k: params[k].to(where) for k in flat}
        s = ada.init(p)
        for gr in grads:
            p, s = ada.apply({k: gr[k].to(where) for k in flat}, p, s)
        out[str(where)] = p
    worst = max(((out[str(dev)][k].cpu() - out["cpu"][k]).abs().max()
                 / out["cpu"][k].abs().max().clamp(min=1.0)).item()
                for k in flat)
    check(worst <= ADAFACTOR_TOL,
          f"Adafactor, 3 updates of {len(flat)} LM parameters on the card "
          f"against the CPU: worst |diff| / max(1, max|cpu|) {worst:.2e} "
          f"(tol {ADAFACTOR_TOL:g})")
    for fp16 in (False, True):
        ema = bt.Ema(decay=0.99, fp16=fp16)
        res = {}
        for where in ("cpu", dev):
            st = ema.init({k: v.to(where) for k, v in params.items()})
            for gr in grads:
                st = ema.apply({k: (params[k] + gr[k]).to(where)
                                for k in params}, st)
            res[str(where)] = st
        # the same f32 elementwise ops on both sides; stored in bf16, a
        # last-bit difference may round the other way: one bf16 ulp
        tol = 2.0 ** -8 if fp16 else 1e-6
        worst = max(((res[str(dev)][k].cpu().float() - res["cpu"][k].float())
                     .abs().max() / res["cpu"][k].float().abs().max()
                     .clamp(min=1.0)).item() for k in params)
        check(worst <= tol,
              f"Ema (fp16={fp16}), 3 updates of the LM's parameters on the "
              f"card against the CPU: worst |diff| / max(1, max|cpu|) "
              f"{worst:.2e} (tol {tol:g})")


def entry_point_run(bt, dev, card_line):
    """``python -m blocksparse_tpu_torch.examples.enwik8`` at the flagship's
    width (its block-sparse MLP by flag) for ENTRY_STEPS steps on the
    synthetic stream, counted: loss falling; a checkpoint at
    ENTRY_CKPT_AT restored into a fresh model equals what was saved bit
    for bit, and its next step on the same batch equals the uninterrupted
    run's bit for bit."""
    import shutil

    from blocksparse_tpu_torch import checkpoint as ck
    from blocksparse_tpu_torch.examples import enwik8
    ckpt = Path("build") / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    args = enwik8.parse_args([
        "--n_iter", str(ENTRY_STEPS), "--mlp_block_size", "32",
        "--mlp_density", "0.5", "--ckpt_dir", str(ckpt), "--ckpt_every",
        str(ENTRY_CKPT_AT), "--eval_every", str(ENTRY_EVAL)])
    snaps = {}

    def clone(t):
        return {k: clone(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.detach().clone()

    def on_step(step, model, opt_state, loss_scale, metrics):
        if step in (ENTRY_CKPT_AT - 1, ENTRY_CKPT_AT):
            snaps[step] = (clone(model.state_dict()), clone(opt_state),
                           loss_scale.clone(), clone(metrics))
    reset_counts()
    t = time.perf_counter()
    out = enwik8.train(args, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = read_counts()
    losses = np.array(out["losses"])
    first, last = losses[:ENTRY_WINDOW].mean(), losses[-ENTRY_WINDOW:].mean()
    check(len(losses) == ENTRY_STEPS and np.isfinite(losses).all()
          and last < first,
          f"entry point [{card_line}]: {ENTRY_STEPS} steps in {wall:.1f} s "
          f"(data, build and capture included); loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}, mean of the first {ENTRY_WINDOW} "
          f"{first:.4f} > of the last {last:.4f} (bits/byte "
          f"{first / np.log(2):.3f} -> {last / np.log(2):.3f}); eval "
          f"bits/byte {out['eval']}")
    print("entry point losses: " + " ".join(f"{x:.4f}" for x in losses),
          flush=True)
    want = ("bsmm_fprop", "bsmm_bprop", "bsmm_updat", "bsmm_updat_reduce",
            "bst_attn_fwd_lse", "bst_attn_dq", "bst_attn_dkv")
    check(all(launches[k] > 0 for k in want),
          f"entry point launches {launches}: every kernel of the train "
          f"step ran")

    tree, meta = ck.restore(ckpt, device=dev)
    params_k, state_k, scale_k, _ = snaps[ENTRY_CKPT_AT - 1]
    _, fresh, _, step_fn = enwik8.build(args)
    fresh.load_state_dict(tree["params"])
    check(meta["step"] == ENTRY_CKPT_AT
          and same_tree(fresh.state_dict(), params_k)
          and same_tree(tree["opt_state"], state_k)
          and torch.equal(tree["loss_scale"], scale_k),
          f"checkpoint at step {ENTRY_CKPT_AT} restored into a fresh model: "
          f"params, Adam state, loss scale and step equal the saved ones "
          f"bit for bit")
    train, _ = enwik8.load_data(None, 9 * 10 ** 7, 5 * 10 ** 6)
    it = enwik8.batch_iter(train, args.n_batch, args.n_ctx,
                           np.random.RandomState(1))
    for _ in range(ENTRY_CKPT_AT + 1):
        x, y = next(it)
    state, metrics, scale = step_fn(
        tree["opt_state"], torch.from_numpy(x).long().to(dev),
        torch.from_numpy(y).long().to(dev), tree["loss_scale"])
    params_n, state_n, scale_n, metrics_n = snaps[ENTRY_CKPT_AT]
    check(same_tree(fresh.state_dict(), params_n)
          and same_tree(state, state_n)
          and torch.equal(scale, scale_n)
          and all(torch.equal(metrics[k], metrics_n[k]) for k in metrics_n),
          f"the restored model's step {ENTRY_CKPT_AT} on the same batch "
          f"equals the uninterrupted run's bit for bit (loss "
          f"{metrics['loss'].item():.6f}, params, state, scale)")
    shutil.rmtree(ckpt, ignore_errors=True)
    del fresh, step_fn, tree, snaps
    torch.cuda.empty_cache()
    return launches


def training_surface(bt, model, plain, cfg, sd, dev, card_line):
    """The training surface the LM's recipe needs besides the kernels:
    16-bit Adam slots in the captured step, packed16 on the card,
    residual dropout, Adafactor and EMA, and the enwik8 entry point with
    its checkpoint, from the seed weights ``sd`` (the earlier phases
    trained the model).  Returns the launch counts of the counted paths."""
    for m in (model, plain):
        m.load_state_dict(sd)
    slots = slot_steps(bt, model, plain, cfg, dev, card_line)
    packed16_checks(bt)
    dropout_checks(bt, cfg, sd, dev)
    adafactor_ema_checks(bt, model, dev)
    return slots, entry_point_run(bt, dev, card_line)


# ---------------- F5, the gated matmul and the sparse LSTM ----------------

# The gated matmul at bsmm1's shape: a random 0/1 gate of this density
GATE_DENSITY = 0.5
# dg = Σ_block dw_raw · W: f32 sums of the same products on both sides, in
# other orders (dw's own tolerance)
GATE_DG_TOL = UPDAT_TOL
# The sparse LSTM at full width: LSTMConfig's defaults (nhidden 1120,
# ba_10 layout, nembd 64, nproj 512/512, nsteps 64) with
# benchmarks/lstm_bench.py:36-40's chip settings (isteps 5, batch 128),
# f32.  At these seed params its recurrence amplifies a rounding ~1.7x a
# token (lstm_path prints the growth): past ~30 tokens the logits of any
# two f32 summation orders (the plain model against itself: index_add_'s
# atomics) disagree by O(1).  So the kernel model is held to the plain
# model where that is a test:
# - every token's step (all isteps) and its VJP, from the same state,
#   input and cotangents, the state carried on from the kernel model's:
#   forward 1e-5 x max(1, max|plain|), VJP 1e-4 x max|plain|;
# - the whole model's loss and every gradient over the first
#   LSTM_CHECK_STEPS tokens: loss 1e-5 relative, gradients 1e-4 of each
#   tensor's largest (f32 sums in other orders).
LSTM_BATCH, LSTM_ISTEPS, LSTM_CHECK_STEPS = 128, 5, 4
LSTM_LOSS_TOL, LSTM_GRAD_TOL = 1e-5, 1e-4
# The entry point's step from the seed params: the recurrence's gradient
# norm starts in the 1e7-1e10 (the same growth, backwards), so the clip to
# 1.0 sets every step's size until the dynamics settle; at lr 1e-2 the
# loss falls within 10 steps.
LSTM_STEPS, LSTM_LR, LSTM_WINDOW = 10, 1e-2, 3


def f5_check(dev):
    """F5: a host sync inside a capture fails it; the LM's capture helper
    raises the error, and afterwards the default CUDA generator draws
    (``torch.randn``) and a good capture replays, drawing anew each
    replay."""
    from blocksparse_tpu_torch.models.sparse_transformer import capture_graph
    x = torch.ones(1024, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    # the cause, shown on torch's own capture (no repair): printed, not
    # checked, as it is torch's behaviour
    try:
        with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side):
            float((x * 2).sum())
    except RuntimeError:
        pass
    try:
        torch.randn(4, device=dev)
        cause = "torch.randn draws"
    except RuntimeError as e:
        cause = f"torch.randn raises {str(e).splitlines()[0]!r}"
    print(f"F5's cause: after torch's own failed capture, {cause}",
          flush=True)
    raised = None
    try:
        capture_graph(side, lambda: float((x * 2).sum()))
    except RuntimeError as e:
        raised = type(e).__name__
    torch.cuda.current_stream(dev).wait_stream(side)
    check(raised is not None, f"F5: a host sync inside a capture raises "
          f"({raised})")
    r = torch.randn(1024, device=dev)
    check(bool(torch.isfinite(r).all()),
          "F5: torch.randn on the card after the failed capture")
    out = {}

    def body():
        out["y"] = x * 3 + torch.randn(1024, device=dev)
    graph = capture_graph(side, body)
    graph.replay()
    first = out["y"].clone()
    graph.replay()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(first).all()) and not torch.equal(first,
                                                                 out["y"]),
          "F5: a good capture afterwards replays (two replays, two draws)")
    del graph


def gated_run(op, x, w, gate, e, **kw):
    """(y, dx, dw[, dg]) of y = op(x, w, gate) for the cotangent e."""
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    args = (x, w)
    if isinstance(gate, torch.Tensor):
        gate = gate.detach().requires_grad_()
        args += (gate,)
    y = op(x, w, gate=gate, **kw)
    return (y.detach(),) + torch.autograd.grad((y.float() * e).sum(), args)


def gated_checks(model, plain, dev, g, card_line):
    """The gated matmul at bsmm1's shape (N = BATCH x ctx, 512 -> 2048,
    b32), bf16 and f32: a random 0/1 gate, dynamic, with every (dw_gated,
    gate_grad) pair, y, dx, dw and dg of the kernels against the plain
    op; the static gate (the op of the surviving blocks) against the
    dynamic gate, and both forward + backward's device time."""
    op, ref = model.bsmm1, plain.bsmm1
    N = BATCH * model.config.ctx
    gate_np = (np.random.RandomState(SEED).rand(op.blocks)
               < GATE_DENSITY).astype(np.float32)
    kept = float(gate_np.mean())
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((N, op.C), device=dev, generator=g).to(dtype)
        w = (torch.randn(op.w_shape, device=dev, generator=g)
             * 0.02).to(dtype)
        e = torch.randn((N, op.K), device=dev, generator=g)
        gate = torch.as_tensor(gate_np, device=dev)
        name = f"gated bsmm1 N={N} {str(dtype)[6:]}"
        dw_tol = UPDAT_TOL if dtype == torch.float32 else TOL[dtype]
        for dw_gated in (False, True):
            for gate_grad in (False, True):
                kw = dict(dw_gated=dw_gated, gate_grad=gate_grad)
                got = gated_run(op, x, w, gate, e, **kw)
                want = gated_run(ref, x, w, gate, e, **kw)
                for part, a, b, tol in zip(
                        ("y", "dx", "dw", "dg"), got, want,
                        (TOL[dtype], TOL[dtype], dw_tol, GATE_DG_TOL)):
                    compare(f"{name} dw_gated={dw_gated} "
                            f"gate_grad={gate_grad}: {part}", a, b, tol)
                check(gate_grad or not got[3].any(),
                      f"{name} dw_gated={dw_gated} gate_grad={gate_grad}: "
                      f"dg zero without gate_grad")
        dyn = gated_run(op, x, w, gate, e, dw_gated=True)
        static = gated_run(op, x, w, gate_np, e, dw_gated=True)
        sub = op._static_gates[gate_np.tobytes()].sub
        check(sub.blocks == int(gate_np.sum()),
              f"{name}: the static gate's op holds the {sub.blocks} "
              f"surviving blocks of {op.blocks}")
        for part, a, b, tol in zip(("y", "dx", "dw"), static, dyn,
                                   (TOL[dtype], TOL[dtype], dw_tol)):
            compare(f"{name}: static gate against dynamic gate, {part}", a,
                    b, tol)
        del dyn, static
        ms = {}
        for what, gt in (("dynamic", gate), ("static", gate_np)):
            ms[what] = device_ms_per_call(
                lambda gt=gt: gated_run(op, x, w, gt, e, dw_gated=True),
                lambda k: True, n=5)
        print(f"{name}: forward + backward device time, gate keeping "
              f"{kept:.3f} of the blocks: dynamic {ms['dynamic']:.4f} ms, "
              f"static {ms['static']:.4f} ms ({ms['static'] / ms['dynamic']:.3f}"
              f" of dynamic) [{card_line}]", flush=True)
        del x, w, e
        torch.cuda.empty_cache()


def lstm_models(bt, dev):
    """The full-width LSTM on the kernels and on the plain versions, from
    the same seed params."""
    cfg = bt.LSTMConfig(isteps=LSTM_ISTEPS)
    model = bt.SparseLSTM(cfg, device=dev)
    plain = bt.SparseLSTM(cfg, device=dev, impl="xla")
    sd = bt.lstm_params_from_jax(bt.random_jax_lstm_params(model, SEED),
                                 model)
    for m in (model, plain):
        m.load_state_dict(sd)
    return cfg, model, plain


def lstm_grads(m, tokens, targets):
    names, params = zip(*m.named_parameters())
    loss = m.loss(tokens, targets)
    return loss.detach(), dict(zip(names, torch.autograd.grad(loss,
                                                              params)))


def lstm_kernel_rows(op, dev, g, card_line, rows, marks):
    """The LSTM's three bsmm directions at its shape (C 1120 -> K 4480, N
    128, f32, CN): each against its plain version; device time (profiler)
    beside the bound and a dense f32 torch.matmul of the scattered
    layout."""
    from blocksparse_tpu_torch import BlocksparseMatMul
    from blocksparse_tpu_torch.kernels import bsmm as bk
    N, f32 = LSTM_BATCH, torch.float32
    ref = BlocksparseMatMul(op.layout, op.bsize, op.axis, impl="xla")
    sms = bk.device_sm_count(dev)
    x = torch.randn((op.C, N), device=dev, generator=g)
    dy = torch.randn((op.K, N), device=dev, generator=g)
    w = torch.randn(op.w_shape, device=dev, generator=g) * 0.05
    name = f"LSTM bsmm (C {op.C} -> K {op.K}, N {N}, f32, CN)"
    flops = xprop_flops(op, N)
    nb = 4 * (op.C * N + op.blocks * op.bsize ** 2 + op.K * N)
    xprop_bound = bound(flops, nb, PEAK_F32_FLOPS)
    updat_bound = bound(flops, 4 * (op.C * N + op.K * N
                                    + op.blocks * op.bsize ** 2),
                        PEAK_F32_FLOPS)
    wd = dense_weight(op, w)                          # (C, K)
    xn, dyn = x.t().contiguous(), dy.t().contiguous()
    libs = {"fprop": time_ms(lambda: xn @ wd, 20),
            "bprop": time_ms(lambda: dyn @ wd.t(), 20),
            "updat": time_ms(lambda: x @ dyn, 20)}
    errs = {"fprop": compare(f"{name} fprop", op._xprop(x, w, "f"),
                             ref._xprop(x, w, "f"), TOL[f32]),
            "bprop": compare(f"{name} bprop (route "
                             f"{op._route(N, 'b', sms)})",
                             op._xprop(dy, w, "b"), ref._xprop(dy, w, "b"),
                             TOL[f32]),
            "updat": compare(f"{name} updat", op._updat(x, dy),
                             ref._updat(x, dy), UPDAT_TOL)}
    same_bits(f"{name} fprop", lambda: op._xprop(x, w, "f"))
    same_bits(f"{name} bprop", lambda: op._xprop(dy, w, "b"))
    same_bits(f"{name} updat", lambda: op._updat(x, dy))
    rows.setdefault("f32_configs", {}).update(f32_configs(op, N, "LSTM", sms))
    dev_ms = {
        "fprop": kernel_device_ms(lambda: op._xprop(x, w, "f"),
                                  "bsmm_xprop_nc_kernel"),
        "bprop": device_ms_per_call(
            lambda: op._xprop(dy, w, "b"),
            lambda k: "bsmm_xprop_nc_kernel" in k or "bsmm_merge" in k),
        "merge": kernel_device_ms(lambda: op._xprop(dy, w, "b"),
                                  "bsmm_merge_kernel"),
        "updat": kernel_device_ms(lambda: op._updat(x, dy),
                                  "bsmm_updat_nc_kernel")}
    plain_ms = {"fprop": time_ms(lambda: ref._xprop(x, w, "f"), 10),
                "bprop": time_ms(lambda: ref._xprop(dy, w, "b"), 10),
                "updat": time_ms(lambda: ref._updat(x, dy), 10)}
    for d in ("fprop", "bprop", "updat"):
        b = updat_bound if d == "updat" else xprop_bound
        print(f"{name} {d}: device {dev_ms[d]:.4f} ms"
              + (f" (of it bsmm_merge {dev_ms['merge']:.4f})"
                 if d == "bprop" else "")
              + f", {flops / dev_ms[d] / 1e9:.2f} TFLOP/s; bound "
              f"{b[0]:.4f} ms ({b[1]}); dense f32 torch.matmul, layout "
              f"scattered, {libs[d]:.4f} ms; plain {plain_ms[d]:.4f} ms "
              f"[{card_line}]", flush=True)
    # the bprop route's merge alone: its f32 tiles in, y out
    phases = op._phases(N, "b", sms)
    tiles = op._plan("split", "b", phases)["tiles"]
    merge_bound = bound(N * op.C * (phases - 1),
                        4 * N * op.bsize * tiles + 4 * N * op.C,
                        PEAK_F32_FLOPS)
    parts = torch.randn((N, tiles * op.bsize), device=dev, generator=g)
    idx = op._plan_tensors(dev, "split", "b", phases)["merge_idx"]
    merge_err = compare(f"{name} bsmm_merge of the bprop's {tiles} tiles "
                        f"(exact)", bk.bsmm_merge(parts, idx, op.bsize, f32),
                        bk.merge_plain(parts, idx.long(), op.bsize, f32), 0.0)
    merge_plain_ms = time_ms(lambda: bk.merge_plain(parts, idx.long(),
                                                    op.bsize, f32), 10)
    merge_lib = time_ms(lambda: parts.view(N, tiles, op.bsize)[:, idx.long()]
                        .sum(2), 20)
    rows["lstm_fprop"] = (errs["fprop"], dev_ms["fprop"], plain_ms["fprop"])
    rows["lstm_bprop"] = (errs["bprop"], dev_ms["bprop"], plain_ms["bprop"])
    rows["lstm_updat"] = (errs["updat"], dev_ms["updat"], plain_ms["updat"])
    rows["lstm_merge"] = (merge_err, dev_ms["merge"], merge_plain_ms)
    marks["bsmm_fprop_lstm"] = (*xprop_bound, libs["fprop"])
    marks["bsmm_bprop_lstm"] = (*xprop_bound, libs["bprop"])
    marks["bsmm_updat_lstm"] = (*updat_bound, libs["updat"])
    marks["bsmm_merge_lstm"] = (*merge_bound, merge_lib)
    del x, dy, w, wd, xn, dyn, parts
    torch.cuda.empty_cache()


def lstm_teacher_forced(model, plain, tokens, g):
    """Each token's step on the kernel model against the plain model's from
    the same (c, h) and input, the state carried on from the kernel
    model's, and each step's VJP (in c, h, the input and the layers'
    parameters) for the same random cotangents.  Returns {quantity: the
    worst error over the tokens as a share of its tolerance}."""
    with torch.no_grad():
        xproj = torch.einsum("bte,ep->btp", model.wte[tokens], model.w_in)
    cfg = model.config
    shape = (cfg.lsteps, cfg.nhidden, tokens.shape[0])
    c = h = torch.zeros(shape, device=tokens.device)
    names = ["c", "h", "out", "dc", "dh", "dx"] + [
        f"d{n}" for n, _ in model.layers.named_parameters()]
    worst = dict.fromkeys(names, 0.0)
    for t in range(tokens.shape[1]):
        ins = (c, h, xproj[:, t])
        cots = None
        got = []
        for m in (model, plain):
            leaves = [a.clone().requires_grad_() for a in ins]
            res = m._step(*leaves, None)
            if cots is None:
                cots = [torch.randn(r.shape, device=r.device, generator=g)
                        for r in res]
            grads = torch.autograd.grad(
                res, leaves + list(m.layers.parameters()), cots)
            got.append([r.detach() for r in res] + list(grads))
        for i, (name, a, b) in enumerate(zip(names, *got)):
            if i < 3:
                tol = TOL[torch.float32] * max(1.0, b.abs().max().item())
            else:
                tol = LSTM_GRAD_TOL * b.abs().max().item()
            err = (a - b).abs().max().item()
            worst[name] = max(worst[name], err / tol if tol else
                              (np.inf if err else 0.0))
        c, h = got[0][0], got[0][1]
    return worst


def lstm_path(bt, dev, g, card_line, rows, marks):
    """The sparse LSTM at full width, f32: its routes; the three bsmm
    directions at its shape; the kernel model against the plain model
    token by token over all nsteps (forward and VJP) and as a whole over
    the first LSTM_CHECK_STEPS tokens (loss and every gradient); then
    LSTM_STEPS steps of the entry point's step (clip, Adam, EMA) on the
    synthetic stream, counted, with falling loss, ms a step by CUDA
    events and kernels a step by the profiler.  Returns the launch counts
    of the steps."""
    from blocksparse_tpu_torch.examples import lstm_train
    from blocksparse_tpu_torch.kernels import bsmm as bk
    cfg, model, plain = lstm_models(bt, dev)
    op = model.bsmm_h
    sms = bk.device_sm_count(dev)
    routes = {"fprop": op.dispatch_mode(LSTM_BATCH),
              "bprop": op._route(LSTM_BATCH, "b", sms),
              "bprop_runs": op._phases(LSTM_BATCH, "b", sms),
              "updat_splits": op.updat_splits(LSTM_BATCH, torch.float32)}
    print(f"LSTM: nhidden {cfg.nhidden}, {cfg.mask_kind} tiled x4: "
          f"{op.blocks} blocks of {op.CB * op.KB} (density {op.sparsity}), "
          f"{op.blocks * op.bsize ** 2 / 1e6:.2f} M weights; nembd "
          f"{cfg.nembd}, nproj {cfg.nproj_in}/{cfg.nproj_out}, nsteps "
          f"{cfg.nsteps}, isteps {cfg.isteps}, batch {LSTM_BATCH}, f32; "
          f"routes at N={LSTM_BATCH} on {sms} SMs: {routes}", flush=True)
    check(routes["fprop"] == "grouped" and routes["bprop"] == "phased",
          f"LSTM routes: fprop unsplit, bprop the split route "
          f"({routes['bprop_runs']} runs: bsmm_partials + bsmm_merge)")

    lstm_kernel_rows(op, dev, g, card_line, rows, marks)

    rng = np.random.RandomState(SEED)
    tokens, targets = (torch.as_tensor(rng.randint(0, 256, (
        LSTM_BATCH, cfg.nsteps)), device=dev) for _ in range(2))
    worst = lstm_teacher_forced(model, plain, tokens, g)
    for name, share in worst.items():
        check(share <= 1.0, f"LSTM token by token ({cfg.nsteps} tokens from "
              f"the same state), {name}: worst at {share:.3f} of its "
              f"tolerance")
    n = LSTM_CHECK_STEPS
    reset_counts()
    loss, grads = lstm_grads(model, tokens[:, :n], targets[:, :n])
    torch.cuda.synchronize()
    once = read_counts()
    ploss, pgrads = lstm_grads(plain, tokens[:, :n], targets[:, :n])
    rel = abs(loss.item() - ploss.item()) / abs(ploss.item())
    check(rel <= LSTM_LOSS_TOL and bool(torch.isfinite(loss)),
          f"LSTM loss over {n} tokens, kernel model {loss.item():.6f} "
          f"against plain model {ploss.item():.6f}: rel diff {rel:.3e} "
          f"(tol {LSTM_LOSS_TOL:g})")
    share = 0.0
    for k, pg in pgrads.items():
        err = (grads[k] - pg).abs().max().item()
        scale = pg.abs().max().item()
        share = max(share, err / (LSTM_GRAD_TOL * scale))
        check(err <= LSTM_GRAD_TOL * scale,
              f"LSTM gradient {k} over {n} tokens: max_abs_err {err:.3e} "
              f"(max|plain| {scale:.3e}, tol {LSTM_GRAD_TOL:g} x max)")
    print(f"LSTM gradients over {n} tokens: worst at {share:.3f} of the "
          f"tolerance; that loss + backward launched {once}", flush=True)
    with torch.no_grad():
        logits = [m(tokens) for m in (model, plain, plain)]
    full = [bt.softmax_cross_entropy(lg, targets).mean().item()
            for lg in logits]
    at = (0, 4, 8, 16, 32, cfg.nsteps - 1)

    def by_token(a, b):
        d = (a - b).abs().amax(dim=(0, 2))
        return d, " ".join(f"{t}: {d[t].item():.2e}" for t in at)
    d_pp, pp = by_token(logits[2], logits[1])
    _, kp = by_token(logits[0], logits[1])
    growth = (d_pp[16] / d_pp[0]).item() ** (1 / 16)
    print(f"LSTM over all {cfg.nsteps} tokens, no check (a rounding grows "
          f"{growth:.2f}x a token over the first 16): max |logits| "
          f"difference by token, the plain model against itself "
          f"(index_add_'s atomics) {pp}; the kernel model against it {kp}; "
          f"loss: kernel model {full[0]:.7f}, plain model {full[1]:.7f} "
          f"and again {full[2]:.7f}", flush=True)
    del logits
    del grads, pgrads, plain
    torch.cuda.empty_cache()

    args = lstm_train.parse_args(["--isteps", str(LSTM_ISTEPS), "--batch",
                                  str(LSTM_BATCH), "--lr", str(LSTM_LR)])
    model, optm, ema, state, ema_state, _ = lstm_train.build(args)
    step = lstm_train.make_step(model, optm, ema)
    train, _ = lstm_train.load_data(None, cfg.nsteps, LSTM_BATCH)
    brng = np.random.RandomState(1)
    batches = [tuple(torch.from_numpy(a).long().to(dev) for a in
                     lstm_train.get_batch(train, brng, LSTM_BATCH,
                                          cfg.nsteps))
               for _ in range(LSTM_STEPS + 1)]
    state, ema_state, loss0, gn0 = step(state, ema_state, *batches[0])
    torch.cuda.synchronize()                   # the warm-up, a step too
    losses, norms, step_ms = [], [], []
    reset_counts()
    for x, y in batches[1:]:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        state, ema_state, loss, gn = step(state, ema_state, x, y)
        end.record()
        losses.append(loss)
        norms.append(gn)
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    launches = read_counts()
    losses = np.array([float(l) for l in losses])
    first, last = (losses[:LSTM_WINDOW].mean(),
                   losses[-LSTM_WINDOW:].mean())
    check(np.isfinite(losses).all() and last < first,
          f"LSTM entry-point step x {LSTM_STEPS} at lr {LSTM_LR:g} "
          f"[{card_line}], after a warm-up step (loss {float(loss0):.4f}, "
          f"grad norm {float(gn0):.3g}): loss "
          + " ".join(f"{l:.4f}" for l in losses)
          + f" (mean of the first {LSTM_WINDOW} {first:.4f} > of the last "
          f"{last:.4f}); grad norm " + " ".join(f"{float(n):.3g}"
                                                 for n in norms)
          + "; ms a step (CUDA events) " + " ".join(f"{m:.1f}"
                                                   for m in step_ms))
    per = {k: v // LSTM_STEPS for k, v in launches.items() if v}
    want = {"bsmm_fprop": cfg.nsteps * cfg.isteps,
            "bsmm_bprop": cfg.nsteps * cfg.isteps,
            "bsmm_merge": cfg.nsteps * cfg.isteps,
            "bsmm_updat": cfg.nsteps * cfg.isteps}
    check(per == want, f"LSTM launches a step {per}, expected {want}")
    x, y = batches[-1]
    _, kernels = device_events(lambda: step(state, ema_state, x, y))
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    ours = {name: (sum(e.self_device_time_total for e in kernels
                       if name in e.key) / 1e3,
                   sum(e.count for e in kernels if name in e.key))
            for name in ("bsmm_xprop_nc_kernel", "bsmm_merge_kernel",
                         "bsmm_updat_nc_kernel")}
    print(f"LSTM step profile: {count} kernels, {total:.2f} ms of device "
          f"time against {np.median(step_ms):.1f} ms a step (busy "
          f"{total / np.median(step_ms):.0%}); port kernels "
          + ", ".join(f"{k} {ms:.2f} ms ({n})" for k, (ms, n) in
                      ours.items())
          + f"; every kernel by name: {by_kernel(kernels, 1)} "
          f"[{card_line}]", flush=True)
    del model, batches, state, ema_state
    torch.cuda.empty_cache()
    return launches


# ---------------- the MoE LM and the rest of the conv ----------------

# The enwik8 LM with Mixture-of-Experts MLPs (the JAX example's
# --moe_experts, examples/enwik8.py:86-91,124-126): 8 experts of 512 ->
# 2048 -> 512 at b32, density 1.0, top-1, capacity factor 1.25
# (Switch-Base-8's routing), so C = 2,560 slots an expert at 8 x 2048
# tokens; bf16 compute with the experts' products in f32 (ROADMAP F6).
MOE_EXPERTS, MOE_K, MOE_CF = 8, 1, 1.25
MOE_STEPS = 3


class RouteTap:
    """Routing tables of a model's MoE calls, kept or imposed.  ``record``
    appends each call's (topi, src, dst) to its layer's list; ``forced``
    (another tap's lists) makes each call take the next tables of its
    layer instead of routing (the gates recomputed from this model's own
    probs).  A kernel model and its plain model then compute the same
    function on the same routing: a token whose top expert or whose drop
    differs between the two (their router inputs differ by roundings) would
    otherwise change its output by O(1).  A tap that neither records nor is
    forced routes as the layer does."""

    def __init__(self, bt, model):
        base = type(model.moe)
        tap = self

        class Tapped(base):
            def __call__(self, params, x, *args, **kw):
                tap.layer = tap.layers[id(params)]
                return base.__call__(self, params, x, *args, **kw)

            def _route(self, probs, C):
                if tap.forced is not None:
                    topi, src, dst = tap.forced[tap.layer].pop(0)
                    hit = nnf.one_hot(topi, self.E).to(probs.dtype)
                    topv = (probs[:, None, :] * hit).sum(-1)
                    gates = topv / torch.clamp(topv.sum(-1, keepdim=True),
                                               min=1e-9)
                    return gates, topi, src, dst
                out = base._route(self, probs, C)
                if tap.record:
                    tap.tables[tap.layer].append(
                        tuple(t.clone() for t in out[1:]))
                return out
        model.moe.__class__ = Tapped
        self.layers = {id(layer.moe): i for i, layer in enumerate(model.h)}
        self.tables = {i: [] for i in self.layers.values()}
        self.record, self.forced, self.layer = False, None, None

    def clear(self):
        for v in self.tables.values():
            v.clear()


def run_tapped(kernel_tap, plain_tap, kernel_fn, plain_fn):
    """kernel_fn() recording its routing, then plain_fn() on it: both
    results.  Every recorded table must be used."""
    kernel_tap.clear()
    kernel_tap.record = True
    try:
        a = kernel_fn()
    finally:
        kernel_tap.record = False
    plain_tap.forced = {k: list(v) for k, v in kernel_tap.tables.items()}
    try:
        b = plain_fn()
        left = sum(len(v) for v in plain_tap.forced.values())
    finally:
        plain_tap.forced = None
    check(left == 0, f"the plain model took every routing table the kernel "
                     f"model recorded ({left} left)")
    return a, b


def routing_flips(kernel_tap, plain_tap, kernel_fn, plain_fn):
    """Tokens whose top experts or drops differ between the two models'
    own routing in one call each: (per layer, any layer)."""
    taps = (kernel_tap, plain_tap)
    for t in taps:
        t.clear()
        t.record = True
    try:
        kernel_fn()
        plain_fn()
    finally:
        for t in taps:
            t.record = False
    per, union = [], None
    for l in sorted(kernel_tap.tables):
        (ki, ks, kd), (pi, _, pd) = (t.tables[l][0] for t in taps)
        dropped = ks.numel()                 # dst's sentinel: E * C
        diff = (ki != pi).any(1) | ((kd == dropped) != (pd == dropped)) \
            .any(1)
        per.append(int(diff.sum()))
        union = diff if union is None else union | diff
    for t in taps:
        t.clear()
    return per, int(union.sum())


def moe_models(bt, dev):
    cfg = flagship_config(bt, mlp_density=1.0, moe_experts=MOE_EXPERTS,
                          moe_k=MOE_K, moe_capacity_factor=MOE_CF)
    model = bt.SparseTransformerLM(cfg, device=dev)
    plain = bt.SparseTransformerLM(cfg, device=dev, impl="xla")
    sd = bt.params_from_jax(bt.random_jax_params(model, seed=SEED), model)
    model.load_state_dict(sd)
    plain.load_state_dict(sd)
    return cfg, model, plain, RouteTap(bt, model), RouteTap(bt, plain)


def moe_layer_checks(model, plain, dev, g, card_line, rows, marks):
    """One MoE layer at the LM's shape (16,384 bf16 tokens): the kernel
    layer against the plain one on the same input (the router is plain
    torch in both: one routing), forward and VJP, F6's dtypes; then the
    experts' products at N = C against their plain versions, timed beside
    their bound and a dense f32 torch.matmul."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    moe, pmoe_, f32, bf = model.moe, plain.moe, torch.float32, torch.bfloat16
    T, C = BATCH * model.config.ctx, moe.capacity(BATCH * model.config.ctx)
    x = (torch.randn((T, moe.d), device=dev, generator=g)).to(bf)
    dy = torch.randn((T, moe.d), device=dev, generator=g)
    res = []
    for m, lm in ((moe, model), (pmoe_, plain)):
        params = dict(lm.h[0].moe.items())
        xr = x.detach().requires_grad_()
        y, aux = m(lm.h[0].moe, xr)
        grads = torch.autograd.grad((y, aux), [xr] + list(params.values()),
                                    (dy, torch.tensor(1.0, device=dev)))
        res.append((y.detach(), aux.detach(), grads))
    (y, aux, gk), (yp, auxp, gp) = res
    check(y.dtype == f32 and gk[0].dtype == bf
          and all(t.dtype == f32 for t in gk[1:]),
          "MoE layer dtypes (ROADMAP F6): y f32 from bf16 tokens, dx bf16, "
          "the expert weights' gradients f32")
    compare(f"MoE layer (T {T}, E {moe.E}, C {C}) y against the plain "
            f"layer", y, yp, TOL[bf])
    check(abs(aux.item() - auxp.item()) <= 1e-6,
          f"MoE layer aux {aux.item():.7f} against the plain layer's "
          f"{auxp.item():.7f}")
    names = ["dx"] + [f"d{k}" for k in dict(model.h[0].moe.items())]
    compare_tensors("MoE layer VJP against the plain layer",
                    dict(zip(names, gk)), dict(zip(names, gp)), GRAD_TOL)
    del res, gk, gp, y, yp
    torch.cuda.empty_cache()

    # the experts' products at N = C, f32 (bsmm1's input upcast, F6)
    op1, op2 = moe.bsmm1, moe.bsmm2
    ref1, ref2 = bt_ops(op1), bt_ops(op2)
    sms = bk.device_sm_count(dev)
    xe = torch.randn((C, op1.C), device=dev, generator=g)
    du = torch.randn((C, op1.K), device=dev, generator=g)
    w = torch.randn(op1.w_shape, device=dev, generator=g) * 0.02
    flops = xprop_flops(op1, C)
    nb = 4 * (op1.C * C + op1.blocks * op1.bsize ** 2 + op1.K * C)
    b_x = bound(flops, nb, PEAK_F32_FLOPS)
    wd = dense_weight(op1, w)
    name = (f"MoE bsmm1 (C {op1.C} -> K {op1.K}, N {C}, b{op1.bsize}, "
            f"{op1.blocks} blocks, f32)")
    routes = {"fprop": op1._route(C, "f", sms), "bprop":
              op1._route(C, "b", sms), "bsmm2 fprop": op2._route(C, "f", sms),
              "bsmm2 bprop": op2._route(C, "b", sms),
              "bsmm1 updat runs (bf16 x, du)": op1.updat_splits(C, bf),
              "bsmm2 updat runs (f32)": op2.updat_splits(C, f32)}
    print(f"MoE routes at N = C = {C} on {sms} SMs: {routes}", flush=True)
    errs = {"fprop": compare(f"{name} fprop", op1._xprop(xe, w, "f"),
                             ref1._xprop(xe, w, "f"), TOL[f32]),
            "bprop": compare(f"{name} bprop", op1._xprop(du, w, "b"),
                             ref1._xprop(du, w, "b"), TOL[f32]),
            "updat": compare(f"{name} updat (bsmm2's: h (C, {op2.C}), "
                             f"dy (C, {op2.K}))", op2._updat(du, xe),
                             ref2._updat(du, xe), UPDAT_TOL)}
    same_bits(f"{name} fprop", lambda: op1._xprop(xe, w, "f"))
    same_bits(f"{name} bprop", lambda: op1._xprop(du, w, "b"))
    same_bits(f"{name} updat (bsmm2's)", lambda: op2._updat(du, xe))
    rows.setdefault("f32_configs", {}).update(
        {**f32_configs(op1, C, "MoE bsmm1", sms),
         **f32_configs(op2, C, "MoE bsmm2", sms)})
    dev_ms = {
        "fprop": kernel_device_ms(lambda: op1._xprop(xe, w, "f"),
                                  "bsmm_xprop_nc_kernel"),
        "bprop": device_ms_per_call(
            lambda: op1._xprop(du, w, "b"),
            lambda k: "bsmm_xprop_nc_kernel" in k or "bsmm_merge" in k),
        "updat": kernel_device_ms(lambda: op2._updat(du, xe),
                                  "bsmm_updat_nc_kernel")}
    plain_ms = {"fprop": time_ms(lambda: ref1._xprop(xe, w, "f"), 5),
                "bprop": time_ms(lambda: ref1._xprop(du, w, "b"), 5),
                "updat": time_ms(lambda: ref2._updat(du, xe), 5)}
    libs = {"fprop": time_ms(lambda: xe @ wd, 20),
            "bprop": time_ms(lambda: du @ wd.t(), 20),
            "updat": time_ms(lambda: du.t() @ xe, 20)}
    # the bf16 tensor-core updat bsmm1 runs in the step (bf16 x and du)
    xb, dub = xe.to(bf), du.to(bf)
    errs["updat_bf16"] = compare(f"{name} updat in bf16 (the step's bsmm1)",
                                 op1._updat(xb, dub), ref1._updat(xb, dub),
                                 UPDAT_TOL)
    bf_ms = kernel_device_ms(lambda: op1._updat(xb, dub),
                             kernel_of(op1, C, "u")[0])
    for d in ("fprop", "bprop", "updat"):
        print(f"{name} {d}: device {dev_ms[d]:.4f} ms, "
              f"{flops / dev_ms[d] / 1e9:.2f} TFLOP/s; bound {b_x[0]:.4f} ms "
              f"({b_x[1]}); dense f32 torch.matmul {libs[d]:.4f} ms; plain "
              f"{plain_ms[d]:.4f} ms [{card_line}]", flush=True)
    print(f"{name} updat in bf16 (tensor cores): device {bf_ms:.4f} ms, "
          f"{flops / bf_ms / 1e9:.2f} TFLOP/s [{card_line}]", flush=True)
    for d in ("fprop", "bprop", "updat"):
        rows[f"moe_{d}"] = (errs[d], dev_ms[d], plain_ms[d])
        marks[f"bsmm_{d}_moe"] = (*b_x, libs[d])
    del xe, du, w, wd, xb, dub
    torch.cuda.empty_cache()
    return routes


def bt_ops(op):
    """The plain twin of a BlocksparseMatMul."""
    from blocksparse_tpu_torch import BlocksparseMatMul
    return BlocksparseMatMul(op.layout, op.bsize, op.axis, impl="xla")


def moe_generate(bt, model, plain, ktap, ptap, cfg, dev, prompts):
    """``generate`` on the kernel model, counted; each token is the sample
    of its step's forward (the step replayed: the logits that token was
    drawn from, at the same noise), and each step's logits agree with the
    plain model's on the same tokens and routing."""
    n, steps = prompts.shape[1], GENERATE_TOKENS
    reset_counts()
    out = bt.generate(model, prompts, steps,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    launches = read_counts()
    check(tuple(out.shape) == (prompts.shape[0], n + steps)
          and torch.equal(out[:, :n], prompts)
          and bool(((out >= 0) & (out < cfg.n_vocab)).all()),
          f"MoE generate: {steps} tokens after {tuple(prompts.shape)}, in "
          f"range")
    noise = bt.models.sparse_transformer.sample_noise(
        (steps, prompts.shape[0], cfg.n_vocab),
        torch.Generator(device=dev).manual_seed(SEED), dev)
    worst = 0.0
    for i in range(steps):
        buf = torch.zeros((prompts.shape[0], cfg.ctx), dtype=torch.int64,
                          device=dev)
        buf[:, :n + i] = out[:, :n + i]
        lk, lp = run_tapped(ktap, ptap, lambda: model(buf)[:, n + i - 1],
                            lambda: plain(buf)[:, n + i - 1])
        tok = bt.models.sparse_transformer.sample_tokens(lk, 1.0, noise[i])
        check(torch.equal(tok, out[:, n + i]),
              f"MoE generate step {i}: its tokens are the samples of the "
              f"step's forward logits at the same noise")
        err = (lk - lp).abs().max().item()
        scale = max(1.0, lp.abs().max().item())
        worst = max(worst, err / (MODEL_TOL * scale))
    check(worst <= 1.0, f"MoE generate: each step's logits against the plain "
                        f"model's (same tokens, same routing), worst at "
                        f"{worst:.3f} of the tolerance {MODEL_TOL:g} x "
                        f"max(1, max|plain|)")
    return launches


def moe_step_expect(model, L, N):
    """A train step's launches: per layer and expert, two products forward,
    two in the recompute, two bprops and two updats (bsmm1's in bf16, its
    runs summed by the reduce when split; bsmm2's in f32 unsplit); f32
    products on the split route add a merge each; the attention's as the
    flagship's."""
    from blocksparse_tpu_torch.kernels.bsmm import device_sm_count
    moe, C, sms = model.moe, model.moe.capacity(N), device_sm_count()
    E = moe.E
    merges = sum(op._route(C, d, sms) == "phased"
                 for op in (moe.bsmm1, moe.bsmm2) for d in ("f", "f", "b"))
    return {"bsmm_fprop": 4 * E * L, "bsmm_bprop": 2 * E * L,
            "bsmm_updat": 2 * E * L, "bsmm_merge": merges * E * L,
            "bsmm_updat_reduce": E * L * int(
                moe.bsmm1.updat_splits(C, torch.bfloat16) > 1),
            "bst_attn_fwd_lse": 2 * L, "bst_attn_dq": L, "bst_attn_dkv": L}


def moe_path(bt, dev, g, card_line, rows, marks):
    """The MoE LM at full width: its layer and products at the path's
    shapes; the forward against the plain model (same routing) and the
    routing flips without it; ``generate``; the train step: its first call
    counted, MOE_STEPS captured steps each equal to the eager step bit for
    bit and within tolerance of the plain model's step (same routing), the
    loss falling; ms a step, kernels a step, the graph's memory.  Returns
    the counted step's launches."""
    cfg, model, plain, ktap, ptap = moe_models(bt, dev)
    L, N = cfg.n_layer, BATCH * cfg.ctx
    moe = model.moe
    n_params = sum(p.numel() for p in model.parameters())
    n_expert = sum(p.numel() for n, p in model.named_parameters()
                   if ".moe.w" in n and not n.endswith("wg"))
    print(f"MoE LM: {L} layers x {cfg.n_embd}d, {cfg.n_head} heads, ctx "
          f"{cfg.ctx}; {moe.E} experts of {moe.d} -> {moe.h} -> {moe.d} at "
          f"b{moe.bsmm1.bsize} ({moe.bsmm1.blocks} blocks each), top-{moe.k},"
          f" capacity factor {moe.cf}: C = {moe.capacity(N)} slots an expert "
          f"at {N} tokens; {n_params / 1e6:.2f} M params, {n_expert / 1e6:.2f}"
          f" M expert weights; routes {model._mlp_routes(N)}", flush=True)
    routes = moe_layer_checks(model, plain, dev, g, card_line, rows, marks)

    rng = np.random.RandomState(SEED + 7)
    seq = torch.from_numpy(rng.randint(0, cfg.n_vocab,
                                       (BATCH, cfg.ctx + 1))).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    model(tokens[:1])
    torch.cuda.synchronize()
    reset_counts()
    logits = model(tokens)
    torch.cuda.synchronize()
    fwd_launches = read_counts()
    want = dict.fromkeys(fwd_launches, 0)
    want.update({"bsmm_fprop": 2 * moe.E * L, "bst_attn_fwd": L})
    for op in (moe.bsmm1, moe.bsmm2):
        if op.dispatch_mode(moe.capacity(N)) == "phased":
            want["bsmm_merge"] += moe.E * L
    check(fwd_launches == want, f"MoE forward launches {fwd_launches}, "
                                f"expected {want}")
    logits, ref = run_tapped(ktap, ptap, lambda: model(tokens),
                             lambda: plain(tokens))
    compare(f"MoE forward logits ({BATCH} x {cfg.ctx}) against the plain "
            f"model, same routing", logits, ref, MODEL_TOL)
    per, total = routing_flips(ktap, ptap, lambda: model(tokens),
                               lambda: plain(tokens))
    print(f"      without shared routing, tokens routed otherwise (top "
          f"expert or drop) by layer {per}, in any layer {total} of {N}",
          flush=True)
    fwd_ms = time_ms(lambda: model(tokens), 3)
    print(f"MoE forward batch {BATCH} x {cfg.ctx}: {fwd_ms:.2f} ms (mean of "
          f"3, CUDA events) [{card_line}]", flush=True)
    del logits, ref
    torch.cuda.empty_cache()
    gen_launches = moe_generate(bt, model, plain, ktap, ptap, cfg, dev,
                                seq[:2, :PROMPT_LEN])
    print(f"launches: MoE generate ({GENERATE_TOKENS} tokens, a full forward "
          f"each) {gen_launches}", flush=True)

    # the train step
    ls = torch.tensor(LOSS_SCALE, device=dev)
    opt = bt.AdamOptimizer(learning_rate=LR, zero_nans=True, zero_infs=True)
    step = model.make_train_step(opt, clip_norm=CLIP)
    eager = step._eager
    pstep = plain.make_train_step(opt, clip_norm=CLIP)._eager
    state = opt.init(dict(model.named_parameters()))
    want = dict.fromkeys(read_counts(), 0)
    want.update(moe_step_expect(model, L, N))
    def grads(m):
        names, params = zip(*m.named_parameters())
        loss = m.loss(tokens, targets)
        return loss.detach(), dict(zip(names, (g / ls for g in torch.autograd
                                               .grad(loss * ls, params))))
    (lk, gk), (lp, gp) = run_tapped(ktap, ptap, lambda: grads(model),
                                    lambda: grads(plain))
    rel = abs(lk.item() - lp.item()) / abs(lp.item())
    check(rel <= STEP_LOSS_TOL, f"MoE train loss {lk.item():.6f} against the "
                                f"plain model's {lp.item():.6f}, same routing"
                                f" (rel diff {rel:.2e}, tol {STEP_LOSS_TOL:g})")
    compare_tensors("MoE gradients against the plain model, same routing",
                    gk, gp, GRAD_TOL)
    live = {k: v.abs() > GRAD_TOL * v.abs().max() for k, v in gp.items()}
    del gk, gp
    torch.cuda.empty_cache()
    losses = []
    for i in range(MOE_STEPS):
        start = snapshot(model)
        s_in = {k: (v.clone() if torch.is_tensor(v) else
                    {n: t.clone() for n, t in v.items()})
                for k, v in state.items()}
        plain.load_state_dict(start)

        def kernel_eager():
            return eager({k: (v.clone() if torch.is_tensor(v) else
                              {n: t.clone() for n, t in v.items()})
                          for k, v in s_in.items()}, tokens, targets, ls)

        def plain_eager():
            return pstep({k: (v.clone() if torch.is_tensor(v) else
                              {n: t.clone() for n, t in v.items()})
                          for k, v in s_in.items()}, tokens, targets, ls)
        (_, m_e, sc_e), (_, m_p, _) = run_tapped(ktap, ptap, kernel_eager,
                                                 plain_eager)
        d_e = {k: v - start[k] for k, v in model.state_dict().items()}
        d_p = {k: v - start[k] for k, v in plain.state_dict().items()}
        restore(model, start)
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.empty_cache()
            held0 = torch.cuda.memory_reserved()
            reset_counts()
            t = time.perf_counter()
        state, m_c, scale = step(state, tokens, targets, ls)
        torch.cuda.synchronize()
        if i == 0:
            first_s = time.perf_counter() - t
            launches = read_counts()
            torch.cuda.empty_cache()
            held = (torch.cuda.memory_reserved() - held0) / 2 ** 30
            want2 = {k: 2 * n for k, n in want.items()}
            check(launches == want2,
                  f"MoE train step's first call launches {launches}, "
                  f"expected {want2} (the warm-up's eager step and the "
                  f"captured step, each {want})")
            warm_s, capture_s = step.captures[0]
            print(f"MoE train step graph [{card_line}]: first call "
                  f"{first_s:.3f} s (warm-up {warm_s:.3f} s, capture "
                  f"{capture_s:.3f} s); the graph holds {held:.2f} GiB",
                  flush=True)
        d_c = {k: v - start[k] for k, v in model.state_dict().items()}
        bits = all(torch.equal(m_c[k], m_e[k]) for k in m_c) and \
            torch.equal(scale, sc_e) and \
            all(torch.equal(d_c[k], d_e[k]) for k in d_c)
        check(bits, f"MoE step {i + 1}: the captured step equals the eager "
                    f"step bit for bit (metrics, scale, every update)")
        for k in ("loss", "grad_norm"):
            a, b = m_c[k].item(), m_p[k].item()
            check(abs(a - b) <= STEP_LOSS_TOL * abs(b),
                  f"MoE step {i + 1} {k} {a:.6f} against the plain model's "
                  f"{b:.6f}, same routing (tol {STEP_LOSS_TOL:g} relative)")
        if i == 0:
            compare_tensors("MoE step 1 parameter updates against the plain "
                            "model's", d_c, d_p, GRAD_TOL, live=live,
                            flip_bound=2 * LR + 1e-6)
        losses.append(m_c["loss"].item())
        ls = scale
        del d_e, d_p, d_c, start, s_in
        torch.cuda.empty_cache()
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0],
          f"MoE LM: {MOE_STEPS} captured steps on one batch, loss "
          f"{' '.join(f'{x:.4f}' for x in losses)} (finite, falling)")
    reset_counts()
    holder = {"state": state, "scale": ls}

    def one_step():
        holder["state"], _, holder["scale"] = step(
            holder["state"], tokens, targets, holder["scale"])
    step_ms = time_ms(one_step, TIMED_STEPS)
    replayed = read_counts()
    check(not any(replayed.values()),
          f"MoE train step replays launch through no wrapper ({replayed})")
    _, kernels = device_events(one_step)
    total = sum(e.self_device_time_total for e in kernels) / 1e3
    count = sum(e.count for e in kernels)
    ours = {name: (sum(e.self_device_time_total for e in kernels
                       if name in e.key) / 1e3,
                   sum(e.count for e in kernels if name in e.key))
            for name in ("bsmm_xprop_nc_kernel", "bsmm_updat_nc_kernel",
                         "bsmm_updat_mma_kernel", "bsmm_updat_wgmma_kernel",
                         "bsmm_updat_sparse_kernel",
                         "bsmm_updat_reduce_kernel", "bsmm_merge_kernel",
                         "bst_attn")}
    print(f"MoE train step [{card_line}]: batch {BATCH} x {cfg.ctx}, "
          f"captured {step_ms:.2f} ms (mean of {TIMED_STEPS} replays, CUDA "
          f"events) = {N / step_ms * 1e3:.0f} tokens/s; one replay profiled: "
          f"{count} kernels, {total:.2f} ms of device time (busy "
          f"{total / step_ms:.0%}); port kernels "
          + ", ".join(f"{k} {ms:.2f} ms ({n})" for k, (ms, n) in ours.items())
          + f"; every kernel by name: {by_kernel(kernels, 1)}", flush=True)
    del model, plain, step, holder, state
    torch.cuda.empty_cache()
    return launches


# The rest of the conv at the bench's C = 512 shape (batch 32, 32 x 32,
# 3 x 3 SAME): a ragged BCK (channel blocks of 16, 32 and 48 over the
# bench's 32-blocks' rows), impl="matmul" and the deconv on the bench's
# d 0.25 BCK; the goldens at a small size.
CONV_RAGGED_SIZES = (16, 32, 48)
# f32 against the dense cuDNN call or impl="conv" (TF32 off): sums of C*9
# (y, dI) or N*H*W (dF) products in other orders; bf16 at DENSE_TOL (each
# side rounds its bf16 operands and outputs on its own path)
CONV_F32_TOL = 1e-4


def ragged_bck(C, rng):
    """Blocks of CONV_RAGGED_SIZES channels: the C channels cut into runs
    of random sizes on each side, each input run joined to the output run
    of its index and, at the bench's density, to others."""
    def cuts(n):
        out, at = [], 0
        while at < n:
            s = min(int(rng.choice(CONV_RAGGED_SIZES)), n - at)
            out.append(tuple(range(at, at + s)))
            at += s
        return out
    cs, ks = cuts(C), cuts(C)
    return [(c, k) for i, c in enumerate(cs) for j, k in enumerate(ks)
            if j == i % len(ks) or i == j % len(cs)
            or rng.rand() < CONV_DENSITIES[0]]


def dense_of(conv, F):
    """Any conv's filter scattered into the dense (K, C, R, S) weight of
    the same map (overlapping blocks add)."""
    R, S = conv.TRS[1:]
    wd = torch.zeros((conv.K, conv.C, R, S), dtype=torch.float32,
                     device=F.device)
    blocks = conv.expand_filter(F.reshape(-1).float())
    for (cs, ks), f in zip(conv.BCK, blocks):
        k = torch.as_tensor(ks, device=F.device)[:, None]
        c = torch.as_tensor(cs, device=F.device)[None, :]
        wd[k, c] += f.reshape(len(ks), len(cs), R, S)
    return wd


def conv_rest_path(bt, dev, g, card_line):
    """Ragged, impl="matmul" and the deconv at C = 512, bf16 and f32:
    forward and both gradients against the dense cuDNN conv (or its
    transpose) of the scattered filter and impl="conv", timed beside the
    dense call; the edge bias and the l2 norms against the CPU; the
    goldens at a small size.  Plain torch throughout: no kernel
    launches."""
    C, hw, N = CONV_CHANNELS[0], CONV_HW, CONV_BATCH
    rng = np.random.RandomState(SEED + 3)
    _, d, BCK = conv_configs()[0]
    ops = {"ragged": bt.BlocksparseConv(ragged_bck(C, rng), (3, 3),
                                        (hw, hw), padding="SAME"),
           "matmul": bt.BlocksparseConv(BCK, (3, 3), (hw, hw),
                                        padding="SAME", impl="matmul"),
           "deconv": bt.BlocksparseDeconv(BCK, (3, 3), (hw, hw))}
    conv_ref = bt.BlocksparseConv(BCK, (3, 3), (hw, hw), padding="SAME")
    reset_counts()
    for name, op in ops.items():
        for dt in (torch.float32, torch.bfloat16):
            F = bt.conv_filter_from_jax(bt.random_jax_conv_filter(op, SEED),
                                        op, dev).to(dt)
            x = (torch.rand(op.i_shape(N), device=dev, generator=g) * 2 - 1
                 ).to(dt).reshape([N, -1, hw, hw])
            wd = dense_of(op, F).to(dt)
            if name == "deconv":
                # y = A(F)^T x: the transposed dense conv of the conv's
                # filter, (K, C) in the conv's terms
                def dense(x, w):
                    return nnf.conv_transpose2d(x, w, padding=1)
            else:
                def dense(x, w):
                    return nnf.conv2d(x, w, padding=1)
            tol = DENSE_TOL if dt == torch.bfloat16 else CONV_F32_TOL
            got = conv_fwd_bwd(op, F, x)
            xr, wr = x.detach().requires_grad_(), wd.detach().requires_grad_()
            y = dense(xr, wr)
            gx, gw = torch.autograd.grad(y.float().square().sum(), (xr, wr))
            what = (f"{name} C={C} ({op.blocks} blocks"
                    + ("" if op.fixed_block_size else
                       f", sizes {sorted({len(c) for c, _ in op.BCK})}")
                    + f") N={N} {hw}x{hw} {str(dt)[6:]}")
            compare(f"{what}: y against the dense cuDNN "
                    f"{'conv_transpose2d' if name == 'deconv' else 'conv2d'}"
                    f" of the scattered filter", got[0].reshape(y.shape), y,
                    tol)
            compare(f"{what}: dI against the dense call's", got[1].reshape(
                gx.shape), gx, tol)
            support = dense_of(op, torch.ones_like(got[2])) != 0
            compare(f"{what}: dF against the dense call's on the blocks",
                    dense_of(op, got[2]), gw * support, tol)
            if name == "matmul":
                for n_, a, b in zip(("y", "dI", "dF"), got,
                                    conv_fwd_bwd(conv_ref, F, x)):
                    compare(f"{what}: {n_} against impl=\"conv\"", a, b,
                            tol)
            ms = time_ms(lambda: conv_fwd_bwd(op, F, x), 3)
            with torch.no_grad():
                fwd_ms = time_ms(lambda: op(F, x), 3)
                dense_fwd = time_ms(lambda: dense(x, wd), 5)

            def dense_fb():
                xr, wr = x.detach().requires_grad_(), \
                    wd.detach().requires_grad_()
                return torch.autograd.grad(
                    dense(xr, wr).float().square().sum(), (xr, wr))
            dense_ms = time_ms(dense_fb, 5)
            print(f"{what} [{card_line}]: forward {fwd_ms:.3f} ms, forward +"
                  f" backward {ms:.3f} ms; dense cuDNN forward "
                  f"{dense_fwd:.3f} ms, forward + backward {dense_ms:.3f} ms "
                  f"(CUDA events)", flush=True)
            del F, x, wd, got, y, gx, gw
            torch.cuda.empty_cache()
    # the edge bias on the conv's output (NCHW) and the l2 norms, against
    # the same ops on the CPU
    eb = bt.conv_edge_bias_init([N, C, hw, hw], [N, C, hw, hw],
                                [3, 3, C, C], data_format="NCHW")
    xg = torch.randn((N, C, hw, hw), device=dev, generator=g)
    gb = [torch.rand(eb.shape, device=dev, generator=g) + 0.5
          for _ in range(2)]
    outs = []
    for t in (xg, *gb), tuple(a.cpu() for a in (xg, *gb)):
        leaves = [a.detach().requires_grad_() for a in t]
        y = eb(*leaves)
        outs.append([y.detach()] + list(torch.autograd.grad(
            y.square().sum(), leaves)))
    for n_, a, b in zip(("y", "dx", "dg", "db"), *outs):
        compare(f"edge bias NCHW ({eb.edgeBiasDim} patterns, {C} channels, "
                f"{hw}x{hw}) {n_} on the card against the CPU", a.cpu(), b,
                TOL[torch.float32])
    for name, op in (("conv ragged", ops["ragged"]),
                     ("deconv", ops["deconv"])):
        F = torch.tensor(bt.random_jax_conv_filter(op, SEED), device=dev)
        n = op._n_ccols if name == "deconv" else op._n_krows
        gain = torch.rand(n, device=dev, generator=g) + 0.5
        res = []
        for Fd, gd in ((F, gain), (F.cpu(), gain.cpu())):
            Fr = Fd.detach().requires_grad_()
            out = op.l2_normalize(Fr, gain=gd)
            res.append((out.detach().cpu(), torch.autograd.grad(
                out.square().sum() + out.sum(), Fr)[0].cpu()))
        for n_, a, b in zip(("value", "gradient"), *res):
            compare(f"{name} l2_normalize (C={C}) {n_} on the card against "
                    f"the CPU", a, b, TOL[torch.float32])
    # the goldens at a small size, on the card
    small = [((0, 1, 2, 3, 4), (0, 1, 2)), ((2, 3, 5, 6, 7), (2, 3, 4, 5)),
             ((1, 6), (4, 5, 6, 7)), ((0, 7), (0, 7))]
    gr = np.random.RandomState(SEED)
    for cls in ("BlocksparseConv", "BlocksparseDeconv"):
        op = getattr(bt, cls)(small, (3, 3), (6, 6))
        blocks = [gr.uniform(-1, 1, op.f_shape(b)[:2] + op.TRS)
                  .astype(np.float32) for b in range(op.blocks)]
        F = torch.tensor(op.collapse_filter(blocks, np.float32), device=dev,
                         requires_grad=True)
        I = gr.uniform(-1, 1, op.i_shape(2)).astype(np.float32)
        E = gr.uniform(-1, 1, op.o_shape(2)).astype(np.float32)
        Ir = torch.tensor(I, device=dev, requires_grad=True)
        y = op(F, Ir)
        dF, dI = torch.autograd.grad((y * torch.tensor(E, device=dev)).sum(),
                                     (F, Ir))
        for n_, a, b in (("fprop", y, op.fprop_test(blocks, I)),
                         ("bprop", dI, op.bprop_test(blocks, E)),
                         ("updat", dF, op.updat_test(E, I))):
            compare(f"{cls} ragged (4 blocks, 6x6) {n_} on the card against "
                    f"the NumPy golden", a.cpu().reshape(b.shape),
                    torch.as_tensor(b), 1e-4)
    launched = {k: v for k, v in read_counts().items() if v}
    check(not launched, f"the rest of the conv launches no kernel (plain "
                        f"torch, as JAX's XLA lowerings): {launched}")


# ---------------- the parallel phase: sequence-parallel shard kernels at
# full width in one process, and the sharded train step on NCCL

SP_SHARDS = (2, 4)
SP_STEPS = 3


def sp_inputs(model, dev, g):
    """The flagship attention's training inputs, bf16, batch 8 x 2048: q, k,
    v sliced from one packed qkv (as the LM's), and dO."""
    c, bf = model.config, torch.bfloat16
    qkv = torch.randn((BATCH, c.ctx, 3 * c.n_embd), device=dev,
                      generator=g).to(bf)
    do = torch.randn((BATCH, c.ctx, c.n_embd), device=dev,
                     generator=g).to(bf)
    return (*qkv.split(c.n_embd, dim=-1), do)


def sp_gather(bst, n, q, k, v, do, scale, kernels=True):
    """Gather mode over n shards in one process, each shard's launches on
    its tables (q sliced, K/V whole), as ``sequence_parallel_attention``
    makes them on its rank: per shard (y, lse, dq, dk, dv)."""
    from blocksparse_tpu_torch.ops.transformer import _rowsum
    from blocksparse_tpu_torch.parallel import sequence as seq
    L, out = q.shape[1] // n, []
    for r in range(n):
        tab = seq.shard_tables(bst, n, r, None, q.device)
        qr, dor = q[:, r * L:(r + 1) * L], do[:, r * L:(r + 1) * L]
        y, lse = seq.shard_forward(bst, qr, k, v, scale, tab, kernels)
        out.append((y, lse) + tuple(seq.shard_backward(
            bst, qr, k, v, dor, _rowsum(dor, y, bst.heads), lse, scale, tab,
            kernels)))
    return out


def sp_ring(bst, n, q, k, v, do, scale, kernels=True):
    """Ring mode over n shards in one process, as ``ring_attention`` makes
    its n² pair launches: per query shard the (out, lse) merged over the
    key chunks from -1e30, then per pair dq (f32) and dk/dv summed.
    Returns (y f32, lse, dq f32, dk, dv), whole."""
    from blocksparse_tpu_torch.ops.transformer import _rowsum
    from blocksparse_tpu_torch.parallel import sequence as seq
    L = q.shape[1] // n

    def cut(a, i):
        return a[:, i * L:(i + 1) * L]
    merged = []
    for r in range(n):
        out = torch.zeros(cut(q, r).shape, device=q.device)
        lse = torch.full((q.shape[0], bst.heads, L), -1e30, device=q.device)
        for j in range(n):
            o_t, l_t = seq.shard_forward(
                bst, cut(q, r), cut(k, j), cut(v, j), scale,
                seq.shard_tables(bst, n, r, j, q.device), kernels)
            out, lse = seq.merge(out, lse, o_t, l_t, bst.heads)
        merged.append((out, lse))
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=q.device)
    dv = torch.zeros(v.shape, device=q.device)
    for r in range(n):
        out, lse = merged[r]
        dvec = _rowsum(cut(do, r), out, bst.heads)
        for j in range(n):
            dq_t, dk_t, dv_t = seq.shard_backward(
                bst, cut(q, r), cut(k, j), cut(v, j), cut(do, r), dvec, lse,
                scale, seq.shard_tables(bst, n, r, j, q.device), kernels,
                dq_dtype=torch.float32)
            dq[:, r * L:(r + 1) * L] += dq_t
            dk[:, j * L:(j + 1) * L] += dk_t
            dv[:, j * L:(j + 1) * L] += dv_t
    return (torch.cat([o for o, _ in merged], 1),
            torch.cat([l for _, l in merged], 2), dq, dk, dv)


def gathered(shards):
    """Gather mode's per-shard results joined: (y, lse, dq) concatenated,
    dk and dv summed."""
    return (torch.cat([s[0] for s in shards], 1),
            torch.cat([s[1] for s in shards], 2),
            torch.cat([s[2] for s in shards], 1),
            sum(s[3] for s in shards), sum(s[4] for s in shards))


def profiled_launches(fn, keys, n=5):
    """{key: (mean device ms a launch, launches recorded)} of the port
    kernels whose names hold each key, over n calls of fn() in one
    profiled window (a window may miss its first kernel's record, so a
    key is never timed by one launch alone)."""
    _, kernels = device_events(lambda: [fn() for _ in range(n)],
                               lambda ks: all(any(key in e.key for e in ks)
                                              for key in keys))
    out = {}
    for key in keys:
        hits = [e for e in kernels if key in e.key]
        count = sum(e.count for e in hits)
        out[key] = (sum(e.self_device_time_total for e in hits)
                    / max(count, 1) / 1e3, count)
    return out


def shard_work(bst, n, r, j, B, T, H, hs):
    """One shard's (or pair's) attention work for its bound: (e, the
    product a block's q·k^T takes summed over its blocks, in multiply-adds;
    q rows, k rows touched) at the op's block size (its layout shared)."""
    bs, L = bst.blk_size, T // n
    qlo, klo = r * L // bs, 0 if j is None else j * L // bs
    klen = T // bs if j is None else L // bs
    blocks = [(q, k) for q, k in bst.nt_list[0]
              if qlo <= q < qlo + L // bs and klo <= k < klo + klen]
    qrows = len({q for q, _ in blocks}) * bs
    krows = len({k for _, k in blocks}) * bs
    return len(blocks) * B * H * bs * bs * hs, qrows, krows


def shard_marks(bst, n, mode, B, T, H, hs):
    """The mean bound a launch of a shard's fwd_lse, dq and dk/dv (gather:
    n launches; ring: n² pairs, dq in f32): the larger of its operations
    (4e, 6e and 8e flops: two, three and four products of e multiply-adds)
    over the bf16 peak and its bytes
    (the q/dO rows and k/v rows its blocks touch, read once; lse and D f32;
    out and dq written whole, dk/dv whole in f32) over the memory rate."""
    pairs = [(r, None) for r in range(n)] if mode == "gather" else \
        [(r, j) for r in range(n) for j in range(n)]
    L = T // n
    kl = T if mode == "gather" else L
    row = H * hs * 2                           # a bf16 position of q/k/v
    fwd, dq, dkv = [], [], []
    for r, j in pairs:
        e, qr, kr = shard_work(bst, n, r, j, B, T, H, hs)
        lse = B * H * L * 4
        fwd.append(bound(4 * e, B * (qr + 2 * kr) * row + B * L * row + lse))
        dq.append(bound(6 * e, B * (2 * qr + 2 * kr) * row + 2 * lse
                        + B * L * row * (2 if mode == "ring" else 1)))
        dkv.append(bound(8 * e, B * (2 * qr + 2 * kr) * row + 2 * lse
                         + 2 * B * kl * row * 2))

    def mean(bs_):
        ms = float(np.mean([b[0] for b in bs_]))
        by = max(("bytes", "operations"),
                 key=lambda w: sum(b[1] == w for b in bs_))
        return ms, by
    return mean(fwd), mean(dq), mean(dkv)


def sp_library(bst, n, q, k, v, do, scale, dev):
    """Mean time a shard's ``scaled_dot_product_attention`` (q shard against
    the whole K/V, the layout's rows as an element mask) forward and
    backward take: the one PyTorch call that computes a gather shard's
    fwd_lse (out) and dq/dk/dv."""
    mask = dense_attention_mask(bst, dev)
    B, T, _ = q.shape
    H, L = bst.heads, T // n

    def heads(a):
        return a.reshape(B, a.shape[1], H, -1).transpose(1, 2)
    f, b = [], []
    for r in range(n):
        qr = heads(q[:, r * L:(r + 1) * L]).detach().requires_grad_()
        kk, vv = (heads(a).detach().requires_grad_() for a in (k, v))
        m = mask[r * L:(r + 1) * L]
        f.append(time_ms(lambda: nnf.scaled_dot_product_attention(
            qr, kk, vv, attn_mask=m, scale=scale), 10))
        o = nnf.scaled_dot_product_attention(qr, kk, vv, attn_mask=m,
                                             scale=scale)
        dor = heads(do[:, r * L:(r + 1) * L])
        b.append(time_ms(lambda: torch.autograd.grad(
            o, (qr, kk, vv), dor, retain_graph=True), 10))
    return float(np.mean(f)), float(np.mean(b))


def sp_kernel_checks(bst, q, k, v, do, scale, card_line, rows, marks):
    """(a) The flagship attention's shard kernels at full width in one
    process, at sp 2 and 4: gather mode (each shard's fwd_lse, dq and
    dk/dv on its tables) and the ring (n² pair launches, merged; dq in
    f32), counted; each against the unsharded kernels (gather's y, lse and
    dq bit for bit, its summed dk/dv within f32 rounding; the ring within
    the bf16 tolerance) and against its plain version on the same tables;
    the shards' device time beside the unsharded launch's."""
    bf = torch.bfloat16
    y0, lse0 = bst._kernel_fwd(q, k, v, scale, True)
    dq0, dk0, dv0 = bst._kernel_bwd(q, k, v, do, y0, lse0, scale)
    n_all = sum(n + n * n for n in SP_SHARDS)
    reset_counts()
    runs = {}
    for n in SP_SHARDS:
        runs[("gather", n)] = gathered(sp_gather(bst, n, q, k, v, do, scale))
        runs[("ring", n)] = sp_ring(bst, n, q, k, v, do, scale)
    torch.cuda.synchronize()
    launches = read_counts()
    want = dict.fromkeys(launches, 0)
    want.update({"bst_attn_fwd_lse": n_all, "bst_attn_dq": n_all,
                 "bst_attn_dkv": n_all})
    check(launches == want,
          f"sequence-parallel shards at sp {SP_SHARDS}, gather and ring: "
          f"launches {launches}, expected {want} (gather n of each, the "
          f"ring n² pairs of each)")
    for n in SP_SHARDS:
        y, lse, dq, dk, dv = runs[("gather", n)]
        check(torch.equal(y, y0) and torch.equal(lse, lse0)
              and torch.equal(dq, dq0),
              f"gather sp {n}: the shards' y, lse and dq concatenated equal "
              f"the unsharded kernels' bit for bit (each row walks its "
              f"entries in the same order)")
        for name, got, ref in (("dk", dk, dk0), ("dv", dv, dv0)):
            compare(f"gather sp {n}: {name} summed over the shards against "
                    f"the unsharded kernel (f32)", got, ref,
                    TOL[torch.float32])
        y, lse, dq, dk, dv = runs[("ring", n)]
        compare_fwd(f"ring sp {n}: y merged over {n * n} pair launches "
                    f"against the unsharded kernel", y, y0, bf)
        compare(f"ring sp {n}: lse merged", lse, lse0, LSE_TOL)
        for name, got, ref in (("dq (f32)", dq, dq0), ("dk", dk, dk0),
                               ("dv", dv, dv0)):
            compare(f"ring sp {n}: {name} summed over the pairs against "
                    f"the unsharded kernel", got, ref, ATTN_TOL[bf],
                    norm_tol=ATTN_NORM_TOL)
    # each against its plain version on the same tables
    errs = {}
    for n in SP_SHARDS:
        kern = runs[("gather", n)]
        ref = gathered(sp_gather(bst, n, q, k, v, do, scale, False))
        errs[("gather", n)] = (
            compare_fwd(f"gather sp {n}: y against the plain version on "
                        f"the shard tables", kern[0], ref[0], bf),
            compare(f"gather sp {n}: lse against the plain version",
                    kern[1], ref[1], LSE_TOL),
            compare(f"gather sp {n}: dq against the plain version",
                    kern[2], ref[2], ATTN_TOL[bf], norm_tol=ATTN_NORM_TOL),
            max(compare(f"gather sp {n}: {nm} against the plain version",
                        kern[i], ref[i], ATTN_TOL[bf], norm_tol=ATTN_NORM_TOL)
                for nm, i in (("dk", 3), ("dv", 4))))
        kern = runs[("ring", n)]
        ref = sp_ring(bst, n, q, k, v, do, scale, False)
        errs[("ring", n)] = (
            compare_fwd(f"ring sp {n}: y against the plain version on the "
                        f"pair tables", kern[0], ref[0], bf),
            compare(f"ring sp {n}: lse against the plain version", kern[1],
                    ref[1], LSE_TOL),
            compare(f"ring sp {n}: dq (f32) against the plain version",
                    kern[2], ref[2], ATTN_TOL[bf], norm_tol=ATTN_NORM_TOL),
            max(compare(f"ring sp {n}: {nm} against the plain version",
                        kern[i], ref[i], ATTN_TOL[bf], norm_tol=ATTN_NORM_TOL)
                for nm, i in (("dk", 3), ("dv", 4))))
        del ref
    del runs
    torch.cuda.empty_cache()

    # device time: the unsharded launches beside each shard's, one
    # profiled window each (the forward and the backward, all shards)
    keys = tuple(attn_kernel_key(kind) for kind in ("fwd", "dq", "dkv"))
    one = profiled_launches(lambda: bst._kernel_bwd(
        q, k, v, do, *bst._kernel_fwd(q, k, v, scale, True), scale), keys)
    B, T, _ = q.shape
    H, hs = bst.heads, q.shape[-1] // bst.heads
    lib = {n: sp_library(bst, n, q, k, v, do, scale, q.device)
           for n in SP_SHARDS}
    for n in SP_SHARDS:
        for mode, fn in (("gather", sp_gather), ("ring", sp_ring)):
            # a ring pair's keys are one chunk's: the forward's route may
            # differ from the unsharded one's
            blocks = bst.ctx_blks_k // (n if mode == "ring" else 1)
            mkeys = tuple(attn_kernel_key(kind, key_blocks=blocks)
                          for kind in ("fwd", "dq", "dkv"))
            got = profiled_launches(
                lambda: fn(bst, n, q, k, v, do, scale), mkeys)
            mk = shard_marks(bst, n, mode, B, T, H, hs)
            per = n if mode == "gather" else n * n
            print(f"{mode} sp {n} [{card_line}], device ms a launch (its "
                  f"{per} launches' sum; launches recorded over 5 passes) "
                  f"against the unsharded launch: " + "; ".join(
                      f"{short_key(key)} {got[key][0]:.4f} ("
                      f"{got[key][0] * per:.4f}; {got[key][1]}) vs "
                      f"{one[ukey][0]:.4f}, bound a launch {b[0]:.4f} "
                      f"({b[1]})" for key, ukey, b in zip(mkeys, keys, mk)),
                  flush=True)
            if n != SP_SHARDS[-1]:
                continue
            # the kernels line's rows: the sp-4 launches beside their plain
            # versions' time a launch (the plain backward computes dq, dk
            # and dv in one call: its time stands beside both)
            pf, pb = sp_plain_ms(bst, n, mode, q, k, v, do, scale)
            names = (("attn_fwd_lse_sp4", "attn_dq_sp4", "attn_dkv_sp4")
                     if mode == "gather" else
                     ("attn_fwd_lse_ring4", "attn_dq_ring_f32",
                      "attn_dkv_ring4"))
            e = errs[(mode, n)]
            libs = ((lib[n][0], lib[n][1], lib[n][1]) if mode == "gather"
                    else (None, None, None))
            for name, key, err, b, plain_ms, lib_ms in zip(
                    names, mkeys, (max(e[0], e[1]), e[2], e[3]), mk,
                    (pf, pb, pb), libs):
                rows[name] = (err, got[key][0], plain_ms)
                marks[name] = (b[0], b[1], lib_ms)
    print(f"unsharded launches at batch {B} x {T} [{card_line}]: "
          + ", ".join(f"{short_key(key)} {one[key][0]:.4f} ms"
                      for key in keys)
          + "; a gather shard's SDPA forward / backward (sp "
          + ", ".join(str(n) for n in SP_SHARDS) + "): "
          + ", ".join(f"{lib[n][0]:.4f} / {lib[n][1]:.4f} ms"
                      for n in SP_SHARDS), flush=True)
    return launches


def sp_plain_ms(bst, n, mode, q, k, v, do, scale):
    """The plain versions' mean time a launch of a shard's (gather) or a
    pair's (ring) forward and backward, on their tables."""
    from blocksparse_tpu_torch.ops.transformer import _rowsum
    from blocksparse_tpu_torch.parallel import sequence as seq
    L = q.shape[1] // n

    def cut(a, i):
        return a[:, i * L:(i + 1) * L]
    pairs = [(r, None) for r in range(n)] if mode == "gather" else \
        [(r, j) for r in range(n) for j in range(n)]
    args = []
    for r, j in pairs:
        tab = seq.shard_tables(bst, n, r, j, q.device)
        kk, vv = (k, v) if j is None else (cut(k, j), cut(v, j))
        y, lse = seq.shard_forward(bst, cut(q, r), kk, vv, scale, tab, False)
        args.append((cut(q, r), kk, vv, cut(do, r), tab, y, lse))

    def fwd():
        for qr, kk, vv, _, tab, _, _ in args:
            seq.shard_forward(bst, qr, kk, vv, scale, tab, False)

    def bwd():
        for qr, kk, vv, dor, tab, y, lse in args:
            seq.shard_backward(bst, qr, kk, vv, dor,
                               _rowsum(dor, y, bst.heads), lse, scale, tab,
                               False, dq_dtype=torch.float32)
    return time_ms(fwd, 2) / len(pairs), time_ms(bwd, 2) / len(pairs)


def nccl_train_step(bt, model, sd, cfg, dev, card_line):
    """(b) The flagship's sharded train step through NCCL at world size 1
    (``make_mesh(dp=1)`` on cuda, a FileStore in a temporary directory):
    SP_STEPS steps against the single-device captured step from the same
    params: loss and grad_norm each step within the train step's
    tolerance, and metrics and parameters bit for bit; whether it was
    captured as a CUDA graph, its first call counted, its ms a step beside
    the single-device step's, in turns."""
    import os
    import tempfile

    import torch.distributed as dist
    from blocksparse_tpu_torch.parallel import make_mesh
    rng = np.random.RandomState(SEED + 18)
    seq = torch.from_numpy(rng.randint(0, cfg.n_vocab,
                                       (BATCH, cfg.ctx + 1))).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh(dp=1, device="cuda")
            sharded = bt.SparseTransformerLM(cfg, device=dev, mesh=mesh)
            opt = bt.AdamOptimizer(learning_rate=LR, zero_nans=True,
                                   zero_infs=True)
            runs, launches, steps = {}, None, {}
            for label, m, mesh_ in (("single", model, None),
                                    ("sharded", sharded, mesh)):
                m.load_state_dict(sd)
                step = m.make_train_step(opt, mesh=mesh_, clip_norm=CLIP)
                state = opt.init(dict(m.named_parameters()))
                scale = torch.tensor(LOSS_SCALE, device=dev)
                metrics = []
                reset_counts()
                for i in range(SP_STEPS):
                    state, met, scale = step(state, tokens, targets, scale)
                    metrics.append({k: v.item() for k, v in met.items()})
                    if i == 0 and label == "sharded":
                        torch.cuda.synchronize()
                        launches = read_counts()
                runs[label] = (metrics, snapshot(m))
                steps[label] = (step, state, scale)
            graphs = len(steps["sharded"][0]._graphs)
            check(graphs == 1 and len(steps["sharded"][0].captures) == 1,
                  f"sharded step on an NCCL group of world size 1 "
                  f"[{card_line}]: captured as one CUDA graph (the "
                  f"gradient and norm all-reduces inside it); its first "
                  f"call launched {launches}")
            for i, (a, b) in enumerate(zip(runs["sharded"][0],
                                           runs["single"][0])):
                for key in ("loss", "grad_norm"):
                    check(abs(a[key] - b[key]) <= STEP_LOSS_TOL * abs(b[key]),
                          f"sharded step {i + 1} {key} {a[key]:.6f} vs the "
                          f"single-device step's {b[key]:.6f} (tol "
                          f"{STEP_LOSS_TOL:g} relative)")
            same = all(a == b for a, b in zip(runs["sharded"][0],
                                              runs["single"][0])) and all(
                torch.equal(v, runs["single"][1][k])
                for k, v in runs["sharded"][1].items())
            check(same, f"sharded step (world 1) equals the single-device "
                        f"step bit for bit over {SP_STEPS} steps (metrics and "
                        f"every parameter): a one-rank all-reduce is a copy "
                        f"and the norm sums its squares in the same order")

            def timing(label):
                step, state, scale = steps[label]

                def one():
                    nonlocal state, scale
                    state, _, scale = step(state, tokens, targets, scale)
                return time_ms(one, TIMED_STEPS)
            turns = in_turns({"single": "single", "sharded": "sharded"},
                             timing)
            print(f"train step [{card_line}]: sharded on NCCL (world 1, "
                  f"captured) " + " / ".join(f"{x:.2f}" for x in
                                             turns["sharded"])
                  + " ms, single-device (captured) "
                  + " / ".join(f"{x:.2f}" for x in turns["single"])
                  + f" ms (in turns, each the mean of {TIMED_STEPS} steps "
                  f"by CUDA events)", flush=True)
        finally:
            dist.destroy_process_group()
    model.load_state_dict(sd)
    del sharded, steps, runs
    torch.cuda.empty_cache()
    return launches


def parallel_path(bt, model, sd, cfg, dev, g, card_line, rows, marks):
    """The parallel phase: (a) the shard kernels at full width, (b) the
    sharded train step on NCCL at world size 1.  Returns the counted
    launches of (a)."""
    q, k, v, do = sp_inputs(model, dev, g)
    launches = sp_kernel_checks(model.bst, q, k, v, do,
                                1.0 / np.sqrt(model.hs), card_line, rows,
                                marks)
    del q, k, v, do
    torch.cuda.empty_cache()
    nccl_train_step(bt, model, sd, cfg, dev, card_line)
    return launches


# ---------------- pipeline and experts: GPipe stages and ep shards

PP_STAGES, PP_MICRO = (2, 3), 4
PP_DROP_SEED = SEED + 23    # the pipelined dropout's generator seed
EP_SHARDS = (2, 4)


def one_process():
    """``tests/torch_one_process.py``: the ranks of a pipeline or of an ep
    group driven in turn in one process, through the port's per-stage and
    per-shard steps (the same drivers the tests hold against gloo
    ranks)."""
    tests = str(Path(__file__).resolve().parent / "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_one_process
    return torch_one_process


def unpipelined_grads(model, tokens, targets, scale, dropout=None):
    """The single-device step's loss and the gradients of loss·scale by
    parameter name (as ``_TrainStep._eager`` takes them); ``dropout`` as
    ``loss`` takes it."""
    params = dict(model.named_parameters())
    loss = model.loss(tokens, targets, dropout=dropout)
    grads = torch.autograd.grad(loss * scale, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def grad_norm(grads, scale):
    return float(torch.sqrt(sum((g.float() / scale).square().sum()
                                for g in grads.values())))


def staged_grads(model, tokens, targets, S, n_micro, scale, dropout=None):
    """The flagship's pipelined loss with its S stages run in turn in one
    process (``one_process()``'s ``run_stages``/``backprop_stages``:
    ``stage_forward``/``stage_backward`` on ``model._stage`` over each
    stage's blocks, n_micro microbatches, the activations handed over by
    tensor, the microbatches backwards in reverse); the embedding and the
    head outside the stages, as ``loss_pp`` has them.  With ``dropout``
    (a generator) the pairs of every layer are drawn at the microbatch's
    shape as ``loss_pp`` draws them (``_stage_masks``), and each stage
    carries its layers' pairs as (blocks, masks).  Returns (the loss, the
    gradients of loss·scale by parameter name, (the stages, each stage's
    inputs, the outputs' cotangent) for ``stage_metrics``)."""
    from blocksparse_tpu_torch.ops.transformer import softmax_cross_entropy
    from blocksparse_tpu_torch.parallel import microbatch, unmicrobatch
    run_stages, backprop_stages = (one_process().run_stages,
                                   one_process().backprop_stages)
    n = model.n_local // S
    blocks = [model.h[s * n:(s + 1) * n] for s in range(S)]
    xm = microbatch(model._embed(tokens, model.wpe[None, :tokens.shape[1]]),
                    n_micro)
    masks = model._stage_masks(dropout, xm.shape[1:], xm.device)
    stages = blocks if masks is None else [
        (b, masks[s * n:(s + 1) * n]) for s, b in enumerate(blocks)]
    recs, ym, _ = run_stages(model._stage, stages, xm, with_aux=True)
    inputs = [[rec[0].detach() for rec in r] for r in recs]
    ym.requires_grad_()
    loss = softmax_cross_entropy(model._logits(unmicrobatch(ym)),
                                 targets).mean()
    head = [model.wte, model.lnf_g, model.lnf_b]
    dym, *dhead = torch.autograd.grad(loss * scale, [ym] + head)
    dx, stage_grads = backprop_stages(recs, stages, dym)
    dwte, dwpe = torch.autograd.grad(xm, [model.wte, model.wpe], dx)
    names = {id(p): k for k, p in model.named_parameters()}
    grads = {names[id(p)]: gr for s in range(S)
             for p, gr in zip(blocks[s].parameters(), stage_grads[s])}
    grads.update(wte=dhead[0] + dwte, wpe=dwpe, lnf_g=dhead[1],
                 lnf_b=dhead[2])
    return loss.detach(), grads, (stages, inputs, dym)


def check_against_unpipelined(what, loss, grads, ref, scale):
    """A pipelined loss and its gradients against the single-device
    step's, at the train step's tolerances: the loss and the grad norm
    STEP_LOSS_TOL relative, each gradient GRAD_TOL of its max|ref|."""
    ref_loss, ref_grads = ref
    gn, ref_gn = grad_norm(grads, scale), grad_norm(ref_grads, scale)
    for key, a, b in (("loss", loss.item(), ref_loss.item()),
                      ("grad_norm", gn, ref_gn)):
        check(abs(a - b) <= STEP_LOSS_TOL * abs(b),
              f"{what} {key} {a:.6f} vs the single-device step's {b:.6f} "
              f"(tol {STEP_LOSS_TOL:g} relative)")
    check(set(grads) == set(ref_grads),
          f"{what}: a gradient for every parameter ({len(ref_grads)})")
    return compare_tensors(f"{what} gradients against the single-device "
                           f"step's", grads, ref_grads, GRAD_TOL)


def stage_metrics(model, stages, inputs, dym):
    """Each stage's launches by wrapper and device time (the profiler's
    kernels, summed) over its forwards and backwards of the microbatches,
    rerun from its logged inputs with the outputs' cotangent as dy (the
    kernels' work does not depend on the values)."""
    from blocksparse_tpu_torch.parallel import (stage_backward,
                                                stage_forward,
                                                stage_parameters)
    out = []
    for stage, xs in zip(stages, inputs):
        params = stage_parameters(stage)

        def run():
            for h, d in zip(xs, dym):
                stage_backward(stage_forward(model._stage, stage, h, True),
                               d, params)
        torch.cuda.synchronize()
        reset_counts()
        run()
        torch.cuda.synchronize()
        launches = read_counts()
        _, kernels = device_events(run, lambda ks: len(ks) > 0)
        out.append((sum(e.self_device_time_total for e in kernels) / 1e3,
                    launches))
    return out


EP_ROWS = ("moe_ep_bsmm_fprop_f32", "moe_ep_bsmm_bprop_f32",
           "moe_ep_bsmm_updat_f32", "moe_ep_bsmm_updat_bf16",
           "moe_ep_bsmm_updat_reduce")
PP_ROWS = ("pp_stage_attn_fwd", "pp_stage_attn_fwd_lse", "pp_stage_attn_dq",
           "pp_stage_attn_dkv", "pp_stage_bsmm_fprop", "pp_stage_bsmm_bprop",
           "pp_stage_bsmm_updat", "pp_stage_bsmm_updat_reduce")


def pp_kernel_rows(model, dev, g, card_line, rows, marks):
    """Every kernel the pipeline's stages launch, at the microbatch's
    shapes (batch BATCH / PP_MICRO x 2048), against its plain version:
    the attention's serving forward (gpipe's forward under no_grad), its
    training forward (out and lse), dq and dk/dv; bsmm1's and bsmm2's
    fprop, bprop and updat at N = 4,096 and the updat split's reduce.
    The attention's and bsmm1's device time (profiler), bound and library
    call for the kernels line's pp_stage_* rows."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    from blocksparse_tpu_torch.kernels import bst_attn
    bf, c, bst = torch.bfloat16, model.config, model.bst
    sms = bk.device_sm_count(dev)
    B, T, H, hs, bs = BATCH // PP_MICRO, c.ctx, bst.heads, model.hs, \
        bst.blk_size
    scale = 1.0 / np.sqrt(hs)
    tab = bst._tables(dev)
    plain_args = (tab["q_blk"], tab["k_blk"], tab["mask"], H, bs, scale)
    qkv = torch.randn((B, T, 3 * c.n_embd), device=dev, generator=g).to(bf)
    q, k, v = qkv.split(c.n_embd, dim=-1)
    do = torch.randn((B, T, c.n_embd), device=dev, generator=g).to(bf)
    what = f"(microbatch {B} x {T})"

    def fwd():
        return bst_attn.attention_fwd(q, k, v, tab, H, scale)

    def fwd_lse():
        return bst_attn.attention_fwd_lse(q, k, v, tab, H, scale)

    def fwd_plain():
        return bst_attn.attention_fwd_plain(q, k, v, *plain_args)

    def fwd_lse_plain():
        return bst_attn.attention_fwd_lse_plain(q, k, v, *plain_args)
    (out, lse), (out_ref, lse_ref) = fwd_lse(), fwd_lse_plain()
    err = compare_fwd(f"pp stage bst_attn_fwd_lse out {what}", out, out_ref,
                      bf)
    lse_err = (lse - lse_ref).abs().max().item()
    check(lse_err <= LSE_TOL, f"pp stage bst_attn_fwd_lse lse: max_abs_err "
                              f"{lse_err:.3e} (tol {LSE_TOL:g})")
    err_fwd = compare_fwd(f"pp stage bst_attn_fwd (serving) out {what}",
                          fwd(), fwd_plain(), bf)
    dvec = (do.float() * out_ref.float()).reshape(
        B, T, H, -1).sum(-1).transpose(1, 2).contiguous()

    def dq():
        return bst_attn.attention_dq(q, k, v, do, lse_ref, dvec, tab, H,
                                     scale)

    def dkv():
        return bst_attn.attention_dkv(q, k, v, do, lse_ref, dvec, tab, H,
                                      scale)

    def bwd_plain():
        return bst_attn.attention_bwd_plain(q, k, v, do, lse_ref, dvec,
                                            *plain_args)
    dq_ref, dk_ref, dv_ref = bwd_plain()
    err_dq = compare(f"pp stage bst_attn_dq {what}", dq(), dq_ref,
                     ATTN_TOL[bf], norm_tol=ATTN_NORM_TOL)
    dk, dv = dkv()
    err_dkv = max(compare(f"pp stage bst_attn_dkv dk {what}", dk, dk_ref,
                          ATTN_TOL[bf], norm_tol=ATTN_NORM_TOL),
                  compare(f"pp stage bst_attn_dkv dv {what}", dv, dv_ref,
                          ATTN_TOL[bf], norm_tol=ATTN_NORM_TOL))
    # the plain backward computes dq, dk and dv in one call: its time
    # stands beside both kernels
    bwd_ms = time_ms(bwd_plain, 5)
    rows["pp_stage_attn_fwd"] = (
        err_fwd, kernel_device_ms(fwd, attn_kernel_key("fwd")),
        time_ms(fwd_plain, 5))
    rows["pp_stage_attn_fwd_lse"] = (
        max(err, lse_err),
        kernel_device_ms(fwd_lse, attn_kernel_key("fwd")),
        time_ms(fwd_lse_plain, 5))
    rows["pp_stage_attn_dq"] = (
        err_dq, kernel_device_ms(dq, attn_kernel_key("dq")), bwd_ms)
    rows["pp_stage_attn_dkv"] = (
        err_dkv, kernel_device_ms(dkv, attn_kernel_key("dkv")), bwd_ms)
    mask = dense_attention_mask(bst, dev)
    qh, kh, vh = (a.reshape(B, T, H, hs).transpose(1, 2).detach()
                  .requires_grad_() for a in (q, k, v))
    lib = time_ms(lambda: nnf.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask, scale=scale), 20)
    o = nnf.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                         scale=scale)
    doh = do.reshape(B, T, H, hs).transpose(1, 2)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o, (qh, kh, vh), doh,
                                                  retain_graph=True), 20)
    e = bst.blocks * B * H * bs * bs * hs
    one, lse_b = B * T * H * hs * 2, B * H * T * 4
    marks["pp_stage_attn_fwd"] = (*bound(4 * e, 4 * one), lib)
    marks["pp_stage_attn_fwd_lse"] = (*bound(4 * e, 4 * one + lse_b), lib)
    # q, k, v, dO, lse, D in; dq (bf16) out; dk, dv (f32) out
    marks["pp_stage_attn_dq"] = (*bound(6 * e, 5 * one + 2 * lse_b), lib_bwd)
    marks["pp_stage_attn_dkv"] = (*bound(8 * e, 8 * one + 2 * lse_b),
                                  lib_bwd)
    del qkv, q, k, v, do, out, lse, out_ref, lse_ref, dvec, dq_ref, dk_ref
    del dv_ref, dk, dv, mask, qh, kh, vh, o, doh
    N = B * T
    for name, op in (("bsmm1", model.bsmm1), ("bsmm2", model.bsmm2)):
        ref_op = bt_ops(op)
        x = torch.randn((N, op.C), device=dev, generator=g).to(bf)
        dy = torch.randn((N, op.K), device=dev, generator=g).to(bf)
        w = (torch.randn(op.w_shape, device=dev, generator=g) * 0.02).to(bf)
        calls = {"fprop": (lambda: op._xprop(x, w, "f"),
                           lambda: ref_op._xprop(x, w, "f"), TOL[bf]),
                 "bprop": (lambda: op._xprop(dy, w, "b"),
                           lambda: ref_op._xprop(dy, w, "b"), TOL[bf]),
                 "updat": (lambda: op._updat(x, dy),
                           lambda: ref_op._updat(x, dy), UPDAT_TOL)}
        routes = {"f": op._route(N, "f", sms), "b": op._route(N, "b", sms),
                  "updat runs": op.updat_splits(N, bf)}
        errs = {d: compare(f"pp stage bsmm_{d} {name} N={N} bf16 (routes "
                           f"{routes})", fn(), ref(), tol)
                for d, (fn, ref, tol) in calls.items()}
        if name == "bsmm1":
            for d, (fn, ref, _) in calls.items():
                rows[f"pp_stage_bsmm_{d}"] = (
                    errs[d], kernel_device_ms(
                        fn, kernel_of(op, N, d[0])[0]), time_ms(ref, 5))
            wd = dense_weight(op, w)
            b2 = op.bsize ** 2
            xb = 2 * (N * op.C + op.blocks * b2 + N * op.K)
            flops = xprop_flops(op, N)
            marks["pp_stage_bsmm_fprop"] = (*bound(flops, xb),
                                            time_ms(lambda: x @ wd, 20))
            marks["pp_stage_bsmm_bprop"] = (*bound(flops, xb),
                                            time_ms(lambda: dy @ wd.t(), 20))
            marks["pp_stage_bsmm_updat"] = (
                *bound(flops, 2 * N * (op.C + op.K) + 4 * op.blocks * b2),
                time_ms(lambda: x.t() @ dy, 20))
            del wd
        del x, dy, w
    updat_reduce_checks(model.bsmm1, N, dev, g, rows,
                        "pp_stage_bsmm_updat_reduce")
    marks["pp_stage_bsmm_updat_reduce"] = reduce_mark(
        rows, "pp_stage_bsmm_updat_reduce")
    for name in PP_ROWS:
        err, ms, pms = rows[name]
        print(f"{name} (microbatch {B} x {T}): device {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound {marks[name][0]:.4f} ms "
              f"({marks[name][1]}), library {marks[name][2]:.4f} ms "
              f"[{card_line}]", flush=True)
    torch.cuda.empty_cache()


def gpipe_world1(bt, cfg, sd, tokens, targets, ref, dev, scale, card_line,
                 drop_ref):
    """``gpipe`` itself through the LM's ``loss_pp`` on an NCCL group of
    world size 1 (``make_mesh(pp=1)``), PP_MICRO microbatches: the loss
    and every gradient against the single-device step's; the forward
    under no_grad gives the same loss.  Then with resid_pdrop DROPOUT
    and a generator seeded PP_DROP_SEED: the loss and every gradient
    against ``drop_ref`` (the single-device step's given that seed's
    pairs tiled over the microbatches, ROADMAP F11), and the loss given
    the list of pairs that seed draws is the generator's bit for bit."""
    import dataclasses
    import os
    import tempfile

    import torch.distributed as dist
    from blocksparse_tpu_torch.parallel import make_mesh
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_mesh(pp=1, device="cuda")
            m = bt.SparseTransformerLM(dataclasses.replace(
                cfg, pp_microbatch=PP_MICRO), device=dev, mesh=mesh)
            m.load_state_dict(sd)
            params = dict(m.named_parameters())
            loss = m.loss_pp(tokens, targets)
            grads = dict(zip(params, torch.autograd.grad(
                loss * scale, list(params.values()))))
            check_against_unpipelined(
                f"gpipe on NCCL (world 1, {PP_MICRO} microbatches) "
                f"[{card_line}]", loss.detach(), grads, ref, scale)
            with torch.no_grad():
                again = m.loss_pp(tokens, targets)
            check(torch.equal(again, loss.detach()),
                  "gpipe's forward under no_grad gives the same loss bit "
                  "for bit")
            m.config.resid_pdrop = DROPOUT

            def seeded():
                return torch.Generator(device=dev).manual_seed(PP_DROP_SEED)
            loss = m.loss_pp(tokens, targets, dropout=seeded())
            grads = dict(zip(params, torch.autograd.grad(
                loss * scale, list(params.values()))))
            check_against_unpipelined(
                f"gpipe on NCCL (world 1, {PP_MICRO} microbatches) with "
                f"dropout {DROPOUT} [{card_line}]", loss.detach(), grads,
                drop_ref, scale)
            pairs = m._stage_masks(seeded(), (BATCH // PP_MICRO, cfg.ctx,
                                              cfg.n_embd), dev)
            with torch.no_grad():
                listed = m.loss_pp(tokens, targets, dropout=pairs)
            check(torch.equal(listed, loss.detach()),
                  f"gpipe (world 1) with dropout: the list of pairs the "
                  f"seed draws gives the generator's loss "
                  f"{loss.item():.6f} bit for bit")
        finally:
            dist.destroy_process_group()
    del m, grads
    torch.cuda.empty_cache()


def ep_layer_checks(bt, dev, g, card_line, rows, marks):
    """(b) The full-width MoE LM's layer (8 experts of 512 -> 2048 -> 512
    at b32, top-1, capacity factor 1.25; 16,384 bf16 tokens) at ep 2 and
    4, shard by shard in one process (``one_process().run_ep_shards``:
    each shard routes its own tokens, the all-to-all by slicing, the
    local experts' f32 products at N = ep·C), counted; forward and
    gradients against the ep 1 layer on each shard's tokens (the same
    per-shard routing); then the experts' products at N = ep·C against
    their plain versions, timed.  Returns the counted launches."""
    from blocksparse_tpu_torch.kernels import bsmm as bk
    from blocksparse_tpu_torch.ops.moe import BlocksparseMoE
    f32, bf = torch.float32, torch.bfloat16
    kw = dict(block_size=32, density=1.0, capacity_factor=MOE_CF, k=MOE_K)
    one = BlocksparseMoE(MOE_EXPERTS, 512, 2048, **kw)
    params = one.init(g, device=dev)
    T = BATCH * 2048
    x = torch.randn((T, 512), device=dev, generator=g).to(bf)
    dy = torch.randn((T, 512), device=dev, generator=g)
    sms = bk.device_sm_count(dev)
    launches, shapes = None, {}
    for ep in EP_SHARDS:
        moe = BlocksparseMoE(MOE_EXPERTS, 512, 2048, ep=ep, **kw)
        xs, dys = x.chunk(ep), dy.chunk(ep)
        C = moe.capacity(T // ep)
        N = ep * C
        shapes[ep] = (C, N)
        # the ep 1 layer on each shard's tokens
        p1 = {k: t.detach().requires_grad_() for k, t in params.items()}
        x1 = [t.detach().requires_grad_() for t in xs]
        outs1 = [one(p1, t) for t in x1]
        loss1 = sum((y * d).sum() + a for (y, a), d in zip(outs1, dys))
        g1 = torch.autograd.grad(loss1, x1 + list(p1.values()))
        # the ep shards, counted
        pe = {k: t.detach().requires_grad_() for k, t in params.items()}
        xe = [t.detach().requires_grad_() for t in xs]
        torch.cuda.synchronize()
        reset_counts()
        outs = one_process().run_ep_shards(moe, pe, xe)
        loss = sum((y * d).sum() + a for (y, a), d in zip(outs, dys))
        ge = torch.autograd.grad(loss, xe + list(pe.values()))
        torch.cuda.synchronize()
        counted = read_counts()
        launches = counted if launches is None else {
            k: launches[k] + v for k, v in counted.items()}
        same_y = all(torch.equal(a[0], b[0]) for a, b in zip(outs, outs1))
        same_g = all(torch.equal(a, b) for a, b in zip(ge, g1))
        # bsmm1's output is rounded to the tokens' bf16 (F6): where the
        # two N take routes that sum in other orders, a rounding may flip
        for r, ((y, a), (y1, a1)) in enumerate(zip(outs, outs1)):
            compare(f"MoE ep {ep} shard {r} y (T {T // ep}, C {C}, experts "
                    f"at N {N}) against the ep 1 layer", y, y1, TOL[bf])
            check(abs(a.item() - a1.item()) <= 1e-6,
                  f"MoE ep {ep} shard {r} aux {a.item():.7f} vs "
                  f"{a1.item():.7f}")
        names = [f"dx{r}" for r in range(ep)] + [f"d{k}" for k in params]
        compare_tensors(f"MoE ep {ep} shards' VJP against the ep 1 layer's",
                        dict(zip(names, ge)), dict(zip(names, g1)), TOL[bf])
        routes = {d: moe.bsmm1._route(N, d, sms) for d in ("f", "b")}
        routes1 = {d: moe.bsmm1._route(C, d, sms) for d in ("f", "b")}
        print(f"MoE ep {ep} [{card_line}]: shards route {T // ep} tokens "
              f"each, C {C}; the experts' products at N = ep·C = {N} (route "
              f"{routes}) against the ep 1 layer's at N = C (route "
              f"{routes1}); y bit for bit: {same_y}; every gradient bit for "
              f"bit: {same_g}; launches {counted}", flush=True)
        del p1, x1, outs1, g1, pe, xe, outs, ge
        torch.cuda.empty_cache()
    # the experts' products at the ep N (ep 4): f32 (F6), and bsmm1's
    # updat on the tensor cores (bf16 x and du) with its split's reduce
    C, N = shapes[EP_SHARDS[-1]]
    op1, op2 = one.bsmm1, one.bsmm2
    ref1, ref2 = bt_ops(op1), bt_ops(op2)
    xe = torch.randn((N, op1.C), device=dev, generator=g)
    du = torch.randn((N, op1.K), device=dev, generator=g)
    w = torch.randn(op1.w_shape, device=dev, generator=g) * 0.02
    xb, dub = xe.to(bf), du.to(bf)
    flops = xprop_flops(op1, N)
    b2 = op1.bsize ** 2
    nb = 4 * (op1.C * N + op1.blocks * b2 + op1.K * N)
    wd = dense_weight(op1, w)
    calls = {  # name: (kernel, plain, tolerance, device time, bytes, peak)
        "moe_ep_bsmm_fprop_f32": (
            lambda: op1._xprop(xe, w, "f"), lambda: ref1._xprop(xe, w, "f"),
            TOL[f32], lambda fn: kernel_device_ms(fn, "bsmm_xprop_nc_kernel"),
            nb, PEAK_F32_FLOPS, lambda: xe @ wd),
        "moe_ep_bsmm_bprop_f32": (
            lambda: op1._xprop(du, w, "b"), lambda: ref1._xprop(du, w, "b"),
            TOL[f32], lambda fn: device_ms_per_call(
                fn, lambda k: "bsmm_xprop_nc" in k or "bsmm_merge" in k),
            nb, PEAK_F32_FLOPS, lambda: du @ wd.t()),
        "moe_ep_bsmm_updat_f32": (
            lambda: op2._updat(du, xe), lambda: ref2._updat(du, xe),
            UPDAT_TOL, lambda fn: kernel_device_ms(fn, "bsmm_updat_nc_kernel"),
            nb, PEAK_F32_FLOPS, lambda: du.t() @ xe),
        "moe_ep_bsmm_updat_bf16": (
            lambda: op1._updat(xb, dub), lambda: ref1._updat(xb, dub),
            UPDAT_TOL,
            lambda fn: kernel_device_ms(fn, kernel_of(op1, N, "u")[0]),
            2 * N * (op1.C + op1.K) + 4 * op1.blocks * b2, PEAK_FLOPS,
            lambda: xb.t() @ dub)}
    rows["moe_ep_bsmm_updat_bf16_source"] = kernel_of(op1, N, "u")[1]
    for name, (fn, ref, tol, dev_ms, nbytes, peak, lib) in calls.items():
        err = compare(f"MoE ep {name[7:]} N={N}", fn(), ref(), tol)
        rows[name] = (err, dev_ms(fn), time_ms(ref, 5))
        marks[name] = (*bound(flops, nbytes, peak), time_ms(lib, 20))
    updat_reduce_checks(op1, N, dev, g, rows, "moe_ep_bsmm_updat_reduce")
    marks["moe_ep_bsmm_updat_reduce"] = reduce_mark(
        rows, "moe_ep_bsmm_updat_reduce")
    # the MoE LM step's expert products at N = C = 2,560, device time
    # (PERF.md §6, rows 1 and 8)
    step = {"moe_ep_bsmm_fprop_f32": "fprop 0.244",
            "moe_ep_bsmm_bprop_f32": "bprop 0.334",
            "moe_ep_bsmm_updat_f32": "updat 0.401"}
    for name in EP_ROWS:
        err, ms, pms = rows[name]
        was = (f" (the MoE LM step's {step[name]} ms at N = C 2,560)"
               if name in step else "")
        print(f"{name} (N = ep·C = {N}, routes "
              f"{op1._route(N, 'f', sms)}/{op1._route(N, 'b', sms)}, bsmm1 "
              f"updat runs {op1.updat_splits(N, bf)}): device {ms:.4f} "
              f"ms{was}, plain {pms:.4f} ms, bound {marks[name][0]:.4f} ms "
              f"({marks[name][1]}), library {marks[name][2]:.4f} ms "
              f"[{card_line}]", flush=True)
    del xe, du, w, wd, xb, dub, x, dy, params
    torch.cuda.empty_cache()
    return launches


@contextlib.contextmanager
def resid_dropout(model, p):
    """``model`` with ``config.resid_pdrop`` p for the block."""
    saved = model.config
    model.config = dataclasses.replace(saved, resid_pdrop=p)
    try:
        yield model
    finally:
        model.config = saved


def pp_dropout_stages(model, cfg, tokens, targets, scale, ref, dev,
                      card_line):
    """Residual dropout through the pipeline at full width (``model``
    with resid_pdrop DROPOUT): the stages at pp 2 and 3 run in turn in
    one process, each carrying its layers' pairs of one draw from a
    generator seeded PP_DROP_SEED at the microbatch's shape, against the
    single-device step given those pairs tiled over the microbatches
    (ROADMAP F11: every microbatch gets its layer's one pair, and a
    layer's pair does not depend on pp); the draw's device time.
    Returns (that reference, the stages' logs by S for
    ``stage_metrics``)."""
    def seeded():
        return torch.Generator(device=dev).manual_seed(PP_DROP_SEED)
    shape = (BATCH // PP_MICRO, cfg.ctx, cfg.n_embd)
    pairs = model._stage_masks(seeded(), shape, dev)
    tiled = [tuple(m.repeat(PP_MICRO, 1, 1) for m in p) for p in pairs]
    drop_ref = unpipelined_grads(model, tokens, targets, scale, tiled)
    check(abs(drop_ref[0].item() - ref[0].item()) > 1e-4,
          f"pipelined dropout {DROPOUT}: the tiled pairs move the "
          f"single-device loss {ref[0].item():.6f} -> "
          f"{drop_ref[0].item():.6f}")
    def gap(got, want):
        return max(((got[k].float() - w.float()).abs().max()
                    / w.float().abs().max()).item() for k, w in want.items())
    logs = {}
    for S in PP_STAGES:
        loss, grads, logs[S] = staged_grads(model, tokens, targets, S,
                                            PP_MICRO, scale, seeded())
        check_against_unpipelined(
            f"pp {S} stages in one process ({PP_MICRO} microbatches) with "
            f"dropout {DROPOUT} against the tiled pairs", loss, grads,
            drop_ref, scale)
        near, far = gap(grads, drop_ref[1]), gap(grads, ref[1])
        check(2 * near < far,
              f"pp {S} with dropout: the gradients' worst gap to the tiled "
              f"pairs' step {near:.4f} of max|ref|, under half their gap "
              f"to the step without dropout {far:.4f}")
        del grads
    draw_ms = time_ms(lambda: model._stage_masks(seeded(), shape, dev), 5)
    print(f"pipelined dropout's masks [{card_line}]: {2 * cfg.n_layer} "
          f"draws of {shape} a call, {draw_ms:.4f} ms (CUDA events, mean "
          f"of 5)", flush=True)
    del pairs, tiled
    return drop_ref, logs


def pipeline_experts_path(bt, model, sd, cfg, dev, g, card_line, rows,
                          marks):
    """The pipeline and experts phase: (a) the flagship at full width,
    its stages at pp 2 and 3 run in turn in one process (n_micro
    PP_MICRO) against the single-device step, then with residual dropout
    against the single-device step given the tiled pairs
    (``pp_dropout_stages``), each stage's device time and launches beside
    the unpipelined step's and with dropout beside without, and
    ``gpipe`` on NCCL at world size 1, without and with dropout; the
    pp_stage_* kernel rows; (b) the MoE layer's ep shards.  Returns (the
    counted launches of (a), of (b))."""
    rng = np.random.RandomState(SEED + 19)
    seq = torch.from_numpy(rng.randint(0, cfg.n_vocab,
                                       (BATCH, cfg.ctx + 1))).to(dev)
    tokens, targets = seq[:, :-1], seq[:, 1:]
    scale = LOSS_SCALE
    model.load_state_dict(sd)
    ref = unpipelined_grads(model, tokens, targets, scale)
    torch.cuda.synchronize()
    reset_counts()
    unpipelined_grads(model, tokens, targets, scale)
    torch.cuda.synchronize()
    ref_launches = read_counts()
    _, kernels = device_events(lambda: unpipelined_grads(
        model, tokens, targets, scale), lambda ks: len(ks) > 0)
    ref_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    keys = ("bst_attn_fwd_lse", "bst_attn_dq", "bst_attn_dkv", "bsmm_fprop",
            "bsmm_bprop", "bsmm_updat", "bsmm_updat_reduce")
    print(f"unpipelined step's loss and gradients (8 x 2048) "
          f"[{card_line}]: device {ref_ms:.2f} ms, launches "
          f"{ {k: ref_launches[k] for k in keys} }", flush=True)
    torch.cuda.synchronize()
    reset_counts()
    logs = {}
    for S in PP_STAGES:
        loss, grads, logs[S] = staged_grads(model, tokens, targets, S,
                                            PP_MICRO, scale)
        check_against_unpipelined(f"pp {S} stages in one process "
                                  f"({PP_MICRO} microbatches)", loss, grads,
                                  ref, scale)
        del grads
    with resid_dropout(model, DROPOUT):
        drop_ref, drop_logs = pp_dropout_stages(model, cfg, tokens, targets,
                                                scale, ref, dev, card_line)
    gpipe_world1(bt, cfg, sd, tokens, targets, ref, dev, scale, card_line,
                 drop_ref)
    torch.cuda.synchronize()
    pp_launches, pp_wg = read_counts(), read_attn_wgmma()
    from blocksparse_tpu_torch.kernels import bst_attn
    # the microbatch's attention (bs 64, the LM's hs, ctx keys) on the
    # kernels the route rule names: every launch on wgmma, or none
    src = {kind: bst_attn.attn_kernel(kind, torch.bfloat16, 64, model.hs,
                                      cfg.ctx // 64)
           for kind in ("fwd", "dq", "dkv")}
    want_wg = {name: pp_launches[name] * src[kind].endswith("wgmma")
               for name, kind in zip(ATTN_WGMMA_WRAPPERS,
                                     ("fwd", "fwd", "dq", "dkv"))}
    check(pp_wg == want_wg and pp_launches["bst_attn_dq"] > 0,
          f"pipeline phase: the attention's launches on the wgmma kernels "
          f"{pp_wg}, as attn_kernel names them {want_wg} ({src})")
    for S in PP_STAGES:
        plain_stages = stage_metrics(model, *logs[S])
        with resid_dropout(model, DROPOUT):
            drop_stages = stage_metrics(model, *drop_logs[S])
        for s, ((ms, n), (dms, dn)) in enumerate(zip(plain_stages,
                                                      drop_stages)):
            print(f"pp {S} stage {s} ({model.n_local // S} blocks, "
                  f"{PP_MICRO} microbatches of {BATCH // PP_MICRO} x "
                  f"{cfg.ctx}) [{card_line}]: device {ms:.2f} ms, launches "
                  f"{ {k: n[k] for k in keys} }; the unpipelined step's "
                  f"{ref_ms:.2f} ms over all {cfg.n_layer} blocks and the "
                  f"head", flush=True)
            print(f"pp {S} stage {s} with dropout {DROPOUT} [{card_line}]: "
                  f"device {dms:.2f} ms ({100 * (dms / ms - 1):+.2f}% beside "
                  f"{ms:.2f} ms without), launches "
                  f"{ {k: dn[k] for k in keys} } (without: "
                  f"{ {k: n[k] for k in keys} })", flush=True)
            check(dn == n, f"pp {S} stage {s}: dropout launches the "
                           f"stage's kernels as often as the stage without")
    del logs, drop_logs, ref, drop_ref
    torch.cuda.empty_cache()
    pp_kernel_rows(model, dev, g, card_line, rows, marks)
    ep_launches = ep_layer_checks(bt, dev, g, card_line, rows, marks)
    return pp_launches, ep_launches


# The fprop_packed store (kernels/packed_order.py: the JAX op's TPU fprop
# schedule order, rebuilt in NumPy): bench.py's four headline bsmm ops at
# 8192^2, N 2048, bf16, built as bench.py builds them (bench.py:249-291,
# from one RandomState(0): each layout, its canonical weight draw; then x),
# and the canonical bench row's layouts (hidden 7680 at 11.25%).
PACKED_HIDDEN, PACKED_N, PACKED_DENSITY = 8192, 2048, 0.25
PACKED_LAYOUTS = (("random", 32), ("banded", 32), ("banded", 64),
                  ("aligned", 64))
PACKED_TIMED = 10
# the TPU kernel each store feeds, by the JAX op's fprop schedule (mode
# "auto": a panel store or a slot store)
PACKED_TPU = {"dense_tile": "bsmm.py:1422", "grouped": "bsmm.py:674"}
# each route's wrapper (bf16, mode "auto"; its source: kernel_of)
ROUTE_WRAPPER = {"grouped": "bsmm_fprop", "phased": "bsmm_split"}


def make_layout(kind, nb, density, rng):
    """bench.py:221-233 (bench.py imports JAX): a random layout with its
    diagonal set, or a band of half-width density * nb / 2."""
    if kind == "random":
        lay = (rng.rand(nb, nb) < density).astype(np.int32)
        lay[np.arange(nb), np.arange(nb)] = 1
        return lay
    if kind == "banded":
        m = max(int(round(density * nb / 2)), 1)
        lay = np.zeros((nb, nb), np.int32)
        for q in range(nb):
            lay[q, max(0, q - m + 1):q + 1] = 1
            lay[q, q:min(nb, q + m)] = 1
        return lay
    raise ValueError(kind)


def aligned_band_layout(nb, width, R):
    """bench.py:236-245: rows R*i..R*i+R-1 share one band of width
    blocks."""
    lay = np.zeros((nb, nb), np.int32)
    for g in range(-(-nb // R)):
        r0, r1 = g * R, min((g + 1) * R, nb)
        lo = max(0, min(nb - width, g * R - width // 2))
        lay[r0:r1, lo:lo + width] = 1
    return lay


def packed_bench_ops(bt):
    """bench.py's four ops: {(kind, b): (canonical op, packed op, plain
    op, canonical W)} and x, the packed op's host build time printed."""
    rng = np.random.RandomState(0)
    hidden, out = PACKED_HIDDEN, {}
    for kind, b in PACKED_LAYOUTS:
        kw = {}
        if kind == "aligned":
            lay = aligned_band_layout(hidden // b, hidden // b // 4, 4)
            kw = dict(dense_tile_R=4)
        else:
            lay = make_layout(kind, hidden // b, PACKED_DENSITY, rng)
        t = time.perf_counter()
        pk = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=0,
                                  w_layout="fprop_packed", **kw)
        build_s = time.perf_counter() - t
        can = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=0, **kw)
        plain = bt.BlocksparseMatMul(lay, block_size=b, feature_axis=0,
                                     impl="xla")
        W = rng.uniform(-0.1, 0.1, (pk.blocks, b, b)).astype(np.float32)
        o = pk.packed
        print(f"packed {kind} b{b}{' R4' if kw else ''}: {pk.blocks} blocks, "
              f"store {pk.w_shape} ({'panels' if o.panels else 'slots'}, "
              f"{o.mode_f}{', phased' if o.phased else ''}), "
              f"{100 * pk.blocks * b * b / np.prod(pk.w_shape):.1f}% of its "
              f"cells blocks; host build {build_s:.2f} s", flush=True)
        out[(kind, b)] = (can, pk, plain, W)
    x = rng.uniform(-1, 1, (hidden, PACKED_N)).astype(np.float32)
    return out, x


def packed_bench_checks(ops, X, dev, g, card_line, rows, marks):
    """Each bench.py op on its packed store against its canonical op:
    the store packed on the card equal to the NumPy pack, unpacking to
    the draw; the forward bit for bit the canonical op's and within TOL
    of the plain op's; for random b32 the backward too (dX bit for bit,
    dW unpacked bit for bit the canonical dW, the padding zero).  Each
    forward (and random b32's backward) counted; device time of the
    kernels beside the store's gather and repack.  Returns {row name:
    (launches, source, TPU kernel)}."""
    bf = torch.bfloat16
    x = torch.as_tensor(X, device=dev).to(bf)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    launches = {}
    for (kind, b), (can, pk, plain, W) in ops.items():
        name = f"{kind}{b}"
        w = torch.as_tensor(W, device=dev).to(bf)
        wp = pk.pack_weights(w)
        check(torch.equal(wp.cpu(), torch.from_numpy(pk.pack_weights(W))
                          .to(bf)), f"packed {name}: the store packed on "
              f"the card equals the NumPy pack of the draw")
        check(torch.equal(pk.unpack_weights(wp), w),
              f"packed {name}: the store unpacks to the draw bit for bit")
        can(x, w)                                          # warm-up
        torch.cuda.synchronize()
        reset_counts()
        y = pk(x, wp)
        torch.cuda.synchronize()
        counted = read_counts()
        sparse = read_sparse()
        ran = {k: v for k, v in counted.items() if v}
        want_sp = int(pk.kernel_of(PACKED_N, "f") == "bsmm_xprop_sparse")
        check(sparse == {"bsmm_fprop": want_sp, "bsmm_bprop": 0,
                         "pack": want_sp},
              f"packed {name}: fprop launches on bsmm_xprop_sparse.cu "
              f"{sparse}, as kernel_of names them ({want_sp})")
        check(torch.equal(y, can(x, w)),
              f"packed {name}: y equals the canonical op's bit for bit "
              f"(fprop launches {ran})")
        err_f = compare(f"packed {name} fprop against impl=xla", y,
                        plain(x, w), TOL[bf])
        key = f"bsmm_fprop_packed_{name}"
        wrapper = ROUTE_WRAPPER[pk._route(PACKED_N, "f", sms)]
        launches[key] = (counted[wrapper], kernel_of(pk, PACKED_N, "f")[1],
                         PACKED_TPU[pk.packed.mode_f])
        fprop = (lambda: pk._xprop(x, w, "f"))
        ms_f = device_ms_per_call(fprop, lambda k: "bsmm_" in k,
                                  PACKED_TIMED)
        gather_ms = device_ms_per_call(lambda: pk.unpack_weights(wp),
                                       lambda k: True, PACKED_TIMED)
        rows[key] = (err_f, ms_f, time_ms(lambda: plain(x, w), 3))
        b2, N = b * b, PACKED_N
        flops = 2 * N * pk.blocks * b2
        xb = 2 * (N * pk.C + pk.blocks * b2 + N * pk.K)
        wd = dense_weight(can, w)
        lib_f = time_ms(lambda: wd.t() @ x, 20)
        marks[key] = (*bound(flops, xb), lib_f)
        store_mb = np.prod(pk.w_shape) * 2 / 1e6
        print(f"packed {name} N={N} bf16 [{card_line}]: fprop kernels "
              f"{ms_f:.4f} ms ({flops / ms_f / 1e9:.2f} TFLOP/s; bound "
              f"{marks[key][0]:.4f} ms, dense matmul {lib_f:.4f} ms); the "
              f"store's gather {gather_ms:.4f} ms ({store_mb:.1f} MB store, "
              f"{pk.blocks * b2 * 2 / 1e6:.1f} MB of blocks; "
              f"{gather_ms / ms_f:.2f}x the fprop)", flush=True)
        if kind != "random":
            del wd
            continue
        e = (torch.rand((pk.K, N), device=dev, generator=g) * 2 - 1).to(bf)

        def grads(op, weights):
            xi, wi = x.clone().requires_grad_(), \
                weights.clone().requires_grad_()
            out = op(xi, wi)
            out.backward(e)
            return out.detach(), xi.grad, wi.grad
        grads(can, w)
        torch.cuda.synchronize()
        reset_counts()
        y1, dx1, dw1 = grads(pk, wp)
        torch.cuda.synchronize()
        counted = read_counts()
        sparse = read_sparse()
        want_sp = {k: int(pk.kernel_of(PACKED_N, d) == "bsmm_xprop_sparse")
                   for k, d in zip(SPARSE_WRAPPERS, "fb")}
        check(sparse == {**want_sp, "pack": sum(want_sp.values())},
              f"packed {name} forward + backward: launches on "
              f"bsmm_xprop_sparse.cu {sparse}, as kernel_of names them "
              f"{want_sp}")
        y0, dx0, dw0 = grads(can, w)
        check(torch.equal(y1, y0) and torch.equal(dx1, dx0),
              f"packed {name} forward + backward: y and dX equal the "
              f"canonical op's bit for bit")
        check(torch.equal(pk.unpack_weights(dw1), dw0),
              f"packed {name}: dW unpacked equals the canonical dW bit "
              f"for bit")
        check(torch.equal(pk.pack_weights(pk.unpack_weights(dw1)), dw1),
              f"packed {name}: dW's padding cells exactly zero "
              f"({pk.packed_blocks - pk.blocks} of {pk.packed_blocks} cells)")
        err_b = compare(f"packed {name} bprop against impl=xla", dx1,
                        plain._xprop(e, w, "b"), TOL[bf])
        dw_ref = plain._updat(x, e)
        err_u = compare(f"packed {name} updat (f32) against impl=xla",
                        pk._updat(x, e), dw_ref, UPDAT_TOL)
        repack_ms = device_ms_per_call(lambda: pk.pack_weights(dw0),
                                       lambda k: True, PACKED_TIMED)
        ms_b = device_ms_per_call(lambda: pk._xprop(e, w, "b"),
                                  lambda k: "bsmm_" in k, PACKED_TIMED)
        ms_u = kernel_device_ms(lambda: pk._updat(x, e),
                                kernel_of(pk, PACKED_N, "u")[0], PACKED_TIMED)
        wrapper = ROUTE_WRAPPER[pk._route(PACKED_N, "b", sms)]
        wrapper = "bsmm_bprop" if wrapper == "bsmm_fprop" else wrapper
        for d, err, ms, plain_fn, n, src, tpu in (
                ("bprop", err_b, ms_b, lambda: plain._xprop(e, w, "b"),
                 counted[wrapper], kernel_of(pk, PACKED_N, "b")[1],
                 "bsmm.py:1422"),
                ("updat", err_u, ms_u, lambda: plain._updat(x, e),
                 counted["bsmm_updat"], kernel_of(pk, PACKED_N, "u")[1],
                 "bsmm.py:1972")):
            k = f"bsmm_{d}_packed_{name}"
            rows[k] = (err, ms, time_ms(plain_fn, 3))
            launches[k] = (n, src, tpu)
        marks[f"bsmm_bprop_packed_{name}"] = (
            *bound(flops, xb), time_ms(lambda: wd @ e, 20))
        marks[f"bsmm_updat_packed_{name}"] = (
            *bound(flops, 2 * N * (pk.C + pk.K) + 4 * pk.blocks * b2),
            time_ms(lambda: x @ e.t(), 20))
        check(counted["bsmm_updat_reduce"] == 0,
              f"packed {name}: the updat at N={N} runs unsplit")
        print(f"packed {name} backward [{card_line}]: bprop kernels "
              f"{ms_b:.4f} ms, updat kernel {ms_u:.4f} ms, dW's repack into "
              f"the store {repack_ms:.4f} ms ({repack_ms / ms_u:.2f}x the "
              f"updat); launches {({k: v for k, v in counted.items() if v})}",
              flush=True)
        del wd, e, y1, dx1, dw1, y0, dx0, dw0, dw_ref
    torch.cuda.empty_cache()
    return launches


def packed_canonical(bt, dev, g, card_line):
    """The canonical bench row's layouts (hidden 7680 at 11.25%, the
    port's make_mask, b8/b16/b32): the packed op's host build time on the
    host library, which must have loaded; at b32 the order built once more
    by the NumPy builders alone, equal (never at b16 or b8: minutes); the
    depth-8 forward chain (N 64, bf16) on the packed store in modes auto
    and window (the window schedule's store), counted, equal to the
    canonical chain bit for bit.  Returns the chains' launches."""
    from blocksparse_tpu_torch import native
    from blocksparse_tpu_torch.kernels import packed_order
    from blocksparse_tpu_torch.models.sparse_lstm import make_mask
    t = time.perf_counter()
    check(native.available(), f"the host library csrc/bs_host.cpp built "
          f"(g++) and loaded ({time.perf_counter() - t:.2f} s)")
    k, target, bsizes = CANON_ROWS[0]
    hidden, bf = k * CANON_UNIT, torch.bfloat16
    total = {}
    for b in bsizes:
        n = hidden // b
        lay = make_mask(n, f"ba_{pick_m(n, target)}", seed=SEED)
        can, pk, secs = {}, {}, {}
        for mode in ("auto", "window"):
            t = time.perf_counter()
            can[mode] = bt.BlocksparseMatMul(lay, block_size=b,
                                             feature_axis=0, mode=mode)
            secs[f"canonical {mode}"] = time.perf_counter() - t
            t = time.perf_counter()
            pk[mode] = bt.BlocksparseMatMul(lay, block_size=b,
                                            feature_axis=0, mode=mode,
                                            w_layout="fprop_packed")
            secs[f"packed {mode}"] = time.perf_counter() - t
        op = can["auto"]
        line = (f"packed canonical hidden {hidden} b{b}: {op.blocks} blocks, "
                f"store {pk['auto'].w_shape} (window's "
                f"{pk['window'].w_shape}); host build with the library: "
                + ", ".join(f"{k} op {s:.2f} s" for k, s in secs.items()))
        if b == 32:
            t = time.perf_counter()
            py = packed_order.fprop_order(
                [lut for _, lut in op.fprop_list], n, op.blocks, b,
                native=False)
            line += (f"; the order by the NumPy builders "
                     f"{time.perf_counter() - t:.2f} s")
            check(py.w_shape == pk["auto"].w_shape
                  and np.array_equal(py.pos, pk["auto"].packed.pos),
                  f"packed canonical b{b}: the NumPy builders' order equals "
                  f"the library's")
        print(line, flush=True)
        scale = float(np.sqrt(3.0 / (b * op.blocks / n)))
        w = ((torch.rand(op.w_shape, device=dev, generator=g) * 2 - 1)
             * scale).to(bf)
        x = (torch.rand((op.C, CANON_N), device=dev, generator=g) * 2
             - 1).to(bf)
        for mode in ("auto", "window"):
            wp = pk[mode].pack_weights(w)
            torch.cuda.synchronize()
            reset_counts()
            y = chain(pk[mode], x, wp)
            torch.cuda.synchronize()
            launches = {k: v for k, v in read_counts().items() if v}
            check(torch.equal(y, chain(can[mode], x, w)),
                  f"packed canonical b{b} mode {mode}: the depth-"
                  f"{CANON_DEPTH} chain on the packed store equals the "
                  f"canonical chain bit for bit (launches {launches})")
            add_counts(total, launches)
        del w, x, wp, y
    torch.cuda.empty_cache()
    return total


def examples_path(bt, dev, card_line):
    """The port's two examples at full size: simple.py (4096^2, b32,
    N 64, identity weights) counted and against the plain op; mnist.py at
    its defaults (200 steps, batch 128), then with --quantize: the loss
    falls, the accuracy printed.  Returns simple's launches."""
    from blocksparse_tpu_torch.examples import mnist, simple
    np.random.seed(SEED)
    torch.cuda.synchronize()
    reset_counts()
    op, x, w, y = simple.run(dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in read_counts().items() if v}
    check(launches and y.shape == (simple.HIDDEN_SIZE,
                                   simple.MINIBATCH_SIZE),
          f"simple.py on the card: launches {launches}")
    plain = bt.BlocksparseMatMul(op.layout, block_size=op.bsize,
                                 feature_axis=0, impl="xla")
    compare("simple.py y against impl=xla", y, plain(x, w),
            TOL[torch.float32])
    for flags in ([], ["--quantize"]):
        t = time.perf_counter()
        out = mnist.train(mnist.parse_args(flags),
                          mnist.init_params(torch.Generator()
                                            .manual_seed(SEED), device=dev),
                          dev)
        s = time.perf_counter() - t
        losses = [float(v) for v in out["losses"]]
        check(all(np.isfinite(losses)) and np.mean(losses[-20:]) < losses[0],
              f"mnist.py {' '.join(flags) or '(defaults)'}: loss "
              f"{losses[0]:.4f} -> {np.mean(losses[-20:]):.4f} (mean of the "
              f"last 20) over {len(losses)} steps, accuracy "
              f"{out['accuracy']:.3f}, {s:.1f} s ({1e3 * s / len(losses):.2f} "
              f"ms a step with the eval) [{card_line}]")
    return launches


def build_all(sources=SOURCES):
    """Builds csrc/<name>.cu for each of ``sources``, one nvcc each, all
    started together."""
    from blocksparse_tpu_torch.kernels import _build

    def one(name):
        t = time.perf_counter()
        lib = _build.build(name)
        return name, time.perf_counter() - t, lib
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        for name, s, lib in pool.map(one, sources):
            print(f"build {name}: {s:.1f} s -> {lib.name}", flush=True)
    print(f"build total (parallel): {time.perf_counter() - t0:.1f} s",
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile-out", metavar="PATH",
                    help="write the profiled train step's table here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    import blocksparse_tpu_torch as bt

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card_line = card()
    print(f"card: {card_line}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 1. build; F5: a failed capture leaves the process usable
    build_all()
    f5_check(dev)

    # 2. the model, full width, and the same model on the plain versions
    cfg = flagship_config(bt)
    model = bt.SparseTransformerLM(cfg, device=dev)
    plain = bt.SparseTransformerLM(cfg, device=dev, impl="xla")
    sd = bt.params_from_jax(bt.random_jax_params(model, seed=SEED), model)
    model.load_state_dict(sd)
    plain.load_state_dict(sd)
    print(f"model: {cfg.n_layer} layers x {cfg.n_embd}d, {cfg.n_head} heads, "
          f"ctx {cfg.ctx}, attention blocks {model.bst.blocks} of "
          f"{model.bst.ctx_blks_q ** 2}, MLP blocks {model.bsmm1.blocks} of "
          f"{model.bsmm1.CB * model.bsmm1.KB} (b{model.bsmm1.bsize}), "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M params",
          flush=True)

    # 3. kernels against plain versions
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = {}
    serving_kernel_checks(model, plain, dev, g, rows)
    training_kernel_checks(model, plain, dev, g, rows)
    # the wgmma attention kernels against the mma.sync ones beyond the
    # LM's shape: the pipeline's microbatch, sp-4 shards, hs 128
    attn_wgmma_phase(bt, model, dev, g, card_line, rows)
    xprop_block_size_checks(bt, dev, g)
    split_checks(model, dev, g, card_line, rows)
    updat_block_size_checks(bt, dev, g)
    # the wgmma kernels against the mma.sync ones at the main path's shapes
    wgmma_turns(bt, model, dev, g, card_line, rows)
    f32_block_size_checks(bt, dev, g)
    mode_block_size_checks(bt, dev, g)
    attn_block_size_checks(bt, dev, g)
    pad_cost(bt, dev, g, card_line)
    trio_kernel_checks(bt, dev, g, card_line, rows)
    gated_checks(model, plain, dev, g, card_line)

    # 4. the serving path, counted
    serve_launches = serving_path(bt, model, plain, cfg, dev, card_line)

    # 5. the training path, counted
    train_launches, _, train_sparse = training_path(
        bt, model, plain, cfg, dev, card_line, args.profile_out)
    print(f"launches: serving path {serve_launches}; training path (one "
          f"step) {train_launches}", flush=True)

    # 5b. the LMs that reach the attention kernels through the bs-16 view
    # (blk_size 8) and the head-size padding (hs 48): serving and a train
    # step each, counted
    view_launches = view_lm_paths(bt, dev)
    for what, (serve, train, _, _) in view_launches.items():
        print(f"launches: {what}: serving {serve}; train step {train}",
              flush=True)
    # the attention's launches on the mma.sync kernels on these paths (the
    # LM itself runs the wgmma ones)
    view_mma = {name: sum(
        serve[name] - swg[name] + train[name] - twg[name]
        for serve, train, swg, twg in view_launches.values())
        for name in ATTN_WGMMA_WRAPPERS}

    # 5c. the LM at 2 heads of 256 on the unfused ops: forward, prefill,
    # scan decode and the captured train step, counted; then the trio
    # against the fused kernels at 8 heads of 64
    wide_launches = wide_lm_path(bt, dev, card_line)
    print(f"launches: LM {WIDE_HEADS} heads of {512 // WIDE_HEADS} (forward, "
          f"prefill, scan decode, train step's first call) {wide_launches}",
          flush=True)
    route_compare(bt, dev, g, card_line)

    # 5d. the training surface: the captured step with 16-bit Adam slots
    # (counted), packed16 on the card, residual dropout, Adafactor and
    # EMA, and the enwik8 entry point with its checkpoint (counted)
    slot_launches, entry_launches = training_surface(bt, model, plain, cfg,
                                                     sd, dev, card_line)
    print(f"launches: train step's first call by slot format "
          f"{slot_launches}; entry point ({ENTRY_STEPS} steps) "
          f"{entry_launches}", flush=True)

    # 5e. the sparse LSTM at full width (f32, CN): against its plain
    # model, its bsmm directions at its shape, and the entry point's
    # step, counted
    lstm_marks = {}
    lstm_launches = lstm_path(bt, dev, g, card_line, rows, lstm_marks)
    print(f"launches: LSTM ({LSTM_STEPS} entry-point steps) "
          f"{lstm_launches}", flush=True)

    # 5f. the LM with MoE MLPs at full width: its layer and products, the
    # forward and generate against its plain model, the captured train
    # step (counted) against the eager step and the plain model
    moe_launches = moe_path(bt, dev, g, card_line, rows, lstm_marks)
    print(f"launches: MoE LM train step's first call {moe_launches}",
          flush=True)
    f32_kernel_report(rows["f32_configs"])

    # 5g. parallelism: the flagship attention's sequence-parallel shard
    # kernels at full width in one process (gather and ring, sp 2 and 4,
    # counted), then the sharded train step on an NCCL group of world
    # size 1 against the single-device step
    sp_launches = parallel_path(bt, model, sd, cfg, dev, g, card_line, rows,
                                lstm_marks)
    print(f"launches: sequence-parallel shards (sp {SP_SHARDS}, gather and "
          f"ring) {sp_launches}", flush=True)

    # 5h. pipeline and experts: the flagship's stages at pp 2 and 3 in one
    # process and gpipe on NCCL at world size 1 against the single-device
    # step (counted); the MoE layer's ep 2 and 4 shards in one process
    # against its ep 1 layer (counted)
    pp_launches, ep_launches = pipeline_experts_path(
        bt, model, sd, cfg, dev, g, card_line, rows, lstm_marks)
    print(f"launches: pipeline stages (pp {PP_STAGES}, {PP_MICRO} "
          f"microbatches) and gpipe (world 1) {pp_launches}; MoE ep shards "
          f"(ep {EP_SHARDS}) {ep_launches}", flush=True)

    # 6. the block-sparse conv: kernels against plain versions, then the
    # conv path, counted
    conv_kernel_checks(dev, g, rows)
    conv_launches, conv_sparse = conv_path(bt, dev, g, card_line, rows)
    print(f"launches: conv path (one forward + backward) {conv_launches}",
          flush=True)
    # 6b. the rest of the conv (plain torch): ragged, impl="matmul", the
    # deconv, the edge bias and the l2 norms at C=512
    conv_rest_path(bt, dev, g, card_line)

    # 7. BlocksparseMatMul's schedule modes: the three mode kernels against
    # their plain versions, then the canonical bench rows in each mode and
    # the window's regime, counted
    canon = canonical_rows(bt, dev)
    win_ops, win_W = window_op(bt)
    mode_kernel_checks(canon, win_ops["window"], dev, g, card_line, rows)
    # the wgmma mode kernels in turns with the mma.sync ones, mode
    # "grouped" and the dense product, at the canonical rows and the
    # window's regime
    mode_wgmma_phase(bt, dev, g, card_line, rows, canon, win_ops)
    mode_launches = canonical_path(canon, dev, g, card_line, rows)
    add_counts(mode_launches, window_path(win_ops, win_W, dev, g, card_line))
    print(f"launches: modes path (canonical chains, window regime) "
          f"{mode_launches}", flush=True)

    # 7b. the fprop_packed store: bench.py's four headline ops on their
    # packed stores (counted) against their canonical ops, the canonical
    # row's layouts on the host library, and the two examples (counted)
    t_packed = time.perf_counter()
    packed_ops, packed_x = packed_bench_ops(bt)
    packed_marks = {}
    packed_launches = packed_bench_checks(packed_ops, packed_x, dev, g,
                                          card_line, rows, packed_marks)
    del packed_ops, packed_x
    chain_launches = packed_canonical(bt, dev, g, card_line)
    simple_launches = examples_path(bt, dev, card_line)
    print(f"launches: packed bench ops "
          f"{dict((k, v[0]) for k, v in packed_launches.items())}; "
          f"packed canonical chains {chain_launches}; "
          f"simple.py {simple_launches}; packed phase "
          f"{time.perf_counter() - t_packed:.1f} s", flush=True)

    # 8. each kernel's bound and library call
    marks = yardsticks(model, dev, g, rows)
    marks.update(mode_yardsticks(canon, win_ops["plain"], dev, g, card_line,
                                 rows))
    C, NP, b2 = CONV_CHANNELS[0], CONV_BATCH * CONV_HW ** 2, 2
    im2col_bytes = (1 + 9) * C * NP * b2
    marks["im2col"] = (*bound(0, im2col_bytes), rows["unfold"])
    marks["col2im"] = (*bound(0, im2col_bytes), rows["fold"])
    marks["bsmm_split"] = rows[("split_mark", "bsmm2")]
    marks.update(rows["trio_marks"])
    marks.update(lstm_marks)
    marks.update(packed_marks)
    attn_report(model, rows, card_line, marks)
    ptxas_report("bsmm_xprop_mma", "the fused split (OUT_SPLIT)",
                 SPLIT_MANGLED)
    ptxas_report("col2im_tma", "col2im", re.compile("col2im_tma_kernel"))
    trio_ptxas_report()
    # the attention kernels' rows: their device time at the LM's shape (the
    # profiler, in turns), each kernel's error there against the plain
    # version; the mma.sync rows' launches those of the view LMs' paths
    bf = torch.bfloat16
    for key, err_key, dev_key in (("attn_fwd", ("attn_fwd", bf), "fwd_dev"),
                                  ("fwd_lse", ("fwd_lse", bf), "fwd_lse_dev"),
                                  ("dq", ("dq", bf), "dq_dev"),
                                  ("dkv", ("dkv", bf), "dkv_dev")):
        t, plain_ms = rows[dev_key], rows[err_key][2]
        mma_err = rows[({"dq": "dq_mma_err", "dkv": "dkv_mma_err"}.get(
            key, "fwd_lse_mma_err"), bf)]
        rows[(key, "wgmma")] = (rows[err_key][0], float(np.mean(t["wgmma"])),
                                plain_ms)
        rows[(key, "mma")] = (mma_err, float(np.mean(t["mma"])), plain_ms)
    for name in ("bst_attn_fwd", "bst_attn_fwd_lse", "bst_attn_dq",
                 "bst_attn_dkv"):
        marks[f"{name}_wgmma"] = marks[name]

    N = BATCH * cfg.ctx
    pp_n = BATCH // PP_MICRO * cfg.ctx       # the pipeline's microbatch

    def attn_source(kind, key_blocks=cfg.ctx // 64):
        """The source a bf16 launch of ``kind`` at the LM's bs and hs over
        ``key_blocks`` key block-rows runs."""
        from blocksparse_tpu_torch.kernels import bst_attn
        return bst_attn.attn_kernel(kind, bf, 64, model.hs,
                                    key_blocks) + ".cu"
    # the unsplit bf16 products at bsmm1's train shape on each kernel: the
    # wgmma phase's device times (its updat with its split's reduce, the
    # sparse xprop with its weights' packing), the plain version's from the
    # training checks; launches: the train step's first call on the
    # sparse kernels, the canonical grouped chains (b8-b32, N 64) on the
    # mma.sync ones; bsmm_xprop_wgmma.cu's on bench.py's b64 stores (the
    # packed rows)
    def wg_row(d, kernel, plain_key):
        r = rows[("wg", f"bsmm1 N={N}", d)]
        err = r["err"].get(kernel, r["err"].get("wgmma"))
        return (err, float(np.mean(r[kernel])), rows[plain_key][2])
    for name in ("bsmm_fprop", "bsmm_bprop", "bsmm_updat"):
        marks[f"{name}_wgmma"] = marks[name]
    for name in SPARSE_WRAPPERS:
        marks[f"{name}_sparse"] = marks[name]
    marks["xprop_sparse_pack"] = rows["sparse_pack_mark"]
    conv512 = rows[("wg", f"conv C={CONV_CHANNELS[0]}", "u")]
    check(conv512["route"] == "bsmm_updat_sparse",
          f"the conv's updat at C={CONV_CHANNELS[0]} runs "
          f"bsmm_updat_sparse.cu (its row in the kernels line): "
          f"{conv512['route']}")
    marks["bsmm_updat_sparse"] = marks["bsmm_updat"]
    marks["bsmm_updat_sparse_conv"] = (*conv512["bound"], conv512["lib"])
    # the wgmma mode kernels' rows: fine at the canonical b16 row (b8 stays
    # on mma.sync by the rule), window at its regime's N 2048 (N 256 on
    # mma.sync by the rule), the kernel alone and its packing apart; times,
    # bound and the dense product from mode_wgmma_phase's turns
    small = CANON_ROWS[0][0] * CANON_UNIT
    fine_wg = rows[("mode", "fine", f"canonical hidden {small} b16 "
                                    f"N={CANON_N}", "f")]
    win_wg = rows[("mode", "window", f"window regime N={WIN_NS[1]}", "f")]
    for name, r in (("bsmm_fine_wgmma", fine_wg),
                    ("bsmm_window_wgmma", win_wg)):
        marks[name] = (*r["bound"], float(np.mean(r["times"]["dense"])))
    marks["window_wgmma_pack"] = (*win_wg["pack_bound"], None)
    kernels = [  # (name, source, TPU kernel, path's launches, row)
        ("bsmm_fprop", "bsmm_xprop_mma.cu", "bsmm.py:1422",
         mode_launches[("bsmm_fprop", "bsmm_xprop_mma")],
         wg_row("f", "mma", ("fprop", "bsmm1", N, bf))),
        ("bsmm_bprop", "bsmm_xprop_mma.cu", "bsmm.py:1422",
         mode_launches[("bsmm_bprop", "bsmm_xprop_mma")],
         wg_row("b", "mma", ("bprop", "bsmm1", bf))),
        ("bsmm_updat", "bsmm_updat_mma.cu", "bsmm.py:1972",
         mode_launches[("bsmm_updat", "bsmm_updat_mma")],
         wg_row("u", "mma", ("updat", "bsmm1", bf))),
        ("bsmm_fprop_sparse", "bsmm_xprop_sparse.cu", "bsmm.py:1422",
         train_sparse["bsmm_fprop"],
         wg_row("f", "sparse", ("fprop", "bsmm1", N, bf))),
        ("bsmm_bprop_sparse", "bsmm_xprop_sparse.cu", "bsmm.py:1422",
         train_sparse["bsmm_bprop"],
         wg_row("b", "sparse", ("bprop", "bsmm1", bf))),
        ("xprop_sparse_pack", "bsmm_xprop_sparse.cu", "bsmm.py:1422",
         train_sparse["pack"], rows["sparse_pack"]),
        # the updat at bsmm1's train shape on bsmm_updat_wgmma.cu (its
        # launches: bench.py's packed random b32 store's backward, where
        # the route keeps it) and bsmm_updat_sparse.cu (the train step's
        # first call); and the conv's at C=512 on the latter (launches:
        # every configuration's counted backward; the route's time and
        # error against the plain version at the conv's shapes, bound and
        # x^T . dy from the wgmma phase)
        ("bsmm_updat_wgmma", "bsmm_updat_wgmma.cu", "bsmm.py:1972",
         sum(n for n, src, _ in packed_launches.values()
             if src == "bsmm_updat_wgmma.cu"),
         wg_row("u", "wgmma", ("updat", "bsmm1", bf))),
        ("bsmm_updat_sparse", "bsmm_updat_sparse.cu", "bsmm.py:1972",
         train_sparse["bsmm_updat"],
         wg_row("u", "sparse", ("updat", "bsmm1", bf))),
        ("bsmm_updat_sparse_conv", "bsmm_updat_sparse.cu", "bsmm.py:1972",
         conv_sparse["bsmm_updat"], rows[("conv", "bsmm_updat")]),
        ("bsmm_updat_reduce", "bsmm_updat_mma.cu", "bsmm.py:1972",
         train_launches["bsmm_updat_reduce"], rows["reduce"]),
        # the attention at the LM's shape: the forward (serving and lse),
        # dq and dk/dv on their wgmma kernels (the main path's launches)
        # and on the mma.sync ones (the view LMs' launches: bs 8, and bs
        # 16-32 view)
        ("bst_attn_fwd_wgmma", "bst_attn_fwd_wgmma.cu", "bst_attn.py:677",
         serve_launches["bst_attn_fwd"], rows[("attn_fwd", "wgmma")]),
        ("bst_attn_fwd_lse_wgmma", "bst_attn_fwd_wgmma.cu", "bst_attn.py:832",
         train_launches["bst_attn_fwd_lse"], rows[("fwd_lse", "wgmma")]),
        ("bst_attn_dq_wgmma", "bst_attn_dq_wgmma.cu", "bst_attn.py:1084",
         train_launches["bst_attn_dq"], rows[("dq", "wgmma")]),
        ("bst_attn_dkv_wgmma", "bst_attn_dkv_wgmma.cu", "bst_attn.py:1141",
         train_launches["bst_attn_dkv"], rows[("dkv", "wgmma")]),
        ("bst_attn_fwd", "bst_attn_fwd_mma.cu", "bst_attn.py:677",
         view_mma["bst_attn_fwd"], rows[("attn_fwd", "mma")]),
        ("bst_attn_fwd_lse", "bst_attn_fwd_mma.cu", "bst_attn.py:832",
         view_mma["bst_attn_fwd_lse"], rows[("fwd_lse", "mma")]),
        ("bst_attn_dq", "bst_attn_bwd_mma.cu", "bst_attn.py:1084",
         view_mma["bst_attn_dq"], rows[("dq", "mma")]),
        ("bst_attn_dkv", "bst_attn_bwd_mma.cu", "bst_attn.py:1141",
         view_mma["bst_attn_dkv"], rows[("dkv", "mma")]),
        ("im2col", "im2col.cu", "im2col.py:97", conv_launches["im2col"],
         rows[("im2col", bf)]),
        ("col2im", "col2im_tma.cu", "im2col.py:125", conv_launches["col2im"],
         rows[("col2im", bf)]),
        # the modes: each kernel's launches those its rule gave it on the
        # canonical chains and the window path
        ("bsmm_fine", "bsmm_fine_mma.cu", "bsmm.py:2294",
         mode_launches["bsmm_fine"] - mode_launches[("bsmm_fine", "wgmma")],
         rows[("fine", 8, CANON_N, bf)]),
        ("bsmm_fine_wgmma", "bsmm_fine_wgmma.cu", "bsmm.py:2294",
         mode_launches[("bsmm_fine", "wgmma")],
         (fine_wg["err"]["wgmma"], float(np.mean(fine_wg["times"]["wgmma"])),
          fine_wg["plain_ms"])),
        ("bsmm_window", "bsmm_window_mma.cu", "bsmm.py:1800",
         mode_launches["bsmm_window"]
         - mode_launches[("bsmm_window", "wgmma")],
         rows[("window", 32, WIN_NS[0], bf)]),
        ("bsmm_window_wgmma", "bsmm_window_wgmma.cu", "bsmm.py:1800",
         mode_launches[("bsmm_window", "wgmma")],
         (win_wg["err"]["wgmma"], float(np.mean(win_wg["alone"]["kernel"])),
          win_wg["plain_ms"])),
        ("window_wgmma_pack", "bsmm_window_wgmma.cu", "bsmm.py:1800",
         mode_launches["window_wgmma_pack"],
         (0.0, float(np.mean(win_wg["alone"]["pack"])),
          win_wg["plain_pack_ms"])),
        ("bsmm_split", "bsmm_xprop_mma.cu", "bsmm.py:1562",
         serve_launches["bsmm_split"] + mode_launches["bsmm_split"],
         rows[("split", "bsmm2")]),
        ("bsmm_merge", "bsmm_merge.cu", "bsmm.py:1562",
         mode_launches["bsmm_merge"], rows[("merge", torch.float32)]),
        ("bst_nt", "bst_nt_mma.cu", "bsmm.py:1972", wide_launches["bst_nt"],
         rows[("bst_nt", "wide")]),
        ("bst_xn", "bst_xn_mma.cu", "bsmm.py:1422", wide_launches["bst_xn"],
         rows[("bst_xn", "wide")]),
        ("bst_xn_tn", "bst_xn_mma.cu", "bsmm.py:1422",
         wide_launches["bst_xn_tn"], rows[("bst_xn_tn", "wide")]),
        # the LSTM's f32 CN products (bprop: the split route, partials +
        # merge, its ms the route's)
        ("bsmm_fprop_lstm", "bsmm_fprop.cu", "bsmm.py:1422",
         lstm_launches["bsmm_fprop"], rows["lstm_fprop"]),
        ("bsmm_bprop_lstm", "bsmm_fprop.cu", "bsmm.py:1422",
         lstm_launches["bsmm_bprop"], rows["lstm_bprop"]),
        ("bsmm_merge_lstm", "bsmm_merge.cu", "bsmm.py:1562",
         lstm_launches["bsmm_merge"], rows["lstm_merge"]),
        ("bsmm_updat_lstm", "bsmm_updat.cu", "bsmm.py:1972",
         lstm_launches["bsmm_updat"], rows["lstm_updat"]),
        # the MoE LM's expert products at N = C, f32 (F6); the updat row
        # counts both experts' products (bsmm1's on bsmm_updat_wgmma.cu, its
        # bf16 inputs) and times bsmm2's f32 one
        ("bsmm_fprop_moe", "bsmm_fprop.cu", "bsmm.py:1422",
         moe_launches["bsmm_fprop"], rows["moe_fprop"]),
        ("bsmm_bprop_moe", "bsmm_fprop.cu", "bsmm.py:1422",
         moe_launches["bsmm_bprop"], rows["moe_bprop"]),
        ("bsmm_updat_moe", "bsmm_updat.cu", "bsmm.py:1972",
         moe_launches["bsmm_updat"], rows["moe_updat"]),
        # the flagship attention's shards at sp 4 (a launch's mean device
        # time): gather mode on each shard's tables, and the ring's 16
        # pair launches (dq stored in f32); launches: those of the
        # parallel phase's counted run at sp 2 and 4, gather and ring
        ("attn_fwd_lse_sp4", attn_source("fwd"), "bst_attn.py:832",
         sp_launches["bst_attn_fwd_lse"], rows["attn_fwd_lse_sp4"]),
        ("attn_dq_sp4", attn_source("dq"), "bst_attn.py:1084",
         sp_launches["bst_attn_dq"], rows["attn_dq_sp4"]),
        ("attn_dkv_sp4", attn_source("dkv"), "bst_attn.py:1141",
         sp_launches["bst_attn_dkv"], rows["attn_dkv_sp4"]),
        ("attn_fwd_lse_ring4",
         attn_source("fwd", cfg.ctx // 64 // SP_SHARDS[-1]), "bst_attn.py:832",
         sp_launches["bst_attn_fwd_lse"], rows["attn_fwd_lse_ring4"]),
        ("attn_dq_ring_f32",
         attn_source("dq", cfg.ctx // 64 // SP_SHARDS[-1]), "bst_attn.py:1084",
         sp_launches["bst_attn_dq"], rows["attn_dq_ring_f32"]),
        ("attn_dkv_ring4", attn_source("dkv"), "bst_attn.py:1141",
         sp_launches["bst_attn_dkv"], rows["attn_dkv_ring4"]),
        # the pipeline's microbatch shapes (2 x 2048; launches: the stages
        # at pp 2 and 3 and gpipe at world size 1, whose forward under
        # no_grad runs the serving attention) and the experts' products at
        # N = ep·C (f32, F6, and bsmm1's bf16 updat; launches: the ep 2
        # and 4 shards; the updat's count both products')
        ("pp_stage_attn_fwd", attn_source("fwd"), "bst_attn.py:677",
         pp_launches["bst_attn_fwd"], rows["pp_stage_attn_fwd"]),
        ("pp_stage_attn_fwd_lse", attn_source("fwd"), "bst_attn.py:832",
         pp_launches["bst_attn_fwd_lse"], rows["pp_stage_attn_fwd_lse"]),
        ("pp_stage_attn_dq", attn_source("dq"), "bst_attn.py:1084",
         pp_launches["bst_attn_dq"], rows["pp_stage_attn_dq"]),
        ("pp_stage_attn_dkv", attn_source("dkv"), "bst_attn.py:1141",
         pp_launches["bst_attn_dkv"], rows["pp_stage_attn_dkv"]),
        ("pp_stage_bsmm_fprop", kernel_of(model.bsmm1, pp_n, "f")[1],
         "bsmm.py:1422", pp_launches["bsmm_fprop"],
         rows["pp_stage_bsmm_fprop"]),
        ("pp_stage_bsmm_bprop", kernel_of(model.bsmm1, pp_n, "b")[1],
         "bsmm.py:1422", pp_launches["bsmm_bprop"],
         rows["pp_stage_bsmm_bprop"]),
        ("pp_stage_bsmm_updat", kernel_of(model.bsmm1, pp_n, "u")[1],
         "bsmm.py:1972", pp_launches["bsmm_updat"],
         rows["pp_stage_bsmm_updat"]),
        ("pp_stage_bsmm_updat_reduce", "bsmm_updat_mma.cu", "bsmm.py:1972",
         pp_launches["bsmm_updat_reduce"],
         rows["pp_stage_bsmm_updat_reduce"]),
        ("moe_ep_bsmm_fprop_f32", "bsmm_fprop.cu", "bsmm.py:1422",
         ep_launches["bsmm_fprop"], rows["moe_ep_bsmm_fprop_f32"]),
        ("moe_ep_bsmm_bprop_f32", "bsmm_fprop.cu", "bsmm.py:1422",
         ep_launches["bsmm_bprop"], rows["moe_ep_bsmm_bprop_f32"]),
        ("moe_ep_bsmm_updat_f32", "bsmm_updat.cu", "bsmm.py:1972",
         ep_launches["bsmm_updat"], rows["moe_ep_bsmm_updat_f32"]),
        ("moe_ep_bsmm_updat_bf16", rows["moe_ep_bsmm_updat_bf16_source"],
         "bsmm.py:1972", ep_launches["bsmm_updat"],
         rows["moe_ep_bsmm_updat_bf16"]),
        ("moe_ep_bsmm_updat_reduce", "bsmm_updat_mma.cu", "bsmm.py:1972",
         ep_launches["bsmm_updat_reduce"], rows["moe_ep_bsmm_updat_reduce"]),
    ]
    # the fprop_packed store's launches at bench.py's shapes (8192^2, N
    # 2048, bf16): each headline op's forward, random b32's backward
    kernels += [(key, src, tpu, n, rows[key])
                for key, (n, src, tpu) in packed_launches.items()]
    check(all(n > 0 for _, _, _, n, _ in kernels),
          f"every kernel launched on its path ({len(kernels)} kernels)")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"blocksparse_tpu_torch/csrc/{src}",
         "replaces": f"blocksparse_tpu/kernels/{tpu}",
         "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": pms,
         "bound_ms": marks[name][0], "bound_by": marks[name][1],
         "library_ms": marks[name][2]}
        for name, src, tpu, n, (err, ms, pms) in kernels]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
