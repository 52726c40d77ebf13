#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

    python3 chip_smoke.py [--phases name,...]

With no argument every phase runs and every check is kept.  ``--phases``
names the ``phase_*`` functions to run (the prefix may be left off, e.g.
``--phases kernels_bf16,bf16_window``); the build and the ``[card]`` line
always run, a phase that needs what a skipped one hands on is skipped too,
and the line before the last (``[phases]``) says which were skipped.  A
partial run keeps its phases' checks but not the check that every kernel
launched on its path.

Phases, each of which fails the run when it fails:

1. Build the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
   print nvcc's ``-Xptxas -v`` report and the card; per source the spill
   stores and the mma.sync (HMMA) and wgmma (HGMMA) instructions, and for
   each kernel of the bf16 arms' own bodies (rows 1-8's wgmma kernels, rows
   12 and 13's bf16 kernels) its registers, spill stores, HGMMA, bf16
   HMMA.16816 and TF32 HMMA (rows 12 and 13's must have none).
2. Hold every kernel of the paths against its plain PyTorch version on the
   card, at the shapes the full-width TinyLlama-1.1B rounds and evaluation
   and the Mamba2-130M prefill give it (plus unaligned offsets, ragged
   lengths, sliding windows, other head groupings, short and ragged chunks
   and head windows): the product kernels' forward values and autograd
   gradients, the flash kernel's output, the SSD chunk kernel's outputs and
   chunk states (also against the sequential recurrence), and the three
   update kernels bit for bit (the two SGD steps also in place on views
   with shared and mismatched misalignments); time each beside its plain
   version, one library call for the same function (where one exists) and
   its bound on an H100 (three TF32 tensor-core passes for the kernels on
   the tensor cores, rows 1-8, 12 and 13; f32 FMAs or bytes for the
   others), with the block tile each timed product launch took, and two
   launches of each bit-equal; flash also at head_dim 128.  The build's
   report gives each tensor-core source's spill stores and HMMA count.
   Then the bf16 arms of rows 1-13 (``phase_kernels_bf16``, each row
   named ``<kernel>/bf16``): the products within one bf16 ulp of their
   plain versions (plus 1e-6 of the largest magnitude) at ragged shapes
   and odd offsets, then timed at the bf16 paths' shapes beside ``bmm``/
   ``mm`` on the bf16 window views and the bound at the dense bf16 rate;
   the update arms bit for bit (aligned, ragged, in place on views with
   shared odd and mismatched misalignments), timed beside ``add_``/
   ``addcmul_`` and their byte bounds.
3. Run two rounds of the reduced model on the card and on the CPU (the
   plain versions) from the same params, tokens and windows or masks
   (masks drawn on the CPU and copied), and hold the two against each
   other: the window round (checkpointed through ``checkpoint_callback``
   and loaded back bit for bit), a Bernoulli mask round and a structured
   rolling mask round at per-client capacities; one model's eval
   through the flash kernel against the same eval on the CPU; reduced
   Mamba2 serving (prefill 2 x 64, 4 greedy steps) and its loss; the
   extract round (``fused_forward="off"``) and scheme ``full``; and a
   reduced ``PaperExperiment`` (ResNet, 2 rounds each of ``rolling`` and
   ``random`` with CPU-drawn masks, and ``static``); then this slice's
   configurations: staggered rolling (fused and extract), ``random``,
   ``importance`` (shared and staggered), client momentum and proximal,
   server ``sgd`` and ``momentum`` (2 chained rounds each), and server
   Adam, a mask round with client momentum and server Adam, and the bf16
   uplink, each round from the CPU's params and server state and held per
   coordinate at the bound of its step function; then heterogeneous
   capacities (2 rounds at capacities 1, 0.5, 0.5, 0.25 through the fused
   and the extract buckets, and with server ``sgd``) and an
   ``AsyncTrainer`` regime (a fleet of 8 with stragglers and jitter, N = 4,
   M = 2, 4 aggregations: equal virtual times and staleness); then
   reduced Mamba2 (``[agree ssm]``: 3 fused rounds, 1 extract, 1 Bernoulli
   mask and 1 staggered-rolling round) and reduced Hymba (``[agree
   hybrid]``: 3 fused rounds, 1 extract) on the default axes; then
   reduced DeepSeek-7B, Qwen3-14B and Mixtral (``[agree zoo]``: 2 fused
   rounds each, and one continuous batcher run, its logits and tokens);
   then reduced TinyLlama, Mamba2 and Hymba with bf16 params (``[agree
   bf16]``, 4m, 4n).
4. The window path: the shared-window federated round on full-width
   TinyLlama-1.1B (22 layers, f32, 4 clients x 2 local steps x 2 x 256
   tokens), through ``api.fed_round`` and ``api.Trainer``, 3 rounds, with
   every kernel's launch count read before and after.
4a. The eval path, on the server params those rounds leave: the held-out
   loss of one model (``Model.loss``, 4 x 2048 tokens) with
   ``REPRO_USE_FLASH`` set and without, the windowed sub-model's loss with
   the switch (the scalar-offset products and the flash kernel), and one
   backward pass of the windowed sub-model's loss at 2 x 256 tokens without
   it; launches counted per part, seconds and peak memory, the server's and
   the sub-model's flash evals and the backward pass under
   ``torch.profiler``. Then one more window round under ``torch.profiler``
   for the device time by kernel group (and the ``sgd_inplace`` group
   beside the round's byte bound for it), and two rounds of ``api.Trainer``
   with ``eval_fn``, ``eval_every=1`` and ``log_every=1``. The trainer and
   params are freed before the next phase.
4d. The extract path: the window path's configuration with
   ``fused_forward="off"`` (Algorithm 2 as written: compact per-client
   copies through the ordinary forward), 3 rounds from the same initial
   params and offsets, held against the fused path's params and losses;
   the "no per-client W_sub copy" pin (allocation shapes recorded under a
   ``TorchDispatchMode``: the fused client phase makes no stacked compact
   copy of the leaves its kernels read in place, the extract phase does);
   then 2 rounds of scheme ``full`` (FedAvg, every client on a full
   replica).  Seconds per round, peaks and row 10's launches.
4f. The stagger path: the window path's configuration with staggered
   rolling windows (each client its own window: rows 5-8 take one offset
   per client, ``w_down``/``wo`` rows one gather), client momentum,
   server Adam and the bf16 uplink, 3 rounds through ``api.fed_round`` and
   ``api.Trainer``: the clients' offsets, seconds per round, peak, rows
   5-8 and 10's launches, one profiled round, the "no W_sub copy" pin for
   per-client windows (``[wsub stagger]``); then the same configuration
   through ``python -m repro_torch.launch.train`` as a subprocess
   (``[train cli]``, finite losses).
4h. The hetero path: the window path's configuration with capacities
   1, 0.5, 0.25 and 0.125 (a bucket a client: a full replica on the
   extract phase, fused buckets at three widths), 3 rounds through
   ``api.fed_round`` and ``api.Trainer``: seconds per round, peak, rows 5-8
   and 10's launches against the bucket arithmetic, one profiled round and
   the "no W_sub copy" pin on the narrowest fused bucket.
4i. The fleet path, from the same params and batches: the M = N anchor
   (``AsyncTrainer`` == ``Trainer`` bit for bit on the card, 3 rounds); an
   async regime (a fleet of 16, a quarter 10x slower, jitter 0.5, N = 4,
   M = 2, 6 aggregations: host seconds per aggregation, virtual time, mean
   staleness, the aggregations on the per-client arm, peak); the hetero
   fleet (M = N, 2 rounds, within 1e-5 of the sync hetero rounds); the
   training CLI with ``--async-buffer 2 --fleet 8 --straggler-frac 0.25``
   as a subprocess.
4p. The mesh round (``api.fed_round(mesh=)``), after the fleet path.  (a)
   A world of one NCCL rank in this process, full-width TinyLlama-1.1B in
   the window path's configuration: 3 single-process rounds, 3 gather
   rounds (params and client losses bit-equal to them) and 3 psum rounds
   (round 1's client losses bit-equal, its params within 1e-5): seconds a
   round, peak, rows 5-8 and 10's launches.  (b) Two gloo ranks on the one
   card (NCCL takes one rank a device: ``tools/mesh_probe.py``) at 4 of 22
   layers: 2 gather rounds, a psum round and a staggered gather round,
   each held within 1e-4 of the largest magnitude of rank 0's
   single-process rounds (bit-equality printed), every rank's launches and
   peak, then context-parallel decode (each rank half the cache's
   positions; prefill 256, 16 teacher-forced steps) within 1e-4 of the
   single-process logits.  (c) ``[mesh cli]`` (in the stagger path's CLI
   step): ``launch.train --mesh 1 --mesh-agg psum``, 2 rounds.  Rows 5-8
   and 10 carry ``launches_by_path`` ``mesh``, ``mesh_psum``,
   ``mesh_gloo_rank0`` and ``mesh_gloo_rank1``.
4b. The mask path: the same configuration with ``scheme="bernoulli"``
   (Algorithm 1, mask mode chosen by ``api.fed_round`` itself) through
   ``api.Trainer(rng=0)``, 3 rounds, counted, checked and profiled the
   same way; then the peak memory of one client phase run with the model
   on ``w_c`` (what the round runs) and on the literal ``m * w_c``.
4g. The mask path with the optimizers (``[mask opt]``): server Adam on
   the masked mean delta at full width, 3 rounds (row 9); client momentum
   on the plain round (rows 9 and 11) and with server Adam, 2 rounds each
   at 11 of 22 layers (momentum's velocity and the literal client phase
   do not fit beside the full width's masks).
4c. Serving, after the mask path is freed: full-width Mamba2-130M (24
   layers, f32, random weights from seed 0) prefills 8 BigramLM prompts of
   32768 tokens and decodes 32 greedy tokens through ``serve.generate``
   (launches counted, peak from a reset, prefill and ms per token timed);
   teacher-forced decode of the last 256 tokens against one prefill of all
   of them, on the logits and every layer's state; its loss on 4 x 2048
   held-out tokens; one prefill under ``torch.profiler``.  Then
   full-width TinyLlama-1.1B prefills 4 x 1536 tokens and decodes 128
   greedy tokens; teacher-forced decode of the last 512 of 2048 prompt
   tokens against one prefill of all 2048, at 4 of its 22 layers.
4e. The paper's protocol (§5) on full-width pre-act ResNet18: 100 clients
   with 2 labels each, 10 a round, the HeteroFL capacity mix, K = 2 x 32
   images, SyntheticCIFAR 50 000 + 10 000; 5 rounds each of ``rolling``,
   ``random``, ``static`` and ``full`` through ``PaperExperiment.run``,
   evaluated on the last (seconds per round, test loss and accuracy, the
   generalization gap, peak, rows 9 and 11's launches a round); then
   ``python -m repro_torch.launch.experiment --rounds 3`` on the card
   (``stability_finite`` and ``thm1_bound_holds`` held to 1).
4j. SSM training and the hybrid block, after TinyLlama serving.  ``[ssm
   eval]`` adds to the Mamba2 serving block one full-width loss gradient in
   the clients' form (the differentiable chunked SSD, 4 x 2048 tokens).
   ``[ssm round]``: full-width Mamba2-130M, 4 clients x 2 steps x 2 x 1024
   tokens (four chunks of 256), rolling at 0.5 on the default axes
   (``ssm_heads`` 12 of 24), client lr ROUND_LR, 3 fused rounds (seconds,
   peak, finite losses and params, rows 5, 6 and 10's launches against the
   layer arithmetic), one profiled round (``[profile ssm round]``, with the
   chunked SSD's forward and backward device time in it), then 3 extract
   rounds from the same params and offsets, their client losses and params
   within EXTRACT_TOL of the fused ones.  ``[hybrid round]``: the same
   for full-width Hymba-1.5B (16 of its 32 layers, 2 x 256 tokens; ``d_ff``,
   ``heads``, ``kv_heads`` and ``ssm_heads`` at 0.5: rows 5-8 and 10).
   ``[hybrid eval]``: its loss on 4 x 2048 tokens with and without
   ``REPRO_USE_FLASH`` (rows 12 and 13); ``[hybrid serve]``: a 4 x 2048
   prefill and 64 greedy steps, and prefill 1536 + 512 teacher-forced decode
   steps against one prefill of 2048, at 4 of its 32 layers.
4k. The dense and MoE model zoo and the continuous batcher, after the
   hybrid block, each at its published widths from random weights (seed
   0), f32.  ``[deepseek round]``: DeepSeek-7B cut to 4 of 30 layers, 4
   clients x 2 steps x 2 x 256 tokens, rolling at 0.5 on the default axes
   (d_ff, heads, kv_heads), client lr 0.1: 3 fused rounds (seconds, peak
   beside (1 + 2 C) x the params, rows 5-8 and 10's launches against the
   layer arithmetic, a profiled round), 1 extract round held within
   EXTRACT_TOL of the fused rounds' first, and the "no W_sub copy" pin
   (``[wsub zoo]``); ``[qwen3 round]``: Qwen3-14B at 2 of 40 layers and 2
   clients (``qk_norm`` under a heads window), 1 fused and 1 extract
   round; ``[mixtral round]``: Mixtral-8x22B at 1 of 56 layers and 2
   clients (experts 4 of 8, moe_d_ff 8192 of 16384, heads 24 of 48 on
   kv_heads 4 of 8; the ``dropping`` path), 2 fused and 2 extract rounds.
   ``[zoo eval]``: full DeepSeek-7B's loss on 4 x 2048 tokens with and
   without flash (row 13 at G = 1), its windowed sub-model's (rows 1-2,
   13) and that sub-model's backward at 2 x 256 (rows 1-4), each held
   against the compact sub-model (the extracted windows, no kernel): the
   losses within EVAL_RTOL, three gradients within MM_RTOL; Mixtral at 4
   layers on one sequence of 8192 tokens, flash (G = 6 under the window
   of 4096) and not.  ``[serve continuous]``: full-size Qwen3-14B (40
   layers, 14.77 B params): its loss on 2 x 2048 tokens, flash (G = 5
   under ``qk_norm``) and not; 8 requests from ``request_queue``
   (prompts of 64-256 tokens, 8-32 new) through ``ContinuousBatcher`` (4
   slots, a timeline of 4096): requests, tokens, prefills, ticks, ticks
   per second, launches per tick, seconds and peak; then the same queue
   again recording every logit handed out, the tokens equal to the timed
   run's, each request's logits held against a single-request prefill and
   teacher-forced decode within MM_RTOL; one decode tick profiled; then
   Mixtral at 4 layers, the same queue on ``dropping`` and, held the same
   way, on ``dense``.
4l. The rest of the zoo, each at its published widths from random
   weights (seed 0), f32, after ``[serve continuous]``.  ``[mla round]``,
   ``[audio round]``, ``[vlm round]``: 2 clients x 2 steps x 2 x 256
   tokens (MusicGen's with 4 codebook streams, Phi-3-vision's behind 256
   patches), rolling at 0.5 on the default axes (MLA's standalone
   ``heads``, ``d_ff``; GQA's coupled ``heads``/``kv_heads``), client lr
   0.1: 3 fused rounds (seconds, peak beside (1 + 2 C) x the params, rows
   5-8 and 10's launches against the block arithmetic, a profiled round)
   and 1 extract round within EXTRACT_TOL of the fused rounds' first, on
   DeepSeek-V3 cut to its first (dense) layer and the MTP block,
   MusicGen-large at 12 of 48 layers and Phi-3-vision at 8 of 32 (the
   bf16 rounds of 4o run them deeper).
   ``[mla eval]``: DeepSeek-V3 at 1 dense + 1 MoE layer of all 256
   experts + MTP (14.5 B params; ``dropping``): its loss (``lm_loss``,
   ``mtp_loss``) on 1 x 2048 tokens, the ``heads`` + ``d_ff`` sub-model's
   loss (rows 1-2) and backward at 2 x 256 (rows 3-4), held against the
   compact sub-model; ``[mla serve]``: 32 greedy steps after 2 x 256
   through the absorbed decode, teacher-forced decode vs prefill and 4
   requests through the continuous batcher (every logit held against
   single-request decoding) at a capacity that holds every choice.
   ``[audio eval]``, ``[vlm eval]``: MusicGen-large and Phi-3-vision
   whole on 4 x 2048 positions with and without flash (row 13 at
   head_dim 64 and 96); ``[audio serve]``, ``[vlm serve]``: 32 greedy
   steps after 4 x 1536 positions, teacher-forced decode of the last 32
   of 512 positions vs one prefill.
4m. bf16 parameters, after the mask path with the optimizers: ``[agree
   bf16]`` in phase 3 first holds reduced TinyLlama at bf16 card vs CPU (2
   fused window, 2 extract and 2 momentum mask rounds: client losses
   within 2e-2, the params' change from the start within a gap of 0.15 of
   the CPU's over all leaves and 0.4 for a leaf, where unmoved params read
   1).  ``[bf16 window]``: full-width
   TinyLlama-1.1B with bf16 params in the window path's configuration, 3
   fused rounds (seconds, peak, the bf16 arms' launches against the layer
   arithmetic, no f32 arm launched) and a profiled round; ``[bf16 eval]``
   on the params they leave (4 x 2048 tokens, whole and the windowed
   sub-model through rows 1-2, each also with ``REPRO_USE_FLASH`` through
   row 13's bf16 arm, its gradient at 2 x 256 through rows 3-4);
   ``[bf16 extract]``: 3 rounds with
   ``fused_forward="off"`` from the same params and offsets, held
   against the fused rounds' params by the cosine of the two changes
   (0.7 over all leaves, 0.4 a leaf) and their norm ratios (0.8-1.25),
   profiled; ``[bf16 mask]``: 3
   Bernoulli rounds with client momentum (rows 9 and 11); ``[bf16
   serve]``: prefill 4 x 1536 and 32 greedy steps from the bf16 caches.
   cuBLAS runs bf16 products with f32 reductions
   (``allow_bf16_reduced_precision_reduction`` off, as the port's
   ``device.resolve_device`` leaves it).
4n. The SSM family and the hybrid block with bf16 params, after ``[bf16
   serve]``.  Phase 2 adds rows 12 and 13's bf16 arms (x, dt, B, C or q,
   k, v bf16; A and the SSD states f32), within one bf16 ulp plus 1e-4 of
   the largest output of their plain versions at ragged chunks and
   lengths, odd head offsets and views at odd strides, timed at a Mamba2
   prefill layer and Hymba's (row 12), q [4, 2048, 32, 64], head_dim 128
   and Hymba's eval (row 13, beside a bf16 SDPA, which rounds P to bf16),
   each beside its bound (the bf16 bytes; C B^T and q k^T at the dense
   bf16 rate, the products with an f32 operand at the 3xTF32 rate).
   ``[agree bf16]`` in phase 3 adds reduced Mamba2 and Hymba at bf16 (2
   fused, 2 extract and 2 Bernoulli mask rounds each, card vs CPU, by the
   gap).  ``[bf16 ssm round]``: full-width Mamba2-130M with bf16 params
   in ``[ssm round]``'s configuration at client lr BF16_SLICE_LR, 3 fused
   rounds (rows 5, 6 and 10 at bf16, no f32 arm) and one profiled
   (``[profile bf16 ssm round]``, with the chunked SSD's range);
   ``[bf16 ssm extract]``: 3 extract rounds held
   against them by the cosine and norm ratios; ``[bf16 ssm mask]``: 2
   Bernoulli rounds (rows 9 and 11); ``[bf16 ssm eval]``: its loss on 4 x
   2048 tokens (row 12's bf16 arm, 24 launches); ``[bf16 ssm serve]``: 8 x
   32768 prefilled and BF16_SSM_G greedy steps from the bf16 caches (the
   SSM state f32).  ``[bf16 hybrid round]`` / ``[bf16 hybrid extract]``:
   Hymba-1.5B at HYB_LAYERS layers the same way, unprofiled (rows 5-8,
   10);
   ``[bf16 hybrid eval]``: 4 x 2048 with ``REPRO_USE_FLASH`` (rows 12 and
   13 at bf16) and without; ``[bf16 hybrid serve]``: 4 x 2048 and
   BF16_HYB_G greedy steps.  Each prints seconds, peak and its launches.
4o. The rest of the zoo with bf16 params, after ``[bf16 hybrid serve]``.
   Phase 2 adds rows 5-6 at MLA's up-projections, rows 7-8 at one
   client's lane of Mixtral's experts and row 13 at Phi-3-vision's
   head_dim 96.  ``[agree bf16 zoo]`` in phase 3 holds reduced Mixtral,
   DeepSeek-V3, MusicGen and Phi-3-vision at bf16 card vs CPU (2 fused
   rounds each, by the gap) and reduced DeepSeek-V3 through the
   continuous batcher against single-request decoding.  ``[bf16 moe
   round]`` (Mixtral-8x22B, 2 of 56 layers), ``[bf16 mla round]``
   (DeepSeek-V3's dense layer + MTP), ``[bf16 vlm round]`` (Phi-3-vision,
   all 32 layers), ``[bf16 audio round]`` (MusicGen-large, 24 of 48):
   BF16_ZOO_ROUNDS, C = 2, 2 fused rounds then 1 extract round held by
   the cosine and norm ratios; ``[bf16 mla eval]`` / ``[bf16 mla serve]``:
   DeepSeek-V3 at 1 dense + 2 MoE layers + MTP (the sub-model through rows
   1-4, absorbed decode from the bf16 ``c``/``kr`` caches, teacher-forced
   vs prefill); ``[bf16 audio eval]`` / ``[bf16 vlm eval]``: flash vs
   blockwise and a BF16_FAM_G-step generate.

4q. The planning path (``phase_plan``), after the Mamba2 round: the
   window (``[main]``), bf16 window, Mamba2 and mask rounds' configurations
   planned on ``meta`` in this process (``launch.specs.make_plan``,
   ``launch.dryrun.count``), each planned peak beside the same run's
   ``max_memory_allocated`` of that path (``[plan]``, ratio within
   PLAN_RATIO); then ``analysis.round_profile.profile(..., measure=True)``
   at the window path's shapes (``[plan profile]``: each fused and
   extract phase's counted FLOPs, bytes and step bound beside its device
   time, every share at most 1.05).  Every kernel row's bound comes from
   its ``kernels/*.cost()`` (``analysis.roofline.bound_ms``).

The bf16 bodies: rows 1-8's bf16 arm runs on wgmma fed by TMA where the
tensor map takes its operands, else on its mma.sync body; ``[kernels
bf16]`` prints each timed launch's body and tile, its device time alone
(``device_ms``, ``torch.profiler``: at the small shapes ``cuda_ms`` also
counts the Python wrapper's host time), rows 5-6 also at Mamba2's and
Hymba's dt, q and k/v windows, and row 13's bound for the work of its
design (q k^T and P v's two bf16 passes at 989 TFLOP/s) beside that of
its 3xTF32-P design before it (``bound_3xtf32_p_ms``).  Each bf16 path
prints its launches by body (``[bf16 window] launches by body``),
``[bf16 window]`` checks that the wgmma body took all of rows 5-8's, and
rows 1-8's bf16 rows carry ``launches_by_body`` and ``bodies``.

The bf16 rows (``<kernel>/bf16``) carry the bf16 paths' launches
(``bf16_window``; row 10 also ``bf16_extract``; rows 5-11 the bf16 SSM
and hybrid rounds, 12 ``bf16_ssm_serve``, ``bf16_ssm_eval``,
``bf16_hybrid_eval`` and ``bf16_hybrid_serve``, 13 ``bf16_eval``,
``bf16_hybrid_eval``, ``bf16_audio_eval`` and ``bf16_vlm_eval``; rows 5-8
and 10 the bf16 zoo's ``bf16_{moe,mla,vlm,audio}_round`` (row 10 also
their ``_extract``), rows 1-4 ``bf16_mla_eval``).
The update kernels (rows 9-11) are also held and timed at the shapes the
extract and paper paths give them, and rows 5-13 carry each path's
launches (``launches_by_path``: extract, full, stagger, hetero, fleet,
mask_opt, paper, ssm_round, ssm_extract, hybrid_round, hybrid_extract,
hybrid_eval, hybrid_serve, the zoo's deepseek_round, deepseek_extract,
qwen3_round, qwen3_extract, mixtral_round, mixtral_extract, zoo_eval and
qwen3_eval, and the rest of the zoo's mla_round, mla_extract,
audio_round, audio_extract, vlm_round, vlm_extract, audio_eval and
vlm_eval; rows 1-4 carry zoo_eval and mla_eval); rows 5-8 and 10 are also
timed at the hetero path's narrowest bucket (one client, windows 512 and
704 columns), rows 5-8 at the SSM and hybrid rounds' shapes (``SLICE_ROWS``)
and the zoo rounds' (``ZOO_ROWS``: also MLA's up-projections, DeepSeek-
V3's, MusicGen's and Phi-3-vision's), and row 13 at Hymba's eval shape
(25 query heads on 5 kv heads, window 1024) and the zoo evals' (head_dim
128: G = 1, G = 5, and G = 6 under a window of 4096; G = 1 at head_dim 64
and 96).
The last lines are the ``{"kernels": [...]}`` record, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.  With no
card, or without the repository beside it, the script fails and prints no
result.
"""
import contextlib
import dataclasses
import gc
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CKPT_DIR = ROOT / "build" / "chip_smoke"     # git-ignored; removed after use

# The card's rates, and each kernel row's bound from its launch's declared
# cost: ``repro_torch.analysis.roofline`` (PEAK_FLOPS, HBM_BW, bound_ms)
BF16_TOL = "1 bf16 ulp + 1e-6 max|plain|"   # bf16_err
BF16_TOL_1213 = "1 bf16 ulp + 1e-4 max|plain|"   # rows 12, 13
# kernel vs plain version: f32 both, different summation order; bounded
# relative to the output's largest magnitude
MM_RTOL = 1e-4
ROUND_TOL = 1e-4          # reduced round, card vs CPU (losses and params)
EVAL_RTOL = 1e-5          # full-width eval loss, flash vs blockwise
# full-width Mamba2, teacher-forced decode vs prefill: each layer's state h
# past layer 0.  One-token decode and 32k-token prefill round their
# products differently (other GEMM shapes); the differences grow through the
# residual stream with depth (8e-6 at layer 0 to 1.1e-4 at layer 21 of 24 on
# an H100 at 700 W), while layer 0's mixer on one input agrees within 1e-5
# (``layer_states_vs_recurrence``, held to MM_RTOL)
DEPTH_RTOL = 1e-3
HETERO = [1.0, 0.5, 0.25, 0.125]
WARM_MS = 25.0            # kernel timing: warm-up wall time before counting

C, M, D = 4, 512, 2048    # clients, tokens per client (2 x 256), d_model
EB, ES = 4, 2048          # eval batch: 4 sequences of TinyLlama's context
# Hymba's eval and serving: 4 x 2048 (past its window of 1024), 64 greedy
# steps; the teacher-forced check prefills 1536 (a whole number of
# blockwise attention's 512-query chunks and of the SSD's 128-token chunks)
# and decodes the last 512
HB, HS, HG, HSPLIT = 4, 2048, 64, 1536
SRC = "src/repro_torch/kernels/csrc/"
TPU = "src/repro/kernels/"


def check(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


@contextlib.contextmanager
def flash_switch(on):
    """``REPRO_USE_FLASH`` set (or unset) for the duration."""
    old = os.environ.pop("REPRO_USE_FLASH", None)
    if on:
        os.environ["REPRO_USE_FLASH"] = "1"
    try:
        yield
    finally:
        os.environ.pop("REPRO_USE_FLASH", None)
        if old is not None:
            os.environ["REPRO_USE_FLASH"] = old


def eval_loss(model, params, tokens, window=None, flash=False):
    """One model's held-out loss (``Model.loss`` under no_grad), a float."""
    return batch_loss(model, params, {"tokens": tokens}, window, flash)[0]


def batch_loss(model, params, batch, window=None, flash=False):
    """One model's held-out loss on a batch (with its extras: codebook
    tokens, patches) and its metrics, as floats (under no_grad)."""
    with flash_switch(flash), torch.no_grad():
        loss, m = model.loss(params, batch, window=window)
    return float(loss), {k: float(v) for k, v in m.items()}


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    ``warmup`` calls and then more until WARM_MS of wall time has passed:
    a card that idled while the host checked the last result runs its first
    calls at a lower clock."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while 1e3 * (time.perf_counter() - t0) < WARM_MS:
        fn()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n=20):
    """The device time of the kernels one call of ``fn`` launches, from a
    ``torch.profiler`` profile of ``n`` calls after one: the kernels
    alone, where ``cuda_ms`` also counts the host's time between launches
    that do not keep the card busy (small kernels behind a Python
    wrapper)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / n


def err(a, b):
    d = (a - b).abs().max().item()
    return d, d / max(b.abs().max().item(), 1e-30)


def bits_equal(a, b):
    it = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


def bf16_err(a, b, slack=1e-6):
    """``(max abs difference, relative to max|b|, its largest excess over
    the bf16 arms' tolerance)`` of bf16 ``a`` against bf16 ``b``: within
    one bf16 ulp of each element of ``b`` (2^-7 of the power of two at or
    below its magnitude), plus ``slack`` of b's largest magnitude.  The
    kernel and the plain version both sum in f32, in other orders, and
    round once; where the two sums straddle a rounding boundary they round
    one ulp apart (rows 12 and 13 take MM_RTOL as the slack, their f32
    arms' tolerance for the other order).  The excess is <= 0 when every
    element is within."""
    check(a.dtype == b.dtype == torch.bfloat16, f"bf16 arms return "
          f"{a.dtype}, plain {b.dtype}")
    a, b = a.float(), b.float()
    mant, exp = torch.frexp(b)
    ulp = torch.where(mant == 0, torch.zeros_like(b),
                      torch.ldexp(torch.ones_like(b), exp - 8))
    d, top = (a - b).abs(), b.abs().max()
    excess = d - ulp - slack * top
    return (d.max().item(), d.max().item() / max(top.item(), 1e-30),
            excess.max().item())


def scfg_for(scheme):
    """The main path's sub-model configuration, under ``scheme``."""
    from repro_torch.configs.base import SubmodelConfig
    return SubmodelConfig(scheme=scheme, capacity=0.5, local_steps=2,
                          clients_per_round=4, client_lr=0.1,
                          axes=("d_ff", "heads", "kv_heads"))


# -- phase 1 ------------------------------------------------------------------


def phase_build(_build):
    t0 = time.time()
    path, log = _build.build()
    _build.library()
    print(f"[build] {path.name} in {time.time() - t0:.1f} s")
    for line in log.splitlines():
        if ("ptxas info" in line or line.startswith("==")
                or "spill" in line):
            print(f"[build] {line.strip()}")
    per_src, per_fn = kernel_report(_build, path, log)
    for src, (n, spill, hmma, hgmma) in per_src.items():
        print(f"[build] {src}: {n} kernels, {spill} bytes of spill stores, "
              f"HMMA (mma.sync) per kernel {min(hmma)}..{max(hmma)}, HGMMA "
              f"(wgmma) per kernel {min(hgmma)}..{max(hgmma)}")
    # the bf16 arms' own bodies: rows 1-8's wgmma kernels, rows 12 and 13's
    # kernels (bf16 m16n8k16, HMMA.16816, and no TF32 mma: every TF32 HMMA
    # carries .TF32, as 3xTF32's m16n8k8 is HMMA.1688.F32.TF32 on sm_90a)
    for fn, r in per_fn.items():
        bf16_mma = ("flash_attn_bf16_kernel" in fn
                    or "ssd_bf16_kernel" in fn)
        if "wgmma_kernel" in fn or bf16_mma:
            print(f"[build] {r['src']} {demangle(fn)}: {r['regs']} registers, "
                  f"{r['spill']} bytes of spill stores, HGMMA {r['hgmma']}, "
                  f"HMMA.16816 {r['hmma16816']}, TF32 HMMA {r['hmma_tf32']}")
            if bf16_mma:
                check(r["hmma16816"] > 0 and r["hmma_tf32"] == 0,
                      f"bf16 kernel {fn} runs TF32 mma: {r}")
            else:
                check(r["hgmma"] > 0, f"{fn} has no wgmma: {r}")


def demangle(fn):
    """A kernel's name without its template arguments' mangling noise:
    ``rolling_mm_fwd_wgmma_kernel<WTile<128, 128, 6>, 1>``."""
    import re
    for m in re.finditer(r"(\d+)([A-Za-z_])", fn):
        end = m.start(2) + int(m.group(1))
        if fn[m.start(2):end].endswith("kernel"):
            args = re.findall(r"Li(\d+)E", fn[end:].split("EEv")[0])
            return f"{fn[m.start(2):end]}<{', '.join(args)}>"
    return fn


def kernel_report(_build, path, log):
    """Per source: its kernels, the spill stores ptxas reports over all of
    them (bytes), and the HMMA (mma.sync) and HGMMA (wgmma) instructions
    cuobjdump finds in each; and per kernel its source, registers, spill
    stores and tensor-core instructions (HGMMA, bf16 HMMA.16816, TF32
    HMMA)."""
    src, fn, per_fn = None, None, {}
    for line in log.splitlines():
        if line.startswith("== nvcc "):
            src = line.split()[2]
        elif "Function properties for" in line:
            fn = line.rsplit(" ", 1)[-1]
        elif "spill stores" in line and fn:
            per_fn[fn] = dict(src=src, spill=int(
                line.split(" bytes spill stores")[0].rsplit(" ", 1)[-1]),
                regs=0, hmma=0, hgmma=0, hmma16816=0, hmma_tf32=0)
        elif "Used" in line and "registers" in line and fn in per_fn:
            per_fn[fn]["regs"] = int(line.split("Used ")[1].split()[0])
            fn = None
    sass = subprocess.run(
        [str(Path(_build._nvcc()).with_name("cuobjdump")), "-sass",
         str(path)], capture_output=True, text=True, timeout=300,
        check=True).stdout
    fn = None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
        elif fn in per_fn:
            r = per_fn[fn]
            if "HGMMA" in line:
                r["hgmma"] += 1
            elif "HMMA" in line:
                r["hmma"] += 1
                r["hmma16816"] += "HMMA.16816" in line
                r["hmma_tf32"] += ".TF32" in line
    per_src = {}
    for fn, r in per_fn.items():
        n, total, counts, wg = per_src.get(r["src"], (0, 0, [], []))
        per_src[r["src"]] = (n + 1, total + r["spill"], counts + [r["hmma"]],
                             wg + [r["hgmma"]])
    return per_src, per_fn


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# -- phase 2 ------------------------------------------------------------------


# (kernel, TPU row, TPU function, T, N, win, offset, direction) at the main
# path's shapes: the q projection (heads window 16 of 32 at offset 16, i.e.
# 1024 of 2048 columns) and the gate/up pair (d_ff window 2816 of 5632);
# rows 5 and 6 also at the k/v projections' shape (kv_heads window 2 of 4,
# 128 of 256 columns), which takes 88 of a round's 132 launches of each
ROLLING = [
    ("rolling_mm_fwd<1>", 5, "rolling_matmul_batched.py:60", 1, 2048, 1024,
     1024, "fwd"),
    ("rolling_mm_dx<1>", 6, "rolling_matmul_batched.py:110", 1, 2048, 1024,
     1024, "dx"),
    ("rolling_mm_fwd<2>", 7, "rolling_matmul_batched.py:164", 2, 5632, 2816,
     2816, "fwd"),
    ("rolling_mm_dx<2>", 8, "rolling_matmul_batched.py:219", 2, 5632, 2816,
     2816, "dx"),
]
# the SSM and hybrid rounds' shapes of rows 5-8, C = 4 (tag, T, tokens a
# client, K, N, win, offset): Mamba2's z/x and dt projections (2 x 1024
# tokens, d_model 768, ssm_heads 12 of 24 heads of 64) and Hymba's (2 x 256
# tokens, d_model 1600): z/x 25 of 50 heads, dt 25 of 50 columns (a row
# stride and window that are not multiples of 4: the kernels' scalar copy
# path), q 10 of 25 heads, k/v 2 of 5, the gate/up pair 2752 of 5504
SLICE_ROWS = [
    ("mamba2 z/x", 1, 2048, 768, 1536, 768, 768),
    ("mamba2 dt", 1, 2048, 768, 24, 12, 12),
    ("hymba z/x", 1, 512, 1600, 3200, 1600, 1600),
    ("hymba dt", 1, 512, 1600, 50, 25, 25),
    ("hymba q", 1, 512, 1600, 1600, 640, 960),
    ("hymba k/v", 1, 512, 1600, 320, 128, 192),
    ("hymba gate/up", 2, 512, 1600, 5504, 2752, 2752),
]
# this slice's zoo rounds' shapes of rows 5-8 (tag, T, clients, tokens a
# client, K, N, win, offset): DeepSeek-7B's q/k/v (MHA: one shape), Qwen3-
# 14B's and Mixtral-8x22B's q and k/v (heads and kv_heads at half), the
# dense gate/up pairs (d_ff at half); Mixtral's experts: the launch its
# round makes, one client's window of 4 of 8 experts at capacity 320
# (2 x 256 tokens, top-2, capacity factor 1.25) with moe_d_ff 8192 of 16384
ZOO_ROWS = [
    ("deepseek q/k/v", 1, 4, 512, 4096, 4096, 2048, 2048),
    ("qwen3 q", 1, 2, 512, 5120, 5120, 2560, 2560),
    ("qwen3 k/v", 1, 2, 512, 5120, 1024, 512, 512),
    ("mixtral q", 1, 2, 512, 6144, 6144, 3072, 3072),
    ("mixtral k/v", 1, 2, 512, 6144, 1024, 512, 512),
    ("deepseek gate/up", 2, 4, 512, 4096, 11008, 5504, 5504),
    ("qwen3 gate/up", 2, 2, 512, 5120, 17408, 8704, 8704),
    ("mixtral experts, a client", 2, 4, 320, 6144, 16384, 8192, 8192),
    # the rest of the zoo's rounds, C = 2 x 2 x 256 tokens: DeepSeek-V3's
    # MLA up-projections (heads 64 of 128: w_uq's 192 columns a head from
    # q_lora 1536, w_uk's and w_uv's 128 from kv_lora 512) and its dense
    # gate/up (d_ff 9216 of 18432); MusicGen-large's q/k/v (1024 of 2048)
    # and gate/up (4096 of 8192); Phi-3-vision's, on 256 patches + 256
    # tokens a sequence (q/k/v 1536 of 3072, gate/up 4096 of 8192)
    ("mla w_uq", 1, 2, 512, 1536, 24576, 12288, 12288),
    ("mla w_uk/w_uv", 1, 2, 512, 512, 16384, 8192, 8192),
    ("deepseek-v3 gate/up", 2, 2, 512, 7168, 18432, 9216, 9216),
    ("musicgen q/k/v", 1, 2, 512, 2048, 2048, 1024, 1024),
    ("musicgen gate/up", 2, 2, 512, 2048, 8192, 4096, 4096),
    ("phi-3-v q/k/v", 1, 2, 1024, 3072, 3072, 1536, 1536),
    ("phi-3-v gate/up", 2, 2, 1024, 3072, 8192, 4096, 4096),
]
# further correctness cases (C, M, K, N, win, per-client offsets): the k/v
# projections, unaligned and per-client offsets, ragged shapes
EXTRA = [
    (C, M, D, 256, 128, [128] * C),
    (C, M, D, 256, 128, [0, 37, 128, 5]),
    (3, 300, 1000, 777, 333, [0, 17, 444]),
    (C, M, D, 5632, 2816, [1, 2815, 2816, 100]),
]


def phase_kernels(dev):
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels.masked_update import cost as update_cost
    from repro_torch.kernels import ref
    from repro_torch.kernels.masked_update import sgd_
    from repro_torch.kernels.rolling_matmul import (make_offsets,
                                                    rolling_matmul_batched,
                                                    rolling_mm_dx,
                                                    rolling_mm_fwd)
    g = torch.Generator(dev).manual_seed(0)
    rows = []

    for (c, m, k, n, win, offs) in EXTRA:
        for T in (1, 2):
            x = torch.randn((c, m, k), device=dev, generator=g)
            ws = [torch.randn((c, k, n), device=dev, generator=g)
                  for _ in range(T)]
            dys = [torch.randn((c, m, win), device=dev, generator=g)
                   for _ in range(T)]
            o = make_offsets(offs, dev)
            for y, yr in zip(rolling_mm_fwd(x, ws, o, win),
                             ref.rolling_matmul_batched_ref(x, ws, offs,
                                                            win)):
                check(err(y, yr)[1] <= MM_RTOL,
                      f"fwd<{T}> {tuple(x.shape)} win {win} off {offs}: "
                      f"{err(y, yr)}")
            e = err(rolling_mm_dx(dys, ws, o, win),
                    ref.rolling_matmul_batched_dx_ref(dys, ws, offs, win))
            check(e[1] <= MM_RTOL, f"dx<{T}> {tuple(x.shape)} win {win} "
                  f"off {offs}: {e}")
    print(f"[kernels] {len(EXTRA) * 2 * 2} extra shape/offset checks "
          f"within {MM_RTOL} of max|plain|")

    for name, row, tpu_fn, T, N, win, off, kind in ROLLING:
        r = product_timing(dev, g, kind, T, C, M, N, win, off)
        rows.append(dict(name=name, route="cuda",
                         source=SRC + "rolling_mm.cu",
                         replaces=TPU + tpu_fn, tpu_row=row, **r))
        if row in (5, 6):      # the k/v projections: window 128 of 256
            rows[-1]["sub_rows"] = [product_timing(dev, g, kind, T, C, M,
                                                   256, 128, 128)]
        # the stagger path's per-client windows: the grid's 2 windows, each
        # taken by 2 of the 4 clients
        rows[-1].setdefault("sub_rows", []).append(product_timing(
            dev, g, kind, T, C, M, N, win, [0, off, 0, off]))
        # the hetero path's narrowest bucket (capacity 0.125, one client):
        # the q window 512 of 2048 columns (kv_heads 1 of 4) and the gate/up
        # window 704 of 5632, at one of its grid offsets
        h_win, h_off = (512, 1024) if T == 1 else (704, 2816)
        rows[-1]["sub_rows"].append(product_timing(dev, g, kind, T, 1, M, N,
                                                   h_win, h_off))
        # the SSM round's and the hybrid round's shapes
        for tag, T_, m, K, N_, w, o in SLICE_ROWS:
            if T_ == T:
                rows[-1]["sub_rows"].append({"tag": tag, **product_timing(
                    dev, g, kind, T, C, m, N_, w, o, K=K)})
        # the zoo rounds' shapes
        for tag, T_, c, m, K, N_, w, o in ZOO_ROWS:
            if T_ == T:
                rows[-1]["sub_rows"].append({"tag": tag, **product_timing(
                    dev, g, kind, T, c, m, N_, w, o, K=K)})

    # autograd through the Function at the gate/up shape against plain
    # autograd on the window views
    T, N, win, off = 2, 5632, 2816, 2816
    x = torch.randn((C, M, D), device=dev, generator=g, requires_grad=True)
    ws = [torch.randn((C, D, N), device=dev, generator=g,
                      requires_grad=True) for _ in range(T)]
    dys = [torch.randn((C, M, win), device=dev, generator=g)
           for _ in range(T)]
    ys = rolling_matmul_batched(x, ws, make_offsets([off] * C, dev), win)
    got = torch.autograd.grad(ys, [x, *ws], dys)
    ys_ref = ref.rolling_matmul_batched_ref(x, ws, [off] * C, win)
    want = torch.autograd.grad(ys_ref, [x, *ws], dys)
    for name, a, b in zip(("dx", "dW_gate", "dW_up"), got, want):
        e = err(a, b)
        check(e[1] <= MM_RTOL, f"autograd {name}: {e}")
        print(f"[kernels] autograd {name} max abs err {e[0]:.3g} "
              f"(rel {e[1]:.3g})")
    del x, ws, dys, ys, got, ys_ref, want

    # the SGD step on the largest leaf, and on a ragged misaligned one; then
    # in place on views with mismatched misalignments (w at +1 float, g at
    # +2: the scalar loop) and a shared one (both at +1: a scalar head, then
    # the float4 body)
    n = C * D * 5632
    w = torch.randn(n, device=dev, generator=g)
    gr = torch.randn(n, device=dev, generator=g)
    for lo, size in ((0, n), (1, 1_000_003)):
        a = sgd_(w[lo:lo + size].clone(), gr[lo:lo + size], 0.1)
        b = ref.sgd_ref(w[lo:lo + size].clone(), gr[lo:lo + size], 0.1)
        check(torch.equal(a, b), f"sgd_inplace not bit-exact at {lo}+{size}")
    size = n - 2
    for wo, go in ((1, 2), (1, 1)):
        b = ref.sgd_ref(w[wo:wo + size].clone(), gr[go:go + size], 0.1)
        a = w.clone()[wo:wo + size]
        sgd_(a, gr[go:go + size], 0.1)
        check(bits_equal(a, b), f"sgd_inplace not bit-exact on views at w+"
              f"{wo}, g+{go}")
    b_ms, b_by = bound_ms(*update_cost("sgd", n))
    k_ms = cuda_ms(lambda: sgd_(w, gr, 1e-6))
    rows.append(dict(
        name="sgd_inplace", route="cuda", source=SRC + "sgd.cu",
        replaces=TPU + "masked_update.py:53", tpu_row=10,
        shape={"w": [C, D, 5632]}, max_abs_err=0.0, max_rel_err=0.0,
        tolerance=0.0, ms=k_ms, kernel_ms=k_ms,
        plain_ms=cuda_ms(lambda: ref.sgd_ref(w, gr, 1e-6)),
        library_ms=cuda_ms(lambda: w.add_(gr, alpha=-1e-6)),
        library_calls=1, bound_ms=b_ms, bound_by=b_by))
    del w, gr
    rows += mask_kernels(dev, g)
    rows += scalar_kernels(dev, g)
    rows += flash_kernels(dev, g)
    rows += ssd_kernels(dev, g)
    path_update_rows(dev, g, rows)
    for r in rows:
        for sub in [r, *r.get("sub_rows", [])]:
            lib = ("none" if sub["library_ms"] is None
                   else f"{sub['library_ms']:.4f} ms")
            tile = ("" if "block_tile" not in sub else
                    " tile {}x{}".format(*sub["block_tile"]))
            tag = f"{sub['tag']}: " if "tag" in sub else ""
            print(f"[kernels] {r['name']:23s} {tag}{json.dumps(sub['shape'])} "
                  f"err {sub['max_abs_err']:.3g} kernel {sub['ms']:.4f} ms"
                  f"  plain {sub['plain_ms']:.4f} ms  library {lib}  bound "
                  f"{sub['bound_ms']:.4f} ms ({sub['bound_by']}){tile}")
    return rows


def product_timing(dev, g, kind, T, c, m, N, win, off, scalar_name=None,
                   K=D, dtype=torch.float32, slack=1e-6):
    """One product kernel ("fwd" or "dx", T weights) at one shape: ``c``
    clients of ``m`` tokens, x [c, m, K], W [c, K, N], window ``win`` at
    ``off`` (a list: one offset per client).  Held against its plain
    version within MM_RTOL, then timed beside it, beside the library
    (``bmm``/``baddbmm`` on the window views; ``mm``/``addmm`` for one
    model, ``scalar_name`` given, which also names the launches; none for
    per-client windows, which no one call reads in place) and beside its
    bound at the 3xTF32 rate; a second launch must equal the first bit for
    bit.  Returns the kernel table's numbers and the block tile the launch
    took.  ``dtype`` bfloat16 takes the bf16 arm: held within one bf16 ulp
    of the plain version plus ``slack`` of its largest output
    (``bf16_err``), its bound at the dense bf16 rate and half the bytes,
    the library call on the bf16 window views."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.rolling_matmul import (block_tile, make_offsets,
                                                    rolling_mm_dx,
                                                    rolling_mm_fwd)
    x = torch.randn((c, m, K), device=dev, generator=g).to(dtype)
    ws = [torch.randn((c, K, N), device=dev, generator=g).to(dtype)
          for _ in range(T)]
    dys = [torch.randn((c, m, win), device=dev, generator=g).to(dtype)
           for _ in range(T)]
    bf16 = dtype == torch.bfloat16
    def diff(a, b):
        """(abs, rel, excess over the tolerance: <= 0 passes)"""
        if bf16:
            return bf16_err(a, b, slack)
        e = err(a, b)
        return (*e, e[1] - MM_RTOL)
    per_client = isinstance(off, list)
    offs = off if per_client else [off] * c
    o = make_offsets(offs, dev)     # the device copy a model keeps
    views = [] if per_client else [w[:, :, off:off + win] for w in ws]
    lead = [] if scalar_name else [c]
    if kind == "fwd":
        kern = lambda: rolling_mm_fwd(x, ws, o, win, name=scalar_name)  # noqa
        plain = lambda: ref.rolling_matmul_batched_ref(x, ws, offs,  # noqa
                                                       win)
        if scalar_name:
            lib = lambda: [torch.mm(x[0], v[0]) for v in views]  # noqa
        else:
            lib = lambda: [torch.bmm(x, v) for v in views]       # noqa
        before = dict(_build.BODIES)
        out = kern()
        e = max((diff(a, b) for a, b in zip(out, plain())),
                key=lambda t: t[2])
        shape = {"x": lead + [m, K], "W": [T] + lead + [K, N], "win": win}
    else:
        kern = lambda: rolling_mm_dx(dys, ws, o, win, name=scalar_name)  # noqa
        plain = lambda: ref.rolling_matmul_batched_dx_ref(  # noqa
            dys, ws, offs, win)

        def lib():
            if scalar_name:
                acc = torch.mm(dys[0][0], views[0][0].mT)
                for d, v in zip(dys[1:], views[1:]):
                    acc = torch.addmm(acc, d[0], v[0].mT)
                return acc
            acc = torch.bmm(dys[0], views[0].mT)
            for d, v in zip(dys[1:], views[1:]):
                acc = torch.baddbmm(acc, d, v.mT)
            return acc
        before = dict(_build.BODIES)
        out = [kern()]
        e = diff(out[0], plain())
        shape = {"dy": [T] + lead + [m, win], "W": [T] + lead + [K, N],
                 "win": win}
    check(e[2] <= 0, f"{kind}<{T}> {dtype} at {shape}: {e}")
    again = kern()
    check(all(bits_equal(a, b) for a, b in zip(
        out, again if kind == "fwd" else [again])),
          f"{kind}<{T}> {dtype} at {shape}: two launches differ")
    # the body the launch ran (the bf16 arm has two)
    body = [k.rsplit(" ", 1)[1] for k, n in _build.BODIES.items()
            if n > before.get(k, 0)]
    from repro_torch.kernels.rolling_matmul import cost
    b_ms, b_by = bound_ms(*cost(kind, T, c, m, K, win, dtype))
    k_ms = cuda_ms(kern)
    if per_client:
        shape["offsets"] = offs
    extra = {}
    if bf16:
        extra = dict(body=body[0], device_ms=device_ms(kern))
    return dict(
        shape=shape, block_tile=list(block_tile(
            kind, T, c, m, K, win,
            dtype=dtype if extra.get("body") == "wgmma" else torch.float32)),
        max_abs_err=e[0], max_rel_err=e[1],
        tolerance=(BF16_TOL.replace("1e-6", f"{slack:g}") if bf16
                   else MM_RTOL), ms=k_ms,
        kernel_ms=k_ms, plain_ms=cuda_ms(plain),
        library_ms=None if per_client else cuda_ms(lib),
        library_calls=0 if per_client else T, bound_ms=b_ms, bound_by=b_by,
        bound_rate=("bf16: 2*M*N*K at 989 TFLOP/s, the work of both bodies "
                    "and of the mma.sync design" if bf16 else
                    "3xTF32: 2*M*N*K at 495/3 TFLOP/s"), **extra)


def mask_kernels(dev, g):
    """The mask path's update kernels, bit for bit against their plain
    versions: the masked step on the ``w_gate`` client leaf [4, 2048, 5632]
    and on a ragged misaligned slice; the fill-in on the ``w_gate`` server
    leaf [2048, 5632] for C in {3, 4} and server_lr in {1, 0.5}, and on a
    ragged misaligned leaf."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels.masked_update import cost as update_cost
    from repro_torch.kernels import ref
    from repro_torch.kernels.masked_update import fillin_agg_, masked_sgd_
    rows = []
    n = C * D * 5632
    w = torch.randn(n, device=dev, generator=g)
    m = (torch.rand(n, device=dev, generator=g) < 0.5).float()
    gr = torch.randn(n, device=dev, generator=g)
    for lo, size in ((0, n), (1, 1_000_003)):
        sl = slice(lo, lo + size)
        a = masked_sgd_(w[sl].clone(), m[sl], gr[sl], 0.1)
        b = ref.masked_sgd_ref(w[sl].clone(), m[sl], gr[sl], 0.1)
        check(bits_equal(a, b),
              f"masked_sgd_inplace not bit-exact at {lo}+{size}")
    size = n - 2          # in place on views: mismatched, then shared
    for wo, go in ((1, 2), (1, 1)):
        b = ref.masked_sgd_ref(w[wo:wo + size].clone(), m[go:go + size],
                               gr[go:go + size], 0.1)
        a = w.clone()[wo:wo + size]
        masked_sgd_(a, m[go:go + size], gr[go:go + size], 0.1)
        check(bits_equal(a, b), f"masked_sgd_inplace not bit-exact on views "
              f"at w+{wo}, m and g+{go}")
    b_ms, b_by = bound_ms(*update_cost("masked_sgd", n))
    k_ms = cuda_ms(lambda: masked_sgd_(w, m, gr, 1e-6))
    rows.append(dict(
        name="masked_sgd_inplace", route="cuda",
        source=SRC + "masked_update.cu", replaces=TPU + "masked_update.py:33",
        tpu_row=9, shape={"w": [C, D, 5632]}, max_abs_err=0.0,
        max_rel_err=0.0, tolerance=0.0, ms=k_ms, kernel_ms=k_ms,
        plain_ms=cuda_ms(lambda: ref.masked_sgd_ref(w, m, gr, 1e-6)),
        library_ms=cuda_ms(lambda: w.addcmul_(m, gr, value=-1e-6)),
        library_calls=1, bound_ms=b_ms, bound_by=b_by))
    del w, m, gr

    ns = D * 5632
    w = torch.randn(ns, device=dev, generator=g)
    for c in (3, 4):
        wc = torch.randn((c, ns), device=dev, generator=g)
        mc = (torch.rand((c, ns), device=dev, generator=g) < 0.5).float()
        for slr in (1.0, 0.5):
            for lo, size in ((0, ns), (1, 1_000_003)):
                sl = slice(lo, lo + size)
                cw = wc[:, :size].contiguous()
                cm = mc[:, :size].contiguous()
                a = fillin_agg_(w[sl].clone(), cw, cm, slr)
                b = ref.fillin_agg_ref(w[sl].clone(), cw, cm, slr / c)
                check(bits_equal(a, b), f"fillin_agg_inplace not bit-exact "
                      f"at C={c} server_lr={slr} {lo}+{size}")
    print("[kernels] update kernels bit-exact to their plain versions "
          "(aligned, ragged and misaligned; SGD steps in place on views with "
          "shared and mismatched misalignments; fill-in C in {3, 4}, "
          "server_lr in {1, 0.5})")
    b_ms, b_by = bound_ms(*update_cost("fillin", ns, clients=C))
    k_ms = cuda_ms(lambda: fillin_agg_(w, wc, mc, 1.0))
    rows.append(dict(
        name="fillin_agg_inplace", route="cuda",
        source=SRC + "masked_update.cu", replaces=TPU + "masked_update.py:79",
        tpu_row=11, shape={"w": [D, 5632], "w_c": [C, D, 5632]},
        max_abs_err=0.0, max_rel_err=0.0, tolerance=0.0, ms=k_ms,
        kernel_ms=k_ms,
        plain_ms=cuda_ms(lambda: ref.fillin_agg_ref(w, wc, mc, 1.0 / C)),
        library_ms=None, library_calls=0, bound_ms=b_ms, bound_by=b_by))
    return rows


def path_update_rows(dev, g, rows):
    """The update kernels also at the shapes the extract, hetero and paper
    paths give them, bit for bit against their plain versions and timed (a
    ``sub_rows`` entry each): row 10 on the extract round's stacked compact
    ``w_gate`` [4, 2048, 2816] and on one hetero bucket client's full
    ``w_gate`` [1, 2048, 5632]; rows 9 and 11 on ResNet18's largest leaf
    (stage 3's ``conv2``, [3, 3, 512, 512]) at the paper round's 10
    clients."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels.masked_update import cost as update_cost
    from repro_torch.kernels import ref
    from repro_torch.kernels.masked_update import (fillin_agg_, masked_sgd_,
                                                   sgd_)
    by = {r["name"]: r for r in rows}

    def sub(name, shape, ok, cost, kern, plain, lib):
        check(ok, f"{name} not bit-exact at {shape}")
        b_ms, b_by = bound_ms(*cost)
        by[name].setdefault("sub_rows", []).append(dict(
            shape=shape, max_abs_err=0.0, max_rel_err=0.0, tolerance=0.0,
            ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
            library_ms=None if lib is None else cuda_ms(lib),
            bound_ms=b_ms, bound_by=b_by))

    for c, width in ((C, 2816), (1, 5632)):
        # the extract round's stacked compact w_gate; a hetero bucket's one
        # client stepping its full-width copy
        n = c * D * width
        w = torch.randn(n, device=dev, generator=g)
        gr = torch.randn(n, device=dev, generator=g)
        sub("sgd_inplace", {"w": [c, D, width]},
            bits_equal(sgd_(w.clone(), gr, 0.1),
                       ref.sgd_ref(w.clone(), gr, 0.1)),
            update_cost("sgd", n), lambda: sgd_(w, gr, 1e-6),
            lambda: ref.sgd_ref(w, gr, 1e-6), lambda: w.add_(gr, alpha=-1e-6))
    cp, leaf = 10, [3, 3, 512, 512]
    ns = math.prod(leaf)
    n = cp * ns
    w = torch.randn(n, device=dev, generator=g)
    m = (torch.rand(n, device=dev, generator=g) < 0.5).float()
    gr = torch.randn(n, device=dev, generator=g)
    sub("masked_sgd_inplace", {"w": [cp] + leaf},
        bits_equal(masked_sgd_(w.clone(), m, gr, 0.1),
                   ref.masked_sgd_ref(w.clone(), m, gr, 0.1)),
        update_cost("masked_sgd", n), lambda: masked_sgd_(w, m, gr, 1e-6),
        lambda: ref.masked_sgd_ref(w, m, gr, 1e-6),
        lambda: w.addcmul_(m, gr, value=-1e-6))
    ws = torch.randn(ns, device=dev, generator=g)
    wc, mc = w.view(cp, ns), m.view(cp, ns)
    sub("fillin_agg_inplace", {"w": leaf, "w_c": [cp] + leaf},
        bits_equal(fillin_agg_(ws.clone(), wc, mc, 1.0),
                   ref.fillin_agg_ref(ws.clone(), wc, mc, 1.0 / cp)),
        update_cost("fillin", ns, clients=cp),
        lambda: fillin_agg_(ws, wc, mc, 1.0),
        lambda: ref.fillin_agg_ref(ws, wc, mc, 1.0 / cp), None)


# the scalar-offset (one model) products at the eval path's shapes: rows 1-2
# on the windowed sub-model's eval (4 x 2048 tokens), rows 3-4 on its
# gradient (2 x 256 tokens); the q projection (window 1024 of 2048 columns)
# and the gate/up pair (window 2816 of 5632)
# (kernel, TPU row, TPU function, T, M, N, win, offset, direction)
SCALAR = [
    ("rolling_matmul", 1, "rolling_matmul.py:44", 1, EB * ES, 2048, 1024,
     1024, "fwd"),
    ("rolling_matmul_multi", 2, "rolling_matmul.py:95", 2, EB * ES, 5632,
     2816, 2816, "fwd"),
    ("rolling_matmul_dx", 3, "rolling_matmul_bwd.py:50", 1, M, 2048, 1024,
     1024, "dx"),
    ("rolling_matmul_dx_multi", 4, "rolling_matmul_bwd.py:104", 2, M, 5632,
     2816, 2816, "dx"),
]
# the same rows on DeepSeek-7B's windowed sub-model (``[zoo eval]``), by
# TPU row: (tag, M, K, N, win, offset); d_model 4096, the q/k/v window 2048
# of 4096 columns and the gate/up pair's 5504 of 11008, at offset 0 as the
# eval takes them; rows 1-2 on 4 x 2048 tokens, rows 3-4 on 2 x 256
SCALAR_ZOO = {
    1: ("deepseek q/k/v", EB * ES, 4096, 4096, 2048, 0),
    2: ("deepseek gate/up", EB * ES, 4096, 11008, 5504, 0),
    3: ("deepseek q/k/v", M, 4096, 4096, 2048, 0),
    4: ("deepseek gate/up", M, 4096, 11008, 5504, 0),
}


def scalar_kernels(dev, g):
    """TPU rows 1-4: C = 1 launches of the product kernels, counted under
    the scalar-offset names as one model's window counts them, against
    their plain versions (a product on the window view), at ragged shapes
    and misaligned offsets, then held and timed at TinyLlama's eval shapes
    (SCALAR) and DeepSeek-7B's sub-model's (SCALAR_ZOO)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rolling_matmul import (SCALAR_NAMES,
                                                    make_offsets,
                                                    rolling_mm_dx,
                                                    rolling_mm_fwd)

    def rolling_matmul_fwd(x, ws, o, win):
        return [y[0] for y in rolling_mm_fwd(
            x[None], [w[None] for w in ws], o, win,
            name=SCALAR_NAMES[len(ws)][0])]

    def rolling_matmul_dx(dys, ws, o, win):
        return rolling_mm_dx([d[None] for d in dys], [w[None] for w in ws],
                             o, win, name=SCALAR_NAMES[len(ws)][1])[0]

    def plain_fwd(x, ws, off, win):
        return ref.rolling_matmul_batched_ref(x[None], [w[None] for w in ws],
                                              [off], win)

    def plain_dx(dys, ws, off, win):
        return ref.rolling_matmul_batched_dx_ref(
            [d[None] for d in dys], [w[None] for w in ws], [off], win)

    for (m, k, n, win, off) in ((300, 1000, 777, 333, 17),
                                (M, D, 5632, 2816, 1)):
        for T in (1, 2):
            x = torch.randn((m, k), device=dev, generator=g)
            ws = [torch.randn((k, n), device=dev, generator=g)
                  for _ in range(T)]
            dys = [torch.randn((m, win), device=dev, generator=g)
                   for _ in range(T)]
            o = make_offsets([off], dev)
            for y, yr in zip(rolling_matmul_fwd(x, ws, o, win),
                             plain_fwd(x, ws, off, win)):
                check(err(y, yr[0])[1] <= MM_RTOL,
                      f"scalar fwd<{T}> {(m, k, n, win, off)}: "
                      f"{err(y, yr[0])}")
            e = err(rolling_matmul_dx(dys, ws, o, win),
                    plain_dx(dys, ws, off, win)[0])
            check(e[1] <= MM_RTOL, f"scalar dx<{T}> {(m, k, n, win, off)}: "
                  f"{e}")
    print("[kernels] scalar-offset products: 8 ragged / misaligned checks "
          f"within {MM_RTOL} of max|plain|")

    rows = []
    for name, row, tpu_fn, T, m, N, win, off, kind in SCALAR:
        r = product_timing(dev, g, kind, T, 1, m, N, win, off,
                           scalar_name=name)
        rows.append(dict(name=name, route="cuda",
                         source=SRC + "rolling_mm.cu",
                         replaces=TPU + tpu_fn, tpu_row=row, **r))
        tag, m, K, N, win, off = SCALAR_ZOO[row]
        rows[-1]["sub_rows"] = [{"tag": tag, **product_timing(
            dev, g, kind, T, 1, m, N, win, off, scalar_name=name, K=K)}]
    return rows


# flash attention cases (tag, B, S, H, KV, window); the first is the eval
# shape, timed
FLASH = [
    ("eval shape", EB, ES, 32, 4, 0),
    ("sliding window 512", EB, ES, 32, 4, 512),
    ("ragged S 1000", 2, 1000, 32, 4, 0),
    ("G = 1", 2, ES, 8, 8, 0),
    ("windowed sub-model 16/2 heads", EB, ES, 16, 2, 0),
]


def flash_kernels(dev, g):
    """TPU row 13: the flash kernel against its plain version (the Pallas
    body transcribed) at each case; timed at the eval shape and at head_dim
    128 (qwen3's, mixtral's and deepseek_7b's) by ``flash_timing``."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    hd = 64
    for tag, B, S, H, KV, win in FLASH:
        q = torch.randn((B, S, H, hd), device=dev, generator=g)
        k = torch.randn((B, S, KV, hd), device=dev, generator=g)
        v = torch.randn((B, S, KV, hd), device=dev, generator=g)
        e = err(flash_attention(q, k, v, window=win),
                ref.flash_attention_ref(q, k, v, window=win))
        check(e[1] <= MM_RTOL, f"flash {tag} {(B, S, H, KV, win)}: {e}")
        print(f"[kernels] flash {tag:30s} q {[B, S, H, hd]} kv heads {KV} "
              f"window {win}: max abs err {e[0]:.3g} (rel {e[1]:.3g})")
    del q, k, v
    row = dict(name="flash_attention", route="cuda",
               source=SRC + "flash_attn.cu",
               replaces=TPU + "flash_attention.py:88", tpu_row=13,
               **flash_timing(dev, g, EB, ES, 32, 4, 64))
    row["sub_rows"] = [flash_timing(dev, g, EB, ES, 32, 8, 128),
                       {"tag": "hymba eval", **flash_timing(
                           dev, g, HB, HS, 25, 5, 64, window=1024)},
                       {"tag": "deepseek eval (G = 1)", **flash_timing(
                           dev, g, EB, ES, 32, 32, 128)},
                       {"tag": "qwen3 eval (G = 5, qk_norm)", **flash_timing(
                           dev, g, QWEN_EB, ES, 40, 8, 128)},
                       {"tag": "mixtral eval (G = 6, window 4096)",
                        **flash_timing(dev, g, MOE_EB, MOE_ES, 48, 8, 128,
                                       window=4096)},
                       {"tag": "musicgen eval (G = 1, hd 64)", **flash_timing(
                           dev, g, EB, ES, 32, 32, 64)},
                       {"tag": "phi-3-v eval (G = 1, hd 96)", **flash_timing(
                           dev, g, EB, ES, 32, 32, 96)}]
    return [row]


def flash_timing(dev, g, B, S, H, KV, hd, window=0):
    """The flash kernel at one causal (``window`` > 0: sliding-window)
    shape: held against its plain version within MM_RTOL, a second launch
    bit-equal to the first, timed beside it, beside one f32
    ``scaled_dot_product_attention`` (timed only; the port never calls it;
    a sliding window takes it a boolean mask) and beside its bound at the
    3xTF32 rate."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn((B, S, H, hd), device=dev, generator=g)
    k = torch.randn((B, S, KV, hd), device=dev, generator=g)
    v = torch.randn((B, S, KV, hd), device=dev, generator=g)
    kern = lambda: flash_attention(q, k, v, window=window)           # noqa
    plain = lambda: ref.flash_attention_ref(q, k, v, window=window)  # noqa
    out = kern()
    e = err(out, plain())
    shape = {"q": [B, S, H, hd], "kv": [B, S, KV, hd], "causal": True,
             "window": window}
    check(e[1] <= MM_RTOL, f"flash at {shape}: {e}")
    check(bits_equal(out, kern()), f"flash at {shape}: two launches differ")
    del out
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        i = torch.arange(S, device=dev)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        lib = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                           enable_gqa=True)
    else:
        lib = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                           enable_gqa=True)
    from repro_torch.kernels.flash_attention import cost
    b_ms, b_by = bound_ms(*cost(B, S, S, H, KV, hd, True, window))
    k_ms = cuda_ms(kern)
    return dict(
        shape=shape, max_abs_err=e[0], max_rel_err=e[1], tolerance=MM_RTOL,
        ms=k_ms, kernel_ms=k_ms, plain_ms=cuda_ms(plain, iters=5),
        library_ms=cuda_ms(lib), library_calls=1, bound_ms=b_ms,
        bound_by=b_by,
        bound_rate="3xTF32: 4*B*H*hd*(visible pairs) at 495/3 TFLOP/s")


# the SSD chunk block's cases (tag, Bt, nc, Q, nh, hd, N, head_offset,
# head_win); the first is one layer of the Mamba2-130M prefill (8 x 32768
# tokens, chunk 256), timed
SSD = [
    ("Mamba2 prefill layer", 8, 128, 256, 24, 64, 128, None, 0),
    ("hymba's shape", 2, 4, 128, 50, 64, 16, None, 0),
    ("reduced shape", 2, 4, 32, 16, 32, 16, None, 0),
    ("Q = 15", 2, 2, 15, 16, 32, 16, None, 0),
    ("Q = 100", 2, 2, 100, 24, 64, 128, None, 0),
    ("head window (5, 7)", 2, 4, 256, 24, 64, 128, 5, 7),
    ("head window (0, 24)", 2, 4, 256, 24, 64, 128, 0, 24),
    ("head window (16, 8)", 2, 4, 256, 24, 64, 128, 16, 8),
    ("ragged head groups (5, 53)", 2, 4, 256, 64, 64, 128, 5, 53),
]


def ssd_inputs(dev, g, Bt, nc, Q, nh, hd, N):
    """x, dt, A, B, C as the model makes them: dt a softplus, A negative."""
    F = torch.nn.functional
    return (0.5 * torch.randn((Bt, nc, Q, nh, hd), device=dev, generator=g),
            F.softplus(torch.randn((Bt, nc, Q, nh), device=dev, generator=g)),
            -torch.exp(0.3 * torch.randn((nh,), device=dev, generator=g)),
            0.5 * torch.randn((Bt, nc, Q, N), device=dev, generator=g),
            0.5 * torch.randn((Bt, nc, Q, N), device=dev, generator=g))


def ssd_kernels(dev, g):
    """TPU row 12: the SSD chunk kernel against its plain version (the
    Pallas body transcribed) at each case, y and states within MM_RTOL of
    their largest magnitude, and against the sequential oracle on a few
    chunks; timed at one Mamba2 prefill layer beside its bound at the 3xTF32
    rate, a second launch there bit-equal to the first (no single PyTorch
    call computes the block, so there is no library time)."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_intra
    row = None
    for tag, Bt, nc, Q, nh, hd, N, off, win in SSD:
        args = ssd_inputs(dev, g, Bt, nc, Q, nh, hd, N)
        x, dt, A, B, C = args
        hs = slice(off or 0, (off or 0) + (win or nh))
        kern = lambda: ssd_chunk_intra(*args, head_offset=off,   # noqa: E731
                                       head_win=win)
        plain = lambda: ref.ssd_chunk_intra_ref(  # noqa: E731
            x[..., hs, :], dt[..., hs], A[hs], B, C)
        (y, s), (yr, sr) = kern(), plain()
        e = max(err(y, yr), err(s, sr), key=lambda t: t[1])
        check(y.shape == yr.shape and s.shape == sr.shape and e[1] <= MM_RTOL,
              f"ssd_chunk_intra {tag}: shapes {tuple(y.shape)} "
              f"{tuple(s.shape)}, error {e}")
        print(f"[kernels] ssd {tag:22s} x {[Bt, nc, Q, nh, hd]} N {N} heads "
              f"[{hs.start}, {hs.stop}): max abs err {e[0]:.3g} (rel "
              f"{e[1]:.3g})")
        if row is None:
            from repro_torch.kernels.ssd_chunk import cost
            b_ms, b_by = bound_ms(*cost(Bt, nc, Q, win or nh, hd, N))
            del yr, sr
            y2, s2 = kern()
            check(bits_equal(y, y2) and bits_equal(s, s2),
                  f"ssd_chunk_intra {tag}: two launches differ")
            del y, s, y2, s2
            k_ms = cuda_ms(kern)
            row = dict(
                name="ssd_chunk_intra", route="cuda",
                source=SRC + "ssd_chunk.cu",
                replaces=TPU + "ssd_chunk.py:58", tpu_row=12,
                shape={"x": [Bt, nc, Q, nh, hd], "B": [Bt, nc, Q, N]},
                max_abs_err=e[0], max_rel_err=e[1], tolerance=MM_RTOL,
                ms=k_ms, kernel_ms=k_ms, plain_ms=cuda_ms(plain, iters=3,
                                                          warmup=1),
                library_ms=None, library_calls=0, bound_ms=b_ms,
                bound_by=b_by,
                bound_rate="3xTF32: the data's 2*multiply-adds at 495/3 "
                           "TFLOP/s")
        del args, x, dt, A, B, C
    # chunk by chunk against the recurrence from a zero state
    x, dt, A, B, C = ssd_inputs(dev, g, 1, 3, 64, 4, 32, 16)
    y, s = ssd_chunk_intra(x, dt, A, B, C)
    for c in range(3):
        yo, so = ref.ssd_chunk_ref(x[0, c], dt[0, c], A, B[0, c], C[0, c])
        e = max(err(y[0, c], yo), err(s[0, c], so), key=lambda t: t[1])
        check(e[1] <= MM_RTOL, f"ssd_chunk_intra vs the recurrence: {e}")
    print(f"[kernels] ssd against the sequential oracle on 3 chunks of 64: "
          f"within {MM_RTOL} of max|oracle|")
    return [row]


# -- phase 3 ------------------------------------------------------------------


def phase_small_agreement(dev):
    """Two reduced window rounds on the card against the same rounds on
    the CPU."""
    from repro_torch import api
    from repro_torch.checkpoint.checkpoint import load
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg)
    scfg = scfg_for("rolling")
    p_cpu = model.init(0, device="cpu")
    p_gpu = {k: v.to(dev, copy=True) for k, v in p_cpu.items()}
    batches = lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0)
    batch = next(batches)
    ckpt = CKPT_DIR / "reduced.npz"
    outs = {}
    for where, params in (("cpu", p_cpu), ("card", p_gpu)):
        fed = api.fed_round(model, scfg, device=params["embed"].device)
        cbs = [api.checkpoint_callback(str(ckpt))] if where == "card" else []
        trainer = api.Trainer(fed, params, callbacks=cbs)
        trainer.run(iter([batch, batch]), 2)
        outs[where] = (trainer.history, trainer.params)
    (h_c, p_c), (h_g, p_g) = outs["cpu"], outs["card"]
    dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max().item()
             for a, b in zip(h_g, h_c))
    dp = max((p_g[k].cpu() - p_c[k]).abs().max().item() for k in p_c)
    check(dl <= ROUND_TOL and dp <= ROUND_TOL,
          f"reduced round on the card disagrees with the CPU: loss {dl}, "
          f"params {dp}")
    print(f"[agree] reduced 2-round card vs CPU: max |d loss| {dl:.3g}, "
          f"max |d param| {dp:.3g} (tolerance {ROUND_TOL})")

    loaded, meta = load(str(ckpt), device=dev)
    same = set(loaded) == set(p_g) and all(
        bits_equal(loaded[k], p_g[k]) for k in p_g)
    check(same and meta["round"] == 2 and len(meta["history"]) == 2,
          f"checkpoint round trip: bit-exact {same}, metadata {meta}")
    print(f"[agree] checkpoint_callback -> load: {len(p_g)} leaves bit-exact "
          f"on the card, metadata round {meta['round']}")

    # one model's eval through the flash kernel, card vs CPU (plain)
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (4,), 128, seed=999))
                             ["tokens"], dtype=torch.long)
    window = {("d_ff", cfg.d_ff): (37, cfg.d_ff // 2),
              ("kv_heads", cfg.n_kv_heads): (1, cfg.n_kv_heads // 2),
              ("heads", cfg.n_heads): (2, cfg.n_heads // 2)}
    for tag, win in (("server", None), ("window", window)):
        got, want = (eval_loss(model, p, tokens.to(p["embed"].device), win,
                               flash=True)
                     for p in (p_g, p_c))
        d = abs(got - want)
        check(d <= ROUND_TOL, f"reduced flash eval ({tag}) card {got} vs "
              f"CPU {want}")
        print(f"[agree] reduced flash eval ({tag}) card {got:.6f} vs CPU "
              f"{want:.6f}: |d| {d:.3g} (tolerance {ROUND_TOL})")


def phase_small_agreement_mask(dev):
    """Two reduced mask rounds on the card against the same rounds on the
    CPU, with the masks drawn on the CPU and copied: Bernoulli masks, and
    structured rolling masks at per-client capacities."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core.fedavg import dense_client_masks
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg)
    cpu = torch.device("cpu")
    batch = next(lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0))
    for scheme, caps in (("bernoulli", [0.5] * 4), ("rolling", HETERO)):
        scfg = scfg_for(scheme)
        masks = [dense_client_masks(torch.Generator().manual_seed(r),
                                    model.abstract_params(), model.axes(),
                                    scfg, caps, r, cpu) for r in range(2)]
        p_cpu = model.init(0, device="cpu")
        p_gpu = {k: v.to(dev, copy=True) for k, v in p_cpu.items()}
        outs = {}
        for where, params in (("cpu", p_cpu), ("card", p_gpu)):
            fed = api.fed_round(model, scfg, mode="mask", capacities=caps,
                                device=params["embed"].device)
            trainer = api.Trainer(fed, params)
            trainer.run(((batch, {"masks": m}) for m in masks), 2)
            outs[where] = (trainer.history, trainer.params)
        (h_c, p_c), (h_g, p_g) = outs["cpu"], outs["card"]
        dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max()
                 .item() for a, b in zip(h_g, h_c))
        dp = max((p_g[k].cpu() - p_c[k]).abs().max().item() for k in p_c)
        check(dl <= ROUND_TOL and dp <= ROUND_TOL,
              f"reduced {scheme} mask round on the card disagrees with the "
              f"CPU: loss {dl}, params {dp}")
        print(f"[agree] reduced 2-round {scheme} mask round (capacities "
              f"{caps}) card vs CPU: max |d loss| {dl:.3g}, max |d param| "
              f"{dp:.3g} (tolerance {ROUND_TOL})")


def phase_small_agreement_ssm(dev):
    """Reduced Mamba2 serving on the card against the CPU from the same
    params: prefill 2 x 64 tokens and 4 greedy decode steps
    (``serve.generate``), logits within ROUND_TOL of their largest
    magnitude at every step and the same tokens; and one model's loss."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = get_reduced_config("mamba2_130m")
    model = build_model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_gpu = {k: v.to(dev, copy=True) for k, v in p_cpu.items()}
    prompts = torch.as_tensor(sample_prompts(cfg, 2, 64, seed=0)[0],
                              dtype=torch.long)
    got = generate(model, p_gpu, prompts.to(dev), 4, return_logits=True)
    want = generate(model, p_cpu, prompts, 4, return_logits=True)
    e = max((err(a.cpu(), b) for a, b in zip(got["logits"], want["logits"])),
            key=lambda t: t[1])
    same = torch.equal(got["tokens"].cpu(), want["tokens"])
    check(e[1] <= ROUND_TOL and same, f"reduced Mamba2 serving card vs CPU: "
          f"logits {e}, tokens equal {same}")
    print(f"[agree] reduced Mamba2 prefill 2x64 + 4 greedy steps card vs "
          f"CPU: logits max abs diff {e[0]:.3g} (rel {e[1]:.3g}, tolerance "
          f"{ROUND_TOL}), tokens equal")
    toks = prompts[:, :64]
    losses = [eval_loss(model, p, toks.to(p["embed"].device))
              for p in (p_gpu, p_cpu)]
    d = abs(losses[0] - losses[1])
    check(d <= ROUND_TOL, f"reduced Mamba2 loss card {losses[0]} vs CPU "
          f"{losses[1]}")
    print(f"[agree] reduced Mamba2 loss card {losses[0]:.6f} vs CPU "
          f"{losses[1]:.6f}: |d| {d:.3g} (tolerance {ROUND_TOL})")


# -- phase 4 ------------------------------------------------------------------


#: path tag -> launches by body of the kernels with several (rows 1-8's
#: bf16 arm: ``"<name>/bf16 <body>"``), counted with the path's launches
BODY_LAUNCHES = {}


def record_bodies(tag, _build, add=False):
    """Keep (``add``: add to) the body counts of path ``tag``'s run and
    print them."""
    got = BODY_LAUNCHES.setdefault(tag, {}) if add else {}
    for k, n in _build.BODIES.items():
        got[k] = got.get(k, 0) + n
    BODY_LAUNCHES[tag] = got
    if got:
        print(f"[{tag}] launches by body {got}")


#: each run_rounds path's peak memory allocated (bytes), by its tag: the
#: readings phase_plan holds the plans against
PEAKS = {}


def run_rounds(tag, trainer, data, _build, clients=4, after=None):
    """``len(data)`` rounds, each timed to a synchronize, with the kernel
    launches counted from 0 and the peak memory from a reset; checks what
    comes out (``clients`` clients a round) and returns ``(launches,
    seconds per round after the first)`` (a single round: its own).
    ``after(i)`` runs after round i, outside the timing."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    secs = []
    for i, item in enumerate(data):
        t0 = time.perf_counter()
        trainer.run(iter([item]), 1)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if after is not None:
            after(i)
    launches = dict(_build.LAUNCHES)
    record_bodies(tag, _build)
    peak = torch.cuda.max_memory_allocated()
    PEAKS[tag] = peak
    losses = trainer.losses
    client = [h["client_loss"].cpu().tolist() for h in trainer.history]
    print(f"[{tag}] round losses {losses}")
    print(f"[{tag}] client losses [K, C] per round {client}")
    later = secs[1:] or secs
    print(f"[{tag}] seconds per round {secs}; after the first "
          f"{float(np.mean(later)):.3f} s")
    print(f"[{tag}] peak memory allocated {peak / 2**30:.2f} GiB")
    print(f"[{tag}] kernel launches {launches}")
    check(all(math.isfinite(v) for v in losses), f"{tag} losses {losses}")
    check(all(h["client_loss"].shape == (2, clients)
              for h in trainer.history),
          f"{tag} client_loss is not [K=2, C={clients}]")
    bad = [k for k, v in trainer.params.items()
           if not torch.isfinite(v).all()]
    check(not bad, f"{tag} non-finite params {bad[:5]}")
    return launches, float(np.mean(later))


def full_width(dev, param_dtype=torch.float32):
    """Full-width TinyLlama-1.1B with ``param_dtype`` params, and 3
    batches of the window path's shape."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_config("tinyllama_1_1b")
    batches = lm_batches(cfg.vocab, (2, 4, 2), seq=256)
    return cfg, build_model(cfg, param_dtype=param_dtype), [
        next(batches) for _ in range(3)]


def phase_main_path(dev, _build):
    from repro_torch import api
    cfg, model, data = full_width(dev)
    params = model.init(seed=0, device=dev)
    fed = api.fed_round(model, scfg_for("rolling"), device=dev)
    trainer = api.Trainer(fed, params)
    n_params = sum(v.numel() for v in params.values())
    windows = {f"{k[0]}/{k[1]}": w for k, w in fed.scheme.sizes.items()}
    print(f"[main] {cfg.name}: {cfg.n_layers} layers, {n_params:,} params, "
          f"f32; windows {windows}")
    launches, round_s = run_rounds("main", trainer, data, _build)
    # what the extract path is held against, kept on the host
    fused = {"params": {k: v.cpu() for k, v in trainer.params.items()},
             "losses": trainer.losses,
             "offsets": [fed.scheme.offsets(r, 4) for r in range(len(data))]}
    return launches, trainer, data[0], round_s, fused


def phase_eval(dev, trainer, _build):
    """The eval path on the server params the window path's rounds left:
    four parts, each driven once with the launch counts set to 0 just
    before and read just after (the first run is also the warm-up), then
    timed 3 times to a synchronize, with the peak memory from a reset.
    Returns the launches of the whole path, summed over its parts."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg)
    params, fed = trainer.params, trainer.fed
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (EB,), ES, seed=999))
                             ["tokens"], dtype=torch.long).to(dev)
    # the window of the last round trained: a sub-model a client trained
    offs = fed.scheme.offsets(trainer.round_idx - 1,
                              fed.scfg.clients_per_round)
    window = {k: (offs[k][0], w) for k, w in fed.scheme.sizes.items()
              if w < k[1]}
    small = tokens[:2, :256]
    print(f"[eval] {cfg.name} server params after {trainer.round_idx} "
          f"window rounds; held-out batch {list(tokens.shape)} (seed 999); "
          f"sub-model window {window}")

    def grad_pass():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with flash_switch(False):
            loss, _ = model.loss(p, {"tokens": small}, window=window)
            grads = torch.autograd.grad(loss, list(p.values()))
        g = dict(zip(p, grads))["layers/0/mlp/w_gate"]
        o, w = window[("d_ff", cfg.d_ff)]
        outside = (torch.count_nonzero(g[:, :o])
                   + torch.count_nonzero(g[:, o + w:])).item()
        finite = all(bool(torch.isfinite(t).all()) for t in grads)
        return float(loss.detach()), outside, finite

    parts = [
        ("server, flash", lambda: eval_loss(model, params, tokens,
                                            flash=True)),
        ("server, blockwise", lambda: eval_loss(model, params, tokens)),
        ("sub-model, flash", lambda: eval_loss(model, params, tokens,
                                               window, flash=True)),
        ("sub-model, blockwise", lambda: eval_loss(model, params, tokens,
                                                   window)),
        ("sub-model grad 2x256", grad_pass),
    ]
    total, losses = {}, {}
    for tag, fn in parts:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated()
        loss = out[0] if isinstance(out, tuple) else out
        losses[tag] = loss
        check(math.isfinite(loss), f"eval {tag}: loss {loss}")
        print(f"[eval] {tag:22s} loss {loss:.6f}  {float(np.mean(secs)):.4f} "
              f"s (mean of 3 after a warm-up: {[round(t, 4) for t in secs]})"
              f"  peak {peak / 2**30:.2f} GiB  launches {launches}")
        if isinstance(out, tuple):
            check(out[1] == 0 and out[2], f"eval {tag}: {out[1]} nonzero "
                  f"w_gate grads outside the window, finite {out[2]}")
            print(f"[eval] {tag}: grads finite, w_gate grad exactly 0 "
                  "outside the d_ff window")
    for a, b in (("server, flash", "server, blockwise"),
                 ("sub-model, flash", "sub-model, blockwise")):
        rel = abs(losses[a] - losses[b]) / abs(losses[b])
        check(rel <= EVAL_RTOL, f"eval {a} {losses[a]} vs {b} {losses[b]}: "
              f"relative {rel:.3g}")
        print(f"[eval] {a} vs {b}: relative difference {rel:.3g} "
              f"(tolerance {EVAL_RTOL})")
    # the logits themselves, a finer check than the mean loss
    with torch.no_grad():
        with flash_switch(True):
            got = model.forward(params, tokens)[0]
        want = model.forward(params, tokens)[0]
    e = err(got, want)
    del got, want
    check(e[1] <= MM_RTOL, f"eval logits flash vs blockwise: {e}")
    print(f"[eval] server logits flash vs blockwise: max abs diff {e[0]:.3g} "
          f"(rel {e[1]:.3g}, tolerance {MM_RTOL})")
    print(f"[eval] kernel launches on the eval path {total}")
    for tag, fn in (parts[0], parts[2], parts[-1]):
        phase_profile_eval(tag, fn)
    return total


def phase_profile_eval(tag, fn):
    """One more run of an eval part under torch.profiler: device time by
    kernel group (the flash kernel's share) and the profiled wall time."""
    from torch.profiler import profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=profiled()) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    kern, groups = device_kernels(prof)
    if not kern:
        print(f"[profile eval] {tag}: the trace holds no device time: not "
              "measured")
        return
    total = sum(t for _, t, _ in kern)
    print(f"[profile eval] {tag}: device kernels {total:.1f} ms in "
          f"{sum(n for _, _, n in kern)} launches; profiled wall "
          f"{wall_ms:.1f} ms")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile eval] {tag}: {g:26s} {t:9.2f} ms "
              f"{100 * t / total:5.1f}%")


def phase_trainer_eval(trainer, data):
    """Two more window rounds through ``api.Trainer`` with ``eval_fn``
    (the held-out loss, blockwise attention), ``eval_every=1`` and
    ``log_every=1``, resuming at the trainer's round."""
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg)
    dev = trainer.fed.device
    batch = {"tokens": torch.as_tensor(
        next(lm_batches(cfg.vocab, (EB,), ES, seed=999))["tokens"],
        dtype=torch.long).to(dev)}
    lines = []
    t = api.Trainer(trainer.fed, trainer.params,
                    eval_fn=lambda p: {"eval": model.loss(p, batch)[0]},
                    eval_every=1, log_every=1, log_fn=lines.append,
                    start_round=trainer.round_idx)
    with flash_switch(False):
        t.run(iter(data[:2]), 2)
    for line in lines:
        print(f"[trainer] {line}")
    evals = [h.get("eval") for h in t.history]
    check(len(lines) == 2 and all(ln.startswith("round ") and " eval "
                                  in ln for ln in lines),
          f"trainer log lines {lines}")
    check(all(isinstance(e, float) and math.isfinite(e) for e in evals),
          f"trainer eval values {evals}")
    print(f"[trainer] history keys {sorted(t.history[-1])}; eval {evals}")


def phase_mask_path(dev, _build):
    """The mask round (Algorithm 1) at full width: ``api.fed_round`` picks
    mask mode for ``bernoulli`` by itself; every leaf's masked step runs
    twice per round (K = 2) and its fill-in once."""
    from repro_torch import api
    cfg, model, data = full_width(dev)
    params = model.init(seed=0, device=dev)
    fed = api.fed_round(model, scfg_for("bernoulli"), device=dev)
    check(isinstance(fed, api.MaskFedAvg),
          f"bernoulli resolved to {type(fed).__name__}, not MaskFedAvg")
    trainer = api.Trainer(fed, params, rng=0)
    print(f"[mask] {cfg.name}: {len(params)} leaves, bernoulli masks at "
          f"capacities {fed.capacities.tolist()}, Trainer(rng=0)")
    launches, round_s = run_rounds("mask", trainer, data, _build)
    leaves = len(params)
    want = {"masked_sgd_inplace": 2 * leaves * len(data),
            "fillin_agg_inplace": leaves * len(data)}
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"mask path launches {got}, expected {want}")
    return launches, trainer, data[0], round_s


def phase_client_phase_peaks(trainer, batch):
    """Peak memory and time of one client phase (K = 2 steps) of the mask
    round, as the round runs it (the model on ``w_c``) and in the literal
    form (the model on ``m * w_c``), from the same params and masks."""
    from repro_torch.core.fedavg import dense_client_masks
    fed = trainer.fed
    dev = fed.device
    batch = {k: torch.as_tensor(v).to(dev, dtype=torch.long)
             for k, v in batch.items()}
    masks = dense_client_masks(torch.Generator(dev).manual_seed(1),
                               fed.abstract, fed.axes, fed.scfg,
                               fed.capacities, 0, dev)
    for literal in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        w_c, losses = fed.client_phase(trainer.params, batch, masks,
                                       literal=literal)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(bool(torch.isfinite(losses).all()), "client phase losses")
        del w_c, losses
        form = "literal m * w_c" if literal else "on w_c, as the round runs"
        print(f"[mask] client phase ({form}): peak {peak / 2**30:.2f} GiB, "
              f"{secs:.3f} s")


SB, SS, SG = 8, 32768, 32    # Mamba2 serving: batch, prompt, greedy steps
# TinyLlama serving: 4 prompts of 1536, 128 greedy steps; the
# teacher-forced check decodes the last 512 of 2048 prompt tokens
DB, DS, DG, DT = 4, 1536, 128, 512
# The dense and hybrid teacher-forced checks (512 eager decode steps, each
# host-bound) run at 4 layers of the widths they check (cut: depth), the
# timed serving at the phase's own depth: at 22 and 16 layers the two
# checks took 25 s and 45 s of a script that must end in 1200 s
TF_LAYERS = 4


def tf_model(cfg, dev):
    """``cfg`` at TF_LAYERS layers, built and initialised from seed 0."""
    from repro_torch.models import build_model
    model = build_model(dataclasses.replace(cfg, n_layers=TF_LAYERS))
    return model, model.init(seed=0, device=dev)


def timed(fn, n):
    """``n`` calls of ``fn``, each timed to a synchronize; returns the
    seconds and the last result."""
    secs, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs, out


def teacher_forced(model, params, seq, split, extra=None):
    """Prefill ``seq[:, :split]`` (behind ``extra``'s patches, P of them),
    then feed ``seq[:, split:]`` through ``decode_step`` one token at a
    time, at positions ``P + i``; returns the last logits and the
    caches."""
    P = extra["patches"].shape[1] if extra else 0
    S = seq.shape[1]
    with torch.no_grad():
        logits, cache = model.prefill(params, seq[:, :split], extra,
                                      max_len=P + S)
        for pos in range(split, S):
            logits, cache = model.decode_step(params, seq[:, pos], cache,
                                              P + pos)
    return logits, cache


def phase_serve_ssm(dev, _build):
    """Full-width Mamba2-130M serving (random weights, seed 0, f32): 8
    BigramLM prompts of 32768 tokens, prefill and 32 greedy decode steps
    through ``serve.generate``.  The first run is counted (launches from 0,
    peak from a reset) and is the warm-up; two more are timed.  Then the
    kernel's chunk states against the recurrence: prefill 32512 tokens and
    decode the last 256, teacher-forced, against one prefill of all 32768.
    Returns the model, params and prompts for the eval and the profile, and
    the launches of the counted run."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = get_config("mamba2_130m")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    t0 = time.perf_counter()
    prompts = torch.as_tensor(sample_prompts(cfg, SB, SS, seed=0)[0],
                              dtype=torch.long).to(dev)
    print(f"[serve ssm] {cfg.name}: {cfg.n_layers} layers, "
          f"{sum(v.numel() for v in params.values()):,} params, f32; prompts "
          f"{list(prompts.shape)} (BigramLM, seed 0, drawn in "
          f"{time.perf_counter() - t0:.1f} s)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    first = generate(model, params, prompts, SG)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    runs = [generate(model, params, prompts, SG) for _ in range(2)]
    pre = [r["prefill_s"] for r in runs]
    dec = [1e3 * r["decode_s"] / SG for r in runs]
    print(f"[serve ssm] prefill {SB}x{SS}: {float(np.mean(pre)):.4f} s (mean "
          f"of 2 after a warm-up: {[round(t, 4) for t in pre]}; warm-up "
          f"{first['prefill_s']:.4f} s)")
    print(f"[serve ssm] decode: {float(np.mean(dec)):.3f} ms/token ({SG} "
          f"greedy steps, batch {SB}; runs {[round(t, 3) for t in dec]})")
    print(f"[serve ssm] peak memory allocated {peak / 2**30:.2f} GiB; "
          f"kernel launches {launches}")
    toks = first["tokens"]
    check(launches.get("ssd_chunk_intra") == cfg.n_layers,
          f"ssd_chunk_intra launched {launches.get('ssd_chunk_intra')} times "
          f"in one prefill of {cfg.n_layers} layers")
    check(toks.shape == (SB, SG) and int(toks.min()) >= 0
          and int(toks.max()) < cfg.vocab, f"generated tokens {toks.shape}")
    same = all(torch.equal(r["tokens"], toks) for r in runs)
    print(f"[serve ssm] generations equal across the 3 runs: {same}; first "
          f"row {toks[0, :12].tolist()}")

    with torch.no_grad():
        want, full = model.prefill(params, prompts)
    split = SS - cfg.ssm.chunk
    got, cache = teacher_forced(model, params, prompts, split)
    e = err(got, want)
    eh = [err(cache[f"ssm_layers/{i}/h"], full[f"ssm_layers/{i}/h"])
          for i in range(cfg.n_layers)]
    worst = max(eh, key=lambda t: t[1])
    check(bool(torch.isfinite(want).all()), "prefill logits not finite")
    check(e[1] <= MM_RTOL and eh[0][1] <= MM_RTOL
          and worst[1] <= DEPTH_RTOL,
          f"prefill {split} + {SS - split} decode steps vs prefill {SS}: "
          f"logits {e}, state h per layer {eh}")
    print(f"[serve ssm] prefill {split} + {SS - split} teacher-forced decode "
          f"steps vs prefill {SS}: logits max abs diff {e[0]:.3g} (rel "
          f"{e[1]:.3g}, tolerance {MM_RTOL}); state h rel by layer "
          f"{[float(f'{r:.3g}') for _, r in eh]} (layer 0 within {MM_RTOL}, "
          f"all within {DEPTH_RTOL})")
    e0 = layer_states_vs_recurrence(model, params, prompts, split)
    check(e0[1] <= MM_RTOL, f"layer 0's chunk states vs the recurrence on "
          f"the same input: {e0}")
    print(f"[serve ssm] layer 0 on the prefill's own input: chunked SSD over "
          f"{SS} vs chunked {split} + {SS - split} recurrent steps: state h "
          f"max abs diff {e0[0]:.3g} (rel {e0[1]:.3g}, tolerance {MM_RTOL})")
    return model, params, prompts, launches, float(np.mean(pre))


def layer_states_vs_recurrence(model, params, prompts, split):
    """Layer 0's mixer on one input, the embedded and normed prompts: the
    state of one chunked pass over all of them (the kernel's chunk states
    and the inter-chunk loop) against a chunked pass over ``split`` tokens
    followed by one recurrent step per token.  Returns ``err``."""
    from repro_torch.models import ssm
    from repro_torch.models.layers import rms_norm_plain
    cfg = model.cfg
    pre = "ssm_layers/0/ssm/"
    p = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
    p1 = {k: v[None] for k, v in p.items()}        # one model: C = 1 views
    with torch.no_grad():
        u = rms_norm_plain(torch.nn.functional.embedding(prompts,
                                                         params["embed"]),
                           params["ssm_layers/0/ln1"], cfg.norm_eps)[None]
        _, whole = ssm.ssm_train(p1, u, cfg, return_state=True, kernel=True)
        _, cache = ssm.ssm_train(p1, u[:, :, :split], cfg, return_state=True,
                                 kernel=True)
        cache = {k: v[0] for k, v in cache.items()}
        for t in range(split, u.shape[2]):
            _, cache = ssm.ssm_decode(p, u[0, :, t:t + 1], cfg, cache, t)
    return err(cache["h"], whole["h"][0])


def phase_eval_ssm(dev, model, params, _build):
    """Mamba2-130M's loss (``Model.loss`` under no_grad) on 4 x 2048
    held-out tokens: counted once (the warm-up), then timed 3 times."""
    from repro_torch.data.synthetic import lm_batches
    tokens = torch.as_tensor(next(lm_batches(model.cfg.vocab, (EB,), ES,
                                             seed=999))["tokens"],
                             dtype=torch.long).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    loss = eval_loss(model, params, tokens)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    secs, again = timed(lambda: eval_loss(model, params, tokens), 3)
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(loss) and math.isfinite(again),
          f"eval ssm loss {loss}, {again}")
    check(launches.get("ssd_chunk_intra") == model.cfg.n_layers,
          f"eval ssm launches {launches}")
    print(f"[eval ssm] {model.cfg.name} loss on {EB}x{ES} held-out tokens "
          f"(seed 999) {loss:.6f} (timed runs: {again:.6f})  "
          f"{float(np.mean(secs)):.4f} s (mean of 3 "
          f"after a warm-up: {[round(t, 4) for t in secs]})  peak "
          f"{peak / 2**30:.2f} GiB  launches {launches}")


def phase_profile_serve_ssm(model, params, prompts, prefill_s):
    """One Mamba2 prefill under torch.profiler (``profile_prefill``), then
    one decode step."""
    if not profile_prefill("profile serve ssm", model, params, prompts,
                           prefill_s):
        return
    with torch.no_grad():
        logits, cache = model.prefill(params, prompts[:, :256], max_len=257)
    tok = torch.argmax(logits, -1)
    profile_decode_step("serve ssm", lambda: model.decode_step(
        params, tok, cache, 256))


def profile_prefill(tag, model, params, prompts, prefill_s):
    """One prefill under torch.profiler: device time by kernel group, the
    inter-chunk loop's device and host time (its profiler range), the
    device time's share of an unprofiled prefill, the ten longest kernels.
    Returns ``device_kernels``' list (empty where the trace holds no
    device time)."""
    from repro_torch.analysis.trace import Trace
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_chunk import RECURRENCE
    SB, SS = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof, \
            torch.no_grad():
        model.prefill(params, prompts)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    # the range shows up on the device too, as an annotation: not a kernel
    trace = Trace(prof)
    kern, groups = trace.device(skip=(RECURRENCE,))
    if not kern:
        print(f"[{tag}] the trace holds no device time: not "
              "measured")
        return []
    total = sum(t for _, t, _ in kern)
    print(f"[{tag}] one prefill {SB}x{SS}: device kernels "
          f"{total:.1f} ms in {sum(n for _, _, n in kern)} launches = "
          f"{100 * total / (1e3 * prefill_s):.1f}% of an unprofiled prefill "
          f"({1e3 * prefill_s:.1f} ms); profiled wall {wall_ms:.1f} ms")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[{tag}] {g:26s} {t:9.2f} ms "
              f"{100 * t / total:5.1f}%")
    if trace.calls(RECURRENCE):
        dev_ms = sum(kernel_groups(o for r in trace.roots(
            lambda n, _: n == RECURRENCE) for o in trace.tree(r)).values())
        print(f"[{tag}] inter-chunk loop ({RECURRENCE}, "
              f"{trace.calls(RECURRENCE)} ranges): its kernels {dev_ms:.2f} "
              f"ms on the device = {100 * dev_ms / total:.1f}%; "
              f"{trace.host_ms(RECURRENCE):.2f} ms on the host, waits on "
              "the full launch queue included")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:10]:
        print(f"[{tag}]   {t:9.2f} ms x{n:<5d} {name[:100]}")
    return kern


def profile_decode_step(tag, fn):
    """One decode step: its unprofiled wall time (mean of 3 after a
    warm-up) against the device time and launches of one more step under
    torch.profiler."""
    from torch.profiler import profile
    fn()
    secs, _ = timed(fn, 3)
    with profile(activities=profiled()) as prof:
        fn()
        torch.cuda.synchronize()
    kern, groups = device_kernels(prof)
    if not kern:
        print(f"[profile {tag}] decode step: the trace holds no device "
              "time: not measured")
        return
    total = sum(t for _, t, _ in kern)
    wall = 1e3 * float(np.mean(secs))
    print(f"[profile {tag}] one decode step: device kernels {total:.3f} ms "
          f"in {sum(n for _, _, n in kern)} launches = "
          f"{100 * total / wall:.1f}% of an unprofiled step ({wall:.3f} ms); "
          + ", ".join(f"{g} {t:.3f} ms" for g, t in
                      sorted(groups.items(), key=lambda kv: -kv[1])))


def phase_serve_dense(dev, _build):
    """Full-width TinyLlama-1.1B serving: 4 prompts of 1536 tokens, 128
    greedy steps.  A short warm-up, two timed prefills, then the
    generation timed with the peak from a reset; then, at TF_LAYERS of the
    22 layers, prefill 1536 of 2048 prompt tokens + the other 512
    teacher-forced against one prefill of all 2048 (its context)."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    seq = torch.as_tensor(sample_prompts(cfg, DB, DS + DT, seed=0)[0],
                          dtype=torch.long).to(dev)
    prompts = seq[:, :DS]
    generate(model, params, prompts, 8)
    with torch.no_grad():
        pre, (logits, cache) = timed(lambda: model.prefill(
            params, prompts, max_len=DS + DG), 2)
    tok = torch.argmax(logits, -1)
    profile_decode_step("serve dense", lambda: model.decode_step(
        params, tok, cache, DS))
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out = generate(model, params, prompts, DG)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"[serve dense] {cfg.name}: prefill {DB}x{DS}: "
          f"{float(np.mean(pre)):.4f} s (mean of 2 after a warm-up: "
          f"{[round(t, 4) for t in pre]}; in the generation "
          f"{out['prefill_s']:.4f} s)")
    print(f"[serve dense] decode: {1e3 * out['decode_s'] / DG:.3f} ms/token "
          f"({DG} greedy steps, batch {DB}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches}")
    del model, params
    model, params = tf_model(cfg, dev)
    with torch.no_grad():
        want, _ = model.prefill(params, seq)
    got, _ = teacher_forced(model, params, seq, DS)
    e = err(got, want)
    check(bool(torch.isfinite(want).all()) and e[1] <= MM_RTOL,
          f"dense prefill {DS} + {DT} decode steps vs prefill {DS + DT}: {e}")
    print(f"[serve dense] prefill {DS} + {DT} teacher-forced decode steps vs "
          f"prefill {DS + DT} at {TF_LAYERS} of {cfg.n_layers} layers (cut: "
          f"depth): logits max abs diff {e[0]:.3g} (rel {e[1]:.3g}, "
          f"tolerance {MM_RTOL})")


# -- phase 3, the extract round and the paper's protocol ----------------------


def phase_small_agreement_extract(dev):
    """Two reduced rounds of the extract client phase (``fused_forward=
    "off"``, rolling) and two of scheme ``full`` (every client on a full
    replica, no windowed axis) on the card against the same rounds on the
    CPU, from the same params, tokens and offsets."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg)
    batch = next(lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0))
    for scheme, ff in (("rolling", "off"), ("full", "auto")):
        p_cpu = model.init(0, device="cpu")
        p_gpu = {k: v.to(dev, copy=True) for k, v in p_cpu.items()}
        outs = {}
        for where, params in (("cpu", p_cpu), ("card", p_gpu)):
            fed = api.fed_round(model, scfg_for(scheme), fused_forward=ff,
                                device=params["embed"].device)
            check(not fed.use_fused, f"{scheme} resolved to the fused phase")
            offsets = [fed.scheme.offsets(r, 4) for r in range(2)]
            trainer = api.Trainer(fed, params)
            trainer.run(((batch, {"offsets": o}) for o in offsets), 2)
            outs[where] = (trainer.history, trainer.params)
        (h_c, p_c), (h_g, p_g) = outs["cpu"], outs["card"]
        dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max()
                 .item() for a, b in zip(h_g, h_c))
        dp = max((p_g[k].cpu() - p_c[k]).abs().max().item() for k in p_c)
        check(dl <= ROUND_TOL and dp <= ROUND_TOL,
              f"reduced {scheme} extract round on the card disagrees with "
              f"the CPU: loss {dl}, params {dp}")
        print(f"[agree] reduced 2-round extract round ({scheme}, "
              f"fused_forward={ff!r}) card vs CPU: max |d loss| {dl:.3g}, "
              f"max |d param| {dp:.3g} (tolerance {ROUND_TOL})")


def _inject_cpu_masks(exp, scheme):
    """Wrap ``exp``'s batch iterator so that each round carries masks drawn
    on the CPU (a generator seeded by the round) at the round's
    capacities."""
    from repro_torch.core.fedavg import dense_client_masks
    fed = exp.make_fed(scheme)
    orig = exp._round_batches

    def wrapped(scheme, uniform_cap):
        for r, (batch, kw) in enumerate(orig(scheme, uniform_cap)):
            masks = dense_client_masks(
                torch.Generator().manual_seed(r), fed.abstract, fed.axes,
                fed.scfg, kw["capacities"], r, torch.device("cpu"))
            yield batch, {**kw, "masks": masks}

    exp._round_batches = wrapped


def phase_small_agreement_paper(dev):
    """A reduced ``PaperExperiment`` (ResNet-8ish, 6 clients, 3 taking part)
    on the card against the CPU from the same params: 2 rounds each of
    ``rolling`` and ``random`` with the masks drawn on the CPU and copied,
    and ``static`` as it runs; curves (train loss, test loss, accuracy)
    and the generalization gap."""
    from repro_torch.core.paper_protocol import PaperExperiment
    kw = dict(n_clients=6, participate=3, n_train=240, n_test=48, mb=4)
    params, axes = PaperExperiment(**kw, device="cpu").init_params()
    for scheme in ("rolling", "random", "static"):
        res = {}
        for where in ("cpu", dev):
            exp = PaperExperiment(**kw, device=where)
            exp.init_params = lambda where=where: (
                {k: v.to(where, copy=True) for k, v in params.items()}, axes)
            if scheme != "static":
                _inject_cpu_masks(exp, scheme)
            res[str(where)] = exp.run(scheme, rounds=2, eval_every=1)
        a, b = res[str(dev)], res["cpu"]
        d = max([abs(x[k] - y[k]) for x, y in zip(a["curve"], b["curve"])
                 for k in ("train_loss", "test_loss", "test_acc")]
                + [abs(a["gap"][k] - b["gap"][k]) for k in b["gap"]])
        check(d <= ROUND_TOL and len(a["curve"]) == 2,
              f"reduced paper protocol ({scheme}) card vs CPU: {d}")
        print(f"[agree] reduced PaperExperiment {scheme} 2 rounds card vs "
              f"CPU: max |d| over curves and gap {d:.3g} (tolerance "
              f"{ROUND_TOL}); test loss {a['final']['test_loss']:.5f}")


# -- phase 4d: the extract path ------------------------------------------------

# the extract round against the fused round from the same params, tokens
# and offsets after 3 rounds: the fused round's products run the 3xTF32
# hand kernels (rows 5-8), the extract round's cuBLAS f32, so each param
# differs by their rounding, carried through 6 SGD steps at lr 0.1
EXTRACT_TOL = 1e-4


# the leaves whose windows the fused forward reads in place through the
# windowed-product kernels (rows 5-8): the fused client phase must allocate
# no stacked compact copy of them.  (The gradients of the wo and w_down
# window views are compact-shaped in both phases, as the reference's
# dynamic_slice VJP makes them, so those shapes witness nothing.)
PINNED = ("mlp/w_gate", "mlp/w_up", "attn/wq", "attn/wk", "attn/wv")


def compact_shapes(fed, C):
    """``{shape: leaf names}`` of the stacked compact copy ``[C, *sub
    shape]`` of every leaf the round's window narrows (names without the
    layer prefix)."""
    from repro_torch.core.extract import sub_abstract
    out = {}
    for k, s in sub_abstract(fed.abstract, fed.axes,
                             fed.scheme.sizes).items():
        if s != fed.abstract[k]:
            out.setdefault((C, *s), set()).add(k.split("/", 2)[-1])
    return out


def allocation_shapes(fn):
    """Run ``fn()`` and return ``(result, {shape: count})`` of the tensors
    its operators allocate (outputs that share no storage with an input:
    views and in-place results are left out)."""
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def ptrs(tree):
        return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)
                if isinstance(t, torch.Tensor)}

    class Allocations(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            seen = ptrs((args, kwargs))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor) and \
                        t.untyped_storage().data_ptr() not in seen:
                    self.shapes[tuple(t.shape)] += 1
            return out

    with Allocations() as mode:
        result = fn()
    return result, mode.shapes


def phase_wsub_pin(dev, model, params, batch, offsets, scfg=None,
                   tag="wsub"):
    """"No per-client W_sub copy": the fused client phase allocates no
    tensor shaped like a stacked compact leaf (``[C, 2048, 2816]`` for
    ``w_gate``, ``[C, 2048, 16, 64]`` for ``wq``, ...), while the extract
    phase allocates them; both from the same params, batch and offsets
    (one shared window, or with ``scfg`` one window per client, or a
    hetero bucket's configuration and clients)."""
    from repro_torch import api
    scfg = scfg or scfg_for("rolling")
    nc = scfg.clients_per_round
    batch = {k: torch.as_tensor(v).to(dev, torch.long)
             for k, v in batch.items()}
    found = {}
    for ff in ("on", "off"):
        fed = api.fed_round(model, scfg, fused_forward=ff, device=dev)
        compact = compact_shapes(fed, nc)
        pinned = {s for s, names in compact.items() if names <= set(PINNED)}
        other = {(nc, *s) for s in fed.abstract.values()} | \
            (set(compact) - pinned)
        check(pinned and not pinned & other, f"stacked compact shapes "
              f"{sorted(pinned & other)} are also other tensors' shapes: "
              "the pin could not witness a copy")
        phase = fed._client_phase_fused if ff == "on" else fed._client_phase
        out, shapes = allocation_shapes(lambda: phase(params, batch,
                                                      offsets))
        del out
        found[ff] = {"/".join(sorted(compact[s])): n
                     for s, n in shapes.items() if s in pinned}
        seen = {"/".join(sorted(compact[s])): n for s, n in shapes.items()
                if s in compact and s not in pinned}
        print(f"[{tag}] {'fused' if ff == 'on' else 'extract'} client phase: "
              f"{sum(shapes.values())} allocations; stacked compact copies "
              f"of {PINNED}: {found[ff]}; other compact-shaped tensors "
              f"(window rows of w_down/wo and their gradients in the fused "
              f"phase): {seen}")
    check(not found["on"], f"the fused client phase allocated stacked "
          f"compact leaves: {found['on']}")
    check(any("w_gate" in k for k in found["off"]) and
          any("wq" in k for k in found["off"]),
          f"the extract client phase allocated no compact w_gate or wq "
          f"({found['off']}): the detector sees nothing")


def phase_extract_path(dev, _build, fused):
    """The extract round (``fused_forward="off"``) in the window path's
    configuration, 3 rounds from its initial params (seed 0) and its
    offsets, held against the fused path's params and losses after its 3
    rounds (``fused``, kept on the host); the "no W_sub copy" pin; then
    scheme ``full`` (the FedAvg baseline, every client on a full replica),
    2 rounds.  Returns the launches of both."""
    from repro_torch import api
    cfg, model, data = full_width(dev)
    fed = api.fed_round(model, scfg_for("rolling"), fused_forward="off",
                        device=dev)
    check(not fed.use_fused, "fused_forward='off' took the fused phase")
    offsets = [fed.scheme.offsets(r, 4) for r in range(len(data))]
    check(offsets == fused["offsets"], f"the extract round's offsets "
          f"{offsets} are not the window path's {fused['offsets']}")
    params = model.init(seed=0, device=dev)
    trainer = api.Trainer(fed, params)
    print(f"[extract] {cfg.name}: fused_forward='off', windows "
          f"{ {f'{k[0]}/{k[1]}': w for k, w in fed.scheme.sizes.items()} }")
    launches, round_s = run_rounds(
        "extract", trainer, [(b, {"offsets": o}) for b, o in
                             zip(data, offsets)], _build)
    leaves = len(params)
    per_round = launches.get("sgd_inplace", 0) / len(data)
    check(per_round == 2 * leaves, f"extract path: {per_round} sgd_inplace "
          f"launches a round, expected {2 * leaves}")
    print(f"[extract] row 10 (sgd_inplace) launches a round {per_round:.0f} "
          f"({leaves} leaves x K = 2), seconds per round after the first "
          f"{round_s:.3f}")
    dl = max(abs(a - b) for a, b in zip(trainer.losses, fused["losses"]))
    dp = max((trainer.params[k].cpu() - v).abs().max().item()
             for k, v in fused["params"].items())
    check(dl <= EXTRACT_TOL and dp <= EXTRACT_TOL,
          f"extract vs fused path after {len(data)} rounds: loss {dl}, "
          f"params {dp} (tolerance {EXTRACT_TOL})")
    print(f"[extract] vs the fused path after {len(data)} rounds: max |d "
          f"loss| {dl:.3g}, max |d param| {dp:.3g} (tolerance {EXTRACT_TOL}: "
          "3xTF32 hand kernels vs cuBLAS f32)")
    phase_profile("extract", trainer, (data[0], {"offsets": offsets[0]}),
                  round_s)
    phase_wsub_pin(dev, model, trainer.params, data[0],
                   {k: v for k, v in offsets[0].items()})
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()

    fed = api.fed_round(model, scfg_for("full"), device=dev)
    check(not fed.use_fused and fed.scheme.sizes == {},
          "scheme full windowed an axis")
    trainer = api.Trainer(fed, model.init(seed=0, device=dev))
    print(f"[full] {cfg.name}: scheme 'full' (FedAvg, every client on a full "
          "replica; the first round warms up)")
    f_launches, _ = run_rounds("full", trainer, data[:2], _build)
    check(f_launches.get("sgd_inplace", 0) == 2 * 2 * leaves,
          f"full path launches {f_launches}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    return launches, f_launches


# -- this slice: per-client windows, client and server optimizers, the uplink

ADAM_LR, ADAM_B1, ADAM_B2, ADAM_EPS = 0.1, 0.9, 0.99, 1e-6
CLI = ["--arch", "tinyllama_1_1b", "--stagger", "--client-opt", "momentum",
       "--server-opt", "adam", "--uplink-compression", "bf16", "--clients",
       "4", "--local-steps", "2", "--mb", "2", "--seq", "256", "--rounds",
       "3", "--log-every", "1"]


def stagger_scfg():
    return dataclasses.replace(scfg_for("rolling"), stagger=True)


def _to(tree, dev):
    """A copy of a params dict or a server state on ``dev``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=True)
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree


def _injected(fed, mode, rounds):
    """Each round's offsets or masks, drawn on the CPU."""
    from repro_torch.core.fedavg import dense_client_masks
    if mode == "mask":
        return [{"masks": dense_client_masks(
            torch.Generator().manual_seed(r), fed.abstract, fed.axes,
            fed.scfg, fed.capacities, r, torch.device("cpu"))}
            for r in range(rounds)]
    if fed.scfg.scheme == "importance":
        return [{} for _ in range(rounds)]   # read off each round's params
    return [{"offsets": fed._client_offsets(r)} for r in range(rounds)]


def _max_diff(a, b):
    """The largest ``|a - b|`` of an element, leaf by leaf on ``a``'s
    device (``b`` may lie on the host: each leaf is copied over, not the
    whole of ``a`` to the host)."""
    return max((a[k] - b[k].to(a[k].device)).abs().max().item() for k in b)


def phase_small_agreement_opt(dev):
    """This slice's configurations, reduced, on the card against the CPU
    from the same params and the same injected offsets or masks (drawn on
    the CPU; importance offsets read off each device's own params).  The
    SGD-type ones run 2 chained rounds within ROUND_TOL.  Server Adam and
    the bf16 uplink are step functions of the mean delta near eps and near
    bfloat16 rounding midpoints, so each of their 2 rounds runs on both
    from the CPU's params and server state before it, and is held per
    coordinate: Adam within ``ROUND_TOL + 2 lr dd / (sqrt(v_hat) + eps)``
    with ``dd`` the two mean deltas' difference (read back from the first
    moment, itself within ROUND_TOL), the uplink within ``ROUND_TOL +
    server_lr 2^-7 max_c |d_c|`` (one bfloat16 ulp of the largest client
    change, from the CPU's client phase)."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core.trainer import _to_device
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg)
    batch = next(lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0))
    p0 = model.init(0, device="cpu")
    stag, roll = dict(stagger=True), {}
    chained = [
        ("staggered rolling, fused", "window", stag, {}),
        ("staggered rolling, extract", "window", stag,
         dict(fused_forward="off")),
        ("random (CPU-drawn offsets)", "window", dict(scheme="random"), {}),
        ("importance, shared", "window", dict(scheme="importance"), {}),
        ("importance, staggered", "window",
         dict(scheme="importance", stagger=True), {}),
        ("client momentum", "window", roll, dict(client_opt="momentum")),
        ("client proximal", "window", roll, dict(client_opt="proximal")),
        ("server sgd", "window", roll, dict(server_opt="sgd")),
        ("server momentum, staggered", "window", stag,
         dict(server_opt="momentum")),
    ]
    for tag, mode, over, kw in chained:
        scfg = dataclasses.replace(scfg_for("rolling"), **over)
        outs = {}
        for where in ("cpu", dev):
            fed = api.fed_round(model, scfg, mode=mode, device=where, **kw)
            trainer = api.Trainer(fed, _to(p0, where))
            trainer.run(((batch, i) for i in _injected(fed, mode, 2)), 2)
            outs[str(where)] = trainer
        g, c = outs[str(dev)], outs["cpu"]
        dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max()
                 .item() for a, b in zip(g.history, c.history))
        dp = _max_diff(g.params, c.params)
        check(dl <= ROUND_TOL and dp <= ROUND_TOL,
              f"reduced {tag} on the card disagrees with the CPU: loss "
              f"{dl}, params {dp}")
        print(f"[agree] reduced 2-round {tag} card vs CPU: max |d loss| "
              f"{dl:.3g}, max |d param| {dp:.3g} (tolerance {ROUND_TOL})")

    per_round = [
        ("server adam", "window", roll, dict(server_opt="adam")),
        ("mask round, client momentum + server adam", "mask",
         dict(scheme="bernoulli"),
         dict(client_opt="momentum", server_opt="adam")),
        ("bf16 uplink, staggered", "window", stag,
         dict(uplink_compression="bf16")),
    ]
    for tag, mode, over, kw in per_round:
        scfg = dataclasses.replace(scfg_for("rolling"), **over)
        feds = {str(w): api.fed_round(model, scfg, mode=mode, device=w, **kw)
                for w in ("cpu", dev)}
        fc, fg = feds["cpu"], feds[str(dev)]
        injected = _injected(fc, mode, 2)
        params = _to(p0, "cpu")
        state = fc.server_opt.init(params) if fc.server_opt else None
        worst = 0.0
        for r, inj in enumerate(injected):
            b_c = {k: _to_device(v, "cpu") for k, v in batch.items()}
            b_g = {k: _to_device(v, dev) for k, v in batch.items()}
            before, s_before = _to(params, "cpu"), _to(state, "cpu")
            if fc.server_opt is None:
                offs = inj["offsets"]
                full_k, _ = fc._client_phase_fused(before, b_c, offs)
                bound = {k: ROUND_TOL + scfg.server_lr * 2.0 ** -7
                         * (full_k[k] - before[k][None]).abs().amax(0)
                         for k in before}
                del full_k
                pg, mg = fg.round(_to(before, dev), b_g, r, **inj)
                params, mc = fc.round(params, b_c, r, **inj)
            else:
                pg, sg, mg = fg.round_with_server_opt(
                    _to(before, dev), _to(s_before, dev), b_g, r, **inj)
                params, state, mc = fc.round_with_server_opt(
                    params, state, b_c, r, **inj)
                bound = {}
                for k in params:
                    dd = ((sg["m"][k].cpu() - state["m"][k]).abs()
                          / (1 - ADAM_B1))
                    check(dd.max().item() <= ROUND_TOL,
                          f"{tag} round {r}: mean delta {k} card vs CPU "
                          f"{dd.max().item()}")
                    v_hat = state["v"][k] / (1 - ADAM_B2 ** (r + 1))
                    bound[k] = ROUND_TOL + 2 * ADAM_LR * dd / (
                        torch.sqrt(v_hat) + ADAM_EPS)
            dl = (mg["client_loss"].cpu() - mc["client_loss"]).abs().max()
            check(dl.item() <= ROUND_TOL, f"{tag} round {r}: losses {dl}")
            for k in params:
                over_b = (pg[k].cpu() - params[k]).abs() - bound[k]
                check(over_b.max().item() <= 0, f"{tag} round {r}: {k} "
                      f"beyond its bound by {over_b.max().item()}")
            worst = max(worst, _max_diff(pg, params))
        print(f"[agree] reduced {tag}, 2 rounds each from the CPU's params"
              f"{' and state' if fc.server_opt else ''}, card vs CPU: max "
              f"|d param| {worst:.3g}, every coordinate within its bound "
              f"({'Adam' if fc.server_opt else 'bf16'} step function)")


def phase_stagger_path(dev, _build):
    """This slice's path at full width: staggered rolling windows (each
    client its own window of every axis), client momentum, server Adam and
    the bf16 uplink, 3 rounds through ``api.fed_round`` and
    ``api.Trainer``; the per-client offsets; one profiled round; the "no
    W_sub copy" pin for per-client windows; then the same configuration
    through the training CLI, as a subprocess.  Returns the launches."""
    from repro_torch import api
    cfg, model, data = full_width(dev)
    params = model.init(seed=0, device=dev)
    fed = api.fed_round(model, stagger_scfg(), client_opt="momentum",
                        server_opt="adam", uplink_compression="bf16",
                        device=dev)
    check(fed.use_fused and not fed.shared_window,
          "the staggered round is not the per-client fused round")
    offsets = [fed._client_offsets(r) for r in range(len(data))]
    d_ff = offsets[0][("d_ff", cfg.d_ff)]
    R = fed.scheme.n_windows
    check(len(set(d_ff)) == min(R, 4) > 1 and
          all(len(set(o[("d_ff", cfg.d_ff)])) > 1 for o in offsets),
          f"the clients' d_ff offsets {d_ff} are not the staggered order "
          f"over the grid's {R} windows")
    print(f"[stagger] {cfg.name}: staggered rolling, client momentum, "
          f"server adam, bf16 uplink; windows "
          f"{ {f'{k[0]}/{k[1]}': w for k, w in fed.scheme.sizes.items()} }"
          f"; the grid has {R} windows a axis, so the 4 clients take "
          f"{len(set(d_ff))} distinct d_ff offsets a round: "
          f"{[o[('d_ff', cfg.d_ff)] for o in offsets]}")
    trainer = api.Trainer(fed, params)
    launches, round_s = run_rounds("stagger", trainer, data, _build)
    n = len(data)
    want = _window_launches(cfg, len(params), n)
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"stagger path launches {got}, expected {want}")
    check(trainer.opt_state["t"] == n, "server Adam's step count")
    print(f"[stagger] rows 5-8 and 10 a round: "
          f"{ {k: v // n for k, v in got.items()} }")
    phase_profile("stagger", trainer, (data[0], {}), round_s)
    phase_wsub_pin(dev, model, trainer.params, data[0], offsets[0],
                   scfg=stagger_scfg(), tag="wsub stagger")
    del trainer, params, fed
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_cli()
    return launches


#: the mesh round through the CLI: a world of one NCCL rank, psum
MESH_CLI = [*CLI, "--mesh", "1", "--mesh-agg", "psum", "--rounds", "2"]


def phase_train_cli():
    """``python -m repro_torch.launch.train`` with the stagger path's
    configuration, as a subprocess on the card, then the same with the
    mesh round (``MESH_CLI``: ``--mesh 1 --mesh-agg psum``, 2 rounds):
    their JSON losses finite."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    for tag, argv, what in (("train cli", CLI, "3 rounds"),
                            ("mesh cli", MESH_CLI, "a world of one NCCL "
                             "rank, 2 psum rounds")):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m",
                               "repro_torch.launch.train", *argv],
                              capture_output=True, text=True, env=env,
                              cwd=str(ROOT), timeout=600)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f"the training CLI failed "
              f"({proc.returncode}): {proc.stderr[-2000:]}")
        lines = proc.stdout.strip().splitlines()
        out = json.loads(lines[-1])
        check(set(out) == {"first_loss", "last_loss"} and
              all(math.isfinite(v) for v in out.values()),
              f"the training CLI printed {out}")
        for line in lines:
            print(f"[{tag}] {line}")
        print(f"[{tag}] python -m repro_torch.launch.train {' '.join(argv)}"
              f": {secs:.1f} s in all (process start, kernel load, init, "
              f"{what}); finite losses")


MASK_OPT_LAYERS = 11      # client momentum at 11 of 22 layers: see PERF.md


def phase_mask_opt_path(dev, _build):
    """The mask round with the optimizers: (a) full width, server Adam on
    the masked mean delta (``round_with_server_opt``), client SGD, 3
    rounds; client momentum does not fit beside it at full width, so (b)
    client momentum on the plain round (the masked steps, then the
    fill-in) and (c) client momentum with server Adam run at
    ``MASK_OPT_LAYERS`` layers, 2 rounds each.  Returns the launches of
    all three."""
    import collections

    from repro_torch import api
    from repro_torch.models import build_model
    cfg, model, data = full_width(dev)
    total = collections.Counter()
    parts = [("mask opt", model, dict(server_opt="adam"), data),
             (f"mask opt {MASK_OPT_LAYERS}L momentum",
              build_model(dataclasses.replace(cfg,
                                              n_layers=MASK_OPT_LAYERS)),
              dict(client_opt="momentum"), data[:2]),
             (f"mask opt {MASK_OPT_LAYERS}L momentum+adam",
              build_model(dataclasses.replace(cfg,
                                              n_layers=MASK_OPT_LAYERS)),
              dict(client_opt="momentum", server_opt="adam"), data[:2])]
    for tag, m, kw, part in parts:
        params = m.init(seed=0, device=dev)
        fed = api.fed_round(m, scfg_for("bernoulli"), device=dev, **kw)
        check(isinstance(fed, api.MaskFedAvg), f"{tag}: not the mask round")
        trainer = api.Trainer(fed, params, rng=0)
        print(f"[{tag}] {m.cfg.n_layers} layers, {len(params)} leaves, "
              f"{kw}")
        launches, _ = run_rounds(tag, trainer, part, _build)
        leaves, n = len(params), len(part)
        want = {"masked_sgd_inplace": 2 * leaves * n,
                "fillin_agg_inplace": 0 if fed.server_opt else leaves * n}
        got = {k: launches.get(k, 0) for k in want}
        check(got == want, f"{tag} launches {got}, expected {want}")
        total.update(launches)
        del trainer, params, fed
        gc.collect()
        torch.cuda.empty_cache()
    return dict(total)


# -- this slice: heterogeneous capacities and the asynchronous fleet -----------

AGREE_CAPS = (1.0, 0.5, 0.5, 0.25)
FLEET_CLI = ["--arch", "tinyllama_1_1b", "--async-buffer", "2", "--fleet",
             "8", "--straggler-frac", "0.25", "--clients", "4",
             "--local-steps", "2", "--mb", "2", "--seq", "256", "--rounds",
             "3", "--log-every", "1"]
ASYNC_KEYS = {"first_loss", "last_loss", "virtual_time", "rounds_per_vsec",
              "mean_staleness"}


def phase_small_agreement_hetero(dev):
    """This slice's configurations, reduced, on the card against the CPU
    from the same params, offsets (drawn on the CPU) and batches: 2 hetero
    rounds at capacities ``AGREE_CAPS`` through the fused and the extract
    buckets, 2 with server ``sgd``, and an ``AsyncTrainer`` regime (a fleet
    of 8, N = 4 in flight, M = 2, a quarter of it 10x slower, lognormal
    jitter 0.5, 4 aggregations) whose virtual times and staleness must be
    equal and whose params agree within ROUND_TOL."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg)
    batch = next(lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0))
    p0 = model.init(0, device="cpu")
    for tag, kw in (("hetero, fused buckets", {}),
                    ("hetero, extract buckets", dict(fused_forward="off")),
                    ("hetero, server sgd", dict(server_opt="sgd"))):
        outs = {}
        for where in ("cpu", dev):
            fed = api.fed_round(model, scfg_for("rolling"), device=where,
                                capacities=AGREE_CAPS, **kw)
            check(fed.hetero is not None and
                  [b.fed.use_fused for b in fed.hetero] ==
                  [False] + [kw.get("fused_forward") != "off"] * 2,
                  f"{tag}: buckets {fed.hetero}")
            trainer = api.Trainer(fed, _to(p0, where))
            trainer.run(((batch, {"offsets": fed._client_offsets(r)})
                         for r in range(2)), 2)
            outs[str(where)] = trainer
        g, c = outs[str(dev)], outs["cpu"]
        dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max()
                 .item() for a, b in zip(g.history, c.history))
        dp = _max_diff(g.params, c.params)
        check(dl <= ROUND_TOL and dp <= ROUND_TOL,
              f"reduced {tag} on the card disagrees with the CPU: loss "
              f"{dl}, params {dp}")
        print(f"[agree] reduced 2-round {tag} (capacities {AGREE_CAPS}) "
              f"card vs CPU: max |d loss| {dl:.3g}, max |d param| {dp:.3g} "
              f"(tolerance {ROUND_TOL})")

    outs = {}
    for where in ("cpu", dev):
        fed = api.fed_round(model, scfg_for("rolling"), device=where)
        at = api.AsyncTrainer(
            fed, _to(p0, where), buffer_size=2,
            fleet=api.FleetSimulator(8, api.LatencyModel(
                straggler_frac=0.25, jitter_sigma=0.5, seed=0)))
        at.run(lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0), 4)
        outs[str(where)] = at
    g, c = outs[str(dev)], outs["cpu"]
    sched = [(h["virtual_time"], h["staleness"]) for h in g.history]
    check(sched == [(h["virtual_time"], h["staleness"]) for h in c.history],
          f"async virtual times and staleness differ: card {sched}")
    dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max().item()
             for a, b in zip(g.history, c.history))
    dp = _max_diff(g.params, c.params)
    check(dl <= ROUND_TOL and dp <= ROUND_TOL,
          f"reduced async regime on the card disagrees with the CPU: loss "
          f"{dl}, params {dp}")
    print(f"[agree] reduced AsyncTrainer (fleet 8, N = 4, M = 2, stragglers "
          f"0.25 x 10, jitter 0.5), 4 aggregations card vs CPU: (virtual "
          f"time, staleness) equal {sched}; max |d loss| {dl:.3g}, max |d "
          f"param| {dp:.3g} (tolerance {ROUND_TOL})")


def _hetero_launches(cfg, leaves, buckets, n):
    """Rows 5-8 and 10's launches over ``n`` hetero rounds: every fused
    bucket (capacity < 1) runs the windowed products, 3 (q, k, v) and 1
    (gate/up) forward and dx a layer a step, whatever its client count;
    every bucket steps its clients' leaves K = 2 times through row 10."""
    fused = sum(b.fed.use_fused for b in buckets)
    return {"rolling_mm_fwd<1>": 3 * cfg.n_layers * 2 * fused * n,
            "rolling_mm_dx<1>": 3 * cfg.n_layers * 2 * fused * n,
            "rolling_mm_fwd<2>": cfg.n_layers * 2 * fused * n,
            "rolling_mm_dx<2>": cfg.n_layers * 2 * fused * n,
            "sgd_inplace": 2 * leaves * len(buckets) * n}


def phase_hetero_path(dev, _build):
    """Heterogeneous capacities at full width: the window path's
    configuration with ``capacities=HETERO`` (one client a bucket: a full
    replica on the extract phase, and fused buckets at 0.5, 0.25 and 0.125
    of d_ff / kv_heads), 3 rounds through ``api.fed_round`` and
    ``api.Trainer``; the buckets' windows, seconds per round, peak, rows
    5-8 and 10's launches a round, one profiled round, and the "no W_sub
    copy" pin on the narrowest fused bucket.  Returns the launches."""
    from repro_torch import api
    cfg, model, data = full_width(dev)
    params = model.init(seed=0, device=dev)
    fed = api.fed_round(model, scfg_for("rolling"), capacities=HETERO,
                        device=dev)
    check([(b.beta, b.idx) for b in fed.hetero] ==
          [(c, (i,)) for i, c in enumerate(HETERO)],
          f"hetero buckets {[(b.beta, b.idx) for b in fed.hetero]}")
    for b in fed.hetero:
        print(f"[hetero] bucket {b.beta}: lanes {list(b.idx)}, "
              f"{'fused' if b.fed.use_fused else 'extract'} phase, windows "
              f"{ {f'{k[0]}/{k[1]}': w for k, w in b.fed.scheme.sizes.items()} }")
    offsets = [fed._client_offsets(r) for r in range(len(data))]
    print(f"[hetero] union offsets a round {offsets}")
    trainer = api.Trainer(fed, params)
    launches, round_s = run_rounds("hetero", trainer, data, _build)
    n = len(data)
    want = _hetero_launches(cfg, len(params), fed.hetero, n)
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"hetero path launches {got}, expected {want}")
    print(f"[hetero] rows 5-8 and 10 a round: "
          f"{ {k: v // n for k, v in got.items()} }")
    phase_profile("hetero", trainer, (data[0], {}), round_s)
    b = fed.hetero[-1]
    lanes = list(b.idx)
    phase_wsub_pin(dev, model, trainer.params,
                   {k: v[:, lanes] for k, v in data[0].items()},
                   b.fed._client_offsets(0), scfg=b.fed.scfg,
                   tag="wsub hetero")
    del trainer, params, fed
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_fleet_path(dev, _build):
    """The asynchronous fleet at full width, from the same initial params
    (seed 0) and batches: (a) the M = N anchor, 3 rounds of
    ``AsyncTrainer(buffer_size=None)`` against 3 of ``api.Trainer``, params
    and losses bit-equal on the card; (b) an async regime (a fleet of 16,
    a quarter 10x slower, lognormal jitter 0.5; N = 4 in flight, M = 2,
    ``inverse_sqrt`` staleness, 6 aggregations) with its launches counted,
    host seconds per aggregation, virtual time, mean staleness, the
    aggregations that took the per-client arm and the peak; (c) the hetero
    fleet (``capacities=HETERO``, ``FleetSimulator(capacities=)``), M = N,
    2 rounds, within 1e-5 of the largest magnitude of each param of the
    sync hetero rounds; (d) the training CLI with ``--async-buffer 2
    --fleet 8 --straggler-frac 0.25`` as a subprocess.  Returns (b)'s
    launches."""
    from repro_torch import api
    from repro_torch.data.synthetic import lm_batches
    cfg, model, data = full_width(dev)
    scfg = scfg_for("rolling")

    # (a) the anchor
    fed = api.fed_round(model, scfg, device=dev)
    sync = api.Trainer(fed, model.init(seed=0, device=dev))
    sync.run(iter(data), len(data))
    at = api.AsyncTrainer(fed, model.init(seed=0, device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at.run(iter(data), len(data))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    same = all(bits_equal(at.params[k], sync.params[k]) for k in sync.params)
    same_loss = all(bits_equal(a["client_loss"], b["client_loss"])
                    for a, b in zip(at.history, sync.history))
    check(at._fused and same and same_loss,
          f"[fleet] M = N anchor: params bit-equal {same}, losses "
          f"{same_loss}, fused {at._fused}")
    print(f"[fleet] (a) M = N anchor, {len(data)} rounds: AsyncTrainer "
          f"(zero-spread fleet of 4, M = N = 4) == Trainer bit for bit, "
          f"params and client losses; async {secs:.3f} s in all; losses "
          f"{at.losses}")
    del sync, at
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the async regime
    fleet = api.FleetSimulator(16, api.LatencyModel(
        straggler_frac=0.25, straggler_mult=10, jitter_sigma=0.5, seed=0))
    at = api.AsyncTrainer(fed, model.init(seed=0, device=dev),
                          buffer_size=2, fleet=fleet,
                          staleness="inverse_sqrt")
    stream = lm_batches(cfg.vocab, (2, 4, 2), seq=256, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    at.run(stream, 6)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    h = at.history
    stale = float(np.mean([r["staleness"] for r in h]))
    check(len(h) == 6 and all(math.isfinite(v) for v in at.losses) and
          all(torch.isfinite(v).all() for v in at.params.values()),
          f"[fleet] async regime: losses {at.losses}")
    check(stale > 0, "[fleet] async regime saw no staleness")
    check(all(launches.get(k, 0) > 0 for k in (
        "rolling_mm_fwd<1>", "rolling_mm_dx<1>", "rolling_mm_fwd<2>",
        "rolling_mm_dx<2>", "sgd_inplace")),
        f"[fleet] async regime launches {launches}")
    print(f"[fleet] (b) async regime: fleet 16 (stragglers "
          f"{sorted(fleet.stragglers)} x 10, jitter 0.5), N = 4, M = 2, "
          f"inverse_sqrt, 6 aggregations from {at._seq} dispatched clients: "
          f"{secs / 6:.3f} host s per aggregation; virtual time "
          f"{h[-1]['virtual_time']:.4f}; mean staleness {stale:.4f} "
          f"(per aggregation {[r['staleness'] for r in h]}); "
          f"{at.scatter_aggregations} of 6 aggregations on the per-client "
          f"arm (mixed windows); peak {peak / 2**30:.2f} GiB; losses "
          f"{at.losses}")
    print(f"[fleet] (b) kernel launches {launches}")
    del at
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the hetero fleet against the sync hetero rounds
    fed = api.fed_round(model, scfg, capacities=HETERO, device=dev)
    sync = api.Trainer(fed, model.init(seed=0, device=dev))
    sync.run(iter(data[:2]), 2)
    at = api.AsyncTrainer(fed, model.init(seed=0, device=dev),
                          fleet=api.FleetSimulator(4, capacities=HETERO))
    at.run(iter(data[:2]), 2)
    rel = max(((at.params[k] - v).abs().max()
               / v.abs().max().clamp_min(1e-30)).item()
              for k, v in sync.params.items())
    dl = max(abs(a - b) for a, b in zip(at.losses, sync.losses))
    check(at._fused and rel <= 1e-5 and dl <= ROUND_TOL,
          f"[fleet] hetero anchor: params rel {rel}, losses {dl}")
    print(f"[fleet] (c) hetero fleet (capacities {HETERO}, the fleet's "
          f"rank-paired), M = N, 2 rounds vs the sync hetero rounds: max "
          f"|d param| / max|param| {rel:.3g} (tolerance 1e-5: arrival-order "
          f"sums), max |d loss| {dl:.3g}")
    del sync, at, fed
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the CLI
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *FLEET_CLI], capture_output=True, text=True,
                          env=env, cwd=str(ROOT), timeout=600)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"the async training CLI failed "
          f"({proc.returncode}): {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    check(set(out) == ASYNC_KEYS and math.isfinite(out["first_loss"]) and
          math.isfinite(out["last_loss"]),
          f"the async training CLI printed {out}")
    for line in lines:
        print(f"[fleet cli] {line}")
    print(f"[fleet cli] python -m repro_torch.launch.train "
          f"{' '.join(FLEET_CLI)}: {secs:.1f} s in all; finite losses, the "
          "async record")
    return launches


# -- the mesh round (A12): the clients split over torch.distributed ranks ------

MESH_LAYERS = 4           # (b): TinyLlama-1.1B's widths at 4 of 22 layers
MESH_TF = (256, 16)       # (b): prefill, then teacher-forced decode steps
MESH_ROWS = ("rolling_mm_fwd<1>", "rolling_mm_dx<1>", "rolling_mm_fwd<2>",
             "rolling_mm_dx<2>", "sgd_inplace")


def _copy(params):
    return {k: v.clone() for k, v in params.items()}


def _bits(params):
    """A fingerprint of params that a changed bit moves: each leaf's f32
    bit patterns summed as integers."""
    return [int(v.detach().contiguous().view(torch.int32)
                .sum(dtype=torch.int64)) for v in params.values()]


def _rel_err(got, want):
    """The largest ``|got - want|`` over params (dicts) or tensors, over
    the largest ``|want|``, and whether they are equal bit for bit."""
    if isinstance(want, dict):
        d = max((got[k] - want[k]).abs().max().item() for k in want)
        top = max(want[k].abs().max().item() for k in want)
        same = all(torch.equal(got[k], want[k]) for k in want)
    else:
        d = (got - want).abs().max().item()
        top = want.abs().max().item()
        same = torch.equal(got, want)
    return d / max(top, 1e-30), same


def _window_launches(cfg, leaves, n):
    """Rows 5-8 and 10's launches over n fused rounds of the window
    configuration (K = 2, q/k/v and the gate/up pair windowed), whatever
    the clients (one launch takes them all)."""
    return {"rolling_mm_fwd<1>": 3 * cfg.n_layers * 2 * n,
            "rolling_mm_dx<1>": 3 * cfg.n_layers * 2 * n,
            "rolling_mm_fwd<2>": cfg.n_layers * 2 * n,
            "rolling_mm_dx<2>": cfg.n_layers * 2 * n,
            "sgd_inplace": 2 * leaves * n}


def phase_mesh(dev, _build):
    """The mesh round (``api.fed_round(mesh=)``) on the card.  (a) A world
    of one NCCL rank in this process, full-width TinyLlama-1.1B in the
    window path's configuration from the same params, batches and offsets:
    3 single-process rounds, 3 gather rounds (params and client losses
    bit-equal to them) and 3 psum rounds (the first round's losses
    bit-equal, its params within 1e-5); seconds a round (rounds 2-3), peak
    and rows 5-8 and 10's launches of each arm.  (b) Two local gloo ranks
    on the one card (``launch.mesh.spawn``: NCCL takes one rank a device),
    at MESH_LAYERS layers: ``_mesh_card_rank``.  Returns the launches of
    (a)'s gather and psum arms and of (b)'s ranks."""
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.launch.mesh import host_mesh, init_world, spawn
    cfg, model, data = full_width(dev)
    p0 = model.init(seed=0, device=dev)
    scfg = scfg_for("rolling")
    gib = sum(v.numel() * v.element_size() for v in p0.values()) / 2**30

    trainer = api.Trainer(api.fed_round(model, scfg, device=dev), _copy(p0))
    first = {}

    def keep_first(i):
        if i == 0:
            first.update(params=_copy(trainer.params),
                         losses=trainer.history[0]["client_loss"].clone())
    none_launches, none_s = run_rounds("mesh none", trainer, data, _build,
                                       after=keep_first)
    none = dict(params=trainer.params,
                losses=[h["client_loss"] for h in trainer.history])
    del trainer
    end = init_world("cuda")
    check(end is not None and dist.get_backend() == "nccl" and
          dist.get_world_size() == 1, "a world of one NCCL rank")
    launches = {}
    try:
        mesh = host_mesh("1")
        for agg in ("gather", "psum"):
            fed = api.fed_round(model, scfg, mesh=mesh, mesh_agg=agg,
                                device=dev)
            trainer = api.Trainer(fed, _copy(p0))
            errs = {}

            def after(i):
                if i == 0 and agg == "psum":
                    errs["losses"] = _rel_err(
                        trainer.history[0]["client_loss"], first["losses"])
                    errs["params"] = _max_diff(trainer.params,
                                               first["params"])
            launches[agg], round_s = run_rounds(f"mesh {agg}", trainer, data,
                                                _build, after=after)
            print(f"[mesh {agg}] NCCL world of 1, full width, 22 layers: "
                  f"{round_s:.3f} s a round after the first (single-"
                  f"process {none_s:.3f}); peak includes {3 * gib:.2f} GiB "
                  "of the phase's own copies (start, round 1, round 3 of "
                  "the single-process arm)")
            got = {k: launches[agg].get(k, 0) for k in MESH_ROWS}
            want = {k: none_launches.get(k, 0) for k in MESH_ROWS}
            check(got == want and all(got.values()),
                  f"mesh {agg} launches {got}, single-process {want}")
            if agg == "gather":
                err, same = _rel_err(trainer.params, none["params"])
                lsame = all(torch.equal(h["client_loss"], w) for h, w in
                            zip(trainer.history, none["losses"]))
                print(f"[mesh gather] vs single-process, 3 rounds: params "
                      f"bit-equal {same}, client losses bit-equal {lsame}")
                check(same and lsame, "the gather round is not the "
                      f"single-process round bit for bit (params {err})")
            else:
                (lerr, lsame), perr = errs["losses"], errs["params"]
                print(f"[mesh psum] round 1 vs single-process: client "
                      f"losses bit-equal {lsame}; params max |d| {perr:.3e}"
                      " (limit 1e-05)")
                check(lsame and perr <= 1e-5,
                      f"the psum round: losses {lerr}, params {perr}")
            del trainer, fed
    finally:
        end()
    del p0, first, none
    gc.collect()
    torch.cuda.empty_cache()

    # (b) two gloo ranks on the one card
    t0 = time.perf_counter()
    res = spawn(_mesh_card_rank, 2, [{k: np.asarray(v) for k, v in b.items()}
                                     for b in data])
    print(f"[mesh gloo] 2 ranks on one card (gloo), {MESH_LAYERS} of 22 "
          f"layers, {res['n_params']:,} params: {time.perf_counter() - t0:.1f}"
          " s in all (processes, kernel load, init, rounds, decode)")
    for tag, arm in res["arms"].items():
        print(f"[mesh gloo {tag}] seconds a round {arm['secs']}; peak a rank "
              f"{[round(p / 2**30, 2) for p in arm['peaks']]} GiB; vs the "
              f"single-process round: max |d| / max |want| params "
              f"{arm['err'][0]:.3e}, client losses {arm['lerr'][0]:.3e} "
              f"(limit 1e-4); bit-equal params {arm['err'][1]}, losses "
              f"{arm['lerr'][1]}; every rank the same params "
              f"{arm['same']}; launches by rank {arm['launches']}")
        check(arm["err"][0] <= 1e-4 and arm["lerr"][0] <= 1e-4 and
              arm["same"], f"mesh gloo {tag}: {arm['err']} {arm['lerr']}")
        for r, got in enumerate(arm["launches"]):
            got = {k: got.get(k, 0) for k in MESH_ROWS}
            check(got == arm["want"], f"mesh gloo {tag} rank {r} launches "
                  f"{got}, expected {arm['want']}")
    d = res["decode"]
    print(f"[mesh gloo decode] context-parallel (cache positions split over "
          f"the 2 ranks), prefill {MESH_TF[0]} + {MESH_TF[1]} teacher-forced"
          f" steps: max |d| / max |logit| {d['err'][0]:.3e} (limit 1e-4), "
          f"bit-equal {d['err'][1]}; {d['ms']:.2f} ms a step "
          f"(single-process {d['plain_ms']:.2f})")
    check(d["err"][0] <= 1e-4, f"mesh gloo decode {d['err']}")
    return (launches["gather"], launches["psum"],
            *(dict(x) for x in res["arms"]["gather"]["launches"]))


def _mesh_card_rank(batches):
    """One of phase_mesh (b)'s two gloo ranks on the card: full-width
    TinyLlama-1.1B at MESH_LAYERS layers from seed 0, the gather round (2
    rounds), the psum round (1) and a staggered gather round (1) on the
    window path's batches, timed a round, each rank's peak and launches,
    whether every rank ends with the same params; rank 0 then runs the same
    rounds without a mesh and holds the mesh rounds to them (params and
    client losses within 1e-4 of the largest magnitude; bit-equality
    reported); then context-parallel decode (each rank its half of the
    cache's positions) against rank 0's single-process decode.  Rank 0's
    summary is the result."""
    import torch.distributed as dist
    from repro_torch import api
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import host_mesh
    from repro_torch.launch.specs import cache_shard, sample_prompts
    from repro_torch.models import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    cfg = dataclasses.replace(get_config("tinyllama_1_1b"),
                              n_layers=MESH_LAYERS)
    model = build_model(cfg)
    p0 = model.init(seed=0, device=dev)
    mesh = host_mesh("2")
    arms = {"gather": (scfg_for("rolling"), "gather", 2),
            "psum": (scfg_for("rolling"), "psum", 1),
            "stagger gather": (stagger_scfg(), "gather", 1)}
    out, kept = {"n_params": sum(v.numel() for v in p0.values()),
                 "arms": {}}, {}
    for tag, (scfg, agg, n) in arms.items():
        fed = api.fed_round(model, scfg, mesh=mesh, mesh_agg=agg, device=dev)
        trainer = api.Trainer(fed, _copy(p0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        secs = []
        for b in batches[:n]:
            t0 = time.perf_counter()
            trainer.run(iter([b]), 1)
            torch.cuda.synchronize()
            secs.append(round(time.perf_counter() - t0, 4))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (_bits(trainer.params),
                                       torch.cuda.max_memory_allocated(),
                                       dict(_build.LAUNCHES)))
        kept[tag] = trainer
        out["arms"][tag] = dict(
            secs=secs, peaks=[e[1] for e in every],
            launches=[e[2] for e in every],
            same=all(e[0] == every[0][0] for e in every),
            want=_window_launches(cfg, len(p0), n))
    if rank == 0:
        for tag, (scfg, _, n) in arms.items():
            single = api.Trainer(api.fed_round(model, scfg, device=dev),
                                 _copy(p0))
            single.run(iter(batches[:n]), n)
            got = kept[tag]
            out["arms"][tag]["err"] = _rel_err(got.params, single.params)
            out["arms"][tag]["lerr"] = _rel_err(
                torch.stack([h["client_loss"] for h in got.history]),
                torch.stack([h["client_loss"] for h in single.history]))
            del single
    dist.barrier()
    del kept
    split, steps = MESH_TF
    tokens = torch.as_tensor(sample_prompts(cfg, 2, split + steps, seed=0)[0],
                             dtype=torch.long, device=dev)

    def decode(on_mesh):
        with torch.no_grad():
            _, caches = model.prefill(p0, tokens[:, :split],
                                      max_len=split + steps)
            if on_mesh:
                caches = cache_shard(caches, mesh)
            torch.cuda.synchronize()
            t0, logits = time.perf_counter(), []
            for pos in range(split, split + steps):
                lg, caches = model.decode_step(
                    p0, tokens[:, pos], caches, pos,
                    mesh=mesh if on_mesh else None, cp=on_mesh)
                logits.append(lg)
            torch.cuda.synchronize()
        return torch.stack(logits), (time.perf_counter() - t0) * 1e3 / steps

    cp, ms = decode(True)
    if rank == 0:
        plain, plain_ms = decode(False)
        out["decode"] = dict(err=_rel_err(cp, plain), ms=ms,
                             plain_ms=plain_ms)
    return out


# -- this slice: SSM training (Mamba2) and the hybrid block (Hymba) ------------

SSM_SEQ, HYB_SEQ = 1024, 256      # tokens a sequence; 2 sequences a step
# Hymba-1.5B's round, eval and serving keep 16 of its 32 layers (cut:
# depth): its host-bound eager steps would otherwise take the script past
# its time limit on a slow host
HYB_LAYERS = 16
# The full-width rounds' client step size.  At lr 0.1 these rounds amplify
# any rounding difference far past EXTRACT_TOL (3 fused rounds from params
# scaled by 1 + 1e-7 N(0, 1), about one ulp, end about 0.02 from the
# unscaled run), so no two arms that round differently (the fused rounds'
# 3xTF32 products, the extract rounds' cuBLAS f32) could be held within it.
# At 0.003 rounding stays under a twentieth of EXTRACT_TOL while the rounds
# move the params by about ten times it; the perturbed run is repeated in
# every run and printed, and tools/round_lr_probe.py runs other rates.
ROUND_LR, PERTURB = 0.003, 1e-7


def slice_scfg(**over):
    """The SSM and hybrid rounds' sub-model configuration: rolling at
    capacity 0.5 on the default axes (each family's own windowed axes),
    C = 4 clients, K = 2 steps, lr 0.1."""
    from repro_torch.configs.base import SubmodelConfig
    return SubmodelConfig(**{**dict(scheme="rolling", capacity=0.5,
                                    local_steps=2, clients_per_round=4,
                                    client_lr=0.1), **over})


def phase_small_agreement_slice(dev):
    """Reduced Mamba2 and reduced Hymba rounds on the card against the
    same rounds on the CPU, from the same params, tokens (2 x 64 a client
    step) and CPU-drawn offsets or masks, within ROUND_TOL: 3 fused rounds
    and 1 extract round of each; for Mamba2 also 1 Bernoulli mask round
    (rows 9 and 11) and 1 staggered-rolling round."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    window, mask = "window", "mask"
    cases = {
        "ssm": ("mamba2_130m", [
            ("fused", window, {}, {}, 3),
            ("extract", window, {}, dict(fused_forward="off"), 1),
            ("Bernoulli mask", mask, dict(scheme="bernoulli"), {}, 1),
            ("staggered rolling", window, dict(stagger=True), {}, 1)]),
        "hybrid": ("hymba_1_5b", [
            ("fused", window, {}, {}, 3),
            ("extract", window, {}, dict(fused_forward="off"), 1)])}
    for tag, (arch, runs) in cases.items():
        model = build_model(get_reduced_config(arch))
        it = lm_batches(model.cfg.vocab, (2, 4, 2), 64, seed=0)
        data = [next(it) for _ in range(3)]
        p0 = model.init(0, device="cpu")
        for name, mode, over, kw, n in runs:
            outs = {}
            for where in ("cpu", dev):
                fed = api.fed_round(model, slice_scfg(**over), mode=mode,
                                    device=where, **kw)
                check(isinstance(fed, api.MaskFedAvg) if mode == mask else
                      fed.use_fused == (name != "extract"),
                      f"[agree {tag}] {name} resolved to another phase")
                trainer = api.Trainer(fed, _to(p0, where))
                trainer.run(zip(data[:n], _injected(fed, mode, n)), n)
                outs[str(where)] = trainer
            g, c = outs[str(dev)], outs["cpu"]
            dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max()
                     .item() for a, b in zip(g.history, c.history))
            dp = _max_diff(g.params, c.params)
            check(dl <= ROUND_TOL and dp <= ROUND_TOL,
                  f"reduced {arch} {name} on the card disagrees with the "
                  f"CPU: loss {dl}, params {dp}")
            print(f"[agree {tag}] reduced {arch} {name}, {n} round(s) card "
                  f"vs CPU: max |d loss| {dl:.3g}, max |d param| {dp:.3g} "
                  f"(tolerance {ROUND_TOL})")


def _slice_launches(cfg, leaves, n, fused):
    """Rows 5-8 and 10's launches over ``n`` rounds (K = 2 steps each):
    the fused phase runs the windowed products forward and dx once a layer
    a step each (z, x and dt of every SSM mixer; q, k and v of every
    attention; the gate/up pair of every MLP); every step steps each leaf
    through row 10."""
    t1 = 3 * (cfg.ssm is not None) + 3 * (cfg.family != "ssm")
    t2 = int(cfg.family != "ssm")
    per = 2 * cfg.n_layers * n * int(fused)
    return {"rolling_mm_fwd<1>": t1 * per, "rolling_mm_dx<1>": t1 * per,
            "rolling_mm_fwd<2>": t2 * per, "rolling_mm_dx<2>": t2 * per,
            "sgd_inplace": 2 * leaves * n}


def phase_slice_rounds(dev, _build, tag, arch, seq, layers=None):
    """Full-width rounds of this slice's families: C = 4 clients x K = 2
    steps x 2 x ``seq`` tokens, rolling at capacity 0.5 on the default
    axes, client lr ROUND_LR, 3 fused rounds through ``api.fed_round`` and
    ``api.Trainer`` (seconds, peak, finite losses and params, rows 5-8 and
    10's launches against the layer arithmetic), one profiled round with
    the differentiable chunked SSD's share of it; the same 3 fused rounds
    from params scaled by (1 + PERTURB N(0, 1)), for the rounds' own
    sensitivity; then 3 extract rounds from the same params and offsets,
    every client step's loss and the params after the 3 rounds within
    EXTRACT_TOL of the fused ones, which moved the params by more than
    EXTRACT_TOL.  ``layers`` cuts the depth.  Returns the launches of
    both."""
    from repro_torch import api
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    from repro_torch.models.ssm import SSD_CHUNKED
    cfg = zoo_config(arch, layers)
    model = build_model(cfg)
    it = lm_batches(cfg.vocab, (2, 4, 2), seq=seq)
    data = [next(it) for _ in range(3)]
    scfg = slice_scfg(client_lr=ROUND_LR)
    fed = api.fed_round(model, scfg, device=dev)
    check(fed.use_fused, f"[{tag}] the default axes took the extract phase")
    offsets = [fed._client_offsets(r) for r in range(len(data))]
    items = [(b, {"offsets": o}) for b, o in zip(data, offsets)]
    params = model.init(seed=0, device=dev)
    p0 = {k: v.to("cpu", copy=True) for k, v in params.items()}
    leaves, n_params = len(params), sum(v.numel() for v in params.values())
    windows = {f"{k[0]}/{k[1]}": w for k, w in fed.scheme.sizes.items()}
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, {n_params:,} params "
          f"({leaves} leaves), f32; 4 clients x 2 steps x 2 x {seq} tokens, "
          f"client lr {ROUND_LR}; windows {windows}; offsets {offsets}")
    trainer = api.Trainer(fed, params)
    launches, round_s = run_rounds(tag, trainer, items, _build)
    want = _slice_launches(cfg, leaves, len(data), True)
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"[{tag}] launches {got}, expected {want}")
    print(f"[{tag}] rows 5-8 and 10 a round: "
          f"{ {k: v // len(data) for k, v in got.items()} }")
    fused = ({k: v.to("cpu", copy=True) for k, v in trainer.params.items()},
             _client_losses(trainer))
    moved = _max_diff(fused[0], p0)
    del p0
    phase_profile(tag, trainer, items[0], round_s, ranges=(SSD_CHUNKED,))
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()

    # the same fused rounds from params scaled by (1 + PERTURB N(0, 1))
    params = model.init(seed=0, device=dev)
    g = torch.Generator(dev).manual_seed(5)
    with torch.no_grad():
        for v in params.values():
            v.mul_(1 + PERTURB * torch.randn(v.shape, device=dev,
                                             generator=g))
    trainer = api.Trainer(fed, params)
    trainer.run(iter(items), len(items))
    l_pert = (_client_losses(trainer) - fused[1]).abs().max().item()
    d_pert = _max_diff(trainer.params, fused[0])
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()

    fed = api.fed_round(model, scfg, fused_forward="off", device=dev)
    check(not fed.use_fused, f"[{tag} extract] took the fused phase")
    trainer = api.Trainer(fed, model.init(seed=0, device=dev))
    x_launches, x_round_s = run_rounds(f"{tag} extract", trainer, items,
                                       _build)
    want = _slice_launches(cfg, leaves, len(data), False)
    got = {k: x_launches.get(k, 0) for k in want}
    check(got == want, f"[{tag} extract] launches {got}, expected {want}")
    dl = (_client_losses(trainer) - fused[1]).abs().max().item()
    dp = _max_diff(trainer.params, fused[0])
    said = (f"[{tag} extract] vs the fused rounds after {len(data)} rounds: "
            f"max |d client loss| {dl:.3g}, max |d param| {dp:.3g} "
            f"(tolerance {EXTRACT_TOL}: 3xTF32 hand kernels vs cuBLAS f32), "
            f"where the rounds moved the params by up to {moved:.3g}; the "
            f"fused rounds from params scaled by 1 + {PERTURB} N(0, 1) end "
            f"max |d client loss| {l_pert:.3g}, max |d param| {d_pert:.3g} "
            f"from them; row 10 a round "
            f"{x_launches.get('sgd_inplace', 0) // len(data)}; seconds per "
            f"round after the first {x_round_s:.3f}")
    check(moved > EXTRACT_TOL and dl <= EXTRACT_TOL and dp <= EXTRACT_TOL,
          said)
    print(said)
    del trainer, fused
    gc.collect()
    torch.cuda.empty_cache()
    return launches, x_launches


def _client_losses(trainer):
    """Every client step's loss of a trainer's rounds, ``[rounds, K, C]``
    on the host."""
    return torch.stack([h["client_loss"].to("cpu", copy=True)
                        for h in trainer.history])


def phase_ssm_grad(dev, model, params, _build):
    """One full-width Mamba2 loss gradient in the clients' form (C = 1) on
    the eval tokens (4 x 2048), through the differentiable chunked SSD:
    finite, timed (mean of 2 after a warm-up), its peak, and no launch of
    the SSD chunk kernel."""
    from repro_torch.data.synthetic import lm_batches
    tokens = torch.as_tensor(next(lm_batches(model.cfg.vocab, (EB,), ES,
                                             seed=999))["tokens"],
                             dtype=torch.long).to(dev)[None]
    p1 = {k: v.detach()[None].requires_grad_() for k, v in params.items()}

    def grad():
        loss, _ = model.loss(p1, {"tokens": tokens})
        return loss, torch.autograd.grad(loss.sum(), list(p1.values()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    loss, grads = grad()
    loss = float(loss.detach())
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    bad = [k for k, t in zip(p1, grads) if not torch.isfinite(t).all()]
    check(math.isfinite(loss) and not bad,
          f"[ssm eval] the gradient is not finite: {bad[:5]}")
    check(not launches.get("ssd_chunk_intra"),
          f"[ssm eval] the clients' form launched row 12: {launches}")
    del grads
    secs, _ = timed(lambda: grad()[0], 2)
    print(f"[ssm eval] {model.cfg.name} loss gradient on {EB}x{ES} tokens "
          f"(clients' form, C = 1: the differentiable chunked SSD): loss "
          f"{loss:.6f}, every gradient finite, "
          f"{float(np.mean(secs)):.4f} s (mean of 2 after a warm-up: "
          f"{[round(t, 4) for t in secs]}), peak {peak / 2**30:.2f} GiB, "
          f"launches {launches}")


def phase_hybrid_serve(dev, _build):
    """Full-width Hymba-1.5B at HYB_LAYERS of its 32 layers (random
    weights, seed 0, f32) eval and serving.  ``[hybrid eval]``: ``Model.loss`` on 4 x 2048 held-out tokens
    with and without ``REPRO_USE_FLASH`` (each counted once, then timed 3
    times; rows 12 and 13), the two within EVAL_RTOL, one profiled flash
    eval.  ``[hybrid serve]``: 4 prompts of 2048 tokens prefilled and 64
    greedy steps through ``serve.generate`` (launches, peak, prefill s,
    ms/token), then, at TF_LAYERS layers, prefill 1536 + 512
    teacher-forced decode steps against one prefill of 2048 (the last
    logits within MM_RTOL).  Returns the launches of the eval (with flash)
    and of the generation."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = zoo_config("hymba_1_5b", HYB_LAYERS)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (HB,), HS,
                                             seed=999))["tokens"],
                             dtype=torch.long).to(dev)
    out = {}
    for flash in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        loss = eval_loss(model, params, tokens, flash=flash)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        secs, again = timed(lambda: eval_loss(model, params, tokens,
                                              flash=flash), 3)
        peak = torch.cuda.max_memory_allocated()
        want = {"ssd_chunk_intra": cfg.n_layers}
        if flash:
            want["flash_attention"] = cfg.n_layers
        check(math.isfinite(loss) and math.isfinite(again)
              and launches == want,
              f"[hybrid eval] flash={flash}: loss {loss}, {again}, "
              f"launches {launches}, expected {want}")
        out[flash] = (loss, launches)
        print(f"[hybrid eval] {cfg.name} loss on {HB}x{HS} held-out tokens "
              f"(seed 999), REPRO_USE_FLASH {'set' if flash else 'unset'}: "
              f"{loss:.6f}  {float(np.mean(secs)):.4f} s (mean of 3 after a "
              f"warm-up: {[round(t, 4) for t in secs]})  peak "
              f"{peak / 2**30:.2f} GiB  launches {launches}")
    d = abs(out[True][0] - out[False][0])
    check(d <= EVAL_RTOL * abs(out[False][0]),
          f"[hybrid eval] flash vs blockwise: {d}")
    print(f"[hybrid eval] flash vs blockwise |d| {d:.3g} (tolerance "
          f"{EVAL_RTOL} relative)")
    phase_profile_eval("hybrid flash eval", lambda: eval_loss(
        model, params, tokens, flash=True))
    del tokens

    prompts = torch.as_tensor(sample_prompts(cfg, HB, HS, seed=0)[0],
                              dtype=torch.long).to(dev)
    generate(model, params, prompts[:, :256], 4)            # a warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    gen = generate(model, params, prompts, HG)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(launches == {"ssd_chunk_intra": cfg.n_layers},
          f"[hybrid serve] launches {launches}")
    print(f"[hybrid serve] {cfg.name}: prefill {HB}x{HS}: "
          f"{gen['prefill_s']:.4f} s; decode {1e3 * gen['decode_s'] / HG:.3f}"
          f" ms/token ({HG} greedy steps, batch {HB}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches}; first row "
          f"{gen['tokens'][0, :12].tolist()}")
    del model, params
    model, params = tf_model(cfg, dev)
    with torch.no_grad():
        want, _ = model.prefill(params, prompts)
    got, _ = teacher_forced(model, params, prompts, HSPLIT)
    e = err(got, want)
    check(bool(torch.isfinite(want).all()) and e[1] <= MM_RTOL,
          f"[hybrid serve] prefill {HSPLIT} + {HS - HSPLIT} decode steps vs "
          f"prefill {HS}: {e}")
    print(f"[hybrid serve] prefill {HSPLIT} + {HS - HSPLIT} teacher-forced "
          f"decode steps (the ring of {cfg.sliding_window} wraps) vs prefill "
          f"{HS} at {TF_LAYERS} of 32 layers (cut: depth): logits max abs "
          f"diff {e[0]:.3g} (rel {e[1]:.3g}, tolerance {MM_RTOL})")
    del model, params, prompts
    gc.collect()
    torch.cuda.empty_cache()
    return out[True][1], launches


# -- phase 4k: the dense and MoE model zoo, the continuous batcher ---------------

# (tag, arch, layers kept, clients, fused rounds, extract rounds): full widths;
# the depth and the clients are cut so that a fused round, about (1 + 2 C)
# times the f32 params, fits the card
ZOO_ROUNDS = [("deepseek round", "deepseek_7b", 4, 4, 3, 1),
              ("qwen3 round", "qwen3_14b", 2, 2, 1, 1),
              ("mixtral round", "mixtral_8x22b", 1, 2, 2, 2)]
ZOO_SEQ = 256             # tokens a sequence; 2 sequences a client step
MOE_EVAL_LAYERS = 4       # Mixtral's eval and serving: 4 of 56 layers
MOE_EB, MOE_ES = 1, 8192  # one sequence past Mixtral's window of 4096
QWEN_EB = 2               # Qwen3-14B's eval: 2 x 2048 beside its 59 GB
SERVE_SLOTS, SERVE_LEN, SERVE_REQS = 4, 4096, 8
# max_new cut from (16, 32, 48, 64) to its half: eager decode is host-bound,
# and the script must end within its time limit on a slow host
SERVE_PROMPTS, SERVE_NEW = (64, 128, 192, 256), (8, 16, 24, 32)


def zoo_config(arch, layers=None, **over):
    """A zoo config at its published widths, cut to ``layers`` layers
    (and ``over``'s other fields)."""
    from repro_torch.configs.base import get_config
    cfg = get_config(arch)
    if layers is not None:
        over["n_layers"] = layers
    return dataclasses.replace(cfg, **over) if over else cfg


def _zoo_launches(cfg, leaves, n, clients, fused):
    """Rows 5-8 and 10's launches over ``n`` rounds (K = 2 steps each):
    the fused phase runs each attention block's three windowed head
    products (GQA's q, k and v; MLA's per-head up-projections w_uq, w_uk
    and w_uv) through rows 5-6 and each gate/up pair through rows 7-8
    once a block a step (the MTP block is one more; an MoE layer's experts
    once a client, its window of experts in the kernel's leading
    dimension); every step steps each leaf through row 10."""
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.moe is not None else 0
    blocks = cfg.n_layers + int(cfg.mtp)
    per = 2 * n * int(fused)
    t2 = blocks - n_moe + clients * n_moe
    return {"rolling_mm_fwd<1>": 3 * blocks * per,
            "rolling_mm_dx<1>": 3 * blocks * per,
            "rolling_mm_fwd<2>": t2 * per, "rolling_mm_dx<2>": t2 * per,
            "sgd_inplace": 2 * leaves * n}


def phase_zoo_round(dev, _build, tag, arch, layers, clients, n_fused,
                    n_extract, over=None):
    """A zoo config's fused rounds at full width (cut to ``layers``
    layers, and ``over``'s other fields): ``clients`` clients x K = 2 steps
    x 2 x ZOO_SEQ tokens (with the codebook streams and the vision stub's
    patches of the families that take them), rolling at capacity 0.5 on
    the default axes, client lr 0.1, through ``api.fed_round`` and
    ``api.Trainer`` (seconds, peak beside its reckoning, finite losses and
    params, rows 5-8 and 10's launches against the layer arithmetic), one
    profiled round; then ``n_extract`` extract rounds from the same params
    and offsets, every client loss and the params within EXTRACT_TOL of
    the fused rounds' after as many rounds (which moved the params by more
    than EXTRACT_TOL); DeepSeek-7B also pins "no per-client W_sub copy".
    Returns the launches of both."""
    from repro_torch import api
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = zoo_config(arch, layers, **(over or {}))
    full = zoo_config(arch)
    model = build_model(cfg)
    vision = (cfg.vision_patches, cfg.vision_d) if cfg.vision_stub else None
    it = lm_batches(cfg.vocab, (2, clients, 2), seq=ZOO_SEQ,
                    codebooks=cfg.n_codebooks, vision=vision)
    data = [next(it) for _ in range(n_fused)]
    scfg = slice_scfg(clients_per_round=clients)
    fed = api.fed_round(model, scfg, device=dev)
    check(fed.use_fused, f"[{tag}] the default axes took the extract phase")
    offsets = [fed._client_offsets(r) for r in range(n_fused)]
    items = [(b, {"offsets": o}) for b, o in zip(data, offsets)]
    params = model.init(seed=0, device=dev)
    leaves, n_params = len(params), sum(v.numel() for v in params.values())
    windows = {f"{k[0]}/{k[1]}": w for k, w in fed.scheme.sizes.items()}
    reckon = (1 + 2 * clients) * 4 * n_params
    cuts = ([f"depth ({over})" if over else "depth"]
            if layers < full.n_layers else []) + (
        [f"clients {clients}"] if clients < 4 else [])
    print(f"[{tag}] {cfg.name}: {layers} of {full.n_layers} layers (cut: "
          f"{', '.join(cuts) or 'none'}), "
          f"d_model {cfg.d_model}, {n_params:,} params ({leaves} leaves), "
          f"f32; {clients} clients x 2 steps x 2 x {ZOO_SEQ} tokens, client "
          f"lr {scfg.client_lr}; windows {windows}; offsets {offsets}; "
          f"peak reckoned (1 + 2 C) x params = {reckon / 2**30:.2f} GiB plus "
          "activations")
    trainer = api.Trainer(fed, params)
    kept = {}

    def keep(i):
        if i + 1 == n_extract:
            kept["params"] = {k: v.to("cpu", copy=True)
                              for k, v in trainer.params.items()}
            kept["losses"] = _client_losses(trainer)
    launches, round_s = run_rounds(tag, trainer, items, _build,
                                   clients=clients, after=keep)
    want = _zoo_launches(cfg, leaves, n_fused, clients, True)
    got = {k: launches.get(k, 0) for k in want}
    check(got == want, f"[{tag}] launches {got}, expected {want}")
    print(f"[{tag}] rows 5-8 and 10 a round: "
          f"{ {k: v // n_fused for k, v in got.items()} }")
    if tag != "qwen3 round":
        phase_profile(tag, trainer, items[0], round_s)
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()

    fed = api.fed_round(model, scfg, fused_forward="off", device=dev)
    check(not fed.use_fused, f"[{tag} extract] took the fused phase")
    trainer = api.Trainer(fed, model.init(seed=0, device=dev))
    # the initial params again (seed 0): how far the fused rounds moved
    moved = _max_diff(trainer.params, kept["params"])
    x_launches, x_round_s = run_rounds(f"{tag} extract", trainer,
                                       items[:n_extract], _build,
                                       clients=clients)
    want = _zoo_launches(cfg, leaves, n_extract, clients, False)
    got = {k: x_launches.get(k, 0) for k in want}
    check(got == want, f"[{tag} extract] launches {got}, expected {want}")
    dl = (_client_losses(trainer) - kept["losses"]).abs().max().item()
    dp = _max_diff(trainer.params, kept["params"])
    said = (f"[{tag} extract] vs the fused rounds after {n_extract} "
            f"round(s): max |d client loss| {dl:.3g}, max |d param| "
            f"{dp:.3g} (tolerance {EXTRACT_TOL}: 3xTF32 hand kernels vs "
            f"cuBLAS f32), where the rounds moved the params by up to "
            f"{moved:.3g}; seconds per round {x_round_s:.3f}")
    check(moved > EXTRACT_TOL and dl <= EXTRACT_TOL and dp <= EXTRACT_TOL,
          said)
    print(said)
    del trainer, kept
    gc.collect()
    torch.cuda.empty_cache()
    if arch == "deepseek_7b":
        phase_wsub_pin(dev, model, model.init(seed=0, device=dev), data[0],
                       offsets[0], scfg=scfg, tag="wsub zoo")
        gc.collect()
        torch.cuda.empty_cache()
    return launches, x_launches


def _eval_parts(tag, parts, _build):
    """Each part driven once, timed to a synchronize, with the launch
    counts set to 0 just before and read just after and the peak from a
    reset; returns ``{tag: (loss, launches)}``."""
    out = {}
    for name, fn in parts:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        loss = res[0] if isinstance(res, tuple) else res
        check(math.isfinite(loss), f"[{tag}] {name}: loss {loss}")
        print(f"[{tag}] {name:26s} loss {loss:.6f}  {secs:.4f} s  peak "
              f"{peak / 2**30:.2f} GiB  launches {launches}")
        out[name] = (res, launches)
    return out


def _flash_agrees(tag, parts, a, b):
    la, lb = parts[a][0], parts[b][0]
    la, lb = (la[0] if isinstance(la, tuple) else la,
              lb[0] if isinstance(lb, tuple) else lb)
    rel = abs(la - lb) / abs(lb)
    check(rel <= EVAL_RTOL, f"[{tag}] {a} {la} vs {b} {lb}: {rel:.3g}")
    print(f"[{tag}] {a} vs {b}: relative difference {rel:.3g} (tolerance "
          f"{EVAL_RTOL})")


def phase_zoo_eval(dev, _build):
    """``[zoo eval]``: full DeepSeek-7B (30 layers, f32, random weights from
    seed 0): ``Model.loss`` on 4 x 2048 held-out tokens with and without
    ``REPRO_USE_FLASH`` (row 13 at G = 1, head_dim 128), the windowed
    sub-model's loss with it (rows 1-2 and 13) and one backward pass of the
    sub-model's loss at 2 x 256 without it (rows 1-4; every gradient
    finite, exactly 0 outside the d_ff window); then Mixtral-8x22B at 4 of
    56 layers, its loss on one sequence of 8192 tokens with and without
    flash (G = 6 under its window of 4096; the MoE layers on ``dropping``).
    Returns the launches, summed over the parts."""
    from repro_torch import api
    from repro_torch.core.extract import extract
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = zoo_config("deepseek_7b")
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (EB,), ES,
                                             seed=999))["tokens"],
                             dtype=torch.long).to(dev)
    fed = api.fed_round(model, slice_scfg(), device=dev)
    offs = fed.scheme.offsets(0, fed.scfg.clients_per_round)
    window = {k: (offs[k][0], w) for k, w in fed.scheme.sizes.items()
              if w < k[1]}
    small = tokens[:2, :256]
    print(f"[zoo eval] {cfg.name}: {cfg.n_layers} layers, "
          f"{sum(v.numel() for v in params.values()):,} params, f32; "
          f"held-out {list(tokens.shape)} (seed 999); sub-model window "
          f"{window}")

    # the plain run of the same window: the compact sub-model (views of
    # each leaf's window, as the extract phase cuts them) through the
    # model's ordinary products, no kernel; the gradients held are the
    # embedding's (the dx of every layer's products flows into it) and
    # the windows of the first layer's w_gate and the last layer's wq
    sub = extract(params, fed.axes, {k: o for k, (o, _) in window.items()},
                  fed.scheme.sizes)
    held = ("embed", "layers/0/mlp/w_gate",
            f"layers/{cfg.n_layers - 1}/attn/wq")

    def grad_pass():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        with flash_switch(False):
            loss, _ = model.loss(p, {"tokens": small}, window=window)
            grads = torch.autograd.grad(loss, list(p.values()))
        grads = dict(zip(p, grads))
        g = grads["layers/0/mlp/w_gate"]
        o, w = window[("d_ff", cfg.d_ff)]
        outside = (torch.count_nonzero(g[:, :o])
                   + torch.count_nonzero(g[:, o + w:])).item()
        finite = all(bool(torch.isfinite(t).all()) for t in grads.values())
        kept = extract({k: grads[k] for k in held}, fed.axes,
                       {k: o for k, (o, _) in window.items()},
                       fed.scheme.sizes)
        return (float(loss.detach()), outside, finite,
                {k: v.clone() for k, v in kept.items()})

    parts = _eval_parts("zoo eval", [
        ("deepseek server, flash", lambda: eval_loss(model, params, tokens,
                                                     flash=True)),
        ("deepseek server, blockwise", lambda: eval_loss(model, params,
                                                         tokens)),
        ("deepseek sub-model, flash", lambda: eval_loss(
            model, params, tokens, window, flash=True)),
        ("deepseek sub-model grad", grad_pass)], _build)
    L = cfg.n_layers
    for name, want in (
            ("deepseek server, flash", {"flash_attention": L}),
            ("deepseek server, blockwise", {}),
            ("deepseek sub-model, flash", {"flash_attention": L,
                                           "rolling_matmul": 3 * L,
                                           "rolling_matmul_multi": L}),
            ("deepseek sub-model grad", {
                "rolling_matmul": 3 * L, "rolling_matmul_multi": L,
                "rolling_matmul_dx": 3 * L, "rolling_matmul_dx_multi": L})):
        check(parts[name][1] == want, f"[zoo eval] {name}: launches "
              f"{parts[name][1]}, expected {want}")
    res = parts["deepseek sub-model grad"][0]
    check(res[1] == 0 and res[2], f"[zoo eval] sub-model grad: {res[1]} "
          f"nonzero w_gate grads outside the window, finite {res[2]}")
    plain = eval_loss(model, sub, tokens)
    p = {k: v.detach().requires_grad_() for k, v in sub.items()}
    with flash_switch(False):
        loss = model.loss(p, {"tokens": small})[0]
        want = dict(zip(held, torch.autograd.grad(loss,
                                                  [p[k] for k in held])))
    # the graph's leaves are views of the params: let it go with them
    plain_grad, p, loss = float(loss.detach()), None, None
    for name, got, ref_loss in (
            ("sub-model, flash", parts["deepseek sub-model, flash"][0],
             plain),
            ("sub-model grad", res[0], plain_grad)):
        rel = abs(got - ref_loss) / abs(ref_loss)
        check(rel <= EVAL_RTOL, f"[zoo eval] deepseek {name} {got} vs the "
              f"compact sub-model's {ref_loss}: {rel:.3g}")
        print(f"[zoo eval] deepseek {name} loss vs the compact sub-model's "
              f"(no kernel) {ref_loss:.6f}: relative difference {rel:.3g} "
              f"(tolerance {EVAL_RTOL})")
    for name in held:
        e = err(res[3][name], want[name])
        check(e[1] <= MM_RTOL, f"[zoo eval] sub-model grad {name}: {e}")
        print(f"[zoo eval] deepseek sub-model grad {name} "
              f"{list(want[name].shape)} vs the compact sub-model's: max abs "
              f"err {e[0]:.3g} (rel {e[1]:.3g}, tolerance {MM_RTOL})")
    res[3].clear()
    del sub, want, res
    _flash_agrees("zoo eval", parts, "deepseek server, flash",
                  "deepseek server, blockwise")
    phase_profile_eval("deepseek server, flash", lambda: eval_loss(
        model, params, tokens, flash=True))
    del model, params, tokens, small
    gc.collect()
    torch.cuda.empty_cache()

    cfg = zoo_config("mixtral_8x22b", MOE_EVAL_LAYERS)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (MOE_EB,), MOE_ES,
                                             seed=999))["tokens"],
                             dtype=torch.long).to(dev)
    n = sum(v.numel() for v in params.values())
    print(f"[zoo eval] {cfg.name}: {MOE_EVAL_LAYERS} of 56 layers (cut: "
          f"depth), {n:,} params ({4 * n / 1e9:.1f} GB f32); held-out "
          f"{list(tokens.shape)} (seed 999), window {cfg.sliding_window}, "
          f"MoE path {model.moe_path}")
    more = _eval_parts("zoo eval", [
        ("mixtral, flash", lambda: eval_loss(model, params, tokens,
                                             flash=True)),
        ("mixtral, blockwise", lambda: eval_loss(model, params, tokens))],
        _build)
    check(more["mixtral, flash"][1] == {"flash_attention": MOE_EVAL_LAYERS}
          and more["mixtral, blockwise"][1] == {},
          f"[zoo eval] mixtral launches {more}")
    _flash_agrees("zoo eval", more, "mixtral, flash", "mixtral, blockwise")
    del model, params, tokens
    gc.collect()
    torch.cuda.empty_cache()
    total = {}
    for _, launches in [*parts.values(), *more.values()]:
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    print(f"[zoo eval] kernel launches on the eval path {total}")
    return total


class _Recorder:
    """A model as the continuous batcher sees it, keeping the logits each
    request is handed: the prefill's row at the request's last prompt
    token (filed by :meth:`admitted` after the step) and its slot's row of
    every decode step (read off the batcher's slots as the step runs)."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg
        self.eng, self.last_prefill, self.rows = None, None, {}

    def init_cache(self, *args, **kw):
        return self.model.init_cache(*args, **kw)

    def prefill(self, *args, **kw):
        logits, cache = self.model.prefill(*args, **kw)
        self.last_prefill = logits
        return logits, cache

    def decode_step(self, *args, **kw):
        logits, cache = self.model.decode_step(*args, **kw)
        host = logits.to("cpu", copy=True)
        for i, r in enumerate(self.eng._slot_req):
            if r is not None:
                self.rows.setdefault(r.rid, []).append(host[i])
        return logits, cache

    def admitted(self, before):
        """File the prefill rows of the requests the last step admitted
        (in a slot now, and not before it)."""
        for slot, r in enumerate(self.eng._slot_req):
            if r is not None and id(r) not in before:
                row = self.last_prefill[slot, len(r.prompt) - 1]
                self.rows.setdefault(r.rid, []).insert(
                    0, row.to("cpu", copy=True))


def _serve_queue(cfg, n=SERVE_REQS, prompts=SERVE_PROMPTS):
    """``n`` requests from ``request_queue``: prompts cycling through
    ``prompts`` tokens, ``max_new`` through SERVE_NEW."""
    from repro_torch.launch.specs import request_queue
    reqs = request_queue(cfg, [prompts[i % 4] for i in range(n)], seed=0)
    for i, r in enumerate(reqs):
        r.max_new = SERVE_NEW[i % 4]
    return reqs


def drive(eng, rec=None):
    """Step ``eng`` by hand (``ContinuousBatcher.run``'s loop) until its
    queue and slots are empty, each step timed to a synchronize; with
    ``rec``, file each request's logits in it.  Returns the seconds of the
    steps that admitted a cohort (its prefill and the tick) and of the
    others (one decode tick each)."""
    if rec is not None:
        rec.eng = eng
    admit, ticks = [], []
    while eng._queue or any(r is not None for r in eng._slot_req):
        before = {id(r) for r in eng._slot_req if r is not None}
        n = eng.stats.prefills
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(eng.step(), "the continuous batcher stalled")
        torch.cuda.synchronize()
        (admit if eng.stats.prefills > n else ticks).append(
            time.perf_counter() - t0)
        if rec is not None:
            rec.admitted(before)
    return admit, ticks


def serve_continuous(tag, model, params, _build, record=False,
                     n=SERVE_REQS, prompts=SERVE_PROMPTS):
    """``n`` requests through ``ContinuousBatcher`` (SERVE_SLOTS slots, a
    timeline of SERVE_LEN), stepped by :func:`drive`; prints the requests
    completed, tokens, prefills, decode ticks, ticks per second, the
    seconds of the admitting steps and the ms of a tick without one,
    launches per tick, seconds and peak.  With ``record``, the model is
    wrapped in a :class:`_Recorder`; returns the requests, the recorder
    and the launches."""
    from repro_torch.launch.batching import ContinuousBatcher
    reqs = _serve_queue(model.cfg, n, prompts)
    rec = _Recorder(model) if record else None
    eng = ContinuousBatcher(rec or model, params, batch_slots=SERVE_SLOTS,
                            max_len=SERVE_LEN)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    admit, ticks = drive(eng, rec)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    st = eng.stats
    check(st.completed == len(reqs) and all(r.done for r in reqs)
          and all(len(r.out) == r.max_new + 1 for r in reqs),
          f"[{tag}] {st}: not every request completed")
    mo = model.cfg.moe
    path = (f", MoE path {model.moe_path}, capacity factor "
            f"{mo.capacity_factor}" if mo else "")
    print(f"[{tag}] {model.cfg.name} ({model.cfg.n_layers} layers{path})"
          f"{' (recording logits)' if record else ''}: "
          f"{st.completed} requests, {st.tokens_generated} tokens, "
          f"{st.prefills} prefills, {st.decode_steps} decode ticks in "
          f"{secs:.3f} s ({st.decode_steps / secs:.2f} ticks/s; the "
          f"{len(admit)} admitting steps {sum(admit):.3f} s, "
          f"{[round(t, 4) for t in admit]}; the other {len(ticks)} ticks "
          f"{1e3 * float(np.mean(ticks)):.2f} ms each), launches "
          f"{launches} ({sum(launches.values()) / st.decode_steps:.2f} a "
          f"tick), peak memory allocated {peak / 2**30:.2f} GiB; slots "
          f"{SERVE_SLOTS}, timeline {SERVE_LEN}, prompts {prompts}, "
          f"max_new {SERVE_NEW}")
    del eng
    return reqs, rec, launches


def check_single_requests(tag, model, params, reqs, rec, tol=MM_RTOL):
    """Each request's batcher logits against a single-request prefill of
    its prompt and teacher-forced decode steps fed the batcher's own
    tokens: every step within ``tol`` of the request's largest logit, and
    the batcher's token equal to the single request's argmax wherever the
    latter's top-2 margin exceeds that tolerance."""
    worst, ties = 0.0, 0
    for r in reqs:
        got = torch.stack(rec.rows[r.rid])
        check(got.shape[0] == len(r.out), f"[{tag}] request {r.rid}: "
              f"{got.shape[0]} logit rows for {len(r.out)} tokens")
        prompt = torch.as_tensor(r.prompt, dtype=torch.long,
                                 device=params["embed"].device)[None]
        plen, rows = len(r.prompt), []
        with torch.no_grad():
            logits, cache = model.prefill(params, prompt,
                                          max_len=plen + len(r.out))
            rows.append(logits[0].cpu())
            for i, t in enumerate(r.out[:-1]):
                logits, cache = model.decode_step(
                    params, torch.tensor([t], device=prompt.device), cache,
                    plen + i)
                rows.append(logits[0].cpu())
        want = torch.stack(rows)
        scale = want.abs().max().item()
        e = (got.float() - want.float()).abs().max().item() / scale
        top2 = torch.topk(want, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > tol * scale
        toks = torch.tensor(r.out)
        bad = (sure & (toks != want.argmax(-1))).nonzero().flatten().tolist()
        check(e <= tol and not bad, f"[{tag}] request {r.rid}: logits "
              f"{e:.3g} of the largest, tokens differ at steps {bad}")
        worst, ties = max(worst, e), ties + int((~sure).sum())
    print(f"[{tag}] every request vs its single-request prefill + "
          f"teacher-forced decode: logits within {worst:.3g} of each "
          f"request's largest (tolerance {tol}), tokens equal at every "
          f"step whose top-2 margin exceeds it ({ties} steps under it)")


def phase_serve_continuous(dev, _build):
    """``[serve continuous]``: full-size Qwen3-14B (40 layers, 14.77 B
    params, f32, random weights from seed 0): first its eval (``[zoo
    eval]``, 2 x 2048 tokens, with and without flash: row 13 at G = 5
    under ``qk_norm``); then SERVE_REQS requests through the continuous
    batcher, timed, and again while it records every request's logits (a
    copy of the tick's [4, V] logits to the host, so that run's ticks are
    not the engine's time), which are held against single-request
    decoding; one decode tick profiled; then Mixtral-8x22B
    at 4 of 56 layers: the same queue on ``dropping`` (timed), and on
    ``dense`` held against single-request decoding.  Returns the eval's
    launches."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = zoo_config("qwen3_14b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n = sum(v.numel() for v in params.values())
    print(f"[serve continuous] {cfg.name}: {cfg.n_layers} layers, {n:,} "
          f"params ({4 * n / 1e9:.1f} GB f32), made in "
          f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (QWEN_EB,), ES,
                                             seed=999))["tokens"],
                             dtype=torch.long).to(dev)
    parts = _eval_parts("zoo eval", [
        ("qwen3 server, flash", lambda: eval_loss(model, params, tokens,
                                                  flash=True)),
        ("qwen3 server, blockwise", lambda: eval_loss(model, params,
                                                      tokens))], _build)
    check(parts["qwen3 server, flash"][1] == {"flash_attention":
                                              cfg.n_layers},
          f"[zoo eval] qwen3 launches {parts}")
    _flash_agrees("zoo eval", parts, "qwen3 server, flash",
                  "qwen3 server, blockwise")
    del tokens
    gc.collect()
    torch.cuda.empty_cache()
    tag = "serve continuous"
    timed, _, launches = serve_continuous(tag, model, params, _build)
    check(launches == {}, f"[{tag}] kernel launches {launches}")
    reqs, rec, launches = serve_continuous(tag, model, params, _build,
                                           record=True)
    check(launches == {}, f"[{tag}] kernel launches {launches}")
    check([r.out for r in timed] == [r.out for r in reqs],
          f"[{tag}] the timed and the recorded runs handed out different "
          f"tokens")
    check_single_requests(tag, model, params, reqs, rec)
    del rec
    # one decode tick at the pool's shape: 4 slots, a timeline of 4096,
    # 1024 positions valid each
    cache = model.init_cache(SERVE_SLOTS, SERVE_LEN, torch.float32,
                             device=dev)
    valid = torch.zeros((SERVE_SLOTS, SERVE_LEN), dtype=torch.bool,
                        device=dev)
    valid[:, :1024] = True
    tok = torch.arange(SERVE_SLOTS, device=dev)
    rope = torch.full((SERVE_SLOTS,), 1023, device=dev)
    with torch.no_grad():
        profile_decode_step(tag, lambda: model.decode_step(
            params, tok, cache, 1023, valid=valid, rope_pos=rope))
    del model, params, cache
    gc.collect()
    torch.cuda.empty_cache()

    cfg = zoo_config("mixtral_8x22b", MOE_EVAL_LAYERS)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    serve_continuous(tag, model, params, _build)
    dense = build_model(cfg, moe_path="dense")
    reqs, rec, _ = serve_continuous(tag, dense, params, _build, record=True)
    check_single_requests(tag, dense, params, reqs, rec)
    del model, dense, params, rec
    gc.collect()
    torch.cuda.empty_cache()
    total = {}
    for _, launches in parts.values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_small_agreement_zoo(dev):
    """``[agree zoo]``: reduced DeepSeek-7B, Qwen3-14B, Mixtral-8x22B,
    DeepSeek-V3 (MLA, a leading dense layer, an MoE layer, MTP; the MoE
    layers on ``dropping``), MusicGen-large (codebooks) and Phi-3-vision
    (patches), 2 fused rounds each on the card and on the CPU from the
    same params, tokens (2 x 64 a client step) and CPU-drawn offsets,
    within ROUND_TOL; then one continuous batcher run of each token-prompt
    model (2 slots, prompts of 5-12 tokens, 4 new tokens each): every
    logit the batcher hands out within ROUND_TOL of the CPU's, relative to
    the largest, the tokens equal wherever the CPU's top-2 margin exceeds
    that, and the stats equal."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.launch.specs import request_queue
    from repro_torch.models import build_model
    for arch in ("deepseek_7b", "qwen3_14b", "mixtral_8x22b",
                 "deepseek_v3_671b", "musicgen_large", "phi_3_vision_4_2b"):
        model = build_model(get_reduced_config(arch))
        cfg = model.cfg
        vision = ((cfg.vision_patches, cfg.vision_d) if cfg.vision_stub
                  else None)
        it = lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0,
                        codebooks=cfg.n_codebooks, vision=vision)
        data = [next(it) for _ in range(2)]
        p0 = model.init(0, device="cpu")
        outs = {}
        for where in ("cpu", dev):
            fed = api.fed_round(model, slice_scfg(), device=where)
            check(fed.use_fused, f"[agree zoo] {arch} took the extract "
                  "phase")
            trainer = api.Trainer(fed, _to(p0, where))
            trainer.run(zip(data, _injected(fed, "window", 2)), 2)
            outs[str(where)] = trainer
        g, c = outs[str(dev)], outs["cpu"]
        dl = max((a["client_loss"].cpu() - b["client_loss"]).abs().max()
                 .item() for a, b in zip(g.history, c.history))
        dp = _max_diff(g.params, c.params)
        check(dl <= ROUND_TOL and dp <= ROUND_TOL,
              f"[agree zoo] reduced {arch} on the card disagrees with the "
              f"CPU: loss {dl}, params {dp}")
        path = f" (MoE path {model.moe_path})" if cfg.moe else ""
        if cfg.n_codebooks or cfg.vision_stub:
            # the continuous batcher serves plain token prompts only
            print(f"[agree zoo] reduced {arch}{path}, 2 fused rounds card "
                  f"vs CPU: max |d loss| {dl:.3g}, max |d param| {dp:.3g} "
                  f"(tolerance {ROUND_TOL})")
            continue
        served = {}
        for where in ("cpu", dev):
            reqs = request_queue(model.cfg, (5, 9, 7, 12, 3), max_new=4)
            rec = _Recorder(model)
            eng = ContinuousBatcher(rec, _to(p0, where), batch_slots=2,
                                    max_len=60)
            for r in reqs:
                eng.submit(r)
            drive(eng, rec)
            served[str(where)] = (reqs, rec, eng.stats)
        (cr, crec, cst), (gr, grec, gst) = served["cpu"], served[str(dev)]
        want = torch.cat([torch.stack(crec.rows[r.rid]) for r in cr])
        got = torch.cat([torch.stack(grec.rows[r.rid]) for r in gr])
        scale = want.abs().max().item()
        e = (got - want).abs().max().item() / scale
        top2 = torch.topk(want, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > ROUND_TOL * scale
        toks = [torch.tensor(r.out) for r in gr]
        same = torch.cat(toks) == torch.cat([torch.tensor(r.out)
                                             for r in cr])
        check(e <= ROUND_TOL and bool(same[sure].all()) and gst == cst,
              f"[agree zoo] reduced {arch} batcher, card vs CPU: logits "
              f"{e:.3g}, tokens {same.tolist()}, stats {gst} vs {cst}")
        print(f"[agree zoo] reduced {arch}{path}, 2 fused rounds card vs "
              f"CPU: max |d loss| {dl:.3g}, max |d param| {dp:.3g} "
              f"(tolerance {ROUND_TOL}); the batcher's "
              f"logits within {e:.3g} of the largest, tokens equal at "
              f"{int(same.sum())} of {same.numel()} steps "
              f"({int((~sure).sum())} under the margin), stats {gst}")


# -- phase 4l: the rest of the zoo: MLA and MTP, codebooks, the vision stub --

# (tag, arch, layers kept, clients, fused rounds, extract rounds, other cut
# fields): full widths; DeepSeek-V3 keeps its first (dense) layer and the
# MTP block (a MoE layer of 256 experts is 11.5 B params alone), Phi-3-
# vision 8 of its 32 layers, MusicGen-large 12 of its 48 (cut: depth, so
# that the script stays inside its time limit on a slow host; the bf16
# rounds run Phi-3-vision whole and MusicGen at 24 layers)
NEW_ROUNDS = [("mla round", "deepseek_v3_671b", 1, 2, 3, 1,
               {"n_dense_layers": 1}),
              ("audio round", "musicgen_large", 12, 2, 3, 1, {}),
              ("vlm round", "phi_3_vision_4_2b", 8, 2, 3, 1, {})]
# DeepSeek-V3's eval and serving: its first dense layer, one MoE layer of
# all 256 experts (the shared expert, the sigmoid router) and MTP
MLA_EVAL = dict(n_layers=2, n_dense_layers=1)
MLA_ES = 2048              # eval: one sequence of 2048 tokens
MLA_SB, MLA_SS, MLA_SG = 2, 256, 32  # serving: 2 x 256, 32 greedy steps
MLA_TF = 32                # teacher-forced: prefill 224 + 32 vs 256
# the continuous batcher: 4 requests of 16-64 prompt tokens (a cohort of
# 4 x 64 tokens) and 8-32 new ones
MLA_REQS, MLA_PROMPTS = 4, (16, 32, 48, 64)
# MusicGen's and Phi-3-vision's serving: 4 prompts of 1536 positions (for
# Phi-3-vision 256 patches + 1280 tokens), 32 greedy steps; the
# teacher-forced check prefills 480 positions and decodes 32
# (blockwise attention takes whole chunks of 512 past 512)
FAM_SB, FAM_SS, FAM_SG, FAM_TF = 4, 1536, 32, 32


def _batch_on(batch, dev):
    """A numpy batch on ``dev``: tokens as int64, patches as they are."""
    return {k: torch.as_tensor(v, dtype=torch.long if k == "tokens"
                               else None).to(dev) for k, v in batch.items()}


def serve_generate(tag, model, params, prompts, gen, _build, extra=None):
    """``serve.generate`` of ``gen`` greedy tokens after ``prompts`` (a
    warm-up of 4 tokens on the first 256 first), with the launches counted
    from 0 and the peak from a reset; prints prefill s, ms/token and the
    peak, and checks that the kernels run no launch (serving is the
    model's plain products) and the tokens are in the vocabulary."""
    from repro_torch.launch.serve import generate
    generate(model, params, prompts[:, :256], 4, extra=extra)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out = generate(model, params, prompts, gen, extra=extra)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    toks = out["tokens"]
    check(launches == {} and int(toks.min()) >= 0
          and int(toks.max()) < model.cfg.vocab,
          f"[{tag}] launches {launches}, tokens {toks.min()}..{toks.max()}")
    P = extra["patches"].shape[1] if extra else 0
    print(f"[{tag}] {model.cfg.name}: prefill {list(prompts.shape)}"
          f"{f' behind {P} patches' if P else ''}: "
          f"{out['prefill_s']:.4f} s; decode "
          f"{1e3 * out['decode_s'] / gen:.3f} ms/token ({gen} greedy steps, "
          f"batch {prompts.shape[0]}); peak memory allocated "
          f"{peak / 2**30:.2f} GiB; kernel launches {launches}; first row "
          f"{toks[0, :8].tolist()}")


def check_teacher_forced(tag, model, params, seq, split, extra=None):
    """:func:`teacher_forced` against one prefill of all of ``seq``: the
    last logits within MM_RTOL."""
    got, _ = teacher_forced(model, params, seq, split, extra)
    with torch.no_grad():
        want, _ = model.prefill(params, seq, extra)
    e = err(got, want)
    check(bool(torch.isfinite(want).all()) and e[1] <= MM_RTOL,
          f"[{tag}] prefill {split} + {seq.shape[1] - split} decode steps vs "
          f"prefill {seq.shape[1]}: {e}")
    print(f"[{tag}] prefill {split} + {seq.shape[1] - split} teacher-forced "
          f"decode steps vs one prefill of {seq.shape[1]} tokens: logits max "
          f"abs diff {e[0]:.3g} (rel {e[1]:.3g}, tolerance {MM_RTOL})")


def phase_mla_eval_serve(dev, _build):
    """``[mla eval]`` and ``[mla serve]``: DeepSeek-V3 at full width cut to
    its first (dense) layer, one MoE layer of all 256 experts and the MTP
    block (14.5 B params, f32, random weights from seed 0; the MoE layer on
    ``dropping``).  Eval: ``Model.loss`` on one held-out sequence of 2048
    tokens (``lm_loss`` and ``mtp_loss`` finite), the sub-model under a
    ``heads`` 64-of-128 + ``d_ff`` 9216-of-18432 window (rows 1-2 through
    MLA's up-projections and the dense MLPs) and one backward pass of its
    loss at 2 x 256 tokens with respect to the embedding, the dense layer
    and the MTP block (rows 3-4), each held against the compact sub-model
    (the extracted windows, no kernel).  Serving: ``serve.generate`` of 32
    greedy tokens after 2 x 256 through the absorbed decode (``dropping``);
    then, on ``dropping`` at a capacity that holds every choice (capacity
    factor n_experts / top_k = 32: what ``dense`` computes, without the
    ``dense`` path's einsums, which copy the 15 GB expert stacks and do not
    fit beside them), prefill 224 + 32 teacher-forced decode steps
    against one prefill of 256, and MLA_REQS requests through the
    continuous batcher, every logit held against single-request decoding.
    Returns the eval's launches."""
    from repro_torch.core.extract import extract
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    tag = "mla eval"
    cfg = zoo_config("deepseek_v3_671b", **MLA_EVAL)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n = sum(v.numel() for v in params.values())
    batch = _batch_on(next(lm_batches(cfg.vocab, (1,), MLA_ES, seed=999)),
                      dev)
    small = {"tokens": batch["tokens"].new_tensor(next(lm_batches(
        cfg.vocab, (2,), 256, seed=998))["tokens"])}
    H, F = cfg.n_heads, cfg.d_ff
    window = {("heads", H): (H // 2, H // 2), ("d_ff", F): (F // 2, F // 2)}
    offsets = {k: o for k, (o, _) in window.items()}
    sizes = {k: w for k, (_, w) in window.items()}
    axes = model.axes()
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} of 61 layers (cut: depth; "
          f"1 dense + 1 MoE layer of {cfg.moe.n_experts} experts, top-"
          f"{cfg.moe.top_k}, {cfg.moe.n_shared} shared, {cfg.moe.router} "
          f"router) + the MTP block, {n:,} params ({4 * n / 1e9:.1f} GB "
          f"f32), made in {time.perf_counter() - t0:.1f} s; held-out "
          f"{list(batch['tokens'].shape)} (seed 999), MoE path "
          f"{model.moe_path}; sub-model window {window}")
    trained = [k for k in params if k == "embed"
               or k.startswith(("dense_layers/", "mtp/"))]
    held = ("embed", "dense_layers/0/mlp/w_gate", "dense_layers/0/attn/w_uq")

    def grad_pass(p, win):
        """The loss at 2 x 256 and its gradients with respect to the
        ``trained`` leaves (the MoE layer's stay fixed)."""
        p = dict(p)
        for k in trained:
            p[k] = p[k].detach().requires_grad_()
        loss, _ = model.loss(p, small, window=win)
        grads = dict(zip(trained, torch.autograd.grad(
            loss, [p[k] for k in trained])))
        return float(loss.detach()), grads

    def window_grad():
        loss, grads = grad_pass(params, window)
        finite = all(bool(torch.isfinite(t).all()) for t in grads.values())
        outside = 0
        for k, dim, key in (("dense_layers/0/mlp/w_gate", 1, ("d_ff", F)),
                            ("mtp/mlp/w_up", 1, ("d_ff", F)),
                            ("dense_layers/0/attn/w_uq", 1, ("heads", H)),
                            ("mtp/attn/wo", 0, ("heads", H))):
            g, (o, w) = grads[k], window[key]
            outside += (torch.count_nonzero(g) - torch.count_nonzero(
                g.narrow(dim, o, w))).item()
        kept = extract({k: grads[k] for k in held}, axes, offsets, sizes)
        return loss, outside, finite, {k: v.clone() for k, v in
                                       kept.items()}

    parts = _eval_parts(tag, [
        ("deepseek-v3 server", lambda: batch_loss(model, params, batch)),
        ("deepseek-v3 sub-model", lambda: batch_loss(model, params, batch,
                                                     window)),
        ("deepseek-v3 sub-model grad", window_grad)], _build)
    blocks = cfg.n_layers + 1
    mlps = cfg.n_dense_layers + 1
    for name, want in (
            ("deepseek-v3 server", {}),
            ("deepseek-v3 sub-model", {"rolling_matmul": 3 * blocks,
                                       "rolling_matmul_multi": mlps}),
            ("deepseek-v3 sub-model grad", {
                "rolling_matmul": 3 * blocks, "rolling_matmul_multi": mlps,
                "rolling_matmul_dx": 3 * blocks,
                "rolling_matmul_dx_multi": mlps})):
        check(parts[name][1] == want, f"[{tag}] {name}: launches "
              f"{parts[name][1]}, expected {want}")
    metrics = parts["deepseek-v3 server"][0][1]
    check(all(math.isfinite(v) for v in metrics.values()),
          f"[{tag}] metrics {metrics}")
    print(f"[{tag}] server metrics {metrics}")
    res = parts["deepseek-v3 sub-model grad"][0]
    check(res[1] == 0 and res[2], f"[{tag}] sub-model grad: {res[1]} "
          f"nonzero grads outside the windows, finite {res[2]}")
    sub = extract(params, axes, offsets, sizes)
    plain = batch_loss(model, sub, batch)[0]
    plain_grad, want = grad_pass(sub, None)
    want = {k: want[k] for k in held}
    for name, got, ref_loss in (
            ("sub-model", parts["deepseek-v3 sub-model"][0][0], plain),
            ("sub-model grad", res[0], plain_grad)):
        rel = abs(got - ref_loss) / abs(ref_loss)
        check(rel <= EVAL_RTOL, f"[{tag}] {name} {got} vs the compact "
              f"sub-model's {ref_loss}: {rel:.3g}")
        print(f"[{tag}] deepseek-v3 {name} loss vs the compact sub-model's "
              f"(no kernel) {ref_loss:.6f}: relative difference {rel:.3g} "
              f"(tolerance {EVAL_RTOL})")
    for name in held:
        e = err(res[3][name], want[name])
        check(e[1] <= MM_RTOL, f"[{tag}] sub-model grad {name}: {e}")
        print(f"[{tag}] deepseek-v3 sub-model grad {name} "
              f"{list(want[name].shape)} vs the compact sub-model's: max abs "
              f"err {e[0]:.3g} (rel {e[1]:.3g}, tolerance {MM_RTOL})")
    res[3].clear()
    del sub, want, res, small
    gc.collect()
    torch.cuda.empty_cache()

    tag = "mla serve"
    prompts = torch.as_tensor(sample_prompts(cfg, MLA_SB, MLA_SS, seed=0)[0],
                              dtype=torch.long).to(dev)
    serve_generate(tag, model, params, prompts, MLA_SG, _build)
    roomy_model = build_model(roomy(cfg))
    check_teacher_forced(tag, roomy_model, params, prompts, MLA_SS - MLA_TF)
    _, _, launches = serve_continuous(tag, roomy_model, params, _build,
                                      n=MLA_REQS, prompts=MLA_PROMPTS)
    reqs, rec, _ = serve_continuous(tag, roomy_model, params, _build,
                                    record=True, n=MLA_REQS,
                                    prompts=MLA_PROMPTS)
    check(launches == {}, f"[{tag}] kernel launches {launches}")
    check_single_requests(tag, roomy_model, params, reqs, rec)
    del model, roomy_model, params, rec, batch, prompts
    gc.collect()
    torch.cuda.empty_cache()
    total = {}
    for _, launches in parts.values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_family_eval_serve(dev, _build, key, arch):
    """``[{key} eval]`` and ``[{key} serve]`` on a whole model (random
    weights from seed 0, f32): MusicGen-large (``audio``: 4 codebooks,
    sinusoidal positions) or Phi-3-vision (``vlm``: 256 patches ahead of
    the tokens).  Eval: ``Model.loss`` on 4 held-out sequences of 2048
    positions (MusicGen: 2048 x 4 codebook tokens; Phi-3-vision: 256
    patches + 1792 tokens) with and without ``REPRO_USE_FLASH`` (row 13 at
    G = 1, head_dim 64 or 96), the two within EVAL_RTOL.  Serving:
    ``serve.generate`` of FAM_SG greedy tokens after FAM_SB prompts of
    FAM_SS positions, then prefill 480 positions + FAM_TF teacher-forced
    decode steps against one prefill of 512.  Returns the eval's
    launches."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    tag = f"{key} eval"
    cfg = zoo_config(arch)
    model = build_model(cfg)
    params = model.init(seed=0, device=dev)
    n = sum(v.numel() for v in params.values())
    P = cfg.vision_patches if cfg.vision_stub else 0
    vision = (P, cfg.vision_d) if P else None
    batch = _batch_on(next(lm_batches(cfg.vocab, (EB,), ES - P, seed=999,
                                      codebooks=cfg.n_codebooks,
                                      vision=vision)), dev)
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers (whole), {n:,} params "
          f"({4 * n / 1e9:.1f} GB f32); held-out "
          f"{ {k: list(v.shape) for k, v in batch.items()} } (seed 999)")
    parts = _eval_parts(tag, [
        (f"{key} server, flash", lambda: batch_loss(model, params, batch,
                                                    flash=True)),
        (f"{key} server, blockwise", lambda: batch_loss(model, params,
                                                        batch))], _build)
    check(parts[f"{key} server, flash"][1] == {"flash_attention":
                                               cfg.n_layers}
          and parts[f"{key} server, blockwise"][1] == {},
          f"[{tag}] launches {parts}")
    _flash_agrees(tag, parts, f"{key} server, flash",
                  f"{key} server, blockwise")
    del batch
    gc.collect()
    torch.cuda.empty_cache()

    tag = f"{key} serve"
    prompts, extra = sample_prompts(cfg, FAM_SB, FAM_SS - P, seed=0)
    prompts = torch.as_tensor(prompts, dtype=torch.long).to(dev)
    if extra is not None:
        extra = {k: torch.as_tensor(v).to(dev) for k, v in extra.items()}
    serve_generate(tag, model, params, prompts, FAM_SG, _build, extra)
    seq = prompts[:, :512 - P]
    check_teacher_forced(tag, model, params, seq, seq.shape[1] - FAM_TF,
                         extra)
    del model, params, prompts, extra, seq
    gc.collect()
    torch.cuda.empty_cache()
    return parts[f"{key} server, flash"][1]


# -- phase 4e: the paper's protocol ---------------------------------------------

PAPER_SCHEMES = ("rolling", "random", "static", "full")
PAPER_ROUNDS = 5


def phase_paper_path(dev, _build):
    """The paper's §5 protocol at full width: pre-act ResNet18 (stages 2,
    2, 2, 2, width 64, 32 x 32 x 3, 10 classes), 100 clients with 2 labels
    each, 10 taking part a round, the HeteroFL capacity mix, K = 2, 32
    images a step, SyntheticCIFAR with 50 000 train and 10 000 test
    images; 5 rounds of each scheme, evaluated on the last.  A round's
    seconds run from one batch handed to the Trainer to the next (the
    round's device work and the next batch's assembly on the host, to a
    synchronize).  ResNet18 has 56 leaves (1 stem, 8 blocks x 6, 3
    projections, the final BN's 2 and fc's 2).  Returns the launches over
    all schemes' rounds."""
    from repro_torch.configs.resnet18_cifar import CAPACITY_BETAS, CONFIG
    from repro_torch.core.paper_protocol import PaperExperiment
    from repro_torch.data.federated import FederatedDataset
    leaves, n_test = 56, 10_000
    total = {}
    t0 = time.perf_counter()
    exp = PaperExperiment(n_clients=100, participate=10,
                          partition="label", labels_per_client=2,
                          capacities=CAPACITY_BETAS, k_steps=2, mb=32,
                          n_train=50_000, n_test=n_test, rcfg=CONFIG,
                          device=dev)
    setup_s = time.perf_counter() - t0
    # the data and the split are made once; every scheme draws its clients
    # and batches afresh from the seed, as a new experiment would
    parts = exp.fed_data.parts
    orig = exp._round_batches
    for scheme in PAPER_SCHEMES:
        exp.fed_data = FederatedDataset(exp.data.train, parts, seed=exp.seed)
        stamps = []

        def stamped(scheme, uniform_cap, orig=orig, stamps=stamps):
            for item in orig(scheme, uniform_cap):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                yield item

        exp._round_batches = stamped
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        r = exp.run(scheme, rounds=PAPER_ROUNDS, eval_every=0)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        secs = np.diff(stamps).tolist()
        per = {k: launches.get(k, 0) / PAPER_ROUNDS
               for k in ("masked_sgd_inplace", "fillin_agg_inplace")}
        n_leaves = len(exp.make_fed(scheme).abstract)
        check(n_leaves == leaves and per == {
            "masked_sgd_inplace": 2 * leaves, "fillin_agg_inplace": leaves},
              f"paper {scheme}: {n_leaves} leaves, launches a round {per}")
        fin, gap = r["final"], r["gap"]
        check(all(math.isfinite(v) for v in (fin["train_loss"],
                                             fin["test_loss"],
                                             gap["loss_gap"])),
              f"paper {scheme}: non-finite results {fin} {gap}")
        print(f"[paper] {scheme}: seconds per round {secs} (rounds 0-3); "
              f"after the first {float(np.mean(secs[1:])):.4f} s; run "
              f"{run_s:.2f} s with the {n_test}-image eval and the gap; data "
              f"and clients {setup_s:.2f} s (made once for every scheme)")
        print(f"[paper] {scheme}: train loss {fin['train_loss']:.5f}, test "
              f"loss {fin['test_loss']:.5f}, test acc {fin['test_acc']:.4f}, "
              f"gap loss {gap['loss_gap']:+.5f} acc {gap['acc_gap']:+.4f}; "
              f"peak memory allocated {peak / 2**30:.2f} GiB; launches a "
              f"round {per}")
        if scheme == "rolling":       # one more round, profiled
            from repro_torch import api
            trainer = api.Trainer(exp.make_fed(scheme),
                                  exp.init_params()[0], rng=exp.seed + 1)
            items = exp._round_batches(scheme, None)
            trainer.run(items, 1)
            phase_profile("paper", trainer, next(items),
                          float(np.mean(secs[1:])))
            del trainer, items
        del r
        gc.collect()
    del exp
    gc.collect()
    torch.cuda.empty_cache()
    return total


def phase_experiment_cli(dev):
    """``repro_torch.launch.experiment`` on the card, 3 rounds: the three
    tracks through the CLI's entry point."""
    from repro_torch.launch import experiment
    out = CKPT_DIR / "experiment.json"
    try:
        t0 = time.perf_counter()
        rec = experiment.main(["--rounds", "3", "--device", dev.type,
                               "--out", str(out)])
        secs = time.perf_counter() - t0
        check(out.exists(), "the experiment CLI wrote no results file")
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    check(sorted(rec) == sorted(experiment.metric_names()),
          f"experiment records {sorted(rec)}")
    check(rec["stability_finite"] == 1 and rec["thm1_bound_holds"] == 1,
          f"experiment: stability_finite {rec['stability_finite']}, "
          f"thm1_bound_holds {rec['thm1_bound_holds']}")
    print(f"[experiment] 3 rounds in {secs:.1f} s: stability_finite 1, "
          f"thm1_bound_holds 1 (excess {rec['thm1_excess']} <= bound "
          f"{rec['thm1_bound']}); shuffled_beats_random "
          f"{rec['shuffled_beats_random']} (torch's draws: a sample, not "
          "held)")


# -- bf16 parameters (ROADMAP A11, part 1): the bf16 arms of rows 1-11 -------

BF = torch.bfloat16
# bf16 rounds, card vs CPU and extract vs fused on the card: the two sides
# round the same f32 sums to bf16 in other orders, and a round changes most
# weights by a few bf16 ulp, so ulp-level differences stay.  The params are
# held by their change from the starting params (bf16_change_stats), where
# params that did not move read a gap of 1 and a cosine of 0.  Reduced
# rounds (``[agree bf16]``): the gap |got - want| / |want - p0| within
# BF16_GAP over all leaves and for each leaf moved in BF16_LEAF_MOVED
# elements or more (tests/test_torch_bf16.py's limits against the reference,
# which measured 0.037-0.059 and at most 0.20 there).  At full width the
# products' rounding differences grow through 22 layers' backward, where most
# weights' steps are under half a bf16 ulp: extract vs fused measured a gap
# of 0.527 over all leaves and up to 0.93 for a leaf (f32: 3e-4) with the
# changes still aligned (cosine 0.861 over all leaves, at least 0.567 for a
# leaf, norm ratios 0.985-1.009), so ``[bf16 extract]`` holds the cosine to
# BF16_COS and the norm ratio to BF16_RATIO instead.  Client losses within
# BF16_LOSS_TOL, absolute (the reference's bf16 atol,
# tests/test_kernels.py:18).
BF16_LEAF_MOVED = 1000
BF16_GAP = (0.15, 0.4)        # (all leaves, each leaf): at most
BF16_COS = (0.7, 0.4)         # (all leaves, each leaf): at least
BF16_RATIO = (0.8, 1.25)      # every leaf's and all leaves' |got-p0|/|want-p0|
BF16_LOSS_TOL = 2e-2
# full-width bf16 serving: prompts and greedy steps
BF16_SERVE_B, BF16_SERVE_S, BF16_SERVE_G = 4, 1536, 32


def bf16_change_stats(got, want, p0):
    """How ``got``'s change from ``p0`` compares with ``want``'s (float32 on
    got's device, leaf by leaf): the gap ``|got - want| / |want - p0|``,
    the cosine of the two changes and their norm ratio ``|got - p0| /
    |want - p0|`` (Euclidean norms), each over all leaves together and as
    the (smallest, largest) over the leaves that ``want`` moved in
    BF16_LEAF_MOVED elements or more; and the largest ``|got - want|`` of
    an element.  Params that did not move read gap 1, cosine 0, ratio 0."""
    num = den = gg = gw = big = 0.0
    leaves = []
    for k, g in got.items():
        g = g.float()
        w, z = want[k].to(g.device).float(), p0[k].to(g.device).float()
        dg, dw = g - z, w - z
        d2, r2 = float(((g - w) ** 2).sum()), float((dw ** 2).sum())
        g2, gw1 = float((dg ** 2).sum()), float((dg * dw).sum())
        num, den, gg, gw = num + d2, den + r2, gg + g2, gw + gw1
        if int((w != z).sum()) >= BF16_LEAF_MOVED:
            leaves.append((math.sqrt(d2 / r2),
                           gw1 / math.sqrt(g2 * r2) if g2 else 0.0,
                           math.sqrt(g2 / r2)))
        big = max(big, float((g - w).abs().max()))
    span = [(min(c), max(c)) for c in zip(*leaves)]
    return dict(gap=(math.sqrt(num / den), *span[0]),
                cos=(gw / math.sqrt(gg * den) if gg else 0.0, *span[1]),
                ratio=(math.sqrt(gg / den), *span[2]), big=big)


def check_bf16_rounds(tag, losses, want_losses, params, want, p0,
                      hold="gap", cos_min=BF16_COS):
    """Losses within BF16_LOSS_TOL and the params' change against
    ``want``'s (bf16_change_stats): ``hold="gap"`` within BF16_GAP,
    ``"cos"`` at ``cos_min`` (all leaves, each leaf; BF16_COS) or above
    with every norm ratio in BF16_RATIO.  Prints the stats; returns them
    with the largest loss difference."""
    dl = max(abs(a - b) for a, b in zip(losses, want_losses))
    st = bf16_change_stats(params, want, p0)
    gap, cos, ratio = st["gap"], st["cos"], st["ratio"]
    if hold == "gap":
        ok = gap[0] <= BF16_GAP[0] and gap[2] <= BF16_GAP[1]
        rule = f"gap at most {BF16_GAP} (all leaves, each leaf)"
    else:
        ok = (cos[0] >= cos_min[0] and cos[1] >= cos_min[1] and
              BF16_RATIO[0] <= min(ratio) and max(ratio) <= BF16_RATIO[1])
        rule = (f"cosine at least {cos_min} (all leaves, each leaf), "
                f"norm ratios within {BF16_RATIO}")
    said = (f"losses max |d| {dl:.3g} (tolerance {BF16_LOSS_TOL}); the "
            f"params' change against the other side's: gap {gap[0]:.4g} over "
            f"all leaves, {gap[1]:.4g}-{gap[2]:.4g} a leaf; cosine "
            f"{cos[0]:.4g}, {cos[1]:.4g}-{cos[2]:.4g}; norm ratio "
            f"{ratio[0]:.4g}, {ratio[1]:.4g}-{ratio[2]:.4g} (held: {rule}; "
            f"unmoved params read gap 1, cosine 0, ratio 0); max |d param| "
            f"{st['big']:.3g}")
    check(dl <= BF16_LOSS_TOL and ok, f"[{tag}] {said}")
    return said


def phase_kernels_bf16(dev):
    """The bf16 arms of TPU rows 1-13 on the card (rows 12 and 13:
    ``ssd_bf16_rows``, ``flash_bf16_rows``): rows 1-8 within one
    bf16 ulp of their plain versions (``bf16_err``) at ragged shapes and
    odd offsets (the element-by-element copy path), then held and timed at
    the bf16 paths' shapes (rows 5-8 at the window round's, 1-4 at the
    eval's) beside ``bmm``/``mm`` on the bf16 window views and the bound at
    the dense bf16 rate; rows 9-11 bit for bit on the ``w_gate`` leaf (and
    ragged, misaligned and in place on views), timed beside ``add_`` /
    ``addcmul_`` on bf16 and their byte bounds.  Each row is named
    ``<kernel>/bf16``, as its launches count."""
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels.masked_update import cost as update_cost
    from repro_torch.kernels import ref
    from repro_torch.kernels.masked_update import (fillin_agg_, masked_sgd_,
                                                   sgd_)
    from repro_torch.kernels.rolling_matmul import (make_offsets,
                                                    rolling_mm_dx,
                                                    rolling_mm_fwd)
    g = torch.Generator(dev).manual_seed(24)
    worst = 0.0
    # EXTRA, a window of 50 at odd offsets (the mma.sync body), and a
    # ragged contraction and window at offsets of 8k (the wgmma body: dx's
    # last stage of each weight 56 columns wide)
    cases = EXTRA + [(3, 70, 100, 130, 50, [0, 33, 77]),
                     (3, 200, 1000, 776, 120, [0, 64, 656])]
    for (c, m, k, n, win, offs) in cases:
        for T in (1, 2):
            x = torch.randn((c, m, k), device=dev, generator=g).to(BF)
            ws = [torch.randn((c, k, n), device=dev, generator=g).to(BF)
                  for _ in range(T)]
            dys = [torch.randn((c, m, win), device=dev, generator=g).to(BF)
                   for _ in range(T)]
            o = make_offsets(offs, dev)
            es = [bf16_err(y, yr) for y, yr in zip(
                rolling_mm_fwd(x, ws, o, win),
                ref.rolling_matmul_batched_ref(x, ws, offs, win))]
            es.append(bf16_err(rolling_mm_dx(dys, ws, o, win),
                               ref.rolling_matmul_batched_dx_ref(
                                   dys, ws, offs, win)))
            for e in es:
                check(e[2] <= 0, f"bf16 <{T}> {(c, m, k, n, win, offs)}: "
                      f"{e}")
                worst = max(worst, e[0])
    print(f"[kernels bf16] {5 * len(cases)} ragged / "
          f"odd-offset product checks (both bodies) within {BF16_TOL} "
          f"(largest |d| {worst:.3g})")

    rows = []
    for name, row, tpu_fn, T, N, win, off, kind in ROLLING:
        r = product_timing(dev, g, kind, T, C, M, N, win, off, dtype=BF)
        rows.append(dict(name=name + "/bf16", route="cuda",
                         source=SRC + "rolling_mm.cu",
                         replaces=TPU + tpu_fn, tpu_row=row, **r))
        if row in (5, 6):      # the k/v projections: window 128 of 256
            rows[-1]["sub_rows"] = [product_timing(
                dev, g, kind, T, C, M, 256, 128, 128, dtype=BF)]
            # the SSM and hybrid rounds' narrow windows (the dt windows on
            # the mma.sync body: offsets 12 and 25 are no 16-byte vector)
            rows[-1]["sub_rows"] += [
                {"tag": tag, **product_timing(dev, g, kind, 1, C, m, N_, w, o,
                                              K=K, dtype=BF)}
                for tag, T_, m, K, N_, w, o in SLICE_ROWS
                if tag in ("mamba2 dt", "hymba dt", "hymba q", "hymba k/v")]
        # the bf16 zoo rounds' shapes: MLA's per-head up-projections (rows
        # 5-6) and one client's lane of Mixtral's experts (rows 7-8: its
        # window of 4 experts in the kernel's leading dimension).  The
        # lane's dx sums 2 x 8192 products an element: there the f32 sums
        # of two orders part by more than 1e-6 of the largest output (by
        # 3.2e-4 past one ulp + 1e-6 of 672 on an H100 80GB HBM3), so its
        # slack is the f32 arms' tolerance for another order, MM_RTOL, as
        # rows 12-13's is
        rows[-1].setdefault("sub_rows", []).extend(
            {"tag": tag, **product_timing(
                dev, g, kind, T_, c, m, N_, w, o, K=K, dtype=BF,
                slack=MM_RTOL if tag.startswith("mixtral") else 1e-6)}
            for tag, T_, c, m, K, N_, w, o in ZOO_ROWS
            if T_ == T and tag in ("mla w_uq", "mla w_uk/w_uv",
                                   "mixtral experts, a client"))
    for name, row, tpu_fn, T, m, N, win, off, kind in SCALAR:
        r = product_timing(dev, g, kind, T, 1, m, N, win, off,
                           scalar_name=name, dtype=BF)
        rows.append(dict(name=name + "/bf16", route="cuda",
                         source=SRC + "rolling_mm.cu",
                         replaces=TPU + tpu_fn, tpu_row=row, **r))

    n = C * D * 5632           # the w_gate client leaf
    w = torch.randn(n + 8, device=dev, generator=g).to(BF)
    m = (torch.rand(n + 8, device=dev, generator=g) < 0.5).to(BF)
    gr = torch.randn(n + 8, device=dev, generator=g).to(BF)
    for kind in ("sgd", "masked_sgd"):
        def step(wv, mo, go, size, lr=0.1, kind=kind):
            if kind == "sgd":
                return sgd_(wv, gr[go:go + size], lr)
            return masked_sgd_(wv, m[mo:mo + size], gr[go:go + size], lr)

        def plain(wv, mo, go, size, lr=0.1, kind=kind):
            if kind == "sgd":
                return ref.sgd_ref(wv, gr[go:go + size], lr)
            return ref.masked_sgd_ref(wv, m[mo:mo + size], gr[go:go + size],
                                      lr)
        # aligned; a ragged leaf; in place on views with one shared odd
        # misalignment (a scalar head) and with mismatched ones
        for wo, mo, go, size in ((0, 0, 0, n), (0, 0, 0, 1_000_003),
                                 (1, 1, 1, n - 2), (3, 3, 3, 1_000_001),
                                 (1, 2, 2, n - 2)):
            want = plain(w[wo:wo + size].clone(), mo, go, size)
            a = w.clone()[wo:wo + size]
            step(a, mo, go, size)
            check(bits_equal(a, want), f"{kind}_inplace/bf16 not bit-exact "
                  f"at w+{wo}, m+{mo}, g+{go}, {size}")
    w, m, gr = w[:n], m[:n], gr[:n]
    for name, row, tpu_fn, kern, pl, lib, n_cost in (
            ("sgd_inplace", 10, "masked_update.py:53",
             lambda: sgd_(w, gr, 1e-6), lambda: ref.sgd_ref(w, gr, 1e-6),
             lambda: w.add_(gr, alpha=-1e-6), update_cost("sgd", n, BF)),
            ("masked_sgd_inplace", 9, "masked_update.py:33",
             lambda: masked_sgd_(w, m, gr, 1e-6),
             lambda: ref.masked_sgd_ref(w, m, gr, 1e-6),
             lambda: w.addcmul_(m, gr, value=-1e-6),
             update_cost("masked_sgd", n, BF))):
        b_ms, b_by = bound_ms(*n_cost)
        k_ms = cuda_ms(kern)
        rows.append(dict(
            name=name + "/bf16", route="cuda",
            source=SRC + ("sgd.cu" if row == 10 else "masked_update.cu"),
            replaces=TPU + tpu_fn, tpu_row=row, shape={"w": [C, D, 5632]},
            max_abs_err=0.0, max_rel_err=0.0, tolerance=0.0, ms=k_ms,
            kernel_ms=k_ms, plain_ms=cuda_ms(pl), library_ms=cuda_ms(lib),
            library_calls=1, bound_ms=b_ms, bound_by=b_by))
    del w, m, gr

    ns = D * 5632              # the w_gate server leaf
    w = torch.randn(ns + 1, device=dev, generator=g).to(BF)
    for c in (3, 4):
        wc = torch.randn((c, ns), device=dev, generator=g).to(BF)
        mc = (torch.rand((c, ns), device=dev, generator=g) < 0.5).to(BF)
        for slr in (1.0, 0.5):
            for lo, size in ((0, ns), (1, 1_000_003)):
                cw, cm = wc[:, :size].contiguous(), mc[:, :size].contiguous()
                a = fillin_agg_(w[lo:lo + size].clone(), cw, cm, slr)
                b = ref.fillin_agg_ref(w[lo:lo + size].clone(), cw, cm,
                                       slr / c)
                check(bits_equal(a, b), f"fillin_agg_inplace/bf16 not "
                      f"bit-exact at C={c} server_lr={slr} {lo}+{size}")
    print("[kernels bf16] update arms bit-exact to their plain versions "
          "(aligned, ragged, in place on views with shared odd and "
          "mismatched misalignments; fill-in C in {3, 4}, server_lr in "
          "{1, 0.5}, client strides of 8k and 8k + 3 elements)")
    w = w[:ns]
    b_ms, b_by = bound_ms(*update_cost("fillin", ns, BF, clients=C))
    k_ms = cuda_ms(lambda: fillin_agg_(w, wc, mc, 1.0))
    rows.append(dict(
        name="fillin_agg_inplace/bf16", route="cuda",
        source=SRC + "masked_update.cu", replaces=TPU + "masked_update.py:79",
        tpu_row=11, shape={"w": [D, 5632], "w_c": [C, D, 5632]},
        max_abs_err=0.0, max_rel_err=0.0, tolerance=0.0, ms=k_ms,
        kernel_ms=k_ms,
        plain_ms=cuda_ms(lambda: ref.fillin_agg_ref(w, wc, mc, 1.0 / C)),
        library_ms=None, library_calls=0, bound_ms=b_ms, bound_by=b_by))
    del w, wc, mc
    rows += ssd_bf16_rows(dev, g) + flash_bf16_rows(dev, g)
    for r in rows:
        for sub in [r, *r.get("sub_rows", [])]:
            lib = ("none" if sub["library_ms"] is None
                   else f"{sub['library_ms']:.4f} ms")
            more = "".join((
                f" (device {sub['device_ms']:.4f} ms)"
                if "device_ms" in sub else "",
                f"; the 3xTF32-P bound {sub['bound_3xtf32_p_ms']:.4f} ms"
                if "bound_3xtf32_p_ms" in sub else "",
                f"; body {sub['body']}, tile {sub['block_tile']}"
                if "body" in sub else ""))
            tag = f"{sub['tag']}: " if "tag" in sub else ""
            print(f"[kernels bf16] {r['name']:28s} {tag}"
                  f"{json.dumps(sub['shape'])} err {sub['max_abs_err']:.3g} "
                  f"kernel {sub['ms']:.4f} ms  plain "
                  f"{sub['plain_ms']:.4f} ms  library {lib}  bound "
                  f"{sub['bound_ms']:.4f} ms ({sub['bound_by']}){more}")
    return rows


# row 12's bf16 arm (tag, Bt, nc, Q, nh, hd, N, head_offset, head_win, odd
# strides); the first is one layer of the Mamba2 prefill (8 x 32768, chunk
# 256), timed, the second one of Hymba's (4 x 2048, 50 heads, N 16, chunk
# 128), timed as a sub-row
SSD_BF16 = [
    ("Mamba2 prefill layer", 8, 128, 256, 24, 64, 128, None, 0, False),
    ("Hymba prefill layer", 4, 16, 128, 50, 64, 16, None, 0, False),
    ("odd head offset (5, 7)", 2, 4, 256, 24, 64, 128, 5, 7, False),
    ("Hymba odd offset (25, 13), Q = 100", 2, 4, 100, 50, 64, 16, 25, 13,
     False),
    ("odd strides, offset (3, 9)", 2, 4, 256, 24, 64, 128, 3, 9, True),
]
# row 13's bf16 arm, checked only (B, S, H, KV, hd, window, odd strides):
# ragged lengths, Hymba's 25 on 5 heads, head_dim 128 (q staged in shared
# memory), Phi-3-vision's head_dim 96, views at odd strides (the
# element-by-element copies)
FLASH_BF16 = [(2, 1000, 32, 4, 64, 0, False),
              (1, 777, 25, 5, 64, 512, True),
              (2, 300, 6, 2, 128, 0, True),
              (1, 500, 8, 8, 96, 0, True)]


def odd_view(t):
    """``t`` in a buffer one element longer along the last axis, viewed
    back: the same values at odd strides (no 16-byte rows)."""
    buf = torch.zeros((*t.shape[:-1], t.shape[-1] + 1), dtype=t.dtype,
                      device=t.device)
    view = buf[..., :t.shape[-1]]
    view.copy_(t)
    return view


def ssd_bf16_rows(dev, g):
    """Row 12's bf16 arm (``ssd_chunk_intra/bf16``): x, dt, B and C bf16, A
    float32, against the plain version on the same inputs at SSD_BF16's
    cases, y within one bf16 ulp plus MM_RTOL of its largest magnitude
    (``bf16_err``), the float32 states within MM_RTOL, a second launch
    bit-equal at each; timed at the Mamba2 and Hymba prefill layers
    (``cuda_ms`` and the profiler's ``device_ms``) beside the plain version
    (no library call computes the block) and the bound of this design's
    work: the bytes at bf16 (f32 A and states), C B^T in one bf16 pass and
    M x and the state in two (their f32 weights' two parts), all at the
    dense bf16 rate.  A line of its own prints the bytes the design moves
    once and the bound of the widened design before it (M x and the state
    at the 3xTF32 rate); neither goes into the kernels line.  The profiler
    gives no DRAM bytes: the kernel's HBM traffic is not measured."""
    from repro_torch.analysis.roofline import PEAK_FLOPS, bound_ms
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_chunk import ssd_chunk_intra
    row, subs = None, []
    for tag, Bt, nc, Q, nh, hd, N, off, win, odd in SSD_BF16:
        x, dt, A, B, C = ssd_inputs(dev, g, Bt, nc, Q, nh, hd, N)
        x, dt, B, C = (t.to(BF) for t in (x, dt, B, C))
        if odd:
            x, dt, B, C = (odd_view(t) for t in (x, dt, B, C))
        hs = slice(off or 0, (off or 0) + (win or nh))
        kern = lambda: ssd_chunk_intra(x, dt, A, B, C,  # noqa: E731
                                       head_offset=off, head_win=win)
        plain = lambda: ref.ssd_chunk_intra_ref(  # noqa: E731
            x[..., hs, :], dt[..., hs], A[hs], B, C)
        (y, s), (yr, sr) = kern(), plain()
        ey, es = bf16_err(y, yr, MM_RTOL), err(s, sr)
        check(s.dtype == torch.float32 and ey[2] <= 0 and es[1] <= MM_RTOL,
              f"ssd_chunk_intra/bf16 {tag}: y {ey}, states {es}")
        del yr, sr
        y2, s2 = kern()
        check(bits_equal(y, y2) and bits_equal(s, s2),
              f"ssd_chunk_intra/bf16 {tag}: two launches differ")
        del y, s, y2, s2
        print(f"[kernels bf16] ssd {tag:36s} x {[Bt, nc, Q, nh, hd]} N {N} "
              f"heads [{hs.start}, {hs.stop}): y max abs err {ey[0]:.3g} "
              f"(rel {ey[1]:.3g}), states rel {es[1]:.3g}, a second launch "
              f"bit-equal")
        if len(subs) < 2 and not odd and off is None:
            pairs = Q * (Q + 1) // 2
            f_bf16 = Bt * nc * 2 * pairs * N
            f_rest = Bt * nc * nh * (2 * pairs * hd + 2 * Q * hd * N)
            nbytes = (2 * (2 * Bt * nc * Q * nh * hd + Bt * nc * Q * nh
                           + 2 * Bt * nc * Q * N)
                      + 4 * (nh + Bt * nc * nh * hd * N))
            # this design: C B^T in one bf16 pass, M x and the state in
            # two; the widened design's: C B^T at the bf16 rate, the rest in
            # 3xTF32
            from repro_torch.kernels.ssd_chunk import cost
            b_ms, b_by = bound_ms(*cost(Bt, nc, Q, nh, hd, N, BF))
            old_ms, _ = bound_ms(
                f_rest + f_bf16 * PEAK_FLOPS["tf32x3"]
                / PEAK_FLOPS["bfloat16"], nbytes, "tf32x3")
            k_ms = cuda_ms(kern)
            d_ms = device_ms(kern)
            print(f"[kernels bf16] ssd {tag}: {nbytes / 1e9:.3f} GB moved "
                  f"once by the design (x and y, the f32 states, B, C, "
                  f"dt); HBM bytes not measured (no DRAM counters in the "
                  f"profiler); {nbytes / 1e9 / d_ms:.3f} TB/s at its "
                  f"device time; the widened design's 3xTF32 bound "
                  f"{old_ms:.4f} ms")
            subs.append(dict(
                tag=tag, shape={"x": [Bt, nc, Q, nh, hd], "B": [Bt, nc, Q, N]},
                max_abs_err=max(ey[0], es[0]), max_rel_err=max(ey[1], es[1]),
                tolerance=BF16_TOL_1213, ms=k_ms, kernel_ms=k_ms,
                device_ms=d_ms,
                plain_ms=cuda_ms(plain, iters=3, warmup=1), library_ms=None,
                library_calls=0, bound_ms=b_ms, bound_by=b_by,
                bound_rate="C B^T in one bf16 pass, M x and the state in "
                           "two, at 989 TFLOP/s; bytes at bf16, f32 states"))
        del x, dt, A, B, C
    row = dict(name="ssd_chunk_intra/bf16", route="cuda",
               source=SRC + "ssd_chunk.cu", replaces=TPU + "ssd_chunk.py:58",
               tpu_row=12, **{k: v for k, v in subs[0].items() if k != "tag"})
    row["sub_rows"] = subs[1:]
    return [row]


def flash_bf16_timing(dev, g, B, S, H, KV, hd, window=0):
    """Row 13's bf16 arm at one causal (``window`` > 0: sliding-window)
    shape: held against its plain version within one bf16 ulp plus
    MM_RTOL of the largest output, a second launch bit-equal, timed beside
    the plain version, one bf16 ``scaled_dot_product_attention`` (timed
    only; it rounds P to bf16 for P V, less precise work than the kernel's
    two-part P) and the bound of this design's work: the bytes at bf16, q
    k^T and P V's two bf16 passes at the dense bf16 rate; beside it PR
    25's bound (P V in 3xTF32)."""
    from repro_torch.analysis.roofline import PEAK_FLOPS, bound_ms
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (cost, flash_attention,
                                                     visible_pairs)
    q = torch.randn((B, S, H, hd), device=dev, generator=g).to(BF)
    k = torch.randn((B, S, KV, hd), device=dev, generator=g).to(BF)
    v = torch.randn((B, S, KV, hd), device=dev, generator=g).to(BF)
    kern = lambda: flash_attention(q, k, v, window=window)           # noqa
    plain = lambda: ref.flash_attention_ref(q, k, v, window=window)  # noqa
    out = kern()
    e = bf16_err(out, plain(), MM_RTOL)
    shape = {"q": [B, S, H, hd], "kv": [B, S, KV, hd], "causal": True,
             "window": window}
    check(e[2] <= 0, f"flash_attention/bf16 at {shape}: {e}")
    check(bits_equal(out, kern()),
          f"flash_attention/bf16 at {shape}: two launches differ")
    del out
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window:
        i = torch.arange(S, device=dev)
        mask = (i[:, None] >= i[None, :]) & (i[:, None] - i[None, :] < window)
        lib = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa: E731
                           enable_gqa=True)
    else:
        lib = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa: E731
                           enable_gqa=True)
    pairs = visible_pairs(S, S, True, window)
    f_qk = f_pv = 2 * B * H * hd * pairs
    nbytes = 2 * (2 * B * S * H * hd + 2 * B * S * KV * hd)
    # the work of this design: q k^T and P V as two bf16 passes (P's two
    # parts), all at the dense bf16 rate; the design before it kept P V
    # in 3xTF32
    b_ms, b_by = bound_ms(*cost(B, S, S, H, KV, hd, True, window, BF))
    old_ms, _ = bound_ms(f_pv + f_qk * PEAK_FLOPS["tf32x3"]
                         / PEAK_FLOPS["bfloat16"], nbytes, "tf32x3")
    k_ms = cuda_ms(kern)
    return dict(
        shape=shape, max_abs_err=e[0], max_rel_err=e[1],
        tolerance=BF16_TOL_1213, ms=k_ms, kernel_ms=k_ms,
        device_ms=device_ms(kern), plain_ms=cuda_ms(plain, iters=5),
        library_ms=cuda_ms(lib), library_calls=1,
        library_note="SDPA rounds P to bf16 for P V",
        bound_ms=b_ms, bound_by=b_by,
        bound_rate="q k^T and P V's two bf16 passes at 989 TFLOP/s; bytes "
                   "at bf16",
        bound_3xtf32_p_ms=old_ms)


def flash_bf16_rows(dev, g):
    """Row 13's bf16 arm (``flash_attention/bf16``): checked at FLASH_BF16's
    ragged, odd-stride and head_dim-128 cases, then timed
    (``flash_bf16_timing``) at TinyLlama's eval shape, q [4, 2048, 32, 64],
    at head_dim 128, at Hymba's eval (25 on 5 heads, window 1024) and at
    Phi-3-vision's (32 on 32 heads of 96: the ``case 96`` instance)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    for B, S, H, KV, hd, window, odd in FLASH_BF16:
        q = torch.randn((B, S, H, hd), device=dev, generator=g).to(BF)
        k = torch.randn((B, S, KV, hd), device=dev, generator=g).to(BF)
        v = torch.randn((B, S, KV, hd), device=dev, generator=g).to(BF)
        if odd:
            q, k, v = (odd_view(t) for t in (q, k, v))
        e = bf16_err(flash_attention(q, k, v, window=window),
                     ref.flash_attention_ref(q, k, v, window=window),
                     MM_RTOL)
        case = (B, S, H, KV, hd, window, odd)
        check(e[2] <= 0, f"flash_attention/bf16 {case}: {e}")
        print(f"[kernels bf16] flash q {[B, S, H, hd]} kv heads {KV} window "
              f"{window}{' odd strides' if odd else ''}: max abs err "
              f"{e[0]:.3g} (rel {e[1]:.3g})")
    row = dict(name="flash_attention/bf16", route="cuda",
               source=SRC + "flash_attn.cu",
               replaces=TPU + "flash_attention.py:88", tpu_row=13,
               **flash_bf16_timing(dev, g, EB, ES, 32, 4, 64))
    row["sub_rows"] = [flash_bf16_timing(dev, g, EB, ES, 32, 8, 128),
                       {"tag": "hymba eval", **flash_bf16_timing(
                           dev, g, HB, HS, 25, 5, 64, window=1024)},
                       {"tag": "phi-3-v eval, hd 96", **flash_bf16_timing(
                           dev, g, EB, ES, 32, 32, 96)}]
    return [row]


def phase_small_agreement_bf16(dev):
    """Reduced TinyLlama at bf16, card vs CPU from the same bf16 params,
    tokens, offsets and masks: 2 fused window rounds, 2 extract rounds and
    2 Bernoulli mask rounds with client momentum (masks drawn on the CPU
    and copied); losses and the params' change from the start as
    ``check_bf16_rounds`` holds them, params bf16 on both sides."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core.fedavg import dense_client_masks
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = get_reduced_config("tinyllama_1_1b")
    model = build_model(cfg, param_dtype=BF)
    p0 = model.init(0, device="cpu")
    it = lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0)
    batches = [next(it) for _ in range(2)]
    cases = (("window", scfg_for("rolling"), {}),
             ("extract", scfg_for("rolling"), dict(fused_forward="off")),
             ("mask momentum", scfg_for("bernoulli"),
              dict(client_opt="momentum")))
    for tag, scfg, kw in cases:
        outs = {}
        fed0 = api.fed_round(model, scfg, device="cpu", **kw)
        if isinstance(fed0, api.MaskFedAvg):
            inj = [{"masks": dense_client_masks(
                torch.Generator().manual_seed(r), fed0.abstract, fed0.axes,
                scfg, fed0.capacities, r, torch.device("cpu"))}
                for r in range(2)]
        else:
            inj = [{"offsets": fed0.scheme.offsets(r, 4)} for r in range(2)]
        for where in ("cpu", dev):
            fed = api.fed_round(model, scfg, device=where, **kw)
            t = api.Trainer(fed, {k: v.to(where, copy=True)
                                  for k, v in p0.items()})
            t.run(((b, {k: ({n: x.to(where) for n, x in v.items()}
                            if k == "masks" else v) for k, v in i.items()})
                   for b, i in zip(batches, inj)), 2)
            outs[str(where)] = t
        c, gpu = outs["cpu"], outs[str(dev)]
        check(all(v.dtype == BF for v in gpu.params.values()),
              f"bf16 {tag}: params left bf16")
        said = check_bf16_rounds(
            f"agree bf16 {tag}",
            [float(x) for h in gpu.history for x in h["client_loss"].ravel()],
            [float(x) for h in c.history for x in h["client_loss"].ravel()],
            gpu.params, c.params, p0)
        print(f"[agree bf16] reduced {tag}, 2 rounds card vs CPU: losses "
              f"{[round(x, 4) for x in gpu.losses]} vs "
              f"{[round(x, 4) for x in c.losses]}; {said}")


def _only_bf16_arms(tag, launches):
    """No f32 arm ran on a bf16 path: nothing widened to reach it."""
    f32 = {k: n for k, n in launches.items() if not k.endswith("/bf16")}
    check(not f32, f"[{tag}] float32 kernel arms launched on the bf16 path: "
          f"{f32}")


def phase_bf16_window(dev, _build):
    """Full-width TinyLlama-1.1B with bf16 params through the window path's
    configuration (C = 4 x K = 2 x 2 x 256 tokens, rolling at 0.5 on
    d_ff, heads, kv_heads): 3 fused rounds counted (rows 5-8 and 10 at
    bf16, no f32 arm) and profiled; the eval path on the params they leave
    (``[bf16 eval]``: 4 x 2048 held-out tokens, whole and the windowed
    sub-model through rows 1-2, the sub-model's gradient at 2 x 256
    through rows 3-4); then 3 extract rounds (``fused_forward="off"``) from
    the same params and offsets, held against the fused rounds' params
    (captured before the profiled round) by ``check_bf16_rounds``'s cosine
    and norm ratio.  Returns the launches of the window, eval and extract
    paths."""
    from repro_torch import api
    cfg, model, data = full_width(dev, param_dtype=BF)
    params = model.init(seed=0, device=dev)
    p0 = {k: v.cpu() for k, v in params.items()}
    fed = api.fed_round(model, scfg_for("rolling"), device=dev)
    trainer = api.Trainer(fed, params)
    n_params = sum(v.numel() for v in params.values())
    print(f"[bf16 window] {cfg.name}: {cfg.n_layers} layers, {n_params:,} "
          f"params, bf16; windows "
          f"{ {f'{k[0]}/{k[1]}': w for k, w in fed.scheme.sizes.items()} }")
    launches, round_s = run_rounds("bf16 window", trainer, data, _build)
    _only_bf16_arms("bf16 window", launches)
    L, leaves, R = cfg.n_layers, len(params), len(data)
    want = {"rolling_mm_fwd<1>/bf16": 6 * L * R,   # q, k, v x K = 2
            "rolling_mm_dx<1>/bf16": 6 * L * R,
            "rolling_mm_fwd<2>/bf16": 2 * L * R,   # gate/up x K = 2
            "rolling_mm_dx<2>/bf16": 2 * L * R,
            "sgd_inplace/bf16": 2 * leaves * R}
    check(launches == want, f"[bf16 window] launches {launches}, expected "
          f"{want}")
    # TinyLlama's windows are whole 16-byte vectors: TMA takes every launch
    bodies = BODY_LAUNCHES["bf16 window"]
    check(all(bodies.get(f"{k} wgmma", 0) == n for k, n in want.items()
              if k.startswith("rolling_mm")),
          f"[bf16 window] rows 5-8 off the wgmma body: {bodies}")
    check(all(v.dtype == BF for v in trainer.params.values()),
          "[bf16 window] params left bf16")
    # the counted rounds' params, before the profiled round moves them
    fused = {k: v.cpu() for k, v in trainer.params.items()}
    fused_losses = trainer.losses[:R]
    phase_profile("bf16 window", trainer, data[0], round_s)
    e_launches = phase_bf16_eval(dev, model, trainer, _build)
    offsets = [fed.scheme.offsets(r, 4) for r in range(R)]
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()

    fed = api.fed_round(model, scfg_for("rolling"), fused_forward="off",
                        device=dev)
    trainer = api.Trainer(fed, {k: v.to(dev) for k, v in p0.items()})
    x_launches, round_s = run_rounds(
        "bf16 extract", trainer, [(b, {"offsets": o}) for b, o in
                                  zip(data, offsets)], _build)
    _only_bf16_arms("bf16 extract", x_launches)
    check(x_launches == {"sgd_inplace/bf16": 2 * leaves * R},
          f"[bf16 extract] launches {x_launches}")
    said = check_bf16_rounds("bf16 extract", trainer.losses, fused_losses,
                             trainer.params, fused, p0, hold="cos")
    print(f"[bf16 extract] vs the fused rounds (bf16 kernels vs cuBLAS bf16, "
          f"each summing in f32 and rounding once): losses {trainer.losses} "
          f"vs {fused_losses}; {said}")
    phase_profile("bf16 extract", trainer, (data[0], {"offsets": offsets[0]}),
                  round_s)
    del trainer, fused
    gc.collect()
    torch.cuda.empty_cache()
    return launches, e_launches, x_launches


def phase_bf16_eval(dev, model, trainer, _build):
    """``[bf16 eval]``: the eval path at bf16 on the window rounds' params,
    whole and through the windowed sub-model, each without and with
    ``REPRO_USE_FLASH`` (row 13's bf16 arm, a launch a layer), and the
    sub-model's gradient: each part driven once with the launches counted,
    then timed 3 times, peak from a reset; the flash losses within
    BF16_LOSS_TOL of the blockwise ones."""
    from repro_torch.data.synthetic import lm_batches
    cfg, params, fed = model.cfg, trainer.params, trainer.fed
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (EB,), ES, seed=999))
                             ["tokens"], dtype=torch.long).to(dev)
    offs = fed.scheme.offsets(trainer.round_idx - 1,
                              fed.scfg.clients_per_round)
    window = {k: (offs[k][0], w) for k, w in fed.scheme.sizes.items()
              if w < k[1]}
    small = tokens[:2, :256]

    def grad_pass():
        p = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = model.loss(p, {"tokens": small}, window=window)
        grads = torch.autograd.grad(loss, list(p.values()))
        check(all(t.dtype == BF and bool(torch.isfinite(t).all())
                  for t in grads), "[bf16 eval] grads bf16 and finite")
        g = dict(zip(p, grads))["layers/0/mlp/w_gate"]
        o, w = window[("d_ff", cfg.d_ff)]
        check(not g[:, :o].any() and not g[:, o + w:].any(),
              "[bf16 eval] w_gate grad nonzero outside the d_ff window")
        return float(loss.detach())

    total, losses = {}, {}
    for tag, fn in (("server", lambda: eval_loss(model, params, tokens)),
                    ("server, flash", lambda: eval_loss(
                        model, params, tokens, flash=True)),
                    ("sub-model", lambda: eval_loss(model, params, tokens,
                                                    window)),
                    ("sub-model, flash", lambda: eval_loss(
                        model, params, tokens, window, flash=True)),
                    ("sub-model grad 2x256", grad_pass)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        loss = fn()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        _only_bf16_arms("bf16 eval", launches)
        record_bodies("bf16 eval", _build, add=True)
        for k, n in launches.items():
            total[k] = total.get(k, 0) + n
        secs, _ = timed(fn, 3)
        peak = torch.cuda.max_memory_allocated()
        check(math.isfinite(loss), f"[bf16 eval] {tag}: loss {loss}")
        losses[tag] = loss
        print(f"[bf16 eval] {tag:22s} loss {loss:.6f}  "
              f"{float(np.mean(secs)):.4f} s (mean of 3 after a warm-up: "
              f"{[round(t, 4) for t in secs]})  peak {peak / 2**30:.2f} GiB"
              f"  launches {launches}")
    for tag in ("server", "sub-model"):
        d = abs(losses[f"{tag}, flash"] - losses[tag])
        check(d <= BF16_LOSS_TOL, f"[bf16 eval] {tag} flash vs blockwise {d}")
        print(f"[bf16 eval] {tag}: flash vs blockwise |d| {d:.3g} "
              f"(tolerance {BF16_LOSS_TOL})")
    L = cfg.n_layers     # q, k, v and the gate/up pair a layer, in the two
    want = {"rolling_matmul/bf16": 9 * L,     # sub-models' and the grad's
            "rolling_matmul_multi/bf16": 3 * L,   # forwards; dx in the grad
            "rolling_matmul_dx/bf16": 3 * L,
            "rolling_matmul_dx_multi/bf16": L,
            "flash_attention/bf16": 2 * L}    # the two flash evals
    check(total == want, f"[bf16 eval] launches {total}, expected {want}")
    return total


def phase_bf16_mask(dev, _build):
    """``[bf16 mask]``: the Bernoulli mask round with client momentum
    (float32 velocity) at full width, bf16 params and masks, 3 rounds
    through ``api.Trainer(rng=0)``: rows 9 and 11 at bf16, no f32 arm."""
    from repro_torch import api
    cfg, model, data = full_width(dev, param_dtype=BF)
    params = model.init(seed=0, device=dev)
    fed = api.fed_round(model, scfg_for("bernoulli"), device=dev,
                        client_opt="momentum")
    check(isinstance(fed, api.MaskFedAvg), "bernoulli is not MaskFedAvg")
    trainer = api.Trainer(fed, params, rng=0)
    print(f"[bf16 mask] {cfg.name}: bf16 params and masks, client momentum "
          f"(float32 velocity), capacities {fed.capacities.tolist()}")
    launches, round_s = run_rounds("bf16 mask", trainer, data, _build)
    _only_bf16_arms("bf16 mask", launches)
    leaves, R = len(params), len(data)
    want = {"masked_sgd_inplace/bf16": 2 * leaves * R,
            "fillin_agg_inplace/bf16": leaves * R}
    check(launches == want, f"[bf16 mask] launches {launches}, expected "
          f"{want}")
    check(all(v.dtype == BF for v in trainer.params.values()),
          "[bf16 mask] params left bf16")
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_bf16_serve(dev, _build):
    """``[bf16 serve]``: full-width TinyLlama-1.1B with bf16 params serves 4
    prompts of 1536 tokens and 32 greedy steps from the bf16 caches
    prefill returns: prefill seconds (mean of 2 after a warm-up), ms per
    token, peak; bf16 logits, finite."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = get_config("tinyllama_1_1b")
    model = build_model(cfg, param_dtype=BF)
    params = model.init(seed=0, device=dev)
    B, S, G = BF16_SERVE_B, BF16_SERVE_S, BF16_SERVE_G
    prompts = torch.as_tensor(sample_prompts(cfg, B, S, seed=0)[0],
                              dtype=torch.long).to(dev)
    generate(model, params, prompts, 4)
    with torch.no_grad():
        pre, (logits, cache) = timed(lambda: model.prefill(
            params, prompts, max_len=S + G), 2)
    check(logits.dtype == BF and bool(torch.isfinite(logits.float()).all())
          and all(v.dtype == BF for v in cache.values()),
          f"[bf16 serve] prefill logits {logits.dtype}, caches bf16")
    del logits, cache
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out = generate(model, params, prompts, G, return_logits=True)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    check(all(t.dtype == BF and bool(torch.isfinite(t.float()).all())
              for t in out["logits"]), "[bf16 serve] decode logits")
    print(f"[bf16 serve] {cfg.name} bf16: prefill {B}x{S}: "
          f"{float(np.mean(pre)):.4f} s (mean of 2 after a warm-up: "
          f"{[round(t, 4) for t in pre]}); decode "
          f"{1e3 * out['decode_s'] / G:.3f} ms/token ({G} greedy steps, "
          f"batch {B}); peak {peak / 2**30:.2f} GiB; kernel launches "
          f"{launches}")
    return launches


# -- bf16 parameters (ROADMAP A11, part 2): the SSM family and the hybrid
# block at bf16, through rows 12 and 13's bf16 arms -----------------------

# Reduced bf16 rounds card vs CPU (``[agree bf16]``): each family's client
# lr in tests/test_torch_bf16_ssm.py, where the port is held to the
# reference (at 0.1 Hymba's bf16 rounds amplify rounding until the
# reference's own fused and extract arms part by a gap of 0.26)
BF16_AGREE_LR = {"mamba2_130m": 0.1, "hymba_1_5b": 0.01}
# The full-width bf16 SSM and hybrid rounds' client lr, chosen with
# ``tools/round_lr_probe.py --bf16`` (PERF.md §6, PR 25): extract against
# fused is held by the cosine of the two changes and their norm ratios
# (check_bf16_rounds), which unmoved params fail (cosine 0, ratio 0).  Like
# the f32 rounds at lr 0.1, these rounds amplify rounding: at lr 0.1,
# 0.03 and 0.01 extract vs fused read a cosine of 0.26, 0.37 and 0.58 over
# all leaves for Mamba2 (at least 0.13, 0.18 and 0.30 a leaf) and 0.57,
# 0.77 and 0.95 for Hymba at 16 layers (0.29, 0.43 and 0.64 a leaf), norm
# ratios 0.89-1.16 throughout.  At 0.01 both hold a limit between those
# readings and an unmoved state's 0: Mamba2 (0.4, 0.2), Hymba BF16_COS
BF16_SLICE_LR = 0.01
BF16_SLICE_COS = {"mamba2_130m": (0.4, 0.2), "hymba_1_5b": BF16_COS}
BF16_SSM_G, BF16_HYB_G = 32, 32   # greedy steps after the bf16 prefills


def phase_small_agreement_bf16_ssm(dev):
    """Reduced Mamba2 and Hymba at bf16, card vs CPU from the same bf16
    params, tokens and CPU-drawn offsets or masks, 2 rounds each: fused,
    extract and Bernoulli mask (BF16_AGREE_LR); losses and the params'
    change as ``check_bf16_rounds`` holds them (the gap), params bf16."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    for arch, lr in BF16_AGREE_LR.items():
        model = build_model(get_reduced_config(arch), param_dtype=BF)
        p0 = model.init(0, device="cpu")
        it = lm_batches(model.cfg.vocab, (2, 4, 2), 64, seed=0)
        data = [next(it) for _ in range(2)]
        for tag, mode, over, kw in (
                ("fused", "window", {}, {}),
                ("extract", "window", {}, dict(fused_forward="off")),
                ("mask", "mask", dict(scheme="bernoulli"), {})):
            scfg = slice_scfg(client_lr=lr, **over)
            inj = _injected(api.fed_round(model, scfg, mode=mode,
                                          device="cpu", **kw), mode, 2)
            outs = {}
            for where in ("cpu", dev):
                fed = api.fed_round(model, scfg, mode=mode, device=where,
                                    **kw)
                t = api.Trainer(fed, _to(p0, where))
                t.run(((b, {k: _to(v, where) for k, v in i.items()})
                       for b, i in zip(data, inj)), 2)
                outs[str(where)] = t
            c, gpu = outs["cpu"], outs[str(dev)]
            check(all(v.dtype == BF for v in gpu.params.values()),
                  f"[agree bf16] {arch} {tag}: params left bf16")
            said = check_bf16_rounds(
                f"agree bf16 {arch} {tag}",
                [float(x) for h in gpu.history
                 for x in h["client_loss"].ravel()],
                [float(x) for h in c.history
                 for x in h["client_loss"].ravel()],
                gpu.params, c.params, p0)
            print(f"[agree bf16] reduced {arch} {tag}, 2 rounds card vs CPU "
                  f"(client lr {lr}): losses "
                  f"{[round(x, 4) for x in gpu.losses]} vs "
                  f"{[round(x, 4) for x in c.losses]}; {said}")


def _bf16_slice_launches(cfg, leaves, n, fused):
    """``_slice_launches`` under the bf16 arms' names, zeros left out."""
    return {f"{k}/bf16": v for k, v in
            _slice_launches(cfg, leaves, n, fused).items() if v}


def phase_bf16_slice_rounds(dev, _build, tag, arch, seq, layers=None,
                            lr=None, profile=False):
    """Full-width bf16 rounds of an SSM or hybrid config (``layers`` cuts
    the depth), in the f32 slice rounds' configuration (C = 4 x K = 2 x 2 x
    ``seq`` tokens, rolling at 0.5 on the default axes) at client lr
    ``lr`` (BF16_SLICE_LR): 3 fused rounds counted (rows 5-8 and 10 at
    bf16 against the layer arithmetic, no f32 arm, params bf16) and, with
    ``profile``, one profiled as ``[profile bf16 window]`` is, with the
    chunked SSD's range (its device annotation is no kernel); then 3
    extract rounds
    (``fused_forward="off"``) from the same params and offsets, held
    against the fused rounds' params (taken before the profiled round) by
    ``check_bf16_rounds``'s cosine (BF16_SLICE_COS) and norm ratios.
    Returns the launches of both."""
    from repro_torch import api
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    from repro_torch.models.ssm import SSD_CHUNKED
    lr = BF16_SLICE_LR if lr is None else lr
    cfg = zoo_config(arch, layers)
    model = build_model(cfg, param_dtype=BF)
    it = lm_batches(cfg.vocab, (2, 4, 2), seq=seq)
    data = [next(it) for _ in range(3)]
    scfg = slice_scfg(client_lr=lr)
    fed = api.fed_round(model, scfg, device=dev)
    check(fed.use_fused, f"[{tag}] the default axes took the extract phase")
    offsets = [fed._client_offsets(r) for r in range(len(data))]
    items = [(b, {"offsets": o}) for b, o in zip(data, offsets)]
    params = model.init(seed=0, device=dev)
    p0 = {k: v.to("cpu", copy=True) for k, v in params.items()}
    leaves, n_params = len(params), sum(v.numel() for v in params.values())
    windows = {f"{k[0]}/{k[1]}": w for k, w in fed.scheme.sizes.items()}
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, {n_params:,} params "
          f"({leaves} leaves), bf16; 4 clients x 2 steps x 2 x {seq} tokens, "
          f"client lr {lr}; windows {windows}")
    trainer = api.Trainer(fed, params)
    launches, round_s = run_rounds(tag, trainer, items, _build)
    _only_bf16_arms(tag, launches)
    want = _bf16_slice_launches(cfg, leaves, len(data), True)
    check(launches == want, f"[{tag}] launches {launches}, expected {want}")
    check(all(v.dtype == BF for v in trainer.params.values()),
          f"[{tag}] params left bf16")
    fused = ({k: v.to("cpu", copy=True) for k, v in trainer.params.items()},
             trainer.losses[:len(data)])
    if profile:
        phase_profile(tag, trainer, items[0], round_s, ranges=(SSD_CHUNKED,))
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()

    xtag = tag.replace("round", "extract")
    fed = api.fed_round(model, scfg, fused_forward="off", device=dev)
    check(not fed.use_fused, f"[{xtag}] took the fused phase")
    trainer = api.Trainer(fed, _to(p0, dev))
    x_launches, _ = run_rounds(xtag, trainer, items, _build)
    _only_bf16_arms(xtag, x_launches)
    want = _bf16_slice_launches(cfg, leaves, len(data), False)
    check(x_launches == want, f"[{xtag}] launches {x_launches}, expected "
          f"{want}")
    said = check_bf16_rounds(xtag, trainer.losses, fused[1], trainer.params,
                             fused[0], p0, hold="cos",
                             cos_min=BF16_SLICE_COS[arch])
    print(f"[{xtag}] vs the fused rounds (bf16 kernels vs cuBLAS bf16, each "
          f"summing in f32 and rounding once): losses {trainer.losses} vs "
          f"{fused[1]}; {said}")
    del trainer, fused, p0
    gc.collect()
    torch.cuda.empty_cache()
    return launches, x_launches


def phase_bf16_ssm_mask(dev, _build):
    """``[bf16 ssm mask]``: full-width Mamba2-130M at bf16, 2 Bernoulli
    mask rounds (capacity 0.5, client lr BF16_SLICE_LR, ``Trainer(rng=0)``)
    of the slice rounds' shape: rows 9 and 11 at bf16, no f32 arm, params
    bf16."""
    from repro_torch import api
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = zoo_config("mamba2_130m")
    model = build_model(cfg, param_dtype=BF)
    it = lm_batches(cfg.vocab, (2, 4, 2), seq=SSM_SEQ)
    data = [next(it) for _ in range(2)]
    params = model.init(seed=0, device=dev)
    fed = api.fed_round(model, slice_scfg(scheme="bernoulli",
                                          client_lr=BF16_SLICE_LR),
                        device=dev)
    check(isinstance(fed, api.MaskFedAvg), "bernoulli is not MaskFedAvg")
    print(f"[bf16 ssm mask] {cfg.name}: bf16 params and masks, capacities "
          f"{fed.capacities.tolist()}, client lr {BF16_SLICE_LR}")
    trainer = api.Trainer(fed, params, rng=0)
    launches, _ = run_rounds("bf16 ssm mask", trainer, data, _build)
    _only_bf16_arms("bf16 ssm mask", launches)
    leaves, R = len(params), len(data)
    want = {"masked_sgd_inplace/bf16": 2 * leaves * R,
            "fillin_agg_inplace/bf16": leaves * R}
    check(launches == want, f"[bf16 ssm mask] launches {launches}, "
          f"expected {want}")
    check(all(v.dtype == BF for v in trainer.params.values()),
          "[bf16 ssm mask] params left bf16")
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _bf16_eval(tag, model, params, tokens, _build, want, flash=False):
    """One eval at bf16 counted (its launches must be ``want``, bf16 arms
    only), then timed 3 times; returns the loss and the launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    loss = eval_loss(model, params, tokens, flash=flash)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    secs, again = timed(lambda: eval_loss(model, params, tokens,
                                          flash=flash), 3)
    peak = torch.cuda.max_memory_allocated()
    _only_bf16_arms(tag, launches)
    check(math.isfinite(loss) and math.isfinite(again) and launches == want,
          f"[{tag}] loss {loss}, {again}, launches {launches}, expected "
          f"{want}")
    print(f"[{tag}] {model.cfg.name} loss on {list(tokens.shape)} held-out "
          f"tokens (seed 999), REPRO_USE_FLASH {'set' if flash else 'unset'}"
          f": {loss:.6f}  {float(np.mean(secs)):.4f} s (mean of 3 after a "
          f"warm-up: {[round(t, 4) for t in secs]})  peak "
          f"{peak / 2**30:.2f} GiB  launches {launches}")
    return loss, launches


def _bf16_generate(tag, model, params, prompts, gen, _build, want,
                   extra=None):
    """``serve.generate`` at bf16 (after the vision stub's ``extra``
    patches, if given) after a short warm-up, counted (launches ``want``,
    bf16 arms only) and timed: prefill seconds, ms a token, peak; bf16
    logits, finite.  Returns the launches and the prefill seconds."""
    from repro_torch.launch.serve import generate
    generate(model, params, prompts[:, :256], 2, extra=extra)  # a warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out = generate(model, params, prompts, gen, return_logits=True,
                   extra=extra)
    launches = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    _only_bf16_arms(tag, launches)
    check(launches == want, f"[{tag}] launches {launches}, expected {want}")
    check(all(t.dtype == BF and bool(torch.isfinite(t.float()).all())
              for t in out["logits"]), f"[{tag}] logits bf16 and finite")
    B, S = prompts.shape[:2]
    behind = f" behind {extra['patches'].shape[1]} patches" if extra else ""
    print(f"[{tag}] {model.cfg.name} bf16: prefill {B}x{S}{behind}: "
          f"{out['prefill_s']:.4f} s; decode "
          f"{1e3 * out['decode_s'] / gen:.3f} ms/token ({gen} greedy steps "
          f"from the bf16 caches, batch {B}); peak {peak / 2**30:.2f} GiB; "
          f"kernel launches {launches}; first row "
          f"{out['tokens'][0, :12].tolist()}")
    return launches, out["prefill_s"]


def _check_bf16_caches(tag, model, params, prompts):
    """The caches a bf16 prefill returns: the SSM state ``h`` float32, the
    rest (conv tails, a hybrid layer's ring) bf16."""
    with torch.no_grad():
        _, cache = model.prefill(params, prompts[:, :512], max_len=520)
    bad = {k: str(v.dtype) for k, v in cache.items()
           if v.dtype != (torch.float32 if k.endswith("/h") else BF)}
    check(not bad, f"[{tag}] cache dtypes {bad}")


def phase_bf16_ssm_eval_serve(dev, _build):
    """Full-width Mamba2-130M with bf16 params (seed 0): ``[bf16 ssm
    eval]``, its loss on 4 x 2048 held-out tokens through row 12's bf16 arm
    (24 launches); ``[bf16 ssm serve]``, 8 prompts of 32768 tokens
    prefilled through it and BF16_SSM_G greedy steps from the bf16 caches
    (h float32); ``[profile bf16 ssm serve]``, one prefill profiled: its
    device time by kernel group and row 12's device time, share and
    launches.  Returns both paths' launches."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = get_config("mamba2_130m")
    model = build_model(cfg, param_dtype=BF)
    params = model.init(seed=0, device=dev)
    want = {"ssd_chunk_intra/bf16": cfg.n_layers}
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (EB,), ES,
                                             seed=999))["tokens"],
                             dtype=torch.long).to(dev)
    _, e_launches = _bf16_eval("bf16 ssm eval", model, params, tokens,
                               _build, want)
    prompts = torch.as_tensor(sample_prompts(cfg, SB, SS, seed=0)[0],
                              dtype=torch.long).to(dev)
    _check_bf16_caches("bf16 ssm serve", model, params, prompts)
    s_launches, prefill_s = _bf16_generate("bf16 ssm serve", model, params,
                                           prompts, BF16_SSM_G, _build, want)
    kern = profile_prefill("profile bf16 ssm serve", model, params, prompts,
                           prefill_s)
    ssd = [(t, n) for name, t, n in kern if "ssd_bf16_kernel" in name]
    if kern:
        total = sum(t for _, t, _ in kern)
        ms, n = sum(t for t, _ in ssd), sum(n for _, n in ssd)
        check(n == cfg.n_layers, f"[profile bf16 ssm serve] row 12's kernel "
              f"ran {n} times in a prefill, expected {cfg.n_layers}")
        print(f"[profile bf16 ssm serve] row 12's bf16 kernel: {ms:.2f} ms "
              f"of the prefill's {total:.1f} ms of device time "
              f"({100 * ms / total:.1f}%), {n} launches a prefill, "
              f"{ms / n:.4f} ms a launch")
    del model, params, prompts, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return e_launches, s_launches


def phase_bf16_hybrid_eval_serve(dev, _build):
    """Hymba-1.5B at HYB_LAYERS of its 32 layers with bf16 params (seed
    0): ``[bf16 hybrid eval]``, its loss on 4 x 2048 held-out tokens with
    ``REPRO_USE_FLASH`` (rows 12 and 13 at bf16, a launch of each a layer)
    and without (row 12), the two within BF16_LOSS_TOL; ``[bf16 hybrid
    serve]``, 4 prompts of 2048 prefilled (past the window of 1024) and
    BF16_HYB_G greedy steps from the bf16 caches.  Returns the flash
    eval's and the generation's launches."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    cfg = zoo_config("hymba_1_5b", HYB_LAYERS)
    model = build_model(cfg, param_dtype=BF)
    params = model.init(seed=0, device=dev)
    tokens = torch.as_tensor(next(lm_batches(cfg.vocab, (HB,), HS,
                                             seed=999))["tokens"],
                             dtype=torch.long).to(dev)
    L = cfg.n_layers
    flash, e_launches = _bf16_eval(
        "bf16 hybrid eval", model, params, tokens, _build,
        {"ssd_chunk_intra/bf16": L, "flash_attention/bf16": L}, flash=True)
    blockwise, _ = _bf16_eval("bf16 hybrid eval", model, params, tokens,
                              _build, {"ssd_chunk_intra/bf16": L})
    d = abs(flash - blockwise)
    check(d <= BF16_LOSS_TOL, f"[bf16 hybrid eval] flash vs blockwise {d}")
    print(f"[bf16 hybrid eval] flash vs blockwise |d| {d:.3g} (tolerance "
          f"{BF16_LOSS_TOL})")
    prompts = torch.as_tensor(sample_prompts(cfg, HB, HS, seed=0)[0],
                              dtype=torch.long).to(dev)
    _check_bf16_caches("bf16 hybrid serve", model, params, prompts)
    s_launches, _ = _bf16_generate("bf16 hybrid serve", model, params,
                                   prompts, BF16_HYB_G, _build,
                                   {"ssd_chunk_intra/bf16": L})
    del model, params, prompts, tokens
    gc.collect()
    torch.cuda.empty_cache()
    return e_launches, s_launches


# -- bf16 parameters (ROADMAP A11, part 3): the MoE family, MLA and MTP,
# codebooks and the vision stub at bf16 ------------------------------------

# Reduced bf16 zoo rounds card vs CPU (``[agree bf16 zoo]``), at the client
# lr of tests/test_torch_bf16_moe.py and tests/test_torch_bf16_audio_vlm.py
# (0.01: at 0.1 the reference's own fused and extract arms part by more than
# those tests' 5e-3 on Mixtral's and DeepSeek-V3's losses); the MoE layers
# on ``dropping`` at a capacity factor of n_experts / top_k, where every
# expert holds every token, as those tests run them
BF16_ZOO_AGREE_LR = 0.01
# The full-width bf16 zoo rounds: (tag, arch, layers kept, clients, fused
# rounds, extract rounds, other cut fields, the cosine limits of extract vs
# fused (all leaves, each leaf)).  At bf16 a round holds (1 + 2 C) x 2 bytes
# a param: Mixtral-8x22B fits 2 of its 56 layers at C = 2 (5.4 B params,
# 50.4 GiB reckoned), Phi-3-vision all 32, MusicGen-large 24 of 48 (the
# script's time), DeepSeek-V3 its first dense layer and the MTP block (an
# MoE layer of 256 experts is 11.5 B params).  Client lr BF16_ZOO_LR; the
# cosine limits lie between the readings of PERF.md §6 and an
# unmoved state's 0, as BF16_SLICE_COS's do
BF16_ZOO_LR = 0.01
BF16_ZOO_ROUNDS = [
    ("bf16 moe round", "mixtral_8x22b", 2, 2, 2, 1, {}, (0.7, 0.4)),
    ("bf16 mla round", "deepseek_v3_671b", 1, 2, 2, 1,
     {"n_dense_layers": 1}, (0.7, 0.4)),
    ("bf16 vlm round", "phi_3_vision_4_2b", 32, 2, 2, 1, {}, (0.7, 0.4)),
    ("bf16 audio round", "musicgen_large", 24, 2, 2, 1, {}, (0.7, 0.4))]
# DeepSeek-V3's bf16 eval and serving: its first dense layer, two MoE layers
# of all 256 experts (top-8: the combine's order matters) and MTP
BF16_MLA_EVAL = dict(n_layers=3, n_dense_layers=1)
BF16_FAM_G = 16            # greedy steps of the bf16 audio and vlm generate


def roomy(cfg):
    """``cfg`` with the MoE dispatch's capacity factor n_experts / top_k:
    every expert holds every token (what ``dense`` computes), so no
    token's routing depends on its neighbours."""
    mo = cfg.moe
    if mo is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.n_experts / mo.top_k))


def phase_small_agreement_bf16_zoo(dev, _build):
    """``[agree bf16 zoo]``: reduced Mixtral-8x22B, DeepSeek-V3 (MLA, a
    leading dense layer, an MoE layer, MTP), MusicGen-large (codebooks) and
    Phi-3-vision (patches) with bf16 params, the MoE layers on ``dropping``
    at the roomy capacity: 2 fused rounds each on the card and on the CPU
    from the same params, tokens (2 x 64 a client step) and CPU-drawn
    offsets, at client lr BF16_ZOO_AGREE_LR; losses and the params' change
    as ``check_bf16_rounds`` holds them (the gap), params bf16, no f32 arm
    on the card.  Then reduced DeepSeek-V3 at bf16 through the continuous
    batcher on the card (2 slots, prompts of 5-12 tokens, 4 new each): each
    logit it hands out held against the card's own single-request prefill
    and teacher-forced decode within BF16_LOSS_TOL of the request's
    largest."""
    from repro_torch import api
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.batching import ContinuousBatcher
    from repro_torch.launch.specs import request_queue
    from repro_torch.models import build_model
    tag = "agree bf16 zoo"
    for arch in ("mixtral_8x22b", "deepseek_v3_671b", "musicgen_large",
                 "phi_3_vision_4_2b"):
        model = build_model(roomy(get_reduced_config(arch)), param_dtype=BF)
        cfg = model.cfg
        vision = ((cfg.vision_patches, cfg.vision_d) if cfg.vision_stub
                  else None)
        it = lm_batches(cfg.vocab, (2, 4, 2), 64, seed=0,
                        codebooks=cfg.n_codebooks, vision=vision)
        data = [next(it) for _ in range(2)]
        p0 = model.init(0, device="cpu")
        scfg = slice_scfg(client_lr=BF16_ZOO_AGREE_LR)
        outs = {}
        for where in ("cpu", dev):
            fed = api.fed_round(model, scfg, device=where)
            check(fed.use_fused, f"[{tag}] {arch} took the extract phase")
            trainer = api.Trainer(fed, _to(p0, where))
            _build.reset_launches()
            trainer.run(zip(data, _injected(fed, "window", 2)), 2)
            outs[str(where)] = trainer
        _only_bf16_arms(f"{tag} {arch}", dict(_build.LAUNCHES))
        g, c = outs[str(dev)], outs["cpu"]
        check(all(v.dtype == BF for v in g.params.values()),
              f"[{tag}] {arch}: params left bf16")
        said = check_bf16_rounds(
            f"{tag} {arch}",
            [float(x) for h in g.history for x in h["client_loss"].ravel()],
            [float(x) for h in c.history for x in h["client_loss"].ravel()],
            g.params, c.params, p0)
        print(f"[{tag}] reduced {arch}, 2 fused rounds card vs CPU (client "
              f"lr {BF16_ZOO_AGREE_LR}): {said}")
    model = build_model(roomy(get_reduced_config("deepseek_v3_671b")),
                        param_dtype=BF)
    params = model.init(0, device=dev)
    reqs = request_queue(model.cfg, (5, 9, 7, 12, 3), max_new=4)
    rec = _Recorder(model)
    eng = ContinuousBatcher(rec, params, batch_slots=2, max_len=60)
    check(all(v.dtype == BF for v in eng._cache.values()),
          f"[{tag}] the batcher's caches are not bf16")
    for r in reqs:
        eng.submit(r)
    drive(eng, rec)
    check_single_requests(f"{tag} batcher", model, params, reqs, rec,
                          tol=BF16_LOSS_TOL)


def _bf16_zoo_launches(cfg, leaves, n, clients, fused):
    """``_zoo_launches`` under the bf16 arms' names, zeros left out."""
    return {f"{k}/bf16": v for k, v in
            _zoo_launches(cfg, leaves, n, clients, fused).items() if v}


def phase_bf16_zoo_round(dev, _build, tag, arch, layers, clients, n_fused,
                         n_extract, over, cos_min):
    """A zoo config's fused rounds with bf16 params at full width (cut to
    ``layers`` layers and ``over``'s other fields; the MoE layers on
    ``dropping`` at their published capacity): ``clients`` clients x K = 2
    steps x 2 x ZOO_SEQ tokens (with the codebook streams and the patches
    of the families that take them), rolling at capacity 0.5 on the
    default axes, client lr BF16_ZOO_LR (seconds, peak beside its
    reckoning, finite losses and params, params bf16, rows 5-8 and 10 at
    bf16 against the layer arithmetic, no f32 arm, the launches by body:
    Mixtral's experts through ``experts=`` lanes); then ``n_extract``
    extract rounds from the same params and offsets, held against the
    fused rounds' params after as many rounds by ``check_bf16_rounds``'s
    cosine (``cos_min``) and norm ratios.  Returns the launches of
    both."""
    from repro_torch import api
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import build_model
    cfg = zoo_config(arch, layers, **over)
    full = zoo_config(arch)
    model = build_model(cfg, param_dtype=BF)
    vision = (cfg.vision_patches, cfg.vision_d) if cfg.vision_stub else None
    it = lm_batches(cfg.vocab, (2, clients, 2), seq=ZOO_SEQ,
                    codebooks=cfg.n_codebooks, vision=vision)
    data = [next(it) for _ in range(n_fused)]
    scfg = slice_scfg(clients_per_round=clients, client_lr=BF16_ZOO_LR)
    fed = api.fed_round(model, scfg, device=dev)
    check(fed.use_fused, f"[{tag}] the default axes took the extract phase")
    offsets = [fed._client_offsets(r) for r in range(n_fused)]
    items = [(b, {"offsets": o}) for b, o in zip(data, offsets)]
    params = model.init(seed=0, device=dev)
    p0 = {k: v.to("cpu", copy=True) for k, v in params.items()}
    leaves, n_params = len(params), sum(v.numel() for v in params.values())
    windows = {f"{k[0]}/{k[1]}": w for k, w in fed.scheme.sizes.items()}
    reckon = (1 + 2 * clients) * 2 * n_params
    cut = (f"depth{f' ({over})' if over else ''}"
           if layers < full.n_layers else "none")
    print(f"[{tag}] {cfg.name}: {layers} of {full.n_layers} layers (cut: "
          f"{cut}), d_model {cfg.d_model}, {n_params:,} params ({leaves} "
          f"leaves), bf16; {clients} clients x 2 steps x 2 x {ZOO_SEQ} "
          f"tokens, client lr {scfg.client_lr}; windows {windows}; offsets "
          f"{offsets}; peak reckoned (1 + 2 C) x params = "
          f"{reckon / 2**30:.2f} GiB plus activations")
    trainer = api.Trainer(fed, params)
    kept = {}

    def keep(i):
        if i + 1 == n_extract:
            kept["params"] = {k: v.to("cpu", copy=True)
                              for k, v in trainer.params.items()}
            kept["losses"] = list(trainer.losses)
    launches, _ = run_rounds(tag, trainer, items, _build, clients=clients,
                             after=keep)
    _only_bf16_arms(tag, launches)
    want = _bf16_zoo_launches(cfg, leaves, n_fused, clients, True)
    check(launches == want, f"[{tag}] launches {launches}, expected {want}")
    check(all(v.dtype == BF for v in trainer.params.values()),
          f"[{tag}] params left bf16")
    del trainer, params
    gc.collect()
    torch.cuda.empty_cache()

    xtag = tag.replace("round", "extract")
    fed = api.fed_round(model, scfg, fused_forward="off", device=dev)
    check(not fed.use_fused, f"[{xtag}] took the fused phase")
    trainer = api.Trainer(fed, _to(p0, dev))
    x_launches, _ = run_rounds(xtag, trainer, items[:n_extract], _build,
                               clients=clients)
    _only_bf16_arms(xtag, x_launches)
    want = _bf16_zoo_launches(cfg, leaves, n_extract, clients, False)
    check(x_launches == want, f"[{xtag}] launches {x_launches}, expected "
          f"{want}")
    said = check_bf16_rounds(xtag, trainer.losses, kept["losses"],
                             trainer.params, kept["params"], p0, hold="cos",
                             cos_min=cos_min)
    print(f"[{xtag}] vs the fused rounds after {n_extract} round(s) (bf16 "
          f"kernels vs cuBLAS bf16, each summing in f32 and rounding once): "
          f"losses {trainer.losses} vs {kept['losses']}; {said}")
    del trainer, kept, p0
    gc.collect()
    torch.cuda.empty_cache()
    return launches, x_launches


def phase_bf16_mla_eval_serve(dev, _build):
    """``[bf16 mla eval]`` and ``[bf16 mla serve]``: DeepSeek-V3 at full
    width with bf16 params, cut to its first (dense) layer, two MoE layers
    of all 256 experts (top-8, sigmoid router, the shared expert;
    ``dropping``) and the MTP block.  Eval: ``Model.loss`` on one held-out
    sequence of 2048 tokens, the sub-model under a ``heads`` 64-of-128 +
    ``d_ff`` 9216-of-18432 window (rows 1-2 at bf16) and one backward pass
    of its loss at 2 x 256 tokens with respect to the embedding, the dense
    layer and the MTP block (rows 3-4 at bf16), the window's loss within
    BF16_LOSS_TOL of the compact sub-model's (cuBLAS bf16) and its
    gradients finite, 0 outside the windows.  Serving: ``serve.generate`` of
    MLA_SG greedy tokens after 2 x 256 through the absorbed decode from the
    bf16 ``c``/``kr`` caches, then, at the roomy capacity, prefill 224 +
    MLA_TF teacher-forced decode steps against one prefill of 256 within
    BF16_LOSS_TOL of the largest logit.  Returns the eval's launches."""
    from repro_torch.core.extract import extract
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    tag = "bf16 mla eval"
    cfg = zoo_config("deepseek_v3_671b", **BF16_MLA_EVAL)
    model = build_model(cfg, param_dtype=BF)
    t0 = time.perf_counter()
    params = model.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n = sum(v.numel() for v in params.values())
    batch = _batch_on(next(lm_batches(cfg.vocab, (1,), MLA_ES, seed=999)),
                      dev)
    small = {"tokens": batch["tokens"].new_tensor(next(lm_batches(
        cfg.vocab, (2,), 256, seed=998))["tokens"])}
    H, F = cfg.n_heads, cfg.d_ff
    window = {("heads", H): (H // 2, H // 2), ("d_ff", F): (F // 2, F // 2)}
    offsets = {k: o for k, (o, _) in window.items()}
    sizes = {k: w for k, (_, w) in window.items()}
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} of 61 layers (cut: depth; 1 "
          f"dense + {cfg.n_layers - 1} MoE layers of {cfg.moe.n_experts} "
          f"experts, top-{cfg.moe.top_k}) + the MTP block, {n:,} params "
          f"({2 * n / 2**30:.1f} GiB bf16), made in "
          f"{time.perf_counter() - t0:.1f} s; sub-model window {window}")
    trained = [k for k in params if k == "embed"
               or k.startswith(("dense_layers/", "mtp/"))]

    def grad_pass():
        p = dict(params)
        for k in trained:
            p[k] = p[k].detach().requires_grad_()
        loss, _ = model.loss(p, small, window=window)
        grads = torch.autograd.grad(loss, [p[k] for k in trained])
        g = dict(zip(trained, grads))
        finite = all(bool(torch.isfinite(t.float()).all()) for t in grads)
        outside = 0
        for k, dim, key in (("dense_layers/0/mlp/w_gate", 1, ("d_ff", F)),
                            ("mtp/attn/wo", 0, ("heads", H))):
            gk, (o, w) = g[k], window[key]
            outside += (torch.count_nonzero(gk) - torch.count_nonzero(
                gk.narrow(dim, o, w))).item()
        return float(loss.detach()), outside, finite, {
            k: str(t.dtype) for k, t in g.items()}

    parts = _eval_parts(tag, [
        ("deepseek-v3 server", lambda: batch_loss(model, params, batch)),
        ("deepseek-v3 sub-model", lambda: batch_loss(model, params, batch,
                                                     window)),
        ("deepseek-v3 sub-model grad", grad_pass)], _build)
    blocks, mlps = cfg.n_layers + 1, cfg.n_dense_layers + 1
    for name, want in (
            ("deepseek-v3 server", {}),
            ("deepseek-v3 sub-model", {"rolling_matmul/bf16": 3 * blocks,
                                       "rolling_matmul_multi/bf16": mlps}),
            ("deepseek-v3 sub-model grad", {
                "rolling_matmul/bf16": 3 * blocks,
                "rolling_matmul_multi/bf16": mlps,
                "rolling_matmul_dx/bf16": 3 * blocks,
                "rolling_matmul_dx_multi/bf16": mlps})):
        _only_bf16_arms(f"{tag} {name}", parts[name][1])
        check(parts[name][1] == want, f"[{tag}] {name}: launches "
              f"{parts[name][1]}, expected {want}")
    metrics = parts["deepseek-v3 server"][0][1]
    check(all(math.isfinite(v) for v in metrics.values()),
          f"[{tag}] metrics {metrics}")
    res = parts["deepseek-v3 sub-model grad"][0]
    check(res[1] == 0 and res[2] and set(res[3].values()) ==
          {"torch.bfloat16"}, f"[{tag}] sub-model grad: {res[1]} nonzero "
          f"grads outside the windows, finite {res[2]}, dtypes {res[3]}")
    sub = extract(params, model.axes(), offsets, sizes)
    plain = batch_loss(model, sub, batch)[0]
    got = parts["deepseek-v3 sub-model"][0][0]
    check(abs(got - plain) <= BF16_LOSS_TOL, f"[{tag}] sub-model {got} vs "
          f"the compact sub-model's {plain}")
    print(f"[{tag}] server metrics {metrics}; the sub-model's loss {got:.6f}"
          f" vs the compact sub-model's (cuBLAS bf16) {plain:.6f}: |d| "
          f"{abs(got - plain):.3g} (tolerance {BF16_LOSS_TOL}); its gradient "
          f"bf16, finite, 0 outside the windows")
    del sub, small
    gc.collect()
    torch.cuda.empty_cache()

    tag = "bf16 mla serve"
    prompts = torch.as_tensor(sample_prompts(cfg, MLA_SB, MLA_SS, seed=0)[0],
                              dtype=torch.long).to(dev)
    with torch.no_grad():
        _, cache = model.prefill(params, prompts[:, :64], max_len=80)
    check({v.dtype for v in cache.values()} == {BF},
          f"[{tag}] the c/kr caches are not bf16")
    del cache
    s_launches, _ = _bf16_generate(tag, model, params, prompts, MLA_SG,
                                   _build, {})
    full_bf16_teacher_forced(tag, build_model(roomy(cfg), param_dtype=BF),
                             params, prompts, MLA_SS - MLA_TF)
    del model, params, batch, prompts
    gc.collect()
    torch.cuda.empty_cache()
    total = {}
    for _, launches in parts.values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def full_bf16_teacher_forced(tag, model, params, seq, split, extra=None):
    """:func:`teacher_forced` at bf16 against one prefill of all of
    ``seq``: the last logits bf16, each within BF16_LOSS_TOL of the
    largest plus BF16_LOSS_TOL of its own (the CPU tests' bf16 logits
    tolerance: the two take each token's products in batches of other
    sizes, whose bf16 activations round apart)."""
    got, _ = teacher_forced(model, params, seq, split, extra)
    with torch.no_grad():
        want, _ = model.prefill(params, seq, extra)
    got, want = got.float(), want.float()
    d = (got - want).abs()
    excess = (d - BF16_LOSS_TOL * (want.abs().max() + want.abs())).max()
    check(excess.item() <= 0, f"[{tag}] prefill {split} + "
          f"{seq.shape[1] - split} decode steps vs prefill {seq.shape[1]}: "
          f"max |d| {d.max().item():.3g}, excess {excess.item():.3g}")
    print(f"[{tag}] prefill {split} + {seq.shape[1] - split} teacher-forced "
          f"decode steps from the bf16 caches vs one prefill of "
          f"{seq.shape[1]} tokens: logits max abs diff {d.max().item():.3g} "
          f"({d.max().item() / want.abs().max().item():.3g} of the largest; "
          f"tolerance {BF16_LOSS_TOL} of the largest plus of each)")


def phase_bf16_family_eval(dev, _build, key, arch):
    """``[bf16 {key} eval]`` on a whole model with bf16 params (seed 0):
    MusicGen-large (``audio``: 4 codebooks, head_dim 64) or Phi-3-vision
    (``vlm``: 256 float32 patches ahead of the tokens, head_dim 96): its
    loss on 4 held-out sequences of 2048 positions with ``REPRO_USE_FLASH``
    (row 13's bf16 arm, a launch a layer: G 1 at head_dim 64 or 96) and
    without, within BF16_LOSS_TOL; then ``serve.generate`` of BF16_FAM_G
    greedy tokens after 4 prompts of 1536 positions from the bf16 caches.
    Returns the flash eval's launches."""
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.launch.specs import sample_prompts
    from repro_torch.models import build_model
    tag = f"bf16 {key} eval"
    cfg = zoo_config(arch)
    model = build_model(cfg, param_dtype=BF)
    params = model.init(seed=0, device=dev)
    n = sum(v.numel() for v in params.values())
    P = cfg.vision_patches if cfg.vision_stub else 0
    vision = (P, cfg.vision_d) if P else None
    batch = _batch_on(next(lm_batches(cfg.vocab, (EB,), ES - P, seed=999,
                                      codebooks=cfg.n_codebooks,
                                      vision=vision)), dev)
    print(f"[{tag}] {cfg.name}: {cfg.n_layers} layers (whole), {n:,} params "
          f"({2 * n / 2**30:.2f} GiB bf16), head_dim {cfg.head_dim}; held-out "
          f"{ {k: list(v.shape) for k, v in batch.items()} } (seed 999)")
    parts = _eval_parts(tag, [
        (f"{key} server, flash", lambda: batch_loss(model, params, batch,
                                                    flash=True)),
        (f"{key} server, blockwise", lambda: batch_loss(model, params,
                                                        batch))], _build)
    flash, blockwise = (parts[f"{key} server, {a}"] for a in ("flash",
                                                              "blockwise"))
    check(flash[1] == {"flash_attention/bf16": cfg.n_layers}
          and blockwise[1] == {}, f"[{tag}] launches {parts}")
    d = abs(flash[0][0] - blockwise[0][0])
    check(d <= BF16_LOSS_TOL, f"[{tag}] flash vs blockwise {d}")
    print(f"[{tag}] flash vs blockwise |d| {d:.3g} (tolerance "
          f"{BF16_LOSS_TOL})")
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    prompts, extra = sample_prompts(cfg, FAM_SB, FAM_SS - P, seed=0)
    prompts = torch.as_tensor(prompts, dtype=torch.long).to(dev)
    if extra is not None:
        extra = {k: torch.as_tensor(v).to(dev) for k, v in extra.items()}
    _bf16_generate(f"bf16 {key} serve", model, params, prompts, BF16_FAM_G,
                   _build, {}, extra=extra)
    del model, params, prompts, extra
    gc.collect()
    torch.cuda.empty_cache()
    return flash[1]


def kernel_groups(ops):
    """The device ms of the kernels linked to the host ops ``ops``, by
    kernel group."""
    from repro_torch.analysis.trace import kernel_group
    out = {}
    for o in ops:
        for name, t in o[4]:
            g = kernel_group(name)
            out[g] = out.get(g, 0.0) + t
    return out


def profiled(ranges=()):
    """The profiler's activities: the device's kernels, and the host's ops
    only where a profiler range is read (``Trace.tree``).  Recording every
    host op slowed a host-bound round several times over (the hetero
    round's profiled wall reached 20.9 s against 1.67 s unprofiled on one
    host, PERF.md section 6), and the device's kernels do not need them."""
    from torch.profiler import ProfilerActivity
    return ([ProfilerActivity.CPU] if ranges else []) + [
        ProfilerActivity.CUDA]


def device_kernels(prof, skip=()):
    """``(name, device ms, count)`` of every kernel in a profile, leaving
    out the names in ``skip``, and their device ms summed by group."""
    from repro_torch.analysis.trace import Trace
    return Trace(prof).device(skip)


def range_kernels(trace, name):
    """The device kernels of the profiler range ``name``, in ms by kernel
    group: ``{"forward": those launched inside it, "backward": those of the
    autograd nodes its forward ops recorded}`` (a node's
    ``evaluate_function`` event carries the sequence number of the forward
    op that made it), and the range's count of calls."""
    fwd = [o for r in trace.roots(lambda n, _: n == name)
           for o in trace.tree(r)]
    seqs = {o[3] for o in fwd if o[3] >= 0}
    bwd = [o for r in trace.roots(
        lambda n, q: n.startswith("autograd::engine::evaluate_function")
        and q in seqs) for o in trace.tree(r)]
    return trace.calls(name), {"forward": kernel_groups(fwd),
                                      "backward": kernel_groups(bwd)}


def phase_profile(tag, trainer, batch, round_s, ranges=()):
    """One more round (after the counted ones) under torch.profiler:
    device time by kernel group, and its share of an unprofiled round's
    wall time ``round_s`` (the profiled round's own wall time carries the
    profiler's host cost, so it is printed but not divided by); the device
    time of each profiler range of ``ranges``, its forward and its
    backward, by kernel group (``range_kernels``); the client
    steps' update group beside its byte bound for the round, from the
    leaves' sizes."""
    from repro_torch.analysis.roofline import HBM_BW
    from repro_torch.analysis.trace import Trace
    from torch.profiler import profile

    from repro_torch import api
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=profiled(ranges)) as prof:
        trainer.run(iter([batch]), 1)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    # a range shows up on the device too, as an annotation: not a kernel
    trace = Trace(prof)
    kern, groups = trace.device(skip=ranges)
    if not kern:
        print(f"[profile {tag}] the trace holds no device time: not "
              "measured")
        return
    total = sum(t for _, t, _ in kern)
    print(f"[profile {tag}] one round: device kernels {total:.1f} ms = "
          f"{100 * total / (1e3 * round_s):.1f}% of an unprofiled round "
          f"({1e3 * round_s:.1f} ms); profiled wall {wall_ms:.1f} ms")
    for g, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile {tag}] {g:26s} {t:9.2f} ms {100 * t / total:5.1f}%")
    for name, t, n in sorted(kern, key=lambda r: -r[1])[:12]:
        print(f"[profile {tag}]   {t:9.2f} ms x{n:<5d} {name[:100]}")
    for name in ranges:
        calls, parts = range_kernels(trace, name)
        fb = {g: parts["forward"].get(g, 0.0) + parts["backward"].get(g, 0.0)
              for g in {**parts["forward"], **parts["backward"]}}
        ms = {k: sum(v.values()) for k, v in parts.items()}
        both = ms["forward"] + ms["backward"]
        print(f"[profile {tag}] range {name} ({calls} calls): forward "
              f"{ms['forward']:.2f} ms + backward {ms['backward']:.2f} ms on "
              f"the device = {both:.2f} ms = {100 * both / total:.1f}% of the "
              f"round's device time, {100 * both / (1e3 * round_s):.1f}% of "
              "an unprofiled round")
        for g, t in sorted(fb.items(), key=lambda kv: -kv[1]):
            print(f"[profile {tag}] range {name} {g:26s} {t:9.2f} ms "
                  f"{100 * t / total:5.1f}%")
    # the client steps' update group against its byte bound for the round:
    # K steps x C clients x every element of every leaf they step (compact
    # in the extract round), reading w and g (and m) and writing w once, in
    # the params' dtype
    esize = next(iter(trainer.params.values())).element_size()
    group, per_elt = (("masked_sgd_inplace (port)", 4 * esize)
                      if isinstance(trainer.fed, api.MaskFedAvg)
                      else ("sgd_inplace (port)", 3 * esize))
    fed, scfg = trainer.fed, trainer.fed.scfg
    if isinstance(fed, api.WindowFedAvg) and not fed.use_fused:
        # the extract round steps its clients' compact copies
        from repro_torch.core.extract import sub_abstract
        n = sum(math.prod(v) for v in sub_abstract(
            fed.abstract, fed.axes, fed.scheme.sizes).values())
    else:
        n = sum(v.numel() for v in trainer.params.values())
    elts = scfg.local_steps * scfg.clients_per_round * n
    b_ms = 1e3 * per_elt * elts / HBM_BW
    check(groups.get(group, 0.0) > 0,
          f"[profile {tag}] no {group} time in the profile")
    t = groups[group]
    print(f"[profile {tag}] update group {group}: {t:.2f} ms against its "
          f"byte bound {b_ms:.2f} ms ({per_elt * elts / 1e9:.1f} GB at "
          f"{HBM_BW / 1e12:.2f} TB/s): {t / b_ms:.3f}x")


# phase_plan (a): each path's configuration planned on meta, by the tag
# its run_rounds reading is kept under: (tag, arch, seq, scheme, dtype)
PLANNED = [("main", "tinyllama_1_1b", 256, "rolling", torch.float32),
           ("bf16 window", "tinyllama_1_1b", 256, "rolling", torch.bfloat16),
           ("ssm round", "mamba2_130m", SSM_SEQ, "slice", torch.float32),
           ("mask", "tinyllama_1_1b", 256, "bernoulli", torch.float32)]
PLAN_RATIO = (0.90, 1.10)      # planned peak over the card's reading


def phase_plan(dev, smi, peaks):
    """The planning path against the card (after the paths whose peaks it
    reads; it runs no round of theirs again).  (a) Each PLANNED path's
    configuration, planned on meta in this process (``launch.specs.
    make_plan``, ``launch.dryrun.count``): its planned peak beside the
    same run's ``max_memory_allocated`` reading of that path (``peaks``,
    from ``run_rounds``), their ratio within PLAN_RATIO.  (b) The round
    profile at the main path's shapes on the card
    (``analysis.round_profile.profile(..., measure=True)``): each phase's
    counted FLOPs, bytes and roofline beside its device time, every share
    (step_lb / device time) at most ``round_profile.SHARE_MAX`` (the
    profile raises otherwise).  Every line carries the card's name and
    power limit."""
    from repro_torch.analysis import round_profile
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun, specs
    lo, hi = PLAN_RATIO
    for tag, arch, seq, scheme, dtype in PLANNED:
        if tag not in peaks:
            print(f"[plan] {tag}: its path did not run; not compared")
            continue
        scfg = (slice_scfg(client_lr=ROUND_LR) if scheme == "slice"
                else scfg_for(scheme))
        t0 = time.perf_counter()
        plan = specs.make_plan(arch, ShapeConfig(tag, seq, 2 * C, "train"),
                               world=1, cfg=zoo_config(arch), scfg=scfg,
                               param_dtype=dtype)
        c = dryrun.count(plan)
        planned, read = c.peak_bytes, peaks[tag]
        ratio = planned / read
        print(f"[plan] {tag}: planned peak {planned / 2**30:.3f} GiB "
              f"(arguments {c.argument_bytes / 2**30:.3f}), the card's "
              f"max_memory_allocated {read / 2**30:.3f} GiB, ratio "
              f"{ratio:.4f}; planned on meta in "
              f"{time.perf_counter() - t0:.1f} s; {smi}")
        check(lo <= ratio <= hi, f"[plan] {tag}: planned peak over the "
              f"card's reading {ratio:.4f}, outside {PLAN_RATIO}")
    from repro_torch.configs.base import get_config
    prof = round_profile.profile("tinyllama_1_1b", device=dev, measure=True,
                                 cfg=get_config("tinyllama_1_1b"),
                                 scfg=scfg_for("rolling"), seq=256)
    for arm in round_profile.ARMS:
        for ph in round_profile.PHASES:
            vals = {m: prof[f"{arm}_{ph}_{m}"] for m in (
                *round_profile.PHASE_METRICS,
                *round_profile.MEASURED_METRICS)}
            print(f"[plan profile] {arm}_{ph} {json.dumps(vals)}; {smi}")
    for ph in round_profile.PHASES:
        print(f"[plan profile] {ph}_bytes_extract_over_fused "
              f"{prof[f'{ph}_bytes_extract_over_fused']}; {smi}")
    shares = {k: v for k, v in prof.items() if k.endswith("_share")}
    check(all(v <= round_profile.SHARE_MAX for v in shares.values()),
          f"[plan profile] shares over {round_profile.SHARE_MAX}: {shares}")
    return prof


def _timed_phase(name, fn):
    """``fn`` printing its host seconds and the script's elapsed time."""
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            t1 = time.perf_counter()
            print(f"[time] {name}: {t1 - t0:.1f} s (at {t1 - T0:.1f} s)")
    run.phase = name
    return run


T0 = time.perf_counter()
#: the phases a run drives (``--phases``), None for all of them
SELECTED = None
#: the phases a partial run left out, in order
SKIPPED = []


def parse_phases(argv):
    """``--phases name,...``: the ``phase_*`` functions to run (the
    ``phase_`` prefix may be left off); no argument runs every phase.  The
    build and the ``[card]`` line always run."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit("usage: python3 chip_smoke.py [--phases name,...]")
    names = {n if n.startswith("phase_") else f"phase_{n}"
             for n in argv[1].split(",") if n}
    unknown = sorted(n for n in names if not callable(globals().get(n)))
    if unknown:
        raise SystemExit(f"chip_smoke: no such phase {unknown}")
    return names


def wanted(fn, needs=()):
    """Whether the run selects phase ``fn`` and every object in ``needs``
    (what earlier phases handed on) exists; records it as skipped if
    not."""
    name = getattr(fn, "phase", fn.__name__)
    if (SELECTED is not None and name not in SELECTED) or any(
            n is None for n in needs):
        SKIPPED.append(name)
        return False
    return True


def phase(fn, *args, skip=None, needs=(), **kw):
    """Phase ``fn`` on ``args`` where ``wanted``; else ``skip``."""
    return fn(*args, **kw) if wanted(fn, needs) else skip


def main(argv=()):
    global SELECTED
    SELECTED = parse_phases(list(argv))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's check needs the card",
              file=sys.stderr)
        return 2
    for name, fn in list(globals().items()):
        if name.startswith("phase_") and callable(fn):
            globals()[name] = _timed_phase(name, fn)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 everywhere
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products in cuBLAS sum in f32 and round once, as the reference's
    # preferred_element_type=float32 and the port's bf16 kernels do
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    print(f"[card] {kind}; {smi}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")

    phase_build(_build)
    rows = phase(phase_kernels, dev, skip=[])
    rows += phase(phase_kernels_bf16, dev, skip=[])
    try:
        phase(phase_small_agreement, dev)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    for fn in (phase_small_agreement_mask, phase_small_agreement_ssm,
               phase_small_agreement_extract, phase_small_agreement_paper,
               phase_small_agreement_opt, phase_small_agreement_hetero,
               phase_small_agreement_slice, phase_small_agreement_zoo,
               phase_small_agreement_bf16, phase_small_agreement_bf16_ssm):
        phase(fn, dev)
    phase(phase_small_agreement_bf16_zoo, dev, _build)
    launches, trainer, batch, round_s, fused = phase(
        phase_main_path, dev, _build, skip=({}, None, None, None, None))
    e_launches = phase(phase_eval, dev, trainer, _build, skip={},
                       needs=(trainer,))
    phase(phase_profile, "window", trainer, batch, round_s, needs=(trainer,))
    if wanted(phase_trainer_eval, needs=(trainer,)):
        phase_trainer_eval(trainer, full_width(dev)[2])
    del trainer            # the two full-width paths do not fit together
    gc.collect()
    torch.cuda.empty_cache()
    x_launches, f_launches = phase(phase_extract_path, dev, _build, fused,
                                   skip=({}, {}), needs=(fused,))
    del fused
    st_launches = phase(phase_stagger_path, dev, _build, skip={})
    h_launches = phase(phase_hetero_path, dev, _build, skip={})
    fl_launches = phase(phase_fleet_path, dev, _build, skip={})
    mg_launches, mp_launches, mr0_launches, mr1_launches = phase(
        phase_mesh, dev, _build, skip=({}, {}, {}, {}))
    m_launches, trainer, batch, round_s = phase(
        phase_mask_path, dev, _build, skip=({}, None, None, None))
    phase(phase_profile, "mask", trainer, batch, round_s, needs=(trainer,))
    phase(phase_client_phase_peaks, trainer, batch, needs=(trainer,))
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    mo_launches = phase(phase_mask_opt_path, dev, _build, skip={})
    bw_launches, be_launches, bx_launches = phase(
        phase_bf16_window, dev, _build, skip=({}, {}, {}))
    bm_launches = phase(phase_bf16_mask, dev, _build, skip={})
    phase(phase_bf16_serve, dev, _build)
    bsr_launches, bsx_launches = phase(
        phase_bf16_slice_rounds, dev, _build, "bf16 ssm round",
        "mamba2_130m", SSM_SEQ, profile=True, skip=({}, {}))
    bsm_launches = phase(phase_bf16_ssm_mask, dev, _build, skip={})
    bse_launches, bss_launches = phase(phase_bf16_ssm_eval_serve, dev, _build,
                                       skip=({}, {}))
    bhr_launches, bhx_launches = phase(
        phase_bf16_slice_rounds, dev, _build, "bf16 hybrid round",
        "hymba_1_5b", HYB_SEQ, HYB_LAYERS, skip=({}, {}))
    bhe_launches, bhs_launches = phase(phase_bf16_hybrid_eval_serve, dev,
                                       _build, skip=({}, {}))
    bzoo = {}
    for tag, arch, layers, clients, n_fused, n_extract, over, cos_min in \
            BF16_ZOO_ROUNDS:
        key = tag.split()[1]
        bzoo[f"bf16_{key}_round"], bzoo[f"bf16_{key}_extract"] = phase(
            phase_bf16_zoo_round, dev, _build, tag, arch, layers, clients,
            n_fused, n_extract, over, cos_min, skip=({}, {}))
    bme_launches = phase(phase_bf16_mla_eval_serve, dev, _build, skip={})
    bfam_eval = {f"bf16_{key}_eval": phase(phase_bf16_family_eval, dev,
                                           _build, key, arch, skip={})
                 for key, arch in (("audio", "musicgen_large"),
                                   ("vlm", "phi_3_vision_4_2b"))}
    model, params, prompts, s_launches, prefill_s = phase(
        phase_serve_ssm, dev, _build, skip=(None, None, None, {}, None))
    phase(phase_eval_ssm, dev, model, params, _build, needs=(model,))
    phase(phase_profile_serve_ssm, model, params, prompts, prefill_s,
          needs=(model,))
    del prompts
    phase(phase_ssm_grad, dev, model, params, _build, needs=(model,))
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    phase(phase_serve_dense, dev, _build)
    sr_launches, sx_launches = phase(
        phase_slice_rounds, dev, _build, "ssm round", "mamba2_130m",
        SSM_SEQ, skip=({}, {}))
    phase(phase_plan, dev, smi, dict(PEAKS))
    hr_launches, hx_launches = phase(
        phase_slice_rounds, dev, _build, "hybrid round", "hymba_1_5b",
        HYB_SEQ, HYB_LAYERS, skip=({}, {}))
    he_launches, hs_launches = phase(phase_hybrid_serve, dev, _build,
                                     skip=({}, {}))
    zoo = {}
    for tag, arch, layers, clients, n_fused, n_extract in ZOO_ROUNDS:
        key = tag.split()[0]
        zoo[f"{key}_round"], zoo[f"{key}_extract"] = phase(
            phase_zoo_round, dev, _build, tag, arch, layers, clients,
            n_fused, n_extract, skip=({}, {}))
    ze_launches = phase(phase_zoo_eval, dev, _build, skip={})
    qe_launches = phase(phase_serve_continuous, dev, _build, skip={})
    for tag, arch, layers, clients, n_fused, n_extract, over in NEW_ROUNDS:
        key = tag.split()[0]
        zoo[f"{key}_round"], zoo[f"{key}_extract"] = phase(
            phase_zoo_round, dev, _build, tag, arch, layers, clients,
            n_fused, n_extract, over, skip=({}, {}))
    me_launches = phase(phase_mla_eval_serve, dev, _build, skip={})
    fam_eval = {f"{key}_eval": phase(phase_family_eval_serve, dev, _build,
                                     key, arch, skip={})
                for key, arch in (("audio", "musicgen_large"),
                                  ("vlm", "phi_3_vision_4_2b"))}
    p_launches = phase(phase_paper_path, dev, _build, skip={})
    phase(phase_experiment_cli, dev)
    path = {"masked_sgd_inplace": m_launches, "fillin_agg_inplace": m_launches,
            "ssd_chunk_intra": s_launches}
    path.update({name: e_launches for name in (
        "flash_attention", "rolling_matmul", "rolling_matmul_multi",
        "rolling_matmul_dx", "rolling_matmul_dx_multi")})
    # the launches of the extract, full, stagger, hetero, fleet, mask-opt
    # and paper paths (rows 5-11)
    more = {"sgd_inplace": {"extract": x_launches, "full": f_launches,
                            "stagger": st_launches, "hetero": h_launches,
                            "fleet": fl_launches},
            "masked_sgd_inplace": {"paper": p_launches,
                                   "mask_opt": mo_launches},
            "fillin_agg_inplace": {"paper": p_launches,
                                   "mask_opt": mo_launches}}
    more.update({name: {"stagger": st_launches, "hetero": h_launches,
                        "fleet": fl_launches} for name in (
        "rolling_mm_fwd<1>", "rolling_mm_dx<1>", "rolling_mm_fwd<2>",
        "rolling_mm_dx<2>")})
    # the mesh round (rows 5-8, 10): (a)'s NCCL world of one, gather and
    # psum; (b)'s two gloo ranks on the card, each rank's gather launches
    for name in MESH_ROWS:
        more[name].update(mesh=mg_launches, mesh_psum=mp_launches,
                          mesh_gloo_rank0=mr0_launches,
                          mesh_gloo_rank1=mr1_launches)
    # the SSM and hybrid rounds (rows 5-8, 10; the extract rounds row 10
    # alone), the hybrid eval (rows 12, 13) and serving (row 12)
    for name in ("rolling_mm_fwd<1>", "rolling_mm_dx<1>"):
        more[name].update(ssm_round=sr_launches, hybrid_round=hr_launches)
    for name in ("rolling_mm_fwd<2>", "rolling_mm_dx<2>"):
        more[name]["hybrid_round"] = hr_launches
    more["sgd_inplace"].update(ssm_round=sr_launches,
                               ssm_extract=sx_launches,
                               hybrid_round=hr_launches,
                               hybrid_extract=hx_launches)
    more["ssd_chunk_intra"] = {"hybrid_eval": he_launches,
                               "hybrid_serve": hs_launches}
    more["flash_attention"] = {"hybrid_eval": he_launches,
                               "zoo_eval": ze_launches,
                               "qwen3_eval": qe_launches, **fam_eval}
    # this slice's zoo: the rounds (rows 5-8, 10; the extract rounds row 10
    # alone) and the evals (rows 1-4 and 13)
    for name in ("rolling_mm_fwd<1>", "rolling_mm_dx<1>",
                 "rolling_mm_fwd<2>", "rolling_mm_dx<2>"):
        more[name].update({k: v for k, v in zoo.items()
                           if k.endswith("_round")})
    more["sgd_inplace"].update(zoo)
    for name in ("rolling_matmul", "rolling_matmul_multi",
                 "rolling_matmul_dx", "rolling_matmul_dx_multi"):
        more[name] = {"zoo_eval": ze_launches, "mla_eval": me_launches}
    # the bf16 arms, on the bf16 paths: rows 5-8 and 10 on the window
    # rounds (row 10 also on the extract rounds), 9 and 11 on the mask
    # rounds, 1-4 on the eval
    for name in ("rolling_mm_fwd<1>", "rolling_mm_dx<1>",
                 "rolling_mm_fwd<2>", "rolling_mm_dx<2>", "sgd_inplace"):
        path[name + "/bf16"] = bw_launches
    for name in ("masked_sgd_inplace", "fillin_agg_inplace"):
        path[name + "/bf16"] = bm_launches
    for name in ("rolling_matmul", "rolling_matmul_multi",
                 "rolling_matmul_dx", "rolling_matmul_dx_multi"):
        path[name + "/bf16"] = be_launches
    more["sgd_inplace/bf16"] = {"bf16_extract": bx_launches}
    # the bf16 SSM and hybrid paths: rows 5-8 and 10 on their rounds (row
    # 10 alone on the extract rounds), 9 and 11 on Mamba2's mask rounds,
    # 12 on the evals and prefills, 13 on the evals with flash
    for name in ("rolling_mm_fwd<1>", "rolling_mm_dx<1>"):
        more[f"{name}/bf16"] = {"bf16_ssm_round": bsr_launches,
                                "bf16_hybrid_round": bhr_launches}
    for name in ("rolling_mm_fwd<2>", "rolling_mm_dx<2>"):
        more[f"{name}/bf16"] = {"bf16_hybrid_round": bhr_launches}
    more["sgd_inplace/bf16"].update(
        bf16_ssm_round=bsr_launches, bf16_ssm_extract=bsx_launches,
        bf16_hybrid_round=bhr_launches, bf16_hybrid_extract=bhx_launches)
    for name in ("masked_sgd_inplace/bf16", "fillin_agg_inplace/bf16"):
        more[name] = {"bf16_ssm_mask": bsm_launches}
    path["ssd_chunk_intra/bf16"] = bss_launches
    more["ssd_chunk_intra/bf16"] = {"bf16_ssm_eval": bse_launches,
                                    "bf16_hybrid_eval": bhe_launches,
                                    "bf16_hybrid_serve": bhs_launches}
    path["flash_attention/bf16"] = be_launches
    more["flash_attention/bf16"] = {"bf16_hybrid_eval": bhe_launches,
                                    **bfam_eval}
    # the bf16 zoo: rows 5-8 and 10 on its rounds (Mixtral's rows 7-8 on
    # its experts' lanes; row 10 alone on the extract rounds), rows 1-4 on
    # DeepSeek-V3's sub-model eval, 13 on the audio and vlm evals
    for name in ("rolling_mm_fwd<1>", "rolling_mm_dx<1>",
                 "rolling_mm_fwd<2>", "rolling_mm_dx<2>"):
        more[f"{name}/bf16"].update({k: v for k, v in bzoo.items()
                                     if k.endswith("_round")})
    more["sgd_inplace/bf16"].update(bzoo)
    for name in ("rolling_matmul", "rolling_matmul_multi",
                 "rolling_matmul_dx", "rolling_matmul_dx_multi"):
        more[f"{name}/bf16"] = {"bf16_mla_eval": bme_launches}
    own_path = {"ssd_chunk_intra/bf16": "bf16_ssm_serve",
                "flash_attention/bf16": "bf16_eval",
                **{f"{name}/bf16": "bf16_eval" for name in (
                    "rolling_matmul", "rolling_matmul_multi",
                    "rolling_matmul_dx", "rolling_matmul_dx_multi")},
                "masked_sgd_inplace/bf16": "bf16_mask",
                "fillin_agg_inplace/bf16": "bf16_mask"}
    for r in rows:
        r["launches"] = path.get(r["name"], launches).get(r["name"], 0)
        if r["name"] in more:
            own = own_path.get(r["name"], "bf16_window" if r[
                "name"].endswith("/bf16") else "main")
            r["launches_by_path"] = {
                own: r["launches"], **{p: n.get(r["name"], 0) for p, n in
                                       more[r["name"]].items()}}
    # rows 1-8's bf16 arm has two bodies: each path's launches of each
    for r in rows:
        by = {tag: {k.rsplit(" ", 1)[1]: n for k, n in got.items()
                    if k.rsplit(" ", 1)[0] == r["name"]}
              for tag, got in BODY_LAUNCHES.items()}
        by = {tag: n for tag, n in by.items() if n}
        if by:
            r["launches_by_body"] = by
            r["bodies"] = {"wgmma": SRC + "rolling_mm.cu "
                           "rolling_mm_{fwd,dx}_wgmma_kernel (TMA + wgmma)",
                           "mma.sync": SRC + "rolling_mm.cu "
                           "rolling_mm_{fwd,dx}_kernel (copies + mma.sync)"}
    missing = [r["name"] for r in rows if r["launches"] == 0] + [
        f"{r['name']} ({p})" for r in rows
        for p, n in r.get("launches_by_path", {}).items() if n == 0]
    if SELECTED is None:
        check(not missing, f"kernels never launched on their path: {missing}")

    print(json.dumps({"kernels": rows}))
    print(smi)
    if SELECTED is not None:
        print(f"[phases] a partial run (--phases): skipped "
              f"{len(SKIPPED)} phases {SKIPPED}; launches on skipped paths "
              f"read 0 ({missing})")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
