"""Drive the PyTorch/CUDA port of MaGGIe on one NVIDIA GPU, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --outputs PATH [--against REF]
    python3 chip_smoke.py --gather-bwd
    python3 chip_smoke.py --video
    python3 chip_smoke.py --video-train
    python3 chip_smoke.py --remat
    python3 chip_smoke.py --ddp
    python3 chip_smoke.py --baselines
    python3 chip_smoke.py --sparsemat
    python3 chip_smoke.py --baselines-train
    python3 chip_smoke.py --demo
    python3 chip_smoke.py --tools
    python3 chip_smoke.py --alternatives
    python3 chip_smoke.py --space
    python3 chip_smoke.py --studies

The second form only answers requests 0 and 1 in f32 and bf16 and saves the
outputs to PATH; with REF, saved by the same form from another version, it
exits non-zero unless every output is equal bit for bit. The third runs only
K1's backward: its checks of phase 2 and its timing of phase 6.3 (run it in a
copy of another version to compare the two in one call). The fourth runs the
video path only: phase 2's video shapes and phase 8. The fifth runs video
training only: phase 2's video train shapes and phase 9. The sixth runs
phase 10 alone, the seventh phase 11 alone, the eighth phase 12 alone, the
ninth phase 13 alone, the tenth phase 14 alone, the eleventh phase 15
alone, the twelfth phase 16 alone, the thirteenth phase 17 alone, the
fourteenth phase 18 alone (in a rank pair of its own, 18.2 too) with 18's
dryrun, the fifteenth phase 19 alone (its CPU halves beside the build).

Phases (any failure exits non-zero):
1. print the card's name and power limit; build the CUDA kernels from the
   sources in this checkout (one nvcc per source, in parallel), and beside
   the build the CPU halves of the card-vs-CPU steps of 6.1, 9.1 and 12.3
   (``cpu_steps_meanwhile``; 11.3's two CLI processes wait beside those of
   13.3 and 17 and of phase 19's checks), so that no timing shares the host
   with them;
2. hold each kernel against its plain PyTorch twin on the card, at every shape,
   memory layout and dtype the main path gives it, and K2 also on a ragged
   and a misaligned map (exact equality);
3. build the flagship MaGGIe image model at full width (atten_dim 128,
   final_channel 64, num_mask 10, max_inst 10, num_embed 3) with seeded random
   weights, spectral norm converged then folded; answer 8 requests (576x1024,
   3 blob instances each, a different seed per request) in f32 with TF32 off,
   check the launch counts (5 gathers and 3 dilations per frame), and hold one
   frame against the same port on the CPU (plain twins);
4. time the forward in f32 and bf16 with CUDA events (host launch cost
   included), hold the bf16 output against the f32 one, split each frame into
   its stages (CUDA events from forward hooks) and sum its kernels' device time
   (torch.profiler); time each kernel beside its plain twin, a library
   yardstick and its memory bound, in f32 and bf16 (device time from
   CUDA-graph replay; eager times with host cost go to the details file); as
   yardsticks, the NCHW->NHWC copies of the gathered encoder maps that the
   ladder no longer makes, and for K2 a clone of its input (the same bytes);
5. the eval engine on the card: an HIM-style set of 2 frames at 720x1280
   with 3 blob instances each, held in memory and decoded through the port's
   ``HIMDataset`` (``ResizeShort`` downscales each to 576x1024 on the host),
   answered by ``engine.test.eval_image`` with the configuration's metrics, in
   f32 and bf16, and in f32 again with ``dataset.test.device_preprocess`` (the
   resize, pad and normalize on the card); checks 5 gathers and 3 dilations per
   frame, finite metrics, and frame 0's metrics against the port on the CPU
   with the same preprocessing; prints frames/s with metrics on, the per-frame
   forward / loader / host split and peak memory;
6. the train step (``engine.train_step.make_train_step``, AdamW with the
   cosine schedule, gradients through K1's backward kernel): one f32 step of
   the full-width model on the card against the same step on the CPU (plain
   twins) at a reduced batch (2 x 256x256); then 5 steps in f32 and 5 in bf16
   at ``tools/bench_train.py``'s condition (batch 2, 512x512, 10 instance
   slots, synthetic batch from a seed), checking finite losses and 10 K1, 6
   K1-backward and 1 K2 launches per step, with ms/step, peak memory and the
   kernels' device time (failing if a kernel that launched reads no device
   time under its CUDA names); K1's backward timed per call, split into its
   index pass and pull, beside its bound, its twin and an ``index_put_``
   yardstick. Phase 2 also holds K1's forward at every train call and its
   backward at every differentiable one (f32, bf16, per-instance, per-image,
   and a capacity past the tile count) and at its design's edges
   (``BWD_EDGE_CASES``) bit for bit, with equal strides and repeatable bits;
7. the trainer through the CLI: a synthetic HIM set written with PIL into a
   temp dir (a train split of 8 JPEG frames at 720x1280 with 1-5 blob
   instances as PNG alphas, an eval split of 2 frames with guidance masks);
   ``maggie_tpu_torch.main.main`` trains ``configs/maggie_image.yaml`` at full
   width (batch 2, 6 iterations, validation every 3, a loss logged every
   iteration), resumes to 8, trains 3 iterations with ``--precision 16``, and
   then 10 f32 iterations logging every 10 without validation (long enough to
   drain the loader's and the infeed's queues, so that its meters say which of
   the loader and the step sets the pace); checks finite losses, 10 K1, 6 K1-backward and 1 K2 launches per train
   iteration and 5 K1 and 3 K2 per val frame, the checkpoint files, that the
   resumed run starts at iteration 6 from the saved state bit for bit, and that
   ``best_model.npz`` loads into the ``--eval-only`` model with the saved
   parameters bit for bit and its eval forward on a val frame agrees with the
   trainer's model in eval mode; prints samples/s, ``data_time``, the infeed
   stall share, ms/step and peak memory beside phase 6's ms/step, and the host
   cost of one train sample by transform (mean over the 8 frames);
8. the video model (``configs/maggie_video.yaml``, arch MaGGIe_Temp, the
   ConvGRU memory and the bidirectional fusion) at full width with seeded
   random weights, SN folded: one synthetic video of 6 frames at 576x1024
   (3 blob instances that move a few pixels a frame) streamed in 4 windows of
   3 frames with the feature cache (``encode_frames`` on the new frame,
   ``decode_window`` on the rolled pack) in f32, TF32 off; checks 5 K1 and 3
   K2 launches and one encoded frame per window after the first, and holds
   windows 0 and 1 against the CPU port within phase 3's budget (flips only
   where a value lies near a threshold of the path, at most 16 of them;
   detail_mask equal outside K2's reach of such values); times ms per
   window cached and uncached in f32 and bf16 (CUDA events, host launch cost
   included) and prints peak memory. Then the video eval engine:
   ``maggie_tpu_torch.main.main`` with ``--eval-only --config
   configs/maggie_video.yaml`` on a synthetic VIM set written with PIL (a
   video of 4 frames at 720x1280, 3 instances, JPEG frames, PNG alphas and
   masks) at full width with the seven metrics; checks the run's launches
   (counted from 0) and those of each window, finite metrics and
   results.csv; prints frames/s with metrics on, the forward / loader / host
   split per window and MESSDdt's host seconds.
   Phase 2 holds K1 and K2 at the video path's shapes too.
9. video training (``configs/maggie_video.yaml`` in train mode, with the
   earlier phases' models freed): one f32 ``make_train_step`` step of the
   full-width video model on the card against the same step on the CPU port
   at batch 1 x clip 3 x 256x256 (phase 6's limits); TRAIN_STEPS steps at
   batch 1 x clip 8 x 512x512 (the yaml's clip and crop, 10 slots, AdamW,
   cosine, clip 0.01) in f32 and bf16, with ms/step, peak memory,
   10 K1, 6 K1-backward and 1 K2 launches per step, the temporal losses
   finite, the kernels' device time and busy share over 2 steps
   (torch.profiler) and any cuDNN FFT time; K1's backward per call at the
   video train shapes (cap 2560); then ``main.main`` training the yaml at
   full width (batch 1) on a synthetic V-HIM-style train split written with
   PIL (2 videos of 16 frames at 720x1280, 3 moving instances) for 3
   iterations, validating at 3 through ``eval_video`` on a 4-frame VIM
   video from phase 8's writer, in f32: launches per iteration and per val
   window, finite losses, clips/s, ms per iteration against 9.2's
   step, ``data_time``, the stall share, peak memory and the host cost of a
   clip by transform. Phase 2 holds K1, its backward and K2 bit for bit at
   the video train shapes (N = 80 maps, cap 2560) too.
10. rematerialisation (``model.remat``, ``models/remat.py``), after phase 9:
   the image step at phase 6's size (10.1) and the video step at phase 9's
   (10.2) under none, full and selective, in f32 and bf16: each remat step
   against the plain one within phase 6's STEP_* limits (whether bit-equal,
   the CUDA generator's state, one block-index replay checked a step; a
   second plain step and one forwarded on a new thread beside them), each
   step's launches asserted from the stage layout (K1 10 / 20 / 20, its
   backward 6, K2 1 / 2 / 2); in f32 ms/step (median of steps 2-3), peak
   memory and the timed steps' launches, asserted the same. 10.3 fits
   peak = fixed + per-frame x frames through two sizes (image batch 1 and
   2, video clip 4 and 8), predicts the largest batch under 95% of the
   memory the process can hold (not run at it, for the script's time
   limit: PERF.md holds earlier runs at the yamls' batches). 10.4 trains
   through ``main.main`` with ``opts model.remat selective`` on phase 7's
   set: launches 20 / 6 / 2 an iteration. The allocator maps expandable segments during the phase.

11. data parallel (``maggie_tpu_torch/parallel/``): 11.1 phase 6's image
   step (batch 2 x 512x512, 10 slots, f32) on two gloo ranks on the one card
   (``--ddp-rank`` processes on cuda:0, a row each, which then run 11.2's
   steps too; NCCL refuses two ranks
   on one device), plain and under ``model.remat selective``, against one
   process on the card on the same global batch within phase 6's STEP_*
   limits, the ranks' models equal bit for bit after the update, K1, its
   backward and K2 launched 10 / 6 / 1 times (selective 20 / 6 / 2) a step
   on each rank, and the ladder without overflow; ms/step (CUDA events,
   steps 2-3) and peak memory per rank beside one process's; 11.2 the video
   step the same way on two clips of 3 frames at 512x512, a clip a rank;
   11.3 ``torchrun --standalone --nproc_per_node 1 -m
   maggie_tpu_torch.main`` (NCCL) trains phase 7's set for 2 iterations
   and must log the losses of the same run without torchrun. The rank pair
   also runs 14.3's and phase 18's steps. ``--ddp`` runs phase 11 alone
   (with 14.3 and 18).
12. the MGM baseline family (``configs/mgm*.yaml``) at full width from seed
   0: 12.1 ``mgm`` (arch MGM_SingInst) and ``mgm_stacked`` answer 2 frames
   (576x1024, 3 blob instances) in f32 with TF32 off, K2 launched twice a
   harness forward (the fusion's k=30 and k=15; a forward per instance for
   the SingInst arch) and K1 never, one frame held against the CPU port at
   phase 3's rule, ms/frame f32 and bf16, bf16 vs f32 (within
   BASE_BF16_*), peak memory; 12.2
   ``mgm_tcvom`` and ``mgm_stacked_tcvom`` stream one 576x1024 video of 4
   frames through ``eval_video`` (2 windows of 3 frames; the whole forward
   on every window), the same launch rule, window 0 against the CPU port,
   ms/window (beside the window's frames encoded in one batch, as the JAX
   package does), peak memory; K2 against its twin at each config's shapes;
   12.3 one f32 train step of ``mgm_stacked`` (batch 1) and of
   ``mgm_tcvom`` (batch 1 x clip 3) at 512x512 on the card against the CPU
   port within phase 6's STEP_* limits, then ms/step and peak memory at
   ``mgm_stacked``'s batch 2 and ``mgm_tcvom``'s clip of 8.
   ``--baselines`` runs phase 12 alone.
13. SparseMat (``configs/sparsemat_*.yaml``, arch SparseMat_SingInst) and
   the dense InstMatt ablation decoder, from seed 0: 13.1 the image yaml,
   its LPN's last head scaled so that a part of each frame is active,
   answers 2 frames (576x1024, 3 blob instances: a forward per instance),
   no kernel launched, each active share within SM_ACTIVE_RANGE, frame 0
   against the CPU port (within REFINED_ATOL off the reach of the pixels
   whose active set differs between the two), ms/frame and peak memory in
   f32 (SparseMat reads no precision); 13.2 the video yaml streams one
   576x1024 video of 4 frames with a still background through
   ``eval_video`` (2 windows), ms/window, the share of pixels kept from the
   previous frame (``shared``), which must be above 0, and window 0's first
   instance against the CPU port by 13.1's rule; 13.3 one f32 step of each
   yaml at one slot on the card against the CPU port within phase 6's
   STEP_* limits (the yamls' own batches are phase 14.2's); 13.4
   ``configs/maggie_image.yaml`` with the decoder
   ``res_shortcut_inst_matt_22`` (final_channel 128) through 12.1's
   ``base_image``: K2 three times a forward, the first forward's calls
   against its twin, the forward against the CPU port at phase 3's rule,
   f32 and bf16, bf16 vs f32 within BASE_BF16_*; and 3 train steps (K2 once
   a step).
   ``--sparsemat`` runs phase 13 alone.
14. remat and data parallel for the baselines (``models/remat.py``: the
   harness with a dense decoder in 3 segments, TCVOM in 2, SparseMat in 1),
   f32, seed 0, yamls' widths, 512x512: 14.1 ``mgm_stacked`` (batch 2),
   ``mgm_stacked_tcvom`` (1 clip of 8), ``sparsemat_video`` (1 clip of 8,
   one slot) and the dense InstMatt decoder (batch 2) under none, full and
   selective, 3 steps each from the same weights and generator seed: each
   remat mode's first step against the plain one within phase 6's STEP_*
   limits (bit-equal or not), the generator's state equal, ms/step (median
   of steps 2-3), peak memory, K2 launches a step asserted from the layout
   (the dense decoder 1 / 2 / 2, the rest 0; K1 never); 14.2 the yaml's own
   batch that fits only under ``selective`` (``mgm_stacked_tcvom``'s 4
   clips of 8) under it: whether it fits,
   ms/step and peak where it does, else the largest batch that fits (each
   out-of-memory batch reported) with phase 10.3's fit through 14.1's
   point; 14.3 ``mgm_stacked_tcvom`` (2 clips of
   3, a clip a rank) and ``sparsemat_image`` (2 images) on two gloo ranks
   on the card, plain and under selective, against one process on the card
   within STEP_*, the ranks bit-equal: run in phase 11's rank pair (after 11.1-11.2) and
   checked there. ``--baselines-train`` runs 14.1-14.2 alone.
15. the demo's serving path (``maggie_tpu_torch/demo/``): the flagship
   image and video models' seed-0 weights written as ``.safetensors`` with
   numpy; ``demo.app.launch_http`` on a free port in this process, on the
   card; 4 image requests (``POST /image``: a 720x1280 frame and 3 blob
   mask PNGs) and a video request (``POST /video``: 5 frames at 576x1024,
   masks for frame 0 only, carried by ``FlowPropagator``'s numpy
   Farneback flow), sent twice (timed, then recorded); status 200 and
   outputs that decode, K1 5 and K2 3 launches per request and per window,
   request 0 and the recorded video against the same requests on the CPU
   port (phase 3's and phase 8's rules); ms per image request (median of
   2-4) split into model (CUDA events) and host, ms per window, the
   propagator's host seconds per frame, peak memory. ``--demo`` runs phase
   15 alone.
16. the tools (``maggie_tpu_torch/tools/``): 16.1 an HIM-style eval set of
   2 frames at 720x1280 with 3 blob alphas each written with PIL,
   ``tools.gen_mask --variant full`` on it (host seconds per mask), then
   ``main.main --eval-only`` on the card at full width with
   ``dataset.test.mask_dir_name masks_gen_full``: K1 5 and K2 3 launches a
   frame, the masks the dataset decoded equal to the arrays the tool wrote,
   one results.csv row of finite metrics; 16.2 ``python -m
   maggie_tpu_torch.tools.train_supervisor`` around ``python -m
   maggie_tpu_torch.main`` on phase 7's set at phase 7's batch for 4
   iterations, a checkpoint every iteration, ``MAGGIE_FAULT_INJECT_ITER`` 3:
   exit 0 after exactly one restart, which carried ``train.resume_last
   True``, the first child logging iterations 1-2 and the second 3-4 with
   finite losses, ``last_step.txt`` and ``last_state.pt`` at step 4; the
   seconds of each child and of each probe. ``--tools`` runs phase 16 alone.
17. the off-by-default alternatives at full width: ``s2d_stem`` and
   ``lazy_os2_shortcut`` build the default model (its modules and seed-0
   weights, checked on the CPU), so the default's numbers are theirs;
   ``phase_rung`` and ``atten_stride 2`` alone and the default: K1 and K2
   launches a frame (5 and 3; K1 6 with the phase rung), one f32 frame
   against the CPU port (phase 3's checks), ms/frame in f32 and bf16 (CUDA
   events, 3 rounds over the three models); K1 at the call shapes the
   phase rung adds, equal to its twin and timed by graph replay against its
   byte bound, warm and over rotating copies of the map that no 50 MB L2
   holds; one window of the video yaml at 256x512 with lazy os2 and the
   phase rung through ``encode_frames`` / ``decode_window`` against the CPU
   (phase 8's check); one step at batch 1 x 512x512 (phase 6's frame size)
   with ``atten_stride 2`` against the CPU within STEP_*.
   ``--alternatives`` runs phase 17 alone.
18. row sharding (``maggie_tpu_torch/parallel/space.py``), in phase 11's
   rank pair after 14.3: the flagship step at full width on one 1024x1024
   frame (3 instances in 10 slots, cap 0.5, f32) with its rows split over
   a space group of the two gloo ranks (``space.shard_batch_2d``), against
   one process on the whole frame on the card within STEP_*: the ranks
   bit-equal, each rank's block selection the one process's, K1 10 / its
   backward 6 / K2 1 launches on each rank; each geometry K1, its backward
   and K2 met on a rank (band-plus-halo maps, the band's entries) held
   against the plain twins (equal bits); ms/step (median of steps 2-3) and
   the step's peak memory above its start per rank beside one process's
   (the rank's must be lower); then ``maggie_tpu_torch.dryrun.dryrun_multichip(2)``
   on the card beside 11.3's CLI runs. 18.2, on the same pair after it:
   the video step (``configs/maggie_video.yaml`` at full width, f32) on one
   clip of 3 frames at 512x512 (3 moving instances in 10 slots), rows split
   1 x 2, against one process on the whole clip by the same checks (the
   ConvGRU in the replicated os8 stage, the diff module replicated on the
   whole os8 maps, its change maps resized to each band). ``--space`` runs
   phase 18 and 18.2 alone.
19. the block-capacity studies (``maggie_tpu_torch/tools/``), shortened:
   19.1 ``cap_quality`` on 10 procedural scenes at 576x1024 (K2 once a
   scene; scenes 0-1's dropped and active shares equal to the CPU port's;
   K2 equal to its twin at 2 and 4 instances; host seconds per
   ``procedural_alpha``; the capacity table); 19.2 ``train_curve``'s oracle
   and block ladders, 20 iterations each at 192x192 (launches a step: K2 1
   for the oracle, K1 10 / its backward 6 / K2 1 for the block ladder;
   ms/step; the first 2 iterations' loss terms against the CPU port's
   within STEP_LOSS_RTOL); 19.3 ``train_long`` (bf16, selective, cap 0.5)
   for 20 iterations with a check every 10 (finite losses, K1 20 / 6 / K2 2
   a step and K1 5 / K2 3 a check scene, the check's MAD); 19.4 K1, its
   backward and K2 at every geometry 19.1-19.3 launched them (train and
   check, f32 and bf16) against their plain twins, exactly. The CPU halves
   run beside 11.3's CLI processes. ``--studies`` runs phase 19 alone.

Prints a ``{"kernels": [...]}`` line (each kernel's ``ddp_launches``: its
launches over the ranks' checked steps of 11.1 and 11.2; ``space_launches``:
over phase 18's ranks' checked step; ``space_video_launches``: over 18.2's;
``study_launches``: over phase 19; ``baseline_launches``:
phase 12.1's and 12.2's; ``sparsemat_launches``: phase 13.4's;
``baseline_train_launches``: phase 14.1's; ``demo_launches``: phase 15's
requests; ``tools_launches``: phase 16.1's eval; ``alternatives_launches``:
phase 17's models, video window and step) and the card line, and last
``{"ok": true, "device": {...}}``. Details go to output/torch_port/chip_smoke.json
(``chip_smoke_video.json``, ``chip_smoke_video_train.json``,
``chip_smoke_remat.json``, ``chip_smoke_ddp.json``,
``chip_smoke_baselines.json``, ``chip_smoke_sparsemat.json``,
``chip_smoke_baselines_train.json``, ``chip_smoke_demo.json``,
``chip_smoke_tools.json``, ``chip_smoke_alternatives.json``,
``chip_smoke_space.json`` and ``chip_smoke_studies.json`` for ``--video``,
``--video-train``, ``--remat``, ``--ddp``, ``--baselines``, ``--sparsemat``,
``--baselines-train``, ``--demo``, ``--tools``, ``--alternatives``,
``--space`` and ``--studies``).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3, NVIDIA data sheet
H, W, N_INST = 576, 1024, 3
N_REQUESTS = 6                # few, for the script's time limit
SPLIT_FRAMES = 6              # frames per stage split and per profiled window
CAP = 216                     # round(0.5 * 3 instances * 9 * 16 blocks)
# Main-path K1 calls per frame (decoder_sparse.py predict_details_block):
# (name, map shape (N, H, W, C) at 576x1024, block, halo, per-image index?,
# memory layout). "pixel": contiguous NHWC; "plane": the NHWC view of the
# encoder's contiguous NCHW tensor, which the kernel reads without a copy.
GATHER_CALLS = (
    ("os1_mask", (3, 576, 1024, 1), 64, 32, False, "pixel"),
    ("x8", (3, 72, 128, 64), 8, 3, False, "pixel"),
    ("fea3", (1, 144, 256, 64), 16, 4, True, "plane"),
    ("fea2", (1, 288, 512, 32), 32, 2, True, "plane"),
    ("sc0_input", (1, 576, 1024, 6), 64, 5, True, "plane"),
)
UNKNOWN_K = (30, 27, 15)
# The video path's K1 calls per 3-frame window (decoder_video.py through
# decoder_sparse.py predict_details_block on b * n_f = 3 frames), at 576x1024
# with 3 instances: the os1 mask and x8 per instance and frame (N = 9), the
# encoder maps per frame (N = 3); the capacity covers the window,
# round(0.5 * 9 maps * 144 blocks) = 648.
VIDEO_FRAMES = 3
VIDEO_CAP = 648
VIDEO_GATHER_CALLS = (
    ("os1_mask", (9, 576, 1024, 1), 64, 32, False, "pixel"),
    ("x8", (9, 72, 128, 64), 8, 3, False, "pixel"),
    ("fea3", (3, 144, 256, 64), 16, 4, True, "plane"),
    ("fea2", (3, 288, 512, 32), 32, 2, True, "plane"),
    ("sc0_input", (3, 576, 1024, 6), 64, 5, True, "plane"),
)
# Train-path K1 calls per step (decoder_sparse.py predict_details_block_train)
# at the card condition (tools/bench_train.py's: batch 2, 512x512, 10 slots, so
# N = 20 instance maps, an 8x8 grid of os1 blocks, cap 640): (name, map shape
# (N, H, W, C), block, halo, per-image index?, layout, differentiable?).
TRAIN_BATCH, TRAIN_HW, TRAIN_SLOTS = 2, 512, 10
TRAIN_CAP = 640               # round(0.5 * 20 maps * 64 blocks)
TRAIN_GATHER_CALLS = (
    ("x8", (20, 64, 64, 64), 8, 3, False, "pixel", True),
    ("m8", (20, 64, 64, 1), 8, 3, False, "pixel", False),
    ("m4", (20, 128, 128, 1), 16, 6, False, "pixel", False),
    ("fea3", (2, 128, 128, 64), 16, 4, True, "plane", True),
    ("x4_dense", (20, 128, 128, 64), 16, 1, False, "pixel", True),
    ("m2", (20, 256, 256, 1), 32, 2, False, "pixel", False),
    ("fea2", (2, 256, 256, 32), 32, 0, True, "plane", True),
    ("x2_dense", (20, 256, 256, 32), 32, 2, False, "pixel", True),
    ("m1", (20, 512, 512, 1), 64, 4, False, "pixel", False),
    ("fea1", (2, 512, 512, 32), 64, 3, True, "plane", True),
)
TRAIN_STEPS = 5
# The video train step's K1 calls (phase 9: configs/maggie_video.yaml, batch 1
# x clip 8 at 512x512, 10 slots, so N = 80 instance maps on the 8x8 grid of
# os1 blocks and 8 frames of encoder maps): TRAIN_GATHER_CALLS' sites at
# these maps, cap round(0.5 * 80 maps * 64 blocks) = 2560.
VIDEO_TRAIN_CLIP, VIDEO_TRAIN_CAP = 8, 2560
VIDEO_TRAIN_GATHER_CALLS = tuple(
    (name, ((VIDEO_TRAIN_CLIP * TRAIN_SLOTS) if not per_image else VIDEO_TRAIN_CLIP,) + shape[1:],
     block, halo, per_image, layout, grad)
    for name, shape, block, halo, per_image, layout, grad in TRAIN_GATHER_CALLS)
# K1 backward's edges beyond the train calls: (name, map (N, H, W, C), block,
# halo, layout, cap, entries, offset of g in elements). Entries: "random" tiles
# with repeats over the whole grid, edge tiles included; "tile0", every entry on
# tile 0 (a list longer than the kernel's 256 staged windows); "sparse", a few
# entries on a large grid, so that most neighbourhoods list none; "off_grid",
# random with a third of the entries outside [0, N) x the tile grid. An offset
# of 1 puts g off 16-byte alignment (a contiguous view into a larger buffer).
# The last two have tiles smaller than a bf16 box, so a box holds two tiles
# side by side, and a ragged last group of columns.
BWD_EDGE_CASES = (
    ("ragged", (3, 50, 75, 8), 16, 3, "pixel", 40, "random", 0),
    ("ragged_plane", (2, 50, 75, 8), 16, 3, "plane", 40, "random", 0),
    ("halo_eq_block", (2, 64, 64, 16), 8, 8, "plane", 60, "random", 0),
    ("halo_gt_block", (2, 48, 40, 8), 8, 11, "pixel", 50, "random", 0),
    ("halo_gt_block_plane", (2, 48, 40, 8), 8, 11, "plane", 50, "random", 0),
    ("c3", (2, 64, 48, 3), 16, 4, "pixel", 24, "random", 0),
    ("c3_plane", (2, 64, 48, 3), 16, 4, "plane", 24, "random", 0),
    ("c1", (2, 64, 48, 1), 16, 4, "pixel", 24, "random", 0),
    ("long_list", (1, 32, 32, 8), 16, 2, "pixel", 300, "tile0", 0),
    ("long_list_plane", (1, 32, 32, 8), 16, 2, "plane", 300, "tile0", 0),
    ("sparse", (2, 256, 256, 32), 16, 2, "plane", 6, "sparse", 0),
    ("off_grid", (2, 64, 64, 8), 16, 2, "pixel", 30, "off_grid", 0),
    ("misaligned_g", (2, 64, 64, 32), 16, 2, "pixel", 30, "random", 1),
    ("misaligned_g_plane", (2, 64, 64, 32), 16, 2, "plane", 30, "random", 1),
    ("wide_c", (1, 4, 6, 8200), 2, 1, "plane", 5, "random", 0),
    ("wide_c_pixel", (1, 4, 6, 8200), 2, 1, "pixel", 5, "random", 0),
    ("tiles_per_box", (2, 24, 40, 64), 8, 3, "pixel", 20, "random", 0),
    ("tiles_per_box_plane", (2, 24, 40, 64), 8, 10, "plane", 20, "random", 0),
)
# phase 6's card-vs-CPU step: the full-width model on a smaller batch, so that
# the CPU step (plain twins) takes seconds: batch 2 at 256x256, 10 slots.
REDUCED_BATCH, REDUCED_HW = 2, 256
# refined_masks GPU (cuDNN/cuBLAS f32, TF32 off) vs CPU (plain twins): the two
# differ only by summation order through ~70 conv/matmul layers of random
# weights; 1e-3 is the reference's own alpha parity budget (MAD 1e-3).
REFINED_ATOL = 1e-3
# bf16 vs f32 refined_masks on the card, same weights and frame. The bf16 path
# is deterministic here: three runs read mean |d alpha| 7.1055e-5 (PERF.md), so
# the mean may grow to 2e-4 (under 3x the reading). Pixels off by more than
# BF16_FAR are those where a bf16 os8 alpha crossed a threshold and the detail
# mask (and so the fused source) changed: 13 of 1,769,472 (share 7.3e-6) in the
# run that read it, so their share may grow to 3e-5 (about 4x, 53 pixels).
BF16_MEAN_ATOL = 2e-4
BF16_FAR = 0.05
BF16_FAR_SHARE = 3e-5
OUT_DIR = os.path.join("output", "torch_port")  # git-ignored (output/*)
# phase 5: the eval engine on an HIM-style set held in memory
ENGINE_FRAMES = 2             # few, for the script's time limit
ENGINE_SRC = (720, 1280)      # ResizeShort(576) takes each frame to 576x1024
# frame 0's metrics on the card against the port on the CPU (relative error,
# worst of the eight metrics). The first reading (PERF.md) was 7.37e-8
# in f32, float rounding of alphas that agree to about 1e-7, so f32 may grow
# to 1e-5; and 1.59e-4 in bf16, so bf16 may grow to 1e-3 (about 6x). A wrong
# instance or a lost frame moves a metric by far more.
ENGINE_F32_RTOL = 1e-5
ENGINE_BF16_RTOL = 1e-3
# the same, f32 with device_preprocess on both sides (the card's and the CPU's
# f32 resize may round the model input differently): the first reading was
# 7.65e-8 (PERF.md), as the host chain's, so it keeps the f32 limit.
ENGINE_DP_RTOL = ENGINE_F32_RTOL


# CUDA function names of each ported kernel, as torch.profiler lists them
KERNEL_NAMES = {"gather_patches": ("gather_pixel_major", "gather_plane_major"),
                "gather_patches_bwd": ("build_tile_lists", "gather_bwd_pull"),
                "compute_unknown": ("compute_unknown_kernel",)}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call: ``iters`` calls captured in one CUDA graph, replayed
    ``reps`` times between CUDA events, so that host-side launch cost (Python,
    ctypes, allocation) is not counted."""
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
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def sample_indices(shape, block, per_image, dev, rs, cap=CAP, maps=N_INST):
    """``cap`` entries over the block grid: every corner and edge block first,
    then random blocks, over ``maps`` instance maps; per-image calls index
    with n // N_INST (repeated tiles)."""
    n, h, w, _ = shape
    nby, nbx = 576 // 64, 1024 // 64
    assert (h // block, w // block) == (nby, nbx), (shape, block)
    border = [(0, 0), (0, nbx - 1), (nby - 1, 0), (nby - 1, nbx - 1)]
    border += [(0, x) for x in range(nbx)] + [(nby - 1, x) for x in range(nbx)]
    border += [(y, 0) for y in range(nby)] + [(y, nbx - 1) for y in range(nby)]
    by = np.array([b[0] for b in border] + list(rs.randint(0, nby, cap)))[:cap]
    bx = np.array([b[1] for b in border] + list(rs.randint(0, nbx, cap)))[:cap]
    inst = rs.randint(0, maps, cap)
    idx_n = inst // N_INST if per_image else inst
    return [torch.from_numpy(a.astype(np.int64)).to(dev) for a in (idx_n, by, bx)]


def train_indices(shape, block, per_image, dev, rs, cap=TRAIN_CAP):
    """``cap`` entries over the train maps' 8x8 block grid, as select_blocks
    gives them: distinct (map, by, bx) tiles in random order; per-image calls
    index with n // TRAIN_SLOTS (up to 10 entries per tile). A map with fewer
    tiles than ``cap`` gets them all, then entries repeating tile 0, as
    select_blocks pads a capacity past the tile count."""
    nb = TRAIN_HW // 64
    assert shape[1] // block == nb and shape[2] // block == nb, (shape, block)
    maps = shape[0] * (TRAIN_SLOTS if per_image else 1)
    tiles = rs.permutation(maps * nb * nb)[:cap]
    tiles = np.concatenate([tiles, np.zeros(cap - len(tiles), np.int64)])
    idx_n = tiles // (nb * nb) // (TRAIN_SLOTS if per_image else 1)
    rem = tiles % (nb * nb)
    return [torch.from_numpy(a.astype(np.int64)).to(dev) for a in (idx_n, rem // nb, rem % nb)]


def train_gather_cases(calls=TRAIN_GATHER_CALLS, overflow=True):
    """(name, shape, block, halo, per_image, layout, differentiable) at every
    train call; with ``overflow`` each differentiable per-instance call also
    on an 8-map copy, whose 512 tiles the 640 entries overflow."""
    for name, shape, block, halo, per_image, layout, grad in calls:
        yield name, shape, block, halo, per_image, layout, grad
        if overflow and grad and not per_image:
            yield name + "_overflow", (8,) + shape[1:], block, halo, per_image, layout, grad


def bwd_edge_inputs(case, dtype, dev, seed):
    """(g, [idx_n, idx_by, idx_bx]) of one BWD_EDGE_CASES row, from ``seed``."""
    _, (n, h, w, c), block, halo, _, cap, entries, shift = case
    rs = np.random.RandomState(seed)
    nby, nbx = -(-h // block), -(-w // block)
    idx = np.stack([rs.randint(0, n, cap), rs.randint(0, nby, cap), rs.randint(0, nbx, cap)])
    if entries == "tile0":
        idx[:] = 0
    elif entries == "off_grid":
        bounds = (n, nby, nbx)
        for p in np.flatnonzero(rs.rand(cap) < 1 / 3):
            axis = rs.randint(3)
            idx[axis, p] = rs.choice([-1, bounds[axis], bounds[axis] + 5])
    size = block + 2 * halo
    numel = cap * size * size * c
    flat = torch.randn(numel + shift, generator=torch.Generator().manual_seed(seed))
    g = flat.to(dev, dtype)[shift:].view(cap, size, size, c)
    return g, [torch.from_numpy(a.astype(np.int64)).to(dev) for a in idx]


def gather_map(shape, layout, dtype, dev, seed=None) -> torch.Tensor:
    """A map (N, H, W, C) in the memory layout the main path hands the kernel:
    random normal from ``seed``, else uniform on the card."""
    n, h, w, c = shape
    if seed is None:
        x = torch.rand((n, c, h, w), device=dev)
    else:
        x = torch.randn((n, c, h, w), generator=torch.Generator().manual_seed(seed)).to(dev)
    x = x.to(dtype).permute(0, 2, 3, 1)
    return x.contiguous() if layout == "pixel" else x


def gather_dtypes(shape):
    """The C=1 os1 mask is f32 in both forwards; the features follow the model."""
    return (torch.float32,) if shape[-1] == 1 else (torch.float32, torch.bfloat16)


def touched_bytes(shape, idx_n, idx_by, idx_bx, block, halo, esize) -> int:
    """Distinct in-map input elements the windows cover (what must be read)."""
    n, h, w, c = shape
    cover = torch.zeros((n, h + 2 * halo, w + 2 * halo), dtype=torch.bool, device=idx_n.device)
    size = block + 2 * halo
    for p in range(idx_n.shape[0]):
        y0, x0 = int(idx_by[p]) * block, int(idx_bx[p]) * block
        cover[int(idx_n[p]), y0:y0 + size, x0:x0 + size] = True
    return int(cover[:, halo:halo + h, halo:halo + w].sum()) * c * esize


def window_bytes(shape, idx_n, idx_by, idx_bx, block, halo, esize) -> int:
    """In-map elements of every entry's window, counted per window (what the
    transpose must read of g: the off-map halo carries nothing); entries off
    the grid count 0."""
    n, h, w, c = shape
    size = block + 2 * halo
    ok = ((idx_n >= 0) & (idx_n < n) & (idx_by >= 0) & (idx_by * block < h)
          & (idx_bx >= 0) & (idx_bx * block < w))

    def extent(b, length):
        lo = b * block - halo
        return (torch.clamp(lo + size, max=length) - torch.clamp(lo, min=0)).clamp(min=0)
    area = extent(idx_by, h) * extent(idx_bx, w) * ok
    return int(area.sum()) * c * esize


def check_video_gathers(dev, rs, out, worst) -> None:
    """K1 at the video path's five calls of a window, in their layouts, f32
    and bf16 (the os1 mask f32), against its twin; appends to ``out``."""
    from maggie_tpu_torch.ops.kernels import gather as kg
    for name, shape, block, halo, per_image, layout in VIDEO_GATHER_CALLS:
        idx = sample_indices(shape, block, per_image, dev, rs, VIDEO_CAP, VIDEO_FRAMES * N_INST)
        for dt in gather_dtypes(shape):
            feat = gather_map(shape, layout, dt, dev, seed=len(out["gather"]))
            got = kg.gather_patches(feat, *idx, block, halo)
            ref = kg.gather_patches_plain(feat, *idx, block, halo)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            if not torch.equal(got, ref):
                fail(f"gather video {name} {dt}: kernel != plain twin (max |diff| {err})")
            worst["gather"] = max(worst["gather"], err)
            out["gather"].append({"call": "video_" + name, "dtype": str(dt), "shape": list(shape),
                                  "layout": layout, "out": list(got.shape), "equal": True})


def check_train_gathers(dev, rs, out, worst, video=False) -> None:
    """The train path: K1's forward at every train call, and its backward (bit
    for bit: the twin sums in the kernel's order) at every differentiable one,
    with the twin's strides; with ``video``, the video train step's calls
    (VIDEO_TRAIN_GATHER_CALLS, cap VIDEO_TRAIN_CAP). Appends to ``out`` and
    ``worst``."""
    from maggie_tpu_torch.ops.kernels import gather as kg
    out.setdefault("gather", [])
    out.setdefault("gather_bwd", [])
    worst.setdefault("gather_bwd", 0.0)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = (train_gather_cases(VIDEO_TRAIN_GATHER_CALLS, overflow=False) if video
             else train_gather_cases())
    cap, tag = (VIDEO_TRAIN_CAP, "video_train_") if video else (TRAIN_CAP, "train_")
    for name, shape, block, halo, per_image, layout, grad in cases:
        idx = train_indices(shape, block, per_image, dev, rs, cap)
        for dt in gather_dtypes(shape):
            feat = gather_map(shape, layout, dt, dev)
            got = kg.gather_patches(feat, *idx, block, halo)
            ref = kg.gather_patches_plain(feat, *idx, block, halo)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"gather {tag}{name} {dt}: kernel != plain twin "
                     f"(max |diff| {float((got.float() - ref.float()).abs().max())})")
            out["gather"].append({"call": tag + name, "dtype": str(dt), "shape": list(shape),
                                  "layout": layout, "out": list(got.shape), "equal": True})
            if not grad:
                continue
            g = torch.randn(got.shape, device=dev, generator=gen).to(dt)
            check_bwd(tag + name, g, idx, shape, block, halo, layout, out, worst)
            out["gather_bwd"][-1]["per_image"] = per_image


def check_bwd(name, g, idx, shape, block, halo, layout, out, worst) -> None:
    """K1's backward on the card against its twin: equal bits, equal strides,
    and the same bits from a second run (no float atomics)."""
    from maggie_tpu_torch.ops.kernels import gather as kg
    plane = layout == "plane"
    got = kg.gather_patches_bwd(g, *idx, shape, block, halo, plane)
    again = kg.gather_patches_bwd(g, *idx, shape, block, halo, plane)
    ref = kg.gather_patches_bwd_plain(g, *idx, shape, block, halo, plane)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max()) if got.numel() else 0.0
    if not torch.equal(got, ref) or got.stride() != ref.stride():
        fail(f"gather backward {name} {g.dtype}: kernel != plain twin (max |diff| {err}, "
             f"strides {got.stride()} vs {ref.stride()})")
    bits = torch.int16 if g.dtype == torch.bfloat16 else torch.int32
    if not torch.equal(got.view(bits), again.view(bits)):
        fail(f"gather backward {name} {g.dtype}: two runs differ")
    worst["gather_bwd"] = max(worst.get("gather_bwd", 0.0), err)
    out.setdefault("gather_bwd", []).append({"call": name, "dtype": str(g.dtype),
                                             "shape": list(shape), "layout": layout,
                                             "equal": True, "repeatable": True})


def check_bwd_edges(dev, out, worst) -> None:
    """K1's backward at every BWD_EDGE_CASES row, f32 and bf16."""
    for case in BWD_EDGE_CASES:
        name, shape, block, halo, layout = case[:5]
        for dt in (torch.float32, torch.bfloat16):
            g, idx = bwd_edge_inputs(case, dt, dev, len(name))
            if (g.data_ptr() % 16 == 0) != (case[-1] == 0):
                fail(f"gather backward {name}: g not at the intended alignment")
            check_bwd("edge_" + name, g, idx, shape, block, halo, layout, out, worst)


def check_unknown(a, k, label, out, worst) -> None:
    """K2 on ``a`` at ``k`` against its plain twin, exactly."""
    from maggie_tpu_torch.ops.kernels import unknown as ku
    got = ku.compute_unknown(a, k)
    ref = ku.compute_unknown_plain(a, k)
    torch.cuda.synchronize()
    err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        fail(f"compute_unknown k={k} {label}: kernel != plain twin "
             f"({int((got != ref).sum())} pixels differ)")
    worst["unknown"] = max(worst["unknown"], err)
    out["unknown"].append({"k": k, "case": label, "shape": list(a.shape),
                           "ones": int(got.sum()), "equal": True})


def check_video_unknown(dev, out, worst) -> None:
    """K2's three calls of a video window on its 3 frames x 3 instances, f32
    in both precisions (the os8 alpha comes from f32 logits)."""
    alphas = torch.from_numpy(video_alphas(VIDEO_FRAMES, H, W)[0]).to(dev)
    for k in UNKNOWN_K:
        check_unknown(alphas, k, "video", out, worst)


def check_video_train_unknown(dev, out, worst) -> None:
    """K2's one call of a video train step, k=30 on the clip's f32 os8 alphas
    (8 frames x 10 slots at 512x512, 3 of them moving discs)."""
    a = np.zeros((VIDEO_TRAIN_CLIP, TRAIN_SLOTS, TRAIN_HW, TRAIN_HW), np.float32)
    a[:, :N_INST] = video_alphas(VIDEO_TRAIN_CLIP, TRAIN_HW, TRAIN_HW)[0]
    check_unknown(torch.from_numpy(a).to(dev), 30, "video_train", out, worst)


def phase_kernels(dev, detail) -> dict:
    from maggie_tpu_torch.flagship import blob_alpha
    from maggie_tpu_torch.ops.kernels import gather as kg
    rs = np.random.RandomState(7)
    out = {"gather": [], "unknown": []}
    worst = {"gather": 0.0, "unknown": 0.0}
    for name, shape, block, halo, per_image, layout in GATHER_CALLS:
        idx = sample_indices(shape, block, per_image, dev, rs)
        for dt in gather_dtypes(shape):
            feat = gather_map(shape, layout, dt, dev, seed=len(out["gather"]))
            got = kg.gather_patches(feat, *idx, block, halo)
            ref = kg.gather_patches_plain(feat, *idx, block, halo)
            torch.cuda.synchronize()
            err = float((got.float() - ref.float()).abs().max())
            if not torch.equal(got, ref):
                fail(f"gather {name} {dt}: kernel != plain twin (max |diff| {err})")
            worst["gather"] = max(worst["gather"], err)
            out["gather"].append({"call": name, "dtype": str(dt), "shape": list(shape),
                                  "layout": layout, "out": list(got.shape), "equal": True})

    check_video_gathers(dev, rs, out, worst)
    check_train_gathers(dev, rs, out, worst)
    check_train_gathers(dev, rs, out, worst, video=True)
    check_bwd_edges(dev, out, worst)

    check_video_unknown(dev, out, worst)
    check_video_train_unknown(dev, out, worst)
    for k in UNKNOWN_K:
        for seed in range(2):
            rr = np.random.RandomState(seed)
            alpha = blob_alpha(H, W, N_INST, rr)
            if seed == 1:  # speckle: isolated uncertain pixels everywhere, tile seams too
                alpha = np.where(rr.rand(*alpha.shape) < 0.002, 0.5, np.round(alpha))
            check_unknown(torch.from_numpy(alpha.astype(np.float32))[None].to(dev), k,
                          f"seed={seed}", out, worst)
    # the element instance: W not a multiple of 4 (nor of the 128-column strip),
    # and a contiguous view 4 bytes off 16-byte alignment
    for label, shape, shift in (("ragged", (2, N_INST, 301, 1021), 0),
                                ("misaligned", (1, N_INST, H, W), 1)):
        rr = np.random.RandomState(shift)
        alpha = np.where(rr.rand(*shape) < 0.002, 0.5, rr.rand(*shape) > 0.5)
        flat = np.concatenate([np.zeros(shift), alpha.ravel()]).astype(np.float32)
        a = torch.from_numpy(flat).to(dev)[shift:].view(shape)
        if (a.data_ptr() % 16 == 0) != (shift == 0):
            fail(f"compute_unknown {label}: view not at the intended alignment")
        for k in UNKNOWN_K:
            check_unknown(a, k, label, out, worst)
    detail["kernel_checks"] = out
    return worst


def detail_mask_check(gpu_out, cpu_out):
    """detail_mask must agree except where a flip is explained by alpha_os8
    within 1e-4 of a threshold: such a pixel's dilation footprint may differ."""
    from maggie_tpu_torch.ops.morphology import LOWER_THRES, UPPER_THRES, dilate_ellipse
    a8 = cpu_out["alpha_os8"][0, 0]
    near = ((a8 - LOWER_THRES).abs() < 1e-4) | ((a8 - UPPER_THRES).abs() < 1e-4)
    allowed = dilate_ellipse(near.float(), 15) > 0
    diff = gpu_out["detail_mask"][0, 0].cpu() != cpu_out["detail_mask"][0, 0]
    return int(near.sum()), int(diff.sum()), int((diff & ~allowed).sum()), allowed | diff


def with_flags(cfg, flags: dict | None):
    """``cfg`` with ``flags`` ({"encoder_args": {...}, "decoder_args": {...}})
    set under ``cfg.model``."""
    for group, values in (flags or {}).items():
        cfg.model[group].update(values)
    return cfg


def bf16_copy(model):
    """``model`` as ``model.precision bf16`` builds it: the same modules and
    weights, with the bf16 compute dtype (the one thing the setting changes,
    ``models/maggie.py``), without a second initialisation at full width."""
    out = copy.deepcopy(model)
    out.compute_dtype = torch.bfloat16
    return out


def build_models(dev, flags: dict | None = None):
    """The flagship model (with ``flags``, ``with_flags``) from seed 0 with SN
    folded: on the CPU, its copy on ``dev`` in f32, and the bf16 model on
    ``dev`` with the same weights."""
    from maggie_tpu_torch.flagship import flagship_cfg
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.utils.checkpoint import fold_spectral_norm
    cpu_model = build_model(with_flags(flagship_cfg(), flags).model, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    fold_spectral_norm(cpu_model)
    return cpu_model, copy.deepcopy(cpu_model).to(dev), bf16_copy(cpu_model).to(dev)


def forward_outputs(path: str, against: str | None) -> int:
    """``--outputs PATH [--against REF]``: answer requests 0 and 1 in f32 and
    bf16 and save every output to PATH; with REF (the same run of another
    version), fail unless each output equals REF's bit for bit."""
    from maggie_tpu_torch.flagship import blob_batch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # else cuDNN may pick other algorithms per process
    dev = torch.device("cuda")
    _, model, bf16_model = build_models(dev)
    outs = {}
    with torch.inference_mode():
        for seed in range(2):
            batch = {k: v.to(dev) for k, v in blob_batch(H, W, N_INST, seed).items()}
            for name, m in (("fp32", model), ("bf16", bf16_model)):
                for k, v in m(batch).items():
                    outs[f"{name}/{seed}/{k}"] = v.cpu()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(outs, path)
    if against is None:
        print(f"forward outputs: {len(outs)} tensors saved to {path}")
        return 0
    ref = torch.load(against)
    differ = sorted(k for k in set(outs) | set(ref)
                    if k not in outs or k not in ref or not torch.equal(outs[k], ref[k]))
    print(f"forward outputs vs {against}: {len(outs) - len(differ)} of {len(outs)} "
          f"equal bit for bit; differ: {differ}")
    return 1 if differ else 0


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if "--outputs" in sys.argv:
        args = sys.argv[1:]
        against = args[args.index("--against") + 1] if "--against" in args else None
        return forward_outputs(args[args.index("--outputs") + 1], against)
    if "--video" in sys.argv:
        return video_only(torch.device("cuda"))
    if "--video-train" in sys.argv:
        return video_train_only(torch.device("cuda"))
    if "--remat" in sys.argv:
        return remat_only(torch.device("cuda"))
    if "--ddp-rank" in sys.argv:
        i = sys.argv.index("--ddp-rank")
        return ddp_rank_main(*sys.argv[i + 1:i + 4])
    if "--ddp" in sys.argv:
        return ddp_only(torch.device("cuda"))
    if "--baselines" in sys.argv:
        return baselines_only(torch.device("cuda"))
    if "--sparsemat" in sys.argv:
        return sparsemat_only(torch.device("cuda"))
    if "--baselines-train" in sys.argv:
        return baselines_train_only(torch.device("cuda"))
    if "--demo" in sys.argv:
        return demo_only(torch.device("cuda"))
    if "--tools" in sys.argv:
        return tools_only()
    if "--alternatives" in sys.argv:
        return alternatives_only(torch.device("cuda"))
    if "--space" in sys.argv:
        return space_only(torch.device("cuda"))
    if "--studies" in sys.argv:
        return studies_only(torch.device("cuda"))
    if "--gather-bwd" in sys.argv:
        print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                         "--format=csv,noheader"], capture_output=True,
                                        text=True, check=True).stdout.strip(), flush=True)
        return gather_bwd_only(torch.device("cuda"))
    from maggie_tpu_torch.flagship import blob_batch
    from maggie_tpu_torch.ops.kernels import build, gather as kg, unknown as ku

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    detail = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}

    laps, lap_t = {}, [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        laps[phase], lap_t[0] = now - lap_t[0], now

    # ---- phase 1: build, with phases 6, 9 and 12's CPU halves beside it ----
    t0 = time.perf_counter()

    def build_all() -> float:
        build.build_all()
        return time.perf_counter() - t0
    ahead = [meanwhile_step(s) for s in [flagship_step(), video_step()] + [
        base_check_step(n, b, f, hw, BASE_CHECK.get(n)) for n, b, f, hw in BASE_TRAIN]]
    detail["build_s"] = cpu_steps_meanwhile(ahead, build_all)
    detail["build_with_cpu_steps_s"] = time.perf_counter() - t0
    print(f"phase 1: kernels built in {detail['build_s']:.1f} s; the CPU halves of "
          f"{len(ahead)} card-vs-CPU steps beside it done after "
          f"{detail['build_with_cpu_steps_s']:.1f} s", flush=True)

    lap("1")
    # ---- phase 2: kernels vs plain twins ----
    worst = phase_kernels(dev, detail)
    print(f"phase 2: kernels equal to their plain twins at every main-path shape "
          f"({len(detail['kernel_checks']['gather'])} gather, "
          f"{len(detail['kernel_checks']['gather_bwd'])} gather backward, "
          f"{len(detail['kernel_checks']['unknown'])} compute_unknown cases)", flush=True)

    lap("2")
    # ---- phase 3: the main path ----
    t0 = time.perf_counter()
    cpu_model, model, bf16_model = build_models(dev)
    requests = [blob_batch(H, W, N_INST, seed) for seed in range(N_REQUESTS)]
    on_dev = [{k: v.to(dev) for k, v in r.items()} for r in requests]
    torch.cuda.synchronize()
    kg.launches = 0
    ku.launches = 0
    outs = []
    with torch.inference_mode():
        for r in on_dev:
            outs.append(model(r))
    torch.cuda.synchronize()
    launches = {"gather_patches": kg.launches, "compute_unknown": ku.launches}
    detail["launches"] = launches
    if launches != {"gather_patches": 5 * N_REQUESTS, "compute_unknown": 3 * N_REQUESTS}:
        fail(f"launch counts {launches} != 5 and 3 per frame over {N_REQUESTS} frames")
    for i, o in enumerate(outs):
        for k, v in o.items():
            if tuple(v.shape) != (1, 1, N_INST, H, W) or not bool(torch.isfinite(v).all()):
                fail(f"request {i}: {k} has shape {tuple(v.shape)} or non-finite values")
        if float(o["refined_masks"].min()) < 0 or float(o["refined_masks"].max()) > 1:
            fail(f"request {i}: refined_masks outside [0, 1]")
    detail["detail_fraction"] = [float(o["detail_mask"].mean()) for o in outs]
    with torch.inference_mode():
        cpu_out = cpu_model(requests[0])
    near, n_diff, unexplained, region = detail_mask_check(outs[0], cpu_out)
    ref_err = (outs[0]["refined_masks"].cpu() - cpu_out["refined_masks"]).abs()[0, 0]
    err_outside = float(ref_err[~region].max()) if bool((~region).any()) else 0.0
    detail["cpu_check"] = {"near_threshold_pixels": near, "detail_mask_diff": n_diff,
                           "unexplained_diff": unexplained,
                           "refined_max_abs_err": float(ref_err.max()),
                           "refined_max_abs_err_outside_flips": err_outside,
                           "refined_mean_abs_err": float(ref_err.mean()),
                           "tolerance": REFINED_ATOL}
    if unexplained:
        fail(f"detail_mask differs from the CPU port at {unexplained} pixels not explained "
             f"by {near} near-threshold alpha_os8 pixels")
    if err_outside > REFINED_ATOL:
        fail(f"refined_masks differ from the CPU port by {err_outside} > {REFINED_ATOL}")
    print(f"phase 3: {N_REQUESTS} requests answered in {time.perf_counter() - t0:.1f} s; "
          f"launches {launches}; CPU check: detail_mask diff {n_diff} px "
          f"({near} near-threshold), refined max |err| {err_outside:.3g}", flush=True)

    lap("3")
    # ---- phase 4: timing ----
    batch = on_dev[0]
    timings = {}
    with torch.inference_mode():
        for name, m in (("fp32", model), ("bf16", bf16_model)):
            windows = [cuda_ms(lambda: m(batch), iters=10, warmup=3 if not i else 1)
                       for i in range(5)]
            timings[name] = {"ms_per_frame_median": float(np.median(windows)),
                             "windows_ms": windows}
        bf_out = bf16_model(batch)
    bf_err = (bf_out["refined_masks"].float() - outs[0]["refined_masks"]).abs()
    drift = {"mean_abs": float(bf_err.mean()), "max_abs": float(bf_err.max()),
             "far_share": float((bf_err > BF16_FAR).float().mean()),
             "detail_mask_flips": int((bf_out["detail_mask"] != outs[0]["detail_mask"]).sum())}
    timings["bf16_vs_fp32"] = drift
    if drift["mean_abs"] > BF16_MEAN_ATOL or drift["far_share"] > BF16_FAR_SHARE:
        fail(f"bf16 refined_masks drift {drift}: limits mean {BF16_MEAN_ATOL}, "
             f"share above {BF16_FAR} {BF16_FAR_SHARE}")
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        model(batch)
    timings["fp32_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    for name, m in (("fp32", model), ("bf16", bf16_model)):
        timings[name].update(stage_split(m, batch, timings[name]["ms_per_frame_median"]))
    detail["forward"] = timings
    print(f"phase 4: forward f32 {timings['fp32']['ms_per_frame_median']:.3f} ms/frame, "
          f"bf16 {timings['bf16']['ms_per_frame_median']:.3f} ms/frame; bf16 vs f32 {drift}",
          flush=True)
    for name in ("fp32", "bf16"):
        t = timings[name]
        print(f"  {name} stages (ms/frame): "
              + ", ".join(f"{k} {v:.3f}" for k, v in t["stage_ms"].items())
              + f"; kernels {t['kernel_ms']:.3f} ms/frame, busy share {t['busy_share']:.3f}",
              flush=True)

    kernels = time_kernels(dev, worst, launches, detail)
    g = detail["kernel_times_per_frame"]["gather_patches"]
    for frame in ("fp32", "bf16"):
        print(f"  gather_patches {frame} per frame: kernel {g[frame]['ms'] * 1e3:.2f} us, "
              f"bound {g[frame]['bound_ms'] * 1e3:.2f} us; removed layout copies "
              f"{g['removed_layout_copies'][frame + '_ms'] * 1e3:.2f} us", flush=True)
    for row in g["calls"]:
        print(f"    {row['call']} {row['dtype']} {row['layout']}: kernel "
              f"{row['ms'] * 1e3:.2f} us, bound {row['bound_ms'] * 1e3:.2f} us", flush=True)
    u = detail["kernel_times_per_frame"]["compute_unknown"]
    print(f"  compute_unknown per frame: kernel {u['ms'] * 1e3:.2f} us (uniform input "
          f"{u['uniform_ms'] * 1e3:.2f}), bound {u['bound_ms'] * 1e3:.2f} us, copy "
          f"{u['copy_ms'] * 1e3:.2f} us", flush=True)
    for row in u["calls"]:
        print(f"    k={row['k']}: kernel {row['ms'] * 1e3:.2f} us (uniform input "
              f"{row['uniform_ms'] * 1e3:.2f}), bound {row['bound_ms'] * 1e3:.2f} us, copy "
              f"{row['copy_ms'] * 1e3:.2f} us", flush=True)

    lap("4")
    # ---- phase 5: the eval engine ----
    engine = phase_engine(cpu_model, model, bf16_model, detail)
    for kern in kernels:
        kern["engine_launches"] = engine["launches"][kern["name"]]

    lap("5")
    # ---- phase 6: the train step ----
    kernels.append(phase_train(dev, worst, detail))
    for kern in kernels[:2]:
        kern["train_launches"] = detail["train"]["fp32"]["launches"][kern["name"]]

    lap("6")
    # ---- phase 7: the trainer through the CLI ----
    trainer = phase_trainer(detail)
    for kern in kernels:
        kern["trainer_launches"] = trainer["launches"][kern["name"]]

    lap("7")
    # ---- phase 8: the video model and the video eval engine ----
    video = phase_video(dev, detail)
    for kern in kernels[:2]:
        kern["video_launches"] = video["model"]["launches"][kern["name"]]
        kern["video_engine_launches"] = video["engine"]["launches"][kern["name"]]

    lap("8")
    # ---- phase 9: video training, with the earlier phases' models freed ----
    del cpu_model, model, bf16_model, on_dev, outs, cpu_out, bf_out, batch
    torch.cuda.empty_cache()
    video_train = phase_video_train(dev, detail)
    for kern in kernels:
        kern["video_train_launches"] = video_train["steps"][kern["name"]]
        kern["video_trainer_launches"] = video_train["trainer"][kern["name"]]

    lap("9")
    # ---- phase 10: rematerialisation, the image and video train steps ----
    torch.cuda.empty_cache()
    remat = phase_remat(dev, detail)
    for kern in kernels:
        kern["remat_launches"] = remat[kern["name"]]

    lap("10")
    # ---- phase 11: data parallel, two ranks on the card and torchrun ----
    torch.cuda.empty_cache()
    # 11.3's CLI processes wait with phases 13 and 17's CPU steps and phase
    # 19's CPU halves beside them; 14.3 and phase 18 run in phase 11's rank pair
    ddp, space_launches, space_video_launches = phase_ddp(
        dev, detail, [meanwhile_step(s) for s in [sm_step(*c) for c in SM_CHECK_STEPS]
                      + [flagship_step(ALT_TRAIN_FLAGS, ALT_TRAIN_BATCH, TRAIN_HW)]]
        + [study_spec()])
    for kern in kernels:
        kern["ddp_launches"] = ddp[kern["name"]]
        kern["space_launches"] = space_launches[kern["name"]]
        kern["space_video_launches"] = space_video_launches[kern["name"]]

    lap("11")
    laps["18"] = detail["ddp"]["space"]["phase_s"]
    laps["11"] -= laps["18"]
    # ---- phase 12: the MGM baseline family ----
    torch.cuda.empty_cache()
    baselines = phase_baselines(dev, detail)
    for kern in kernels:
        kern["baseline_launches"] = baselines["launches"].get(kern["name"], 0)

    lap("12")
    # ---- phase 13: SparseMat and the dense InstMatt ablation decoder ----
    torch.cuda.empty_cache()
    sparsemat = phase_sparsemat(dev, detail)
    for kern in kernels:
        kern["sparsemat_launches"] = sparsemat["launches"].get(kern["name"], 0)

    lap("13")
    # ---- phase 14: remat and data parallel for the baselines ----
    torch.cuda.empty_cache()
    baselines_train = phase_baselines_train(dev, detail)
    for kern in kernels:
        kern["baseline_train_launches"] = baselines_train["launches"][kern["name"]]

    lap("14")
    # ---- phase 15: the demo's serving path ----
    torch.cuda.empty_cache()
    demo = phase_demo(dev, detail)
    for kern in kernels:
        kern["demo_launches"] = demo["launches"][kern["name"]]

    lap("15")
    # ---- phase 16: the tools ----
    torch.cuda.empty_cache()
    tools = phase_tools(detail)
    for kern in kernels:
        kern["tools_launches"] = tools["launches"][kern["name"]]

    lap("16")
    # ---- phase 17: the off-by-default alternatives ----
    torch.cuda.empty_cache()
    alternatives = phase_alternatives(dev, detail)
    for kern in kernels:
        kern["alternatives_launches"] = alternatives[kern["name"]]

    lap("17")
    # ---- phase 19: the block-capacity studies ----
    torch.cuda.empty_cache()
    studies = phase_studies(dev, detail)
    for kern in kernels:
        kern["study_launches"] = studies[kern["name"]]

    lap("19")
    detail["phases_s"] = time.perf_counter() - t_start
    detail["phase_s"] = laps
    print(f"phases 1-19 done in {detail['phases_s']:.1f} s (from main(), imports not counted); "
          f"by phase {json.dumps({k: round(v, 1) for k, v in laps.items()})} (18 ran in 11's "
          f"rank pair, 18.2 and 14.3 too)", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


def engine_set(root: str) -> dict:
    """An HIM-style eval set of ENGINE_FRAMES frames held in memory. ``root``
    gets empty files under the HIM layout's names (what ``HIMDataset``
    indexes); the returned dict maps each path to its decoded array: the
    frame, each instance's blob alpha, and its guidance mask (the alpha
    binarized, then degraded by an 8x nearest down/up)."""
    from maggie_tpu_torch.flagship import blob_alpha, flagship_cfg
    t = flagship_cfg().dataset.test
    h, w = ENGINE_SRC
    arrays = {}
    for i in range(ENGINE_FRAMES):
        rs = np.random.RandomState(100 + i)
        name = f"frame{i}"
        arrays[os.path.join(root, "images", t.split, name + ".jpg")] = \
            rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for j, a in enumerate(blob_alpha(h, w, N_INST, rs)):
            a = np.round(a * 255).astype(np.uint8)
            m = ((a > 127) * 255).astype(np.uint8)[::8, ::8].repeat(8, 0).repeat(8, 1)[:h, :w]
            for d, arr in ((t.alpha_dir_name, a), (t.mask_dir_name, m)):
                arrays[os.path.join(root, d, t.split, name, f"{j:02d}.png")] = arr
    for path in arrays:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        open(path, "wb").close()
    return arrays


def phase_engine(cpu_model, model, bf16_model, detail) -> dict:
    """Phase 5: ``eval_image`` over the in-memory set on the card, f32, bf16
    and f32 with device_preprocess, then frame 0 on the CPU with the host and
    the device preprocessing; fails on a launch count, a non-finite metric or
    frame 0's metrics beyond the limits."""
    import tempfile
    from maggie_tpu_torch.data import build_dataset
    from maggie_tpu_torch.data.loader import DataLoader
    from maggie_tpu_torch.engine import test as eng
    from maggie_tpu_torch.flagship import flagship_cfg
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku

    cfg = flagship_cfg()
    dp_cfg = cfg.clone()
    dp_cfg.dataset.test.device_preprocess = True
    per_frame, metrics_s = [], []
    compute_metrics = eng.compute_metrics

    def keep(*args, **kwargs):   # every frame's metric values, as eval_image logs them
        t0 = time.perf_counter()
        current = compute_metrics(*args, **kwargs)
        metrics_s.append(time.perf_counter() - t0)
        per_frame.append({k: float(v) for k, v in current.items()})
        return current

    out = {"frames": ENGINE_FRAMES, "source_hw": list(ENGINE_SRC), "metrics": cfg.test.metrics}
    with tempfile.TemporaryDirectory() as root:
        arrays = engine_set(root)
        cfg.dataset.test.root_dir = dp_cfg.dataset.test.root_dir = root
        eng.compute_metrics = keep
        try:
            for name, m, c in (("fp32", model, cfg), ("bf16", bf16_model, cfg),
                               ("fp32_device_preprocess", model, dp_cfg),
                               ("cpu", cpu_model, cfg),
                               ("cpu_device_preprocess", cpu_model, dp_cfg)):
                on_card = not name.startswith("cpu")
                ds = build_dataset(c, is_train=False, device="cuda" if on_card else "cpu",
                                   decode=lambda p, mode: arrays[p])
                loader = DataLoader(ds if on_card else [ds[0]], batch_size=1)
                metrics = eng.eval_metrics(cfg.test.metrics)
                per_frame.clear()
                metrics_s.clear()
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    kg.launches = 0
                    ku.launches = 0
                t0 = time.perf_counter()
                batch_s, data_s, host_s = eng.eval_image(m, loader, cfg.test.log_iter, metrics)
                wall = time.perf_counter() - t0
                run = {"wall_s": wall, "frames_per_s": len(per_frame) / wall,
                       "batch_time_s": batch_s, "data_time_s": data_s, "host_time_s": host_s,
                       "metrics_time_s": float(np.mean(metrics_s)),
                       "per_frame": list(per_frame),
                       "average": {k: float(v.average()) for k, v in metrics.items()}}
                if on_card:
                    run["launches"] = {"gather_patches": kg.launches,
                                       "compute_unknown": ku.launches}
                    run["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
                    want = {"gather_patches": 5 * ENGINE_FRAMES, "compute_unknown": 3 * ENGINE_FRAMES}
                    if run["launches"] != want:
                        fail(f"engine {name}: launch counts {run['launches']} != 5 and 3 "
                             f"per frame over {ENGINE_FRAMES} frames")
                    if len(per_frame) != ENGINE_FRAMES or not all(
                            np.isfinite(v) for f in per_frame for v in f.values()):
                        fail(f"engine {name}: {len(per_frame)} frames, metrics {per_frame}")
                out[name] = run
        finally:
            eng.compute_metrics = compute_metrics

    def rel_err(name, ref):
        ref = out[ref]["per_frame"][0]
        return {k: abs(out[name]["per_frame"][0][k] - v) / max(abs(v), 1e-12)
                for k, v in ref.items()}

    card_runs = ("fp32", "bf16", "fp32_device_preprocess")
    for name, ref, limit in (("fp32", "cpu", ENGINE_F32_RTOL), ("bf16", "cpu", ENGINE_BF16_RTOL),
                             ("fp32_device_preprocess", "cpu_device_preprocess", ENGINE_DP_RTOL)):
        rel = out[name]["frame0_rel_err_vs_cpu"] = rel_err(name, ref)
        if max(rel.values()) > limit:
            fail(f"engine {name}: frame 0 metrics differ from the CPU port by {rel} > {limit}")
    # what a user sees change when switching device_preprocess on: no limit,
    # the two preprocessings differ by design (data/device_pipeline.py)
    out["device_preprocess_vs_host_frame0_rel_err"] = rel_err("fp32_device_preprocess", "fp32")
    out["launches"] = {k: sum(out[n]["launches"][k] for n in card_runs)
                       for k in out["fp32"]["launches"]}
    detail["engine"] = out
    for name in card_runs:
        r = out[name]
        print(f"phase 5: engine {name}: {ENGINE_FRAMES} frames ({ENGINE_SRC[0]}x{ENGINE_SRC[1]} "
              f"-> 576x1024, {N_INST} instances) in {r['wall_s']:.3f} s, "
              f"{r['frames_per_s']:.4f} frames/s with metrics on; per frame: batch_time "
              f"{r['batch_time_s']:.4f} s, data_time {r['data_time_s']:.4f} s, host "
              f"{r['host_time_s']:.4f} s (metrics {r['metrics_time_s']:.4f} s, the rest reverse "
              f"transform and clamp); peak device memory "
              f"{r['peak_mem_bytes']} bytes; launches {r['launches']}; frame 0 vs CPU max rel "
              f"err {max(r['frame0_rel_err_vs_cpu'].values()):.3g}", flush=True)
    on, off = out["fp32_device_preprocess"], out["fp32"]
    print(f"phase 5: device_preprocess on vs off (f32): data_time {on['data_time_s']:.4f} vs "
          f"{off['data_time_s']:.4f} s per frame, {on['frames_per_s']:.4f} vs "
          f"{off['frames_per_s']:.4f} frames/s; frame 0 metrics max rel diff "
          f"{max(out['device_preprocess_vs_host_frame0_rel_err'].values()):.3g}", flush=True)
    print(f"phase 5: CPU frame 0 in {out['cpu']['wall_s']:.1f} s "
          f"({out['cpu_device_preprocess']['wall_s']:.1f} s with device_preprocess); metrics "
          f"{out['cpu']['per_frame'][0]}", flush=True)
    return out


# phase 7: the trainer on a synthetic HIM set written to disk
TRAINER_FRAMES, TRAINER_VAL_FRAMES = 8, 2
TRAINER_SRC = (720, 1280)     # ResizeShort(576) -> 576x1024, then 512x512 crops
PER_ITER = {"gather_patches": 10, "gather_patches_bwd": 6, "compute_unknown": 1}
PER_VAL_FRAME = {"gather_patches": 5, "gather_patches_bwd": 0, "compute_unknown": 3}
# a longer f32 run, logging every 10 iterations (the config's cadence) and not
# validating: enough iterations to drain the loader's and the infeed's queues
# (up to 5 batches ahead), so that its meters show which of the loader and the
# step sets the pace; no more, for the script's time limit
SUSTAINED_ITERS = 10
CKPT_FILES = ("last_state.pt", "best_model.npz", "best_score.txt", "last_step.txt",
              "train_meters.json", "config.yaml")


def trainer_set(root: str) -> None:
    """Write the HIM layouts with PIL: ``root/train/images/*.jpg`` with
    ``root/train/alphas/<image>/*.png`` (1-5 blob instances a frame), and
    ``root/images/val/*.jpg`` with ``root/{alphas,<mask dir>}/val/<image>/*.png``
    (3 instances, the masks the alphas binarized), from seeds."""
    from PIL import Image
    from maggie_tpu_torch.flagship import blob_alpha, flagship_cfg
    mask_dir = flagship_cfg().dataset.test.mask_dir_name
    h, w = TRAINER_SRC

    def frame(rs):   # smooth colour fields with grain, as a photo has
        small = Image.fromarray(rs.randint(0, 256, (h // 16, w // 16, 3)).astype(np.uint8))
        f = np.asarray(small.resize((w, h), Image.BILINEAR)).astype(np.int16)
        return np.clip(f + rs.randint(-12, 13, f.shape), 0, 255).astype(np.uint8)

    def save(arr, path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(arr).save(path, **({"quality": 90} if path.endswith(".jpg") else {}))

    for i in range(TRAINER_FRAMES):
        rs = np.random.RandomState(200 + i)
        save(frame(rs), os.path.join(root, "train", "images", f"f{i}.jpg"))
        for j, a in enumerate(blob_alpha(h, w, 1 + i % 5, rs)):
            save(np.round(a * 255).astype(np.uint8),
                 os.path.join(root, "train", "alphas", f"f{i}", f"{j:02d}.png"))
    for i in range(TRAINER_VAL_FRAMES):
        rs = np.random.RandomState(300 + i)
        save(frame(rs), os.path.join(root, "images", "val", f"v{i}.jpg"))
        for j, a in enumerate(blob_alpha(h, w, N_INST, rs)):
            a = np.round(a * 255).astype(np.uint8)
            save(a, os.path.join(root, "alphas", "val", f"v{i}", f"{j:02d}.png"))
            save(((a > 127) * 255).astype(np.uint8),
                 os.path.join(root, mask_dir, "val", f"v{i}", f"{j:02d}.png"))


def kernel_counts() -> dict:
    from maggie_tpu_torch.ops.kernels import launch_counts
    return launch_counts()


def trainer_run(args: list, record: dict, keep_start: bool = False) -> dict:
    """One ``main.main(args)`` with the launches of each train iteration and
    of each validation (and its frames) recorded; with ``keep_start``, the
    state the first iteration starts from, on the host. ``record`` also
    collects a copy of the model each time ``best_model.npz`` is written."""
    import maggie_tpu_torch.engine.test as eng
    import maggie_tpu_torch.engine.train as tr
    import maggie_tpu_torch.utils.checkpoint as ck
    from maggie_tpu_torch import main as cli
    steps, vals, start = [], [], {}
    make, evaluate, evaluate_video, save_npz, metrics = (
        tr.make_train_step, tr.eval_image, tr.eval_video, ck.save_variables_npz,
        eng.compute_metrics)
    frames = []   # one entry a scored frame (eval_image) or window (eval_video)

    def counted_make(model, optimizer, schedule, remat="none"):
        step = make(model, optimizer, schedule, remat)

        def counted(state, *a, **kw):
            if keep_start and not start:
                torch.cuda.synchronize()
                start.update(step=state.step,
                             model={k: v.cpu().clone() for k, v in model.state_dict().items()},
                             optimizer=copy.deepcopy(optimizer.state_dict()))
            before = kernel_counts()
            out = step(state, *a, **kw)
            steps.append({k: v - before[k] for k, v in kernel_counts().items()})
            return out
        return counted

    def counting(fn):
        def counted_eval(*a, **kw):
            before, n0 = kernel_counts(), len(frames)
            out = fn(*a, **kw)
            vals.append({"frames": len(frames) - n0,
                         **{k: v - before[k] for k, v in kernel_counts().items()}})
            return out
        return counted_eval

    def counted_metrics(*a, **kw):
        frames.append(1)
        return metrics(*a, **kw)

    def keep_best(path, model):
        record["best_model"] = copy.deepcopy(model).eval()
        save_npz(path, model)
    tr.make_train_step, tr.eval_image, tr.eval_video = (
        counted_make, counting(evaluate), counting(evaluate_video))
    ck.save_variables_npz, eng.compute_metrics = keep_best, counted_metrics
    try:
        torch.cuda.synchronize()
        before = kernel_counts()
        t0 = time.perf_counter()
        state = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in kernel_counts().items()}
    finally:
        tr.make_train_step, tr.eval_image, tr.eval_video = make, evaluate, evaluate_video
        ck.save_variables_npz, eng.compute_metrics = save_npz, metrics
    return {"state_step": state.step, "wall_s": wall, "steps": steps, "vals": vals,
            "launches": launches, "start": start}


def check_trainer_run(name: str, run: dict, out_dir: str, n_steps: int, n_vals: int,
                      log_iter: int = 1, files=CKPT_FILES, first_iter: int = 0,
                      per_val=PER_VAL_FRAME, val_units: int = TRAINER_VAL_FRAMES,
                      per_iter=PER_ITER) -> dict:
    """Launches per iteration (``per_iter``) and per val unit (``val_units``
    frames, or windows of a video set, each launching ``per_val``), the run's
    own logged iterations (those after ``first_iter``, where it started) with
    finite losses, the files; returns the run's meters and log numbers."""
    if len(run["steps"]) != n_steps or len(run["vals"]) != n_vals:
        fail(f"trainer {name}: {len(run['steps'])} iterations and {len(run['vals'])} "
             f"validations, not {n_steps} and {n_vals}")
    for i, c in enumerate(run["steps"]):
        if c != per_iter:
            fail(f"trainer {name}: iteration {i + 1} launched {c}, not {per_iter}")
    for v in run["vals"]:
        want = {k: n * v["frames"] for k, n in per_val.items()}
        if v["frames"] != val_units or {k: v[k] for k in want} != want:
            fail(f"trainer {name}: a validation launched {v}, not {per_val} per unit "
                 f"over {val_units} units")
    total = {k: n_steps * per_iter[k] + n_vals * val_units * per_val[k] for k in per_iter}
    if run["launches"] != total:
        fail(f"trainer {name}: launches {run['launches']} != {total}")
    with open(os.path.join(out_dir, "log_rank0.log")) as f:
        log = f.read()
    iters, losses, peaks = [], [], []
    for line in log.splitlines():
        m = re.search(r"Iter: (\d+)/\d+, .*?total: ([-\w.]+)", line)
        if m and int(m[1]) > first_iter:
            iters.append(int(m[1]))
            losses.append(float(m[2]))
            peaks += [float(x) for x in re.findall(r"max_mem: (\d+)MB", line)]
    want = [i for i in range(first_iter + 1, first_iter + n_steps + 1) if i % log_iter == 0]
    if iters != want or len(peaks) != len(want) or not all(np.isfinite(losses)):
        fail(f"trainer {name}: logged iterations {iters} (want {want}), losses {losses}, "
             f"{len(peaks)} peak memory readings")
    for f in files:
        if not os.path.isfile(os.path.join(out_dir, f)):
            fail(f"trainer {name}: {f} was not written")
    with open(os.path.join(out_dir, "train_meters.json")) as f:
        meters = json.load(f)
    return {"meters": meters, "logged_losses": losses, "log_max_mem_mb": max(peaks),
            "launches": run["launches"], "wall_s": run["wall_s"],
            "val_launches": run["vals"], "iterations": n_steps}


def host_cost_by_transform(cfg, samples: int = 0) -> dict:
    """Host ms of one train sample by transform, mean over the train samples
    (each drawn once; with ``samples``, about that many spread over the set),
    with the transition band and the rest of the sample; only this thread's
    calls count."""
    from maggie_tpu_torch.data import build_dataset
    import maggie_tpu_torch.data.him as him
    import maggie_tpu_torch.data.vim as vim
    ds = build_dataset(cfg, is_train=True, random_seed=0)
    # the transition band: HIM's ellipse band, VIM's dilated change map
    mod, band = (vim, "gen_diff_mask") if cfg.dataset.train.name == "VIM" else \
        (him, "gen_transition_gt")
    indices = range(0, len(ds), max(1, len(ds) // samples)) if samples else range(len(ds))
    ms: dict[str, float] = {}

    me = threading.get_ident()

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if threading.get_ident() == me:
                ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return call
    ds.transforms.transforms = [timed(type(t).__name__, t) for t in ds.transforms.transforms]
    transition = getattr(mod, band)
    setattr(mod, band, timed("transition_gt", transition))
    try:
        t0 = time.perf_counter()
        for i in indices:
            ds[i]
        total = (time.perf_counter() - t0) * 1e3
    finally:
        setattr(mod, band, transition)
    out = {k: v / len(indices) for k, v in ms.items()}
    out["rest"] = total / len(indices) - sum(out.values())
    out["total"] = total / len(indices)
    return out


def phase_trainer(detail) -> dict:
    """Phase 7: the trainer through ``main.main`` on a synthetic HIM set: a
    fresh f32 run, its resume, a bf16 run; returns the launches of all three."""
    import tempfile
    from maggie_tpu_torch.config import load_config
    from maggie_tpu_torch.pretrained import from_pretrained
    from maggie_tpu_torch.utils.checkpoint import load_model_weights
    from maggie_tpu_torch.models import build_model

    out = {}
    with tempfile.TemporaryDirectory() as root:
        trainer_set(root)
        base = ["--config", "configs/maggie_image.yaml"]
        opts = ["output_dir", os.path.join(root, "out"),
                "dataset.train.root_dir", root, "dataset.train.split", "train",
                "dataset.test.root_dir", root, "dataset.test.split", "val",
                "train.batch_size", str(TRAIN_BATCH), "train.val_iter", "3",
                "train.log_iter", "1", "test.log_iter", "1"]
        out["host_ms_per_sample"] = host_cost_by_transform(
            load_config("configs/maggie_image.yaml", opts))
        f32_dir = os.path.join(root, "out", "f32")
        record = {}
        fresh = trainer_run(base + opts + ["name", "f32", "train.max_iter", "6"], record)
        out["fp32"] = check_trainer_run("f32", fresh, f32_dir, 6, 2)
        saved = torch.load(os.path.join(f32_dir, "last_state.pt"), map_location="cpu",
                           weights_only=True)
        best_model = record.pop("best_model")
        resumed = trainer_run(base + opts + ["name", "f32", "train.max_iter", "8",
                                             "train.resume_last", "True"], record,
                              keep_start=True)
        out["resume"] = check_trainer_run("resume", resumed, f32_dir, 2, 0, first_iter=6)
        start = resumed["start"]
        if start["step"] != 6 or saved["step"] != 6 or resumed["state_step"] != 8:
            fail(f"trainer resume: started at {start['step']} (saved {saved['step']}), "
                 f"ended at {resumed['state_step']}; want 6, 6 and 8")
        differ = [k for k, v in saved["model"].items() if not torch.equal(start["model"][k], v)]
        st, sv = start["optimizer"]["state"], saved["optimizer"]["state"]
        differ += [f"optimizer {i} {k}" for i in sv for k in ("exp_avg", "exp_avg_sq", "step")
                   if not torch.equal(st[i][k].cpu(), sv[i][k])]
        if differ or set(st) != set(sv):
            fail(f"trainer resume: the loaded state differs from last_state.pt at {differ[:5]}")
        out["resume"]["state_tensors_equal"] = len(saved["model"]) + 3 * len(sv)

        # best_model.npz into the --eval-only model: parameters bit for bit
        # (unfolded load), and the folded model's forward against the
        # trainer's model in eval mode on a val frame
        cfg = load_config("configs/maggie_image.yaml", opts)
        cfg.model.weights = os.path.join(f32_dir, "best_model.npz")
        loaded = load_model_weights(build_model(cfg.model, device="cpu"), cfg).state_dict()
        want = best_model.state_dict()
        differ = [k for k, v in loaded.items() if not k.endswith("num_batches_tracked")
                  and not torch.equal(v, want[k].cpu())]
        if differ:
            fail(f"best_model.npz: {len(differ)} tensors differ from the saved model: {differ[:5]}")
        eval_model, _ = from_pretrained(cfg.model.weights, config=cfg, device="cuda")
        from maggie_tpu_torch.data import build_dataset
        sample = build_dataset(cfg, is_train=False, device="cpu")[0]
        batch = {k: torch.from_numpy(sample[k][None]).cuda() for k in ("image", "mask")}
        with torch.inference_mode():
            got = {k: v.cpu() for k, v in eval_model(batch).items()}
            ref = {k: v.cpu() for k, v in best_model(batch).items()}
        near, n_diff, unexplained, region = detail_mask_check(got, ref)
        err = (got["refined_masks"] - ref["refined_masks"]).abs()[0, 0]
        err_outside = float(err[~region].max()) if bool((~region).any()) else 0.0
        out["best_model_check"] = {"tensors_equal": len(loaded), "detail_mask_diff": n_diff,
                                   "near_threshold_pixels": near,
                                   "refined_max_abs_err_outside_flips": err_outside,
                                   "refined_max_abs_err": float(err.max())}
        if unexplained or err_outside > REFINED_ATOL:
            fail(f"best_model.npz eval forward vs the trainer's model: {out['best_model_check']}")
        del eval_model, best_model

        bf16 = trainer_run(["--precision", "16"] + base + opts
                           + ["name", "bf16", "train.max_iter", "3"], record)
        out["bf16"] = check_trainer_run("bf16", bf16, os.path.join(root, "out", "bf16"), 3, 1)
        long = trainer_run(base + opts + ["name", "sustained", "train.max_iter",
                                          str(SUSTAINED_ITERS), "train.val_iter", "1000",
                                          "train.log_iter", "10"], record)
        out["sustained"] = check_trainer_run("sustained", long,
                                             os.path.join(root, "out", "sustained"),
                                             SUSTAINED_ITERS, 0, 10,
                                             ("train_meters.json", "config.yaml"))
        out["launches"] = {k: sum(r["launches"][k] for r in (fresh, resumed, bf16, long))
                           for k in PER_ITER}
    detail["trainer"] = out
    step6 = {p: detail["train"][p]["ms_per_step_median"] for p in ("fp32", "bf16")}
    for name in ("fp32", "bf16", "sustained"):
        m = out[name]["meters"]
        print(f"phase 7: trainer {name} (batch {m['batch_size']}, {m['iters_measured']} "
              f"iterations after the first): {m['samples_per_sec_sustained']:.4f} samples/s, "
              f"{m['batch_time_avg_s'] * 1e3:.1f} ms/iteration against phase 6's "
              f"{step6.get(name, step6['fp32']):.1f} ms/step, data_time {m['data_time_avg_s'] * 1e3:.1f} ms, "
              f"infeed stall share {m['infeed_stall_frac']:.3f}, peak device memory "
              f"{m['peak_mem_mb']:.0f} MB (log {out[name]['log_max_mem_mb']:.0f} MB); launches "
              f"{out[name]['launches']}; losses {out[name]['logged_losses']}", flush=True)
    r = out["resume"]
    print(f"phase 7: resume started at iteration 6 from the saved state ({r['state_tensors_equal']} "
          f"tensors bit-equal), ran to 8; best_model.npz: {out['best_model_check']}", flush=True)
    m, h = out["sustained"]["meters"], out["host_ms_per_sample"]
    loader_ms = h["total"] * m["batch_size"]
    print(f"phase 7: pace at batch {m['batch_size']} (sustained f32): one loader thread needs "
          f"{loader_ms:.1f} ms of host work a batch (samples alone) against "
          f"{(m['batch_time_avg_s'] - m['data_time_avg_s']) * 1e3:.1f} ms an iteration outside "
          f"the wait for data; {m['data_time_avg_s'] * 1e3:.1f} ms of each "
          f"{m['batch_time_avg_s'] * 1e3:.1f} ms iteration waits for the infeed", flush=True)
    print("phase 7: host ms per train sample by transform (mean over "
          f"{TRAINER_FRAMES} frames): " + ", ".join(f"{k} {v:.1f}" for k, v in h.items()),
          flush=True)
    return out


TRAIN_FLAGS = dict(use_mask_atten=False, use_gt_guidance=False, use_prm_weights=True,
                   atten_loss_enabled=True)   # tools/bench_train.py:48
# Card vs CPU port after one f32 step at the reduced size (TF32 off). The two
# sum every conv, matmul and BatchNorm statistic in another order, and this
# random-weight network amplifies such differences through ~70 layers of
# batch statistics: on the CPU alone, 1 vs 8 threads move the gradients by up
# to 8e-3 (relative L2 of one tensor, tests/test_torch_train.py), so
# - loss terms: relative 1e-4 above an absolute 1e-6 (the attention loss of
#   bench_train's uniform alphas is 0 up to rounding: 1.2e-7 on the card and
#   7.9e-8 on the CPU in the first reading);
# - gradients before clipping: relative L2 over all parameters 5e-2;
# - parameters after the step: AdamW's first update is lr * g / (|g| + eps),
#   about lr = 6e-6 whatever |g|, so a gradient element near 0 whose sign
#   differs moves its parameter by up to 2 lr: every element within 2 lr +
#   1e-6, and at most 2% of them beyond 1e-6;
# - BatchNorm running statistics: 1e-4 absolute; spectral-norm u/v: 1e-5.
STEP_LOSS_RTOL = 1e-4
STEP_LOSS_ATOL = 1e-6
STEP_GRAD_REL_L2 = 5e-2
STEP_PARAM_FAR_SHARE = 0.02
STEP_STATS_ATOL = 1e-4
STEP_SN_ATOL = 1e-5


def phase_train(dev, worst, detail) -> dict:
    """Phase 6: the card-vs-CPU step, the full-width steps in f32 and bf16, and
    K1's backward timed per call; returns K1 backward's kernels-line entry."""
    check = card_vs_cpu_step(dev)
    print(f"phase 6: one f32 step on the card vs the CPU port ({check['size']}; CPU step "
          f"{check['cpu_step_s']:.1f} s): loss terms max rel {check['loss_max_rel']:.3g}, "
          f"gradients rel L2 {check['grad_rel_l2']:.3g}, params max |d| "
          f"{check['param_max_abs']:.3g} (share beyond 1e-6 {check['param_far_share']:.3g}), "
          f"BN stats max |d| {check['batch_stats_max_abs']:.3g}, SN u/v max |d| "
          f"{check['spectral_max_abs']:.3g}", flush=True)
    if not check["within"]:
        fail(f"train step on the card differs from the CPU port beyond the limits: {check}")
    runs = {"reduced_check": check}
    for precision in ("fp32", "bf16"):
        r = runs[precision] = train_run(dev, precision)
        k = r["ported_kernels_ms_per_step"]
        print(f"phase 6: train {precision} (batch {TRAIN_BATCH}, {TRAIN_HW}x{TRAIN_HW}, "
              f"{TRAIN_SLOTS} slots): {r['ms_per_step_median']:.3f} ms/step (median of steps "
              f"2-{TRAIN_STEPS}), peak device memory {r['peak_mem_bytes']} bytes, launches per "
              f"step {r['launches_per_step']}; kernels {r['kernel_ms_per_step']:.3f} ms/step "
              f"(busy share {r['busy_share']:.3f}), of which K1 {k['gather_patches']:.3f}, K1 "
              f"backward {k['gather_patches_bwd']:.3f}, K2 {k['compute_unknown']:.3f}; losses "
              f"{[round(ld['total'], 6) for ld in r['losses']]}", flush=True)
    detail["train"] = runs
    t = time_gather_bwd(dev, detail)
    for frame in ("fp32", "bf16"):
        f = t[frame]
    print_gather_bwd_times(t)
    launches = runs["fp32"]["launches"]["gather_patches_bwd"]
    return {"name": "gather_patches_bwd", "route": "cuda",
            "source": "maggie_tpu_torch/ops/kernels/csrc/gather_patches_bwd.cu",
            "replaces": "maggie_tpu/ops/blocksparse.py:80",
            "launches": launches, "launches_per_step": launches // TRAIN_STEPS,
            "max_abs_err": worst["gather_bwd"],
            "ms": t["fp32"]["ms"], "plain_ms": t["fp32"]["plain_ms"],
            "bound_ms": t["fp32"]["bound_ms"], "bound_by": "bytes",
            "library_ms": t["fp32"]["library_ms"],
            "bf16_ms": t["bf16"]["ms"], "bf16_bound_ms": t["bf16"]["bound_ms"],
            "index_ms": t["fp32"]["index_ms"], "pull_ms": t["fp32"]["pull_ms"],
            "bf16_index_ms": t["bf16"]["index_ms"], "bf16_pull_ms": t["bf16"]["pull_ms"]}


def print_gather_bwd_times(t) -> None:
    for frame in ("fp32", "bf16"):
        f = t[frame]
        print(f"phase 6: K1 backward per {frame} step (6 calls): kernel {f['ms']:.4f} ms (index "
              f"pass {f['index_ms']:.4f}, pull {f['pull_ms']:.4f}), bound {f['bound_ms']:.4f} ms, "
              f"twin {f['plain_ms']:.4f} ms, index_put_ {f['library_ms']:.4f} ms", flush=True)
    for row in t["calls"]:
        print(f"    {row['call']} {row['dtype']} {row['layout']}: kernel {row['ms'] * 1e3:.2f} us "
              f"(index pass {row['index_ms'] * 1e3:.2f}, pull {row['pull_ms'] * 1e3:.2f}), bound "
              f"{row['bound_ms'] * 1e3:.2f} us, index_put_ {row['library_ms'] * 1e3:.2f} us",
              flush=True)


def gather_bwd_only(dev) -> int:
    """``--gather-bwd``: build, hold K1's backward against its twin at every
    train and edge case, and time it per call as phase 6.3 does; details to
    output/torch_port/gather_bwd.json."""
    from maggie_tpu_torch.ops.kernels import build
    build.build_all(("gather_patches", "gather_patches_bwd"))
    out, worst = {"gather": []}, {}
    check_train_gathers(dev, np.random.RandomState(7), out, worst)
    check_bwd_edges(dev, out, worst)
    print(f"gather backward: {len(out['gather_bwd'])} cases bit-equal to the twin and "
          f"repeatable", flush=True)
    detail = {}
    print_gather_bwd_times(time_gather_bwd(dev, detail))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "gather_bwd.json"), "w") as f:
        json.dump({"checks": out, **detail}, f, indent=1)
    return 0


@contextlib.contextmanager
def clip_inputs():
    """The gradients as ``make_train_step``'s clip receives them, kept on the
    host in the list this yields."""
    from maggie_tpu_torch.engine import train_step as ts
    grads, clip = [], ts.clip_by_global_norm_

    def keep(gs, *args, **kwargs):
        grads.extend(g.detach().float().cpu().clone() for g in gs)
        return clip(gs, *args, **kwargs)
    ts.clip_by_global_norm_ = keep
    try:
        yield grads
    finally:
        ts.clip_by_global_norm_ = clip


def step_record(model, state, losses, grads, schedule, generator) -> dict:
    """A step as ``compare_steps`` reads it: the loss dict, every gradient
    before the clip, the learning rate, the parameters, BatchNorm
    statistics and spectral u/v after, and the generator's state after."""
    cpu = lambda d: {k: v.detach().to("cpu", torch.float32, copy=True) for k, v in d.items()}
    return {"losses": {k: float(v) for k, v in losses.items()}, "lr": schedule(0),
            "grads": dict(zip((k for k, _ in model.named_parameters()), grads)),
            "params": cpu(state.params()), "batch_stats": cpu(state.batch_stats()),
            "spectral": cpu(state.spectral()), "generator": generator.get_state()}


def one_step(model, batch, generator, cfg, remat: str = "none") -> dict:
    """One ``make_train_step`` step of ``model`` (train mode) from a fresh
    optimizer, as ``step_record`` gives it."""
    from maggie_tpu_torch.engine import train_step as ts
    from maggie_tpu_torch.engine.optim import build_optimizer
    model.train()
    opt, schedule = build_optimizer(cfg, model.parameters())
    state = ts.TrainState(model, opt)
    step = ts.make_train_step(model, opt, schedule, remat=remat)
    with clip_inputs() as grads:
        losses = step(state, batch, generator, **TRAIN_FLAGS)
    return step_record(model, state, losses, grads, schedule, generator)


def compare_steps(a: dict, b: dict) -> dict:
    """The largest differences between two ``one_step`` results, and whether
    each is within its STEP_* limit."""
    loss = max(abs(a["losses"][k] - v) / max(abs(v), STEP_LOSS_ATOL / STEP_LOSS_RTOL)
               for k, v in b["losses"].items())
    num = sum(float(((a["grads"][k] - g).double() ** 2).sum()) for k, g in b["grads"].items())
    den = sum(float((g.double() ** 2).sum()) for g in b["grads"].values())
    d = {k: (a["params"][k] - v).abs() for k, v in b["params"].items()}
    n_far = sum(int((v > 1e-6).sum()) for v in d.values())
    out = {"loss_max_rel": loss,
           "grad_rel_l2": (num / den) ** 0.5,
           "param_max_abs": max(float(v.max()) for v in d.values()),
           "param_far_share": n_far / sum(v.numel() for v in d.values()),
           "batch_stats_max_abs": max(float((a["batch_stats"][k] - v).abs().max())
                                      for k, v in b["batch_stats"].items()),
           "spectral_max_abs": max((float((a["spectral"][k] - v).abs().max())
                                    for k, v in b["spectral"].items()), default=0.0)}
    out["within"] = (loss <= STEP_LOSS_RTOL and out["grad_rel_l2"] <= STEP_GRAD_REL_L2
                     and out["param_max_abs"] <= 2 * b["lr"] + 1e-6
                     and out["param_far_share"] <= STEP_PARAM_FAR_SHARE
                     and out["batch_stats_max_abs"] <= STEP_STATS_ATOL
                     and out["spectral_max_abs"] <= STEP_SN_ATOL)
    return out


# The CPU half of a card-vs-CPU step (the model from seed 0 and one step on
# the CPU) needs no card work and takes 2-20 s of the host at full width. The
# whole run computes most of them in a worker thread while this thread only
# waits, on work that is not timed: the kernel build (phase 1) and 11.3's two
# CLI processes (``cpu_steps_meanwhile``); no timing shares the host with them.
_CPU_AHEAD: dict = {}


def cpu_step(spec) -> tuple:
    """The CPU half of a card-vs-CPU step. ``spec`` = (key, inputs, seed):
    ``inputs()`` gives the config and the batch, ``seed`` the step
    generator's (None: ``torch.Generator()`` as it comes). Returns the
    config, the batch, the model from seed 0 as it was before the step (the
    card's copy starts from it), the step's ``one_step`` record and its
    seconds: computed now, or the ones ``cpu_steps_meanwhile`` computed."""
    key, inputs, seed = spec
    if key in _CPU_AHEAD:
        return _CPU_AHEAD.pop(key)
    from maggie_tpu_torch.models import build_model
    cfg, batch = inputs()
    model = build_model(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0))
    init = copy.deepcopy(model)
    t0 = time.perf_counter()
    record = one_step(model, batch, step_generator(seed), cfg)
    return cfg, batch, init, record, time.perf_counter() - t0


def meanwhile_step(spec) -> tuple:
    """The ``cpu_steps_meanwhile`` spec of ``cpu_step(spec)``."""
    return spec[0], lambda: cpu_step(spec)


def computed(key, fn):
    """What ``cpu_steps_meanwhile`` computed under ``key``, else ``fn()``."""
    return _CPU_AHEAD.pop(key) if key in _CPU_AHEAD else fn()


def step_generator(seed: int | None) -> torch.Generator:
    return torch.Generator() if seed is None else torch.Generator().manual_seed(seed)


def cpu_steps_meanwhile(specs, wait):
    """``wait()``'s result; meanwhile a worker thread computes ``fn()`` of
    each ``(key, fn)`` of ``specs`` for the phases that take them later
    (``cpu_step``, ``computed``). Both are done on return, so that nothing
    timed after it shares the host."""
    errors = []

    def work():
        try:
            for key, fn in specs:
                _CPU_AHEAD[key] = fn()
        except BaseException as exc:  # raised again in this thread
            errors.append(exc)
    worker = threading.Thread(target=work)
    worker.start()
    try:
        out = wait()
    finally:
        worker.join()
    if errors:
        raise errors[0]
    return out


def card_step(spec, dev) -> dict:
    """The card-vs-CPU step of ``spec`` (``cpu_step``): the card's copy of
    the model steps on the same batch with a generator of the same seed, and
    ``compare_steps`` holds it to the CPU's step."""
    cfg, batch, init, cpu, cpu_s = cpu_step(spec)
    card = one_step(init.to(dev), {k: v.to(dev) for k, v in batch.items()},
                    step_generator(spec[2]), cfg)
    out = compare_steps(card, cpu)
    out.update(cpu_step_s=cpu_s, losses_card=card["losses"], losses_cpu=cpu["losses"])
    return out


def flagship_step(flags: dict | None = None, batch_size: int = REDUCED_BATCH,
                  hw: int = REDUCED_HW) -> tuple:
    """The ``cpu_step`` spec of the flagship's step (with ``flags``,
    ``with_flags``) at ``batch_size`` x ``hw`` x ``hw``."""
    def inputs():
        from maggie_tpu_torch.flagship import flagship_cfg, train_batch
        return (with_flags(flagship_cfg(), flags),
                train_batch(batch_size, hw, hw, TRAIN_SLOTS, seed=1))
    return ("flagship", json.dumps(flags, sort_keys=True), batch_size, hw), inputs, 3


def card_vs_cpu_step(dev, flags: dict | None = None, batch_size: int = REDUCED_BATCH,
                     hw: int = REDUCED_HW) -> dict:
    """Phase 6.1: one f32 step of the full-width model (seed 0; the
    flagship's, with ``flags``) on the card and on the CPU (plain twins) on
    the same reduced batch (``batch_size`` x ``hw`` x ``hw``), the random
    draws (dropout, dilation widths) from CPU generators of one seed on both
    sides."""
    out = card_step(flagship_step(flags, batch_size, hw), dev)
    out["size"] = f"batch {batch_size}, {hw}x{hw}, {TRAIN_SLOTS} slots"
    return out


def train_run(dev, precision: str) -> dict:
    """Phase 6.2: TRAIN_STEPS full-width steps at the card condition from seed
    0: losses, ms/step (CUDA events around each step, median of the steps
    after the first), peak device memory, launches per step."""
    from maggie_tpu_torch.engine.optim import build_optimizer
    from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
    from maggie_tpu_torch.flagship import flagship_cfg, train_batch
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    cfg = flagship_cfg(precision)
    model = build_model(cfg.model, device=dev, generator=torch.Generator().manual_seed(0)).train()
    opt, schedule = build_optimizer(cfg, model.parameters())
    state, step = TrainState(model, opt), make_train_step(model, opt, schedule)
    batch = {k: v.to(dev) for k, v in
             train_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_HW, TRAIN_SLOTS, seed=0).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kg.launches = kg.bwd_launches = ku.launches = 0
    ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ld = step(state, batch, gen, **TRAIN_FLAGS)
        end.record()
        losses.append({k: float(v) for k, v in ld.items()})
        ms.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    launches = {"gather_patches": kg.launches, "gather_patches_bwd": kg.bwd_launches,
                "compute_unknown": ku.launches}
    out = {"ms_per_step_median": float(np.median(ms[1:])), "ms_per_step": ms,
           "peak_mem_bytes": torch.cuda.max_memory_allocated(), "losses": losses,
           "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()}}
    if not all(np.isfinite(v) for ld in losses for v in ld.values()):
        fail(f"train {precision}: non-finite losses {losses}")
    want = {"gather_patches": 10, "gather_patches_bwd": 6, "compute_unknown": 1}
    if out["launches_per_step"] != want:
        fail(f"train {precision}: launches per step {out['launches_per_step']} != {want}")
    out.update(step_kernel_split(step, state, batch, gen, out["ms_per_step_median"]))
    return out


def device_us(event) -> float:
    return (event.self_device_time_total if hasattr(event, "self_device_time_total")
            else event.self_cuda_time_total)


def step_kernel_split(step, state, batch, gen, step_ms: float) -> dict:
    """Device time of two steps by torch.profiler: every kernel's, and K1's
    forward and backward and K2's by their CUDA function names (KERNEL_NAMES).
    Fails if a ported kernel launched in those steps but no device time was
    found under its names (a renamed kernel would otherwise read 0)."""
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    counts = lambda: {"gather_patches": kg.launches, "gather_patches_bwd": kg.bwd_launches,
                      "compute_unknown": ku.launches}
    before = counts()
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        for _ in range(2):
            step(state, batch, gen, **TRAIN_FLAGS)
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()}
    split = dict.fromkeys(KERNEL_NAMES, 0.0)
    total = fft = 0.0
    rows = []
    for e in prof.key_averages():
        if e.key.startswith(("aten::", "cuda")):
            continue
        us = device_us(e)
        total += us
        if us > 0:
            rows.append((e.key, us / 1e3 / 2, e.count // 2))
        if "fft" in e.key.lower():
            fft += us
        for k, subs in KERNEL_NAMES.items():
            if any(sub in e.key for sub in subs):
                split[k] += us
    for k, n in launched.items():
        if n and split[k] <= 0.0:
            fail(f"profiled train steps: {k} launched {n} times but no device time was found "
                 f"under {KERNEL_NAMES[k]}")
    fft_ops: dict[str, float] = {}    # cuDNN FFT time by the op that launched it
    for e in prof.events():
        for k in getattr(e, "kernels", ()):
            if "fft" in k.name.lower():
                op = f"{e.name} {e.input_shapes[:3]}"
                fft_ops[op] = fft_ops.get(op, 0.0) + k.duration / 1e3 / 2
    kernel_ms = total / 1e3 / 2
    rows.sort(key=lambda r: -r[1])
    return {"kernel_ms_per_step": kernel_ms, "busy_share": kernel_ms / step_ms,
            "ported_kernels_ms_per_step": {k: v / 1e3 / 2 for k, v in split.items()},
            "fft_ms_per_step": fft / 1e3 / 2,
            "fft_ms_per_step_by_op": dict(sorted(fft_ops.items(), key=lambda r: -r[1])[:8]),
            "top_kernels_per_step": [{"name": n[:90], "ms": ms, "calls": c}
                                     for n, ms, c in rows[:6]]}


def bwd_split_ms(index, ms: float) -> dict:
    """K1 backward's index pass per call by CUDA-graph replay of the pass alone
    (``kg.bwd_index_pass``), and its pull as ``ms``, the whole call's time,
    less that. No profiler: late in a long process torch.profiler dropped
    most of these short kernels' records (PERF.md)."""
    index_ms = graph_ms(index)
    return {"index_ms": index_ms, "pull_ms": ms - index_ms}


def time_gather_bwd(dev, detail, video=False) -> dict:
    """Phase 6.3 (with ``video``, 9.2's): K1's backward per call at the train
    shapes (the video train step's), f32 and bf16, by
    CUDA-graph replay, split into its index pass and pull (``bwd_split_ms``),
    beside its byte bound (each
    window's in-map part of g read, dfeat written, indices read, over the HBM
    rate), its twin and the library
    yardstick: one
    ``index_put_(accumulate=True)`` of every window into a zeroed padded map
    (these two eagerly between CUDA events: the twin reads a count back to
    the host, so it cannot be captured)."""
    from maggie_tpu_torch.ops.kernels import gather as kg
    rs = np.random.RandomState(13)
    keys = ("ms", "index_ms", "pull_ms", "plain_ms", "library_ms", "bound_ms")
    res = {"calls": [], "fp32": dict.fromkeys(keys, 0.0), "bf16": dict.fromkeys(keys, 0.0)}
    calls, cap = ((VIDEO_TRAIN_GATHER_CALLS, VIDEO_TRAIN_CAP) if video
                  else (TRAIN_GATHER_CALLS, TRAIN_CAP))
    for name, shape, block, halo, per_image, layout, grad in calls:
        if not grad:
            continue
        n, h, w, c = shape
        idx = train_indices(shape, block, per_image, dev, rs, cap)
        size = block + 2 * halo
        ar = torch.arange(size, device=dev)
        ii = (idx[0][:, None, None], ((idx[1] * block)[:, None] + ar)[:, :, None],
              ((idx[2] * block)[:, None] + ar)[:, None, :])
        plane = layout == "plane"
        for frame, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            g = torch.randn((cap, size, size, c), device=dev).to(dt)
            padded = torch.zeros((n, h + 2 * halo, w + 2 * halo, c), dtype=dt, device=dev)

            def library():
                padded.zero_()
                padded.index_put_(ii, g, accumulate=True)
            kern = lambda: kg.gather_patches_bwd(g, *idx, shape, block, halo, plane)
            ms = graph_ms(kern)
            row = {"call": name, "dtype": str(dt), "layout": layout, "ms": ms,
                   **bwd_split_ms(lambda: kg.bwd_index_pass(*idx, shape, block), ms),
                   "plain_ms": cuda_ms(lambda: kg.gather_patches_bwd_plain(
                       g, *idx, shape, block, halo, plane), iters=3, warmup=1),
                   "library_ms": cuda_ms(library, iters=5, warmup=1)}
            row["bytes"] = (window_bytes(shape, *idx, block, halo, g.element_size())
                            + n * h * w * c * g.element_size() + 3 * cap * 8)
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            res["calls"].append(row)
            for k in keys:
                res[frame][k] += row[k]
    detail["video_train_gather_bwd_times_per_step" if video else "gather_bwd_times_per_step"] = res
    return res


def stage_split(model, batch, frame_ms: float) -> dict:
    """Device time per frame of each stage, from CUDA events that forward hooks
    record around its modules; ``ladder_fusion`` is the decoder after the
    attention (os8 upsample and K2, block ladder with 5 K1, fusion with 2 K2)
    and ``rest`` the hooked frame minus every stage. Then the kernels' summed
    device time per frame (torch.profiler) and its share of ``frame_ms``."""
    dec = model.decoder
    stages = {"encoder": (model.encoder,), "aspp": (model.aspp,),
              "decoder_os32_os8": (dec.layer1, dec.layer2),
              "attention_os8": (dec.refine_OS8,), "decoder": (dec,)}
    events = {k: [] for k in stages}

    def record():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    handles = []
    for name, mods in stages.items():
        for m in mods:
            handles.append(m.register_forward_pre_hook(
                lambda _m, _a, name=name: events[name].append([record()])))
            handles.append(m.register_forward_hook(
                lambda _m, _a, _o, name=name: events[name][-1].append(record())))
    with torch.inference_mode():
        start = record()
        for _ in range(SPLIT_FRAMES):
            model(batch)
        end = record()
        torch.cuda.synchronize()
    for h in handles:
        h.remove()
    ms = {k: sum(a.elapsed_time(b) for a, b in v) / SPLIT_FRAMES for k, v in events.items()}
    hooked_ms = start.elapsed_time(end) / SPLIT_FRAMES
    ms["ladder_fusion"] = ms["decoder"] - ms["decoder_os32_os8"] - ms["attention_os8"]
    ms["rest"] = hooked_ms - ms["encoder"] - ms["aspp"] - ms.pop("decoder")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode(), torch.profiler.profile(activities=acts) as prof:
        for _ in range(SPLIT_FRAMES):
            model(batch)
        torch.cuda.synchronize()
    kernel_us = 0.0
    for e in prof.key_averages():  # device rows only: ops and runtime calls excluded
        if not e.key.startswith(("aten::", "cuda")):
            kernel_us += device_us(e)
    kernel_ms = kernel_us / 1e3 / SPLIT_FRAMES
    return {"stage_ms": ms, "hooked_frame_ms": hooked_ms, "kernel_ms": kernel_ms,
            "busy_share": kernel_ms / frame_ms}


def gather_call_rows(name, shape, block, halo, per_image, layout, dev, rs) -> dict:
    """K1 at one call shape (``sample_indices``' CAP entries), for each dtype
    the call takes: the kernel, its plain twin and the library yardstick (an
    advanced index of a pre-padded map) by graph replay and eager, and the
    byte bound (the windows written, the distinct in-map input read, the
    indices). {dtype: row}."""
    from maggie_tpu_torch.ops.kernels import gather as kg
    idx = sample_indices(shape, block, per_image, dev, rs)
    size = block + 2 * halo
    ar = torch.arange(size, device=dev)
    ys = (idx[1] * block)[:, None] + ar
    xs = (idx[2] * block)[:, None] + ar
    ii = (idx[0][:, None, None], ys[:, :, None], xs[:, None, :])
    rows = {}
    for dt in gather_dtypes(shape):
        feat = gather_map(shape, layout, dt, dev)
        padded = torch.nn.functional.pad(feat, (0, 0, halo, halo, halo, halo))
        kern = lambda: kg.gather_patches(feat, *idx, block, halo)
        plain = lambda: kg.gather_patches_plain(feat, *idx, block, halo)
        row = {"call": name, "dtype": str(dt), "layout": layout,
               "ms": graph_ms(kern), "plain_ms": graph_ms(plain),
               "library_ms": graph_ms(lambda: padded[ii]),
               "eager_ms": cuda_ms(kern), "eager_plain_ms": cuda_ms(plain)}
        esize = feat.element_size()
        out_bytes = CAP * size * size * shape[-1] * esize
        in_bytes = touched_bytes(shape, *idx, block, halo, esize)
        row["bytes"] = out_bytes + in_bytes + 3 * CAP * 8
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        rows[dt] = row
    return rows


def time_kernels(dev, worst, launches, detail) -> list:
    """Per-frame kernel, plain-twin and yardstick times at the main-path shapes."""
    from maggie_tpu_torch.ops.kernels import unknown as ku
    rs = np.random.RandomState(11)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    g = {"calls": [], "fp32": dict.fromkeys(keys, 0.0), "bf16": dict.fromkeys(keys, 0.0)}
    for call in GATHER_CALLS:
        rows = gather_call_rows(*call, dev, rs)
        g["calls"].extend(rows.values())
        # the bf16 forward gathers its features in bf16 and the os1 mask in f32
        for frame, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            row = rows.get(dt, rows[torch.float32])
            for k in keys:
                g[frame][k] += row[k]
    # yardstick: the NCHW -> NHWC copies that the ladder made before each
    # plane-major gather until the kernel read NCHW itself
    copies = {"fp32_ms": 0.0, "bf16_ms": 0.0, "calls": []}
    for name, shape, _, _, _, layout in GATHER_CALLS:
        if layout != "plane":
            continue
        for frame, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            view = gather_map(shape, "plane", dt, dev)
            row = {"call": name, "dtype": str(dt), "ms": graph_ms(lambda: view.contiguous()),
                   "bytes": 2 * view.numel() * view.element_size()}
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            copies["calls"].append(row)
            copies[f"{frame}_ms"] += row["ms"]
    g["removed_layout_copies"] = copies
    # K2 on the main path's kind of input (blob alphas) and on uniform noise;
    # the copy yardstick is a.clone(): the same bytes read and written
    from maggie_tpu_torch.flagship import blob_alpha
    keys = ("ms", "uniform_ms", "plain_ms", "copy_ms", "bound_ms")
    u = {**dict.fromkeys(keys, 0.0), "calls": []}
    blob = torch.from_numpy(blob_alpha(H, W, N_INST, np.random.RandomState(0)))[None].to(dev)
    uniform = torch.rand((1, N_INST, H, W), device=dev)
    for k in UNKNOWN_K:
        kern = lambda: ku.compute_unknown(blob, k)
        plain = lambda: ku.compute_unknown_plain(blob, k)
        row = {"k": k, "ms": graph_ms(kern),
               "uniform_ms": graph_ms(lambda: ku.compute_unknown(uniform, k)),
               "plain_ms": graph_ms(plain), "copy_ms": graph_ms(blob.clone),
               "eager_ms": cuda_ms(kern), "eager_plain_ms": cuda_ms(plain),
               "bytes": 2 * blob.numel() * 4}
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        u["calls"].append(row)
        for key in keys:
            u[key] += row[key]
    detail["kernel_times_per_frame"] = {"gather_patches": g, "compute_unknown": u}
    return [
        {"name": "gather_patches", "route": "cuda",
         "source": "maggie_tpu_torch/ops/kernels/csrc/gather_patches.cu",
         "replaces": "maggie_tpu/ops/pallas/gather.py:86",
         "launches": launches["gather_patches"],
         "launches_per_frame": launches["gather_patches"] // N_REQUESTS,
         "max_abs_err": worst["gather"],
         "ms": g["fp32"]["ms"], "plain_ms": g["fp32"]["plain_ms"],
         "bound_ms": g["fp32"]["bound_ms"], "bound_by": "bytes",
         "library_ms": g["fp32"]["library_ms"],
         "bf16_ms": g["bf16"]["ms"], "bf16_bound_ms": g["bf16"]["bound_ms"]},
        {"name": "compute_unknown", "route": "cuda",
         "source": "maggie_tpu_torch/ops/kernels/csrc/compute_unknown.cu",
         "replaces": "maggie_tpu/ops/pallas/unknown.py:121",
         "launches": launches["compute_unknown"],
         "launches_per_frame": launches["compute_unknown"] // N_REQUESTS,
         "max_abs_err": worst["unknown"],
         "ms": u["ms"], "plain_ms": u["plain_ms"], "bound_ms": u["bound_ms"],
         "bound_by": "bytes", "library_ms": None, "uniform_ms": u["uniform_ms"],
         "copy_ms": u["copy_ms"]},
    ]


# ---------------------------------------------------------------- phase 8
# the video model (configs/maggie_video.yaml, arch MaGGIe_Temp) streaming one
# synthetic video window by window, then the video eval engine through the CLI
VIDEO_CONFIG = os.path.join("configs", "maggie_video.yaml")
VIDEO_STREAM_FRAMES = 6       # 4 windows of 3 frames, overlap 2
PER_WINDOW = {"gather_patches": 5, "compute_unknown": 3}
VIDEO_TIMING_REPS = 2
VIDEO_SRC = (720, 1280)       # ResizeShort(576) -> 576x1024
VIDEO_SET = (("vid0", 4),)   # (video, frames): 2 windows
# the card's windows against the CPU port's (``video_window_check``):
# refined_masks within phase 3's REFINED_ATOL outside the pixels that a value
# within NEAR of one of the path's discrete decisions may move on rounding:
# K2's 1/255 and 254/255 on its three inputs and the snap's 0.95 on the os8
# alpha, dilated by VIDEO_FLIP_REACH (K2 at k=30, 27 and 15 dilates by
# ellipses of width 15, 13 and 7: radii 7 + 6 + 3 chained); where the two
# boxes differ (the box thresholds the smoothed os8 alpha at 0.1); and in
# frames 1 and 2, which the temporal rule makes pixel by pixel from the
# window's three frames and the previous window's frame 1: the region of any
# frame at that pixel, the change maps near 0.5, its exact comparison of two
# candidates (``rule_near``) and the previous window's frame-1 flips. Within
# that region too, at most VIDEO_MAX_FLIPS pixels may be off by more than
# REFINED_ATOL, and the mean |error| of the other pixels is at most
# VIDEO_MEAN_ATOL: the whole window's mean read 7.7e-9 to 2e-8 with 0-2 flips
# (PERF.md), and a wrong frame or instance moves it by about 1e-2.
NEAR = 1e-4
VIDEO_FLIP_REACH = 33
VIDEO_MAX_FLIPS = 16
VIDEO_MEAN_ATOL = 1e-7


def video_alphas(n_f: int, h: int, w: int, n_i: int = N_INST, seed: int = 0) -> np.ndarray:
    """(1, n_f, n_i, h, w) soft discs of radius h/4 that move 4 px right and
    2 px down a frame, from ``seed``."""
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    cy = [h // 2 + rs.randint(-h // 8, h // 8) for _ in range(n_i)]
    out = np.zeros((1, n_f, n_i, h, w), np.float32)
    r = h // 4
    for t in range(n_f):
        for j in range(n_i):
            d = np.sqrt((yy - cy[j] - 2 * t) ** 2 + (xx - (j + 1) * w // (n_i + 1) - 4 * t) ** 2)
            out[0, t, j] = np.clip((r - d) / (r * 0.2), 0, 1)
    return out


def video_stream(n_f: int, seed: int = 0, hw: tuple = (H, W)) -> dict:
    """One synthetic video at ``hw`` (576x1024): uniform frames and 3 moving
    blob instances, masks the alphas above 0.5 (full size, as VIM eval gives)."""
    h, w = hw
    alpha = video_alphas(n_f, h, w, seed=seed)
    rs = np.random.RandomState(seed + 1)
    return {"image": torch.from_numpy(rs.rand(1, n_f, h, w, 3).astype(np.float32)),
            "mask": torch.from_numpy((alpha > 0.5).astype(np.float32))}


def stream_windows(model, video: dict, cache: bool = True, keep=(), record=None):
    """The engine's streaming loop over ``video``'s 3-frame windows (overlap
    2): with ``cache`` only the new frame is encoded and the feature pack
    rolls; the previous window's frame-1 alpha is carried. Returns the
    outputs of the windows in ``keep``; ``record`` (a list) gets each
    window's launches and encoded frames."""
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    n = video["image"].shape[1]
    feats = prev = None
    kept = {}
    for i in range(n - VIDEO_FRAMES + 1):
        win = {k: v[:, i:i + VIDEO_FRAMES] for k, v in video.items()}
        k0, u0 = kg.launches, ku.launches
        if cache and feats is not None:
            new = model.encode_frames({k: v[:, VIDEO_FRAMES - 1:] for k, v in win.items()})
            feats = {k: torch.cat([feats[k][1:], new[k]]) for k in feats}
            encoded = new["masks"].shape[0]
        else:
            feats = model.encode_frames(win)
            encoded = feats["masks"].shape[0]
        out = model.decode_window(feats, prev_pred=prev)
        prev = out["refined_masks"][:, 1]
        if record is not None:
            record.append({"gather_patches": kg.launches - k0,
                           "compute_unknown": ku.launches - u0, "encoded": encoded})
        if i in keep:
            kept[i] = out
    return kept


def video_models(dev):
    """The video model of configs/maggie_video.yaml at full width, seed 0, SN
    folded: on the CPU, its copy on ``dev`` in f32, and bf16 on ``dev``."""
    from maggie_tpu_torch.config import load_config
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.utils.checkpoint import fold_spectral_norm
    cfg = load_config(VIDEO_CONFIG)
    cpu_model = fold_spectral_norm(build_model(cfg.model, device="cpu",
                                               generator=torch.Generator().manual_seed(0)))
    return cfg, cpu_model, copy.deepcopy(cpu_model).to(dev), bf16_copy(cpu_model).to(dev)


def rule_near(out: dict, prev_pred) -> torch.Tensor:
    """(1, n_i, H, W): where the temporal rule's exact comparison of its two
    frame-1 candidates (``MaGGIeTemp._finalize_eval``) could go the other way
    on rounding: candidates within NEAR of each other, unless both are
    frame 1 itself (both change maps above 0.5) or equal at 0 or 1."""
    a, f, b = out["refined_masks"], out["diff_pred_forward"], out["diff_pred_backward"]
    pp = a[:, 0] if prev_pred is None else prev_pred
    df, db = f[:, 1] > 0.5, b[:, 1] > 0.5
    f01 = torch.where(df, a[:, 1], pp)
    b21 = torch.where(db, a[:, 1], a[:, -1])
    saturated = (f01 == b21) & ((f01 == 0) | (f01 == 1))
    return ((f01 - b21).abs() < NEAR) & ~(df & db) & ~saturated


class ThresholdRecorder:
    """Records, while on, the inputs and results of the video path's discrete
    decisions for the first ``windows`` windows, one dict a window: K2's
    inputs (``k30``, the os8 alpha before the snap; ``k27`` and ``k15``, the
    fusion's), the box and its smoothed-map pixels within NEAR of 0.1
    (``box``, ``box_near``), the change maps the temporal rule reads
    (``diffs``: forward frames 1-2, backward frames 0-1) and where its exact
    comparison is near (``rule``). The kernels' wrappers are called as
    before, so their launch counts do not change, and what is recorded is
    worked out on the CPU, so the card's peak memory does not either."""

    def __init__(self, windows: int):
        import maggie_tpu_torch.models.decoder_sparse as ds
        import maggie_tpu_torch.models.decoder_video as dv
        from maggie_tpu_torch.models.maggie_temp import MaGGIeTemp
        self.ds, self.dv, self.cls = ds, dv, MaGGIeTemp
        self.windows, self.records = windows, []

    def _on(self) -> bool:
        return len(self.records) <= self.windows

    def _keep(self, key, value):
        if self._on():
            self.records[-1][key] = value.detach().cpu()

    def __enter__(self):
        dec = self.dv.ResShortCutInstMattSpconvTempDec
        unknown, box, finalize = self.dv.compute_unknown, dec._bbox_mask, self.cls._finalize_eval
        self.saved = (unknown, self.ds.compute_unknown, box, finalize)

        def spy_unknown(x, k_size):
            if k_size == 30:          # a window's first decision
                self.records.append({})
            self._keep(f"k{k_size}", x)
            return unknown(x, k_size)

        def spy_box(x):
            out = box(x)
            if self._on():
                self._keep("box", out)
                smooth = self.dv.gaussian_smoothing(x.detach().cpu(), sigma=3)
                self._keep("box_near", (smooth - 0.1).abs() < NEAR)
            return out

        def spy_finalize(model, out, prev_pred):
            if self._on():
                keys = ("refined_masks", "diff_pred_forward", "diff_pred_backward")
                host = {k: out[k].detach().cpu() for k in keys}
                self._keep("diffs_f", host["diff_pred_forward"][:, 1:])
                self._keep("diffs_b", host["diff_pred_backward"][:, :-1])
                self._keep("rule", rule_near(host, None if prev_pred is None
                                             else prev_pred.cpu())[0])
            return finalize(model, out, prev_pred)
        self.dv.compute_unknown = self.ds.compute_unknown = spy_unknown
        dec._bbox_mask = staticmethod(spy_box)
        self.cls._finalize_eval = spy_finalize
        return self

    def __exit__(self, *exc):
        unknown, ds_unknown, box, finalize = self.saved
        self.dv.compute_unknown, self.ds.compute_unknown = unknown, ds_unknown
        self.dv.ResShortCutInstMattSpconvTempDec._bbox_mask = staticmethod(box)
        self.cls._finalize_eval = finalize


def video_window_check(card_out, cpu_out, card_rec, cpu_rec, prev_flips=None) -> dict:
    """A card window against the CPU port's (see NEAR for the region and the
    gates): detail_mask equal outside K2's k=30 reach of near pixels and
    where the boxes differ, each box difference in a map with a near pixel,
    refined_masks within REFINED_ATOL outside the region, at most
    VIDEO_MAX_FLIPS flips in all and the other pixels' mean |error| within
    VIDEO_MEAN_ATOL. ``card_rec`` and ``cpu_rec`` are the two runs'
    ``ThresholdRecorder`` records of the window; ``prev_flips`` (n_i, H, W)
    the previous window's frame-1 flips. Returns the counts and the flips of
    frame 1 under ``frame1_flips``."""
    from maggie_tpu_torch.ops.morphology import LOWER_THRES, UPPER_THRES, dilate_ellipse

    def near(x, *values):
        return torch.stack([(x - v).abs() < NEAR for v in values]).any(dim=0)
    k30 = near(cpu_rec["k30"], LOWER_THRES, UPPER_THRES)              # (3, n_i, H, W)
    box_diff = card_rec["box"] != cpu_rec["box"]
    dm_allowed = (dilate_ellipse(k30.float(), 15) > 0) | box_diff
    dm_diff = card_out["detail_mask"][0].cpu() != cpu_out["detail_mask"][0]
    seeds = k30 | near(cpu_rec["k30"], 0.95) | box_diff \
        | near(cpu_rec["k27"], LOWER_THRES, UPPER_THRES) \
        | near(cpu_rec["k15"], LOWER_THRES, UPPER_THRES)
    region = dilate_ellipse(seeds.float(), VIDEO_FLIP_REACH) > 0
    f, b = cpu_rec["diffs_f"][0], cpu_rec["diffs_b"][0]               # (2, n_i, H, W)
    diff_near = near(f[0], 0.5) | near(f[1], 0.5) | near(b[1], 0.5)   # rule: f 1, 2; b 1
    rule = region.any(dim=0) | diff_near | cpu_rec["rule"]
    if prev_flips is not None:
        rule |= prev_flips
    region[1:] |= rule
    err = (card_out["refined_masks"].float().cpu() - cpu_out["refined_masks"])[0].abs()
    flips = err > REFINED_ATOL
    box_maps = box_diff.flatten(2).any(dim=-1)                        # (3, n_i)
    return {"near_threshold_pixels": int(seeds.sum()), "diff_near_pixels": int(diff_near.sum()),
            "rule_near_pixels": int(cpu_rec["rule"].sum()),
            "region_share": float(region.float().mean()),
            "box_diff_pixels": int(box_diff.sum()),
            "unexplained_box_maps": int((box_maps & ~cpu_rec["box_near"].flatten(2).any(-1)).sum()),
            "detail_mask_diff": int(dm_diff.sum()),
            "unexplained_detail_mask_diff": int((dm_diff & ~dm_allowed).sum()),
            "refined_flips": int(flips.sum()), "unexplained_flips": int((flips & ~region).sum()),
            "refined_max_abs_err": float(err.max()),
            "refined_max_abs_err_outside_flips": float(err[~region].max())
            if bool((~region).any()) else 0.0,
            "refined_mean_abs_err": float(err.mean()),
            "refined_mean_abs_err_unflipped": float(err[~flips].mean()),
            "frame1_flips": flips[1]}


def video_window_failures(c: dict) -> list:
    """The gates of ``video_window_check``'s result that fail."""
    return [name for name, bad in (
        ("detail_mask differs outside K2's reach and the box difference",
         c["unexplained_detail_mask_diff"] > 0),
        ("a box differs in a map with no smoothed pixel near 0.1", c["unexplained_box_maps"] > 0),
        ("refined_masks flips outside the region", c["unexplained_flips"] > 0),
        (f"more than {VIDEO_MAX_FLIPS} refined_masks flips", c["refined_flips"] > VIDEO_MAX_FLIPS),
        (f"mean |error| of the unflipped pixels above {VIDEO_MEAN_ATOL}",
         c["refined_mean_abs_err_unflipped"] > VIDEO_MEAN_ATOL)) if bad]


def time_stream(model, video, cache: bool) -> dict:
    """ms per window over the whole stream (CUDA events around it, host
    launch cost included), median of VIDEO_TIMING_REPS passes after one warm
    pass."""
    windows = video["image"].shape[1] - VIDEO_FRAMES + 1
    with torch.inference_mode():
        stream_windows(model, video, cache)
        passes = []
        for _ in range(VIDEO_TIMING_REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            stream_windows(model, video, cache)
            end.record()
            end.synchronize()
            passes.append(start.elapsed_time(end) / windows)
    return {"ms_per_window_median": float(np.median(passes)), "ms_per_window": passes}


def window_kernels(model, video) -> dict:
    """torch.profiler over one cached window's decode (f32): the kernels'
    device time, their 5 largest by name, and K1's and K2's share."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        feats = model.encode_frames({k: v[:, :VIDEO_FRAMES] for k, v in video.items()})
        model.decode_window(feats)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            model.decode_window(feats)
            torch.cuda.synchronize()
    rows = [(e.key, device_us(e) / 1e3, e.count) for e in prof.key_averages()
            if not e.key.startswith(("aten::", "cuda")) and device_us(e) > 0]
    rows.sort(key=lambda r: -r[1])
    ported = {k: sum(ms for name, ms, _ in rows if any(sub in name for sub in subs))
              for k, subs in KERNEL_NAMES.items() if k != "gather_patches_bwd"}
    for k, ms in ported.items():   # a renamed kernel would otherwise read 0
        if ms <= 0.0:
            fail(f"profiled video window: no device time under {KERNEL_NAMES[k]}")
    return {"kernel_ms": sum(r[1] for r in rows), "ported_ms": ported,
            "top": [{"name": n[:90], "ms": ms, "calls": c} for n, ms, c in rows[:5]]}


def phase_video_model(dev, detail) -> dict:
    """Phase 8 (model): the full-width video model streaming one synthetic
    video on the card; launches and encoded frames per window, windows 0 and
    1 against the CPU port, ms per window cached and uncached in f32 and
    bf16, peak memory. Returns the launches of the checked stream."""
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    t0 = time.perf_counter()
    cfg, cpu_model, model, bf16_model = video_models(dev)
    video = video_stream(VIDEO_STREAM_FRAMES)
    on_dev = {k: v.to(dev) for k, v in video.items()}
    windows = VIDEO_STREAM_FRAMES - VIDEO_FRAMES + 1
    out = {"config": VIDEO_CONFIG, "frames": VIDEO_STREAM_FRAMES, "windows": windows,
           "hw": [H, W], "instances": N_INST,
           "temp_method": cfg.model.decoder_args.temp_method}
    record = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kg.launches = 0
    ku.launches = 0
    with torch.inference_mode(), ThresholdRecorder(2) as card_rec:
        card = stream_windows(model, on_dev, True, keep=(0, 1, windows - 1), record=record)
    torch.cuda.synchronize()
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["launches"] = {"gather_patches": kg.launches, "compute_unknown": ku.launches}
    out["per_window"] = record
    for i, r in enumerate(record):
        want = {**PER_WINDOW, "encoded": VIDEO_FRAMES if i == 0 else 1}
        if r != want:
            fail(f"video window {i}: {r}, not {want}")
    if out["launches"] != {k: v * windows for k, v in PER_WINDOW.items()}:
        fail(f"video stream: launches {out['launches']} over {windows} windows")
    for i, o in card.items():
        for k, v in o.items():
            if k == "mem_feat":
                continue
            if tuple(v.shape) != (1, VIDEO_FRAMES, N_INST, H, W) or not bool(torch.isfinite(v).all()):
                fail(f"video window {i}: {k} has shape {tuple(v.shape)} or non-finite values")
        if float(o["refined_masks"].min()) < 0 or float(o["refined_masks"].max()) > 1:
            fail(f"video window {i}: refined_masks outside [0, 1]")
    out["detail_fraction"] = [float(card[i]["detail_mask"].mean()) for i in (0, 1)]
    t1 = time.perf_counter()
    with torch.inference_mode(), ThresholdRecorder(2) as cpu_rec:
        cpu = stream_windows(cpu_model, {k: v[:, :VIDEO_FRAMES + 1] for k, v in video.items()},
                             True, keep=(0, 1))
    out["cpu_windows_s"] = time.perf_counter() - t1
    out["cpu_check"], prev_flips = [], None
    for i in (0, 1):
        c = video_window_check(card[i], cpu[i], card_rec.records[i], cpu_rec.records[i],
                               prev_flips)
        prev_flips = c.pop("frame1_flips")
        out["cpu_check"].append(c)
        if video_window_failures(c):
            fail(f"video window {i} vs the CPU port: {'; '.join(video_window_failures(c))}: {c}")
    del card, cpu, card_rec, cpu_rec
    out["timing"] = {}
    for name, m in (("fp32", model), ("bf16", bf16_model)):
        for cache in (True, False):
            out["timing"][f"{name}_{'cached' if cache else 'uncached'}"] = time_stream(
                m, on_dev, cache)
    out["fp32_decode_kernels"] = window_kernels(model, on_dev)
    detail["video_model"] = out
    print(f"phase 8: video model ({VIDEO_CONFIG}, {cfg.model.decoder_args.temp_method}) streamed "
          f"{VIDEO_STREAM_FRAMES} frames ({windows} windows, {H}x{W}, {N_INST} instances) with "
          f"the feature cache in {time.perf_counter() - t0:.1f} s; launches {out['launches']} "
          f"({PER_WINDOW} and one encoded frame a window after the first); peak device memory "
          f"{out['peak_mem_bytes']} bytes", flush=True)
    for i, c in enumerate(out["cpu_check"]):
        print(f"phase 8: window {i} vs the CPU port: refined max |err| outside the region "
              f"{c['refined_max_abs_err_outside_flips']:.3g} (mean {c['refined_mean_abs_err']:.3g}, "
              f"unflipped {c['refined_mean_abs_err_unflipped']:.3g}), flips {c['refined_flips']} "
              f"px ({c['unexplained_flips']} outside the region), detail_mask diff "
              f"{c['detail_mask_diff']} px ({c['unexplained_detail_mask_diff']} unexplained), box "
              f"diff {c['box_diff_pixels']} px; region share {c['region_share']:.4g} (near "
              f"{c['near_threshold_pixels']} K2/snap px, {c['diff_near_pixels']} change-map px, "
              f"{c['rule_near_pixels']} px of the rule's comparison)", flush=True)
    t, kk = out["timing"], out["fp32_decode_kernels"]
    print("phase 8: ms per window (= per new frame with the cache): "
          + ", ".join(f"{k} {v['ms_per_window_median']:.3f}" for k, v in t.items()), flush=True)
    print(f"phase 8: one f32 window's decode: kernels {kk['kernel_ms']:.3f} ms of device time "
          f"(K1 {kk['ported_ms']['gather_patches']:.3f}, K2 "
          f"{kk['ported_ms']['compute_unknown']:.3f}); largest: "
          + "; ".join(f"{r['name'][:60]} {r['ms']:.3f} ms x{r['calls']}" for r in kk["top"]),
          flush=True)
    return out


def phase_video(dev, detail) -> dict:
    """Phase 8: the video model streaming on the card, then the video eval
    engine through the CLI."""
    return {"model": phase_video_model(dev, detail), "engine": phase_video_engine(detail)}


def video_only(dev) -> int:
    """``--video``: build the kernels, hold them against their twins at the
    video path's shapes, then phase 8."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    out, worst = {"gather": [], "unknown": []}, {"gather": 0.0, "unknown": 0.0}
    check_video_gathers(dev, np.random.RandomState(7), out, worst)
    check_video_unknown(dev, out, worst)
    print(f"video kernels equal to their plain twins ({len(out['gather'])} gather, "
          f"{len(out['unknown'])} compute_unknown cases)", flush=True)
    detail = {"kernel_checks": out}
    phase_video(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_video.json"), "w") as f:
        json.dump(detail, f, indent=1)
    return 0


def video_set(root: str, videos=VIDEO_SET) -> None:
    """Write a VIM eval set with PIL: ``root/chip/fgr/<video>/<frame>.jpg``,
    ``root/chip/{pha,xmem}/<video>/<frame>/<instance>.png``: ``videos`` (name,
    frames) at 720x1280, 3 moving blob instances, the masks the alphas
    binarized."""
    from PIL import Image
    h, w = VIDEO_SRC
    for v, (name, n_f) in enumerate(videos):
        alpha = video_alphas(n_f, h, w, seed=40 + v)[0]
        rs = np.random.RandomState(50 + v)
        for t in range(n_f):
            small = Image.fromarray(rs.randint(0, 256, (h // 16, w // 16, 3)).astype(np.uint8))
            frame = np.asarray(small.resize((w, h), Image.BILINEAR))
            path = os.path.join(root, "chip", "fgr", name, f"{t:04d}.jpg")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(frame).save(path, quality=90)
            for j in range(N_INST):
                a = np.round(alpha[t, j] * 255).astype(np.uint8)
                for d, arr in (("pha", a), ("xmem", ((a > 127) * 255).astype(np.uint8))):
                    path = os.path.join(root, "chip", d, name, f"{t:04d}", f"{j:02d}.png")
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    Image.fromarray(arr).save(path)


def phase_video_engine(detail) -> dict:
    """Phase 8 (engine): ``main.main(["--config", configs/maggie_video.yaml,
    "--eval-only", ...])`` at full width on a synthetic VIM set; launches per
    window, finite metrics, results.csv, frames/s with metrics on and the
    per-window split."""
    import tempfile
    import maggie_tpu_torch.engine.test as eng
    import maggie_tpu_torch.utils.metrics as pm
    from maggie_tpu_torch import main as cli
    from maggie_tpu_torch.models.maggie_temp import MaGGIeTemp
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku

    windows, split, messddt, metric_s = [], {}, [], []
    decode, eval_video, update, metrics = (MaGGIeTemp.decode_window, eng.eval_video,
                                           pm.MESSDdt.update, eng.compute_metrics)

    def counted_decode(model, *a, **kw):
        k0, u0 = kg.launches, ku.launches
        out = decode(model, *a, **kw)
        windows.append({"gather_patches": kg.launches - k0, "compute_unknown": ku.launches - u0})
        return out

    def timed_eval_video(*a, **kw):
        split["batch_time_s"], split["data_time_s"], split["host_time_s"] = eval_video(*a, **kw)
        return split["batch_time_s"], split["data_time_s"], split["host_time_s"]

    def timed_update(self, *a, **kw):
        t0 = time.perf_counter()
        out = update(self, *a, **kw)
        messddt.append(time.perf_counter() - t0)
        return out

    def timed_metrics(*a, **kw):
        t0 = time.perf_counter()
        out = metrics(*a, **kw)
        metric_s.append(time.perf_counter() - t0)
        return out

    out = {"videos": [list(v) for v in VIDEO_SET], "source_hw": list(VIDEO_SRC)}
    with tempfile.TemporaryDirectory() as root:
        video_set(root)
        out_dir = os.path.join(root, "out")
        MaGGIeTemp.decode_window, eng.eval_video = counted_decode, timed_eval_video
        pm.MESSDdt.update, eng.compute_metrics = timed_update, timed_metrics
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kg.launches = 0
            ku.launches = 0
            t0 = time.perf_counter()
            results = cli.main(["--config", VIDEO_CONFIG, "--eval-only", "name", "video",
                                "output_dir", out_dir, "dataset.test.root_dir", root,
                                "dataset.test.split", "chip", "test.log_iter", "100"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"gather_patches": kg.launches, "compute_unknown": ku.launches}
        finally:
            MaGGIeTemp.decode_window, eng.eval_video = decode, eval_video
            pm.MESSDdt.update, eng.compute_metrics = update, metrics
        with open(os.path.join(out_dir, "video", "results.csv")) as f:
            rows = f.read().strip().split("\n")
    n_windows = sum(n - VIDEO_FRAMES + 1 for _, n in VIDEO_SET)
    n_frames = sum(n for _, n in VIDEO_SET)
    want = ["MAD", "MSE", "SAD", "Grad", "Conn", "dtSSD", "MESSDdt"]
    if launches != {k: v * n_windows for k, v in PER_WINDOW.items()}:
        fail(f"video engine: launches {launches} over {n_windows} windows, not {PER_WINDOW} each")
    if len(windows) != n_windows or any(w != PER_WINDOW for w in windows):
        fail(f"video engine: {len(windows)} windows launched {windows}, not {PER_WINDOW} "
             f"each over {n_windows}")
    if not all(k in results and np.isfinite(results[k]) for k in want):
        fail(f"video engine: metrics {results}")
    if len(rows) != 2 or rows[0].split(",")[2:] != list(results) or \
            not all(np.isfinite(float(c)) for c in rows[1].split(",")[2:]):
        fail(f"video engine: results.csv reads {rows}")
    out.update(results={k: float(v) for k, v in results.items()}, wall_s=wall, frames=n_frames, windows=n_windows,
               frames_per_s=n_frames / wall, per_window=split,
               metrics_time_s_per_window=float(np.mean(metric_s)),
               messddt_host_s_per_window=float(np.sum(messddt)) / n_windows,
               messddt_calls=len(messddt),
               launches=launches,
               peak_mem_bytes=torch.cuda.max_memory_allocated(), results_csv=rows)
    detail["video_engine"] = out
    print(f"phase 8: video engine (main --eval-only --config {VIDEO_CONFIG}): {n_frames} frames "
          f"({len(VIDEO_SET)} videos, {VIDEO_SRC[0]}x{VIDEO_SRC[1]} -> 576x1024, {N_INST} "
          f"instances, {n_windows} windows) in {wall:.3f} s, {out['frames_per_s']:.4f} frames/s "
          f"with the seven metrics on; per window: forward (batch_time) "
          f"{split['batch_time_s']:.4f} s, loader (data_time) {split['data_time_s']:.4f} s, host "
          f"{split['host_time_s']:.4f} s (metrics {out['metrics_time_s_per_window']:.4f} s, of "
          f"which MESSDdt {out['messddt_host_s_per_window']:.4f} s); peak device memory "
          f"{out['peak_mem_bytes']} bytes; launches {out['launches']}; metrics "
          + ", ".join(f"{k} {results[k]:.6g}" for k in want), flush=True)
    return out


# ---------------------------------------------------------------- phase 9
# video training: configs/maggie_video.yaml (MaGGIe_Temp, bi_fusion) in train
# mode through make_train_step, then the trainer through the CLI validating
# through eval_video
VIDEO_REDUCED = (3, 256)      # 9.1: batch 1 x clip 3 x 256x256, 10 slots
VIDEO_TRAIN_SET = (("v0", 16), ("v1", 16))   # 9.3's train videos at VIDEO_SRC
VIDEO_TRAINER_ITERS, VIDEO_TRAINER_VAL_ITER = 3, 3
VIDEO_TRAINER_VAL_SET = (("vid0", 4),)      # phase 8's writer: 2 windows a validation
PER_VAL_WINDOW = {"gather_patches": 5, "gather_patches_bwd": 0, "compute_unknown": 3}

def video_train_batch(n_f: int, hw: int, seed: int = 0) -> dict:
    """One train clip (batch 1) of ``n_f`` frames at ``hw`` x ``hw`` in
    TRAIN_SLOTS slots: uniform frames; in slots 0-2 soft discs moving 4 px
    right and 2 down a frame (``video_alphas``); masks the alphas above 0.5
    at full size, as the VIM train set gives them; the transition GT ones on
    frame 0 and, after it, where any instance's alpha changed by more than
    5/255 since the frame before (the VIM set's change map, undilated)."""
    alpha = np.zeros((1, n_f, TRAIN_SLOTS, hw, hw), np.float32)
    alpha[:, :, :N_INST] = video_alphas(n_f, hw, hw, seed=seed)
    changed = (np.abs(alpha[:, 1:] - alpha[:, :-1]) > 5 / 255).any(axis=2, keepdims=True)
    trans = np.concatenate([np.ones_like(changed[:, :1]), changed], axis=1)
    rs = np.random.RandomState(seed + 1)
    batch = {"image": rs.rand(1, n_f, hw, hw, 3), "mask": alpha > 0.5, "alpha": alpha,
             "transition": np.broadcast_to(trans, alpha.shape)}
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in batch.items()}


def video_train_cfg(precision: str = "fp32"):
    from maggie_tpu_torch.config import load_config
    cfg = load_config(VIDEO_CONFIG)
    cfg.model.precision = precision
    return cfg


def video_step() -> tuple:
    """The ``cpu_step`` spec of 9.1's step."""
    n_f, hw = VIDEO_REDUCED
    return ("video", n_f, hw), lambda: (video_train_cfg(), video_train_batch(n_f, hw, seed=1)), 3


def video_card_vs_cpu_step(dev) -> dict:
    """9.1: one f32 step of the full-width video model (seed 0) on the card
    and on the CPU (plain twins) on the same reduced clip, the random draws
    from CPU generators of one seed on both sides; phase 6's STEP_* limits."""
    n_f, hw = VIDEO_REDUCED
    out = card_step(video_step(), dev)
    out["size"] = f"batch 1 x clip {n_f}, {hw}x{hw}, {TRAIN_SLOTS} slots"
    return out


def video_train_run(dev, precision: str) -> dict:
    """9.2: TRAIN_STEPS full-width video steps at batch 1 x clip
    VIDEO_TRAIN_CLIP x 512x512 from seed 0: losses, ms/step (CUDA events around each step,
    median of the steps after the first), peak device memory, launches per
    step, and the kernels' device time over 2 more steps (torch.profiler)."""
    from maggie_tpu_torch.engine.optim import build_optimizer
    from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    cfg = video_train_cfg(precision)
    model = build_model(cfg.model, device=dev, generator=torch.Generator().manual_seed(0)).train()
    opt, schedule = build_optimizer(cfg, model.parameters())
    state, step = TrainState(model, opt), make_train_step(model, opt, schedule)
    batch = {k: v.to(dev) for k, v in video_train_batch(VIDEO_TRAIN_CLIP, TRAIN_HW, seed=0).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kg.launches = kg.bwd_launches = ku.launches = 0
    ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ld = step(state, batch, gen, **TRAIN_FLAGS)
        end.record()
        losses.append({k: float(v) for k, v in ld.items()})
        ms.append(start.elapsed_time(end))
    torch.cuda.synchronize()
    launches = kernel_counts()
    out = {"precision": precision, "clip": VIDEO_TRAIN_CLIP, "ms_per_step_median": float(np.median(ms[1:])),
           "ms_per_step": ms, "peak_mem_bytes": torch.cuda.max_memory_allocated(),
           "card_total_bytes": torch.cuda.get_device_properties(dev).total_memory,
           "losses": losses, "launches": launches,
           "launches_per_step": {k: v / TRAIN_STEPS for k, v in launches.items()}}
    if not all(np.isfinite(v) for ld in losses for v in ld.values()):
        fail(f"video train {precision}: non-finite losses {losses}")
    if not {"loss_temp", "loss_temp_bce", "loss_temp_dtssd"} <= set(losses[0]):
        fail(f"video train {precision}: no temporal losses in {sorted(losses[0])}")
    if out["launches_per_step"] != PER_ITER:
        fail(f"video train {precision}: launches per step {out['launches_per_step']} != {PER_ITER}")
    out.update(step_kernel_split(step, state, batch, gen, out["ms_per_step_median"]))
    return out


def video_train_set(root: str) -> None:
    """Write a V-HIM-style train split with PIL: ``root/V/fgr/<video>/<t>.jpg``
    and ``root/V/pha/<video>/<t>/<instance>.png``: VIDEO_TRAIN_SET's videos at
    VIDEO_SRC, 3 soft discs moving 4 px right and 2 down a frame over smooth
    colour frames with grain."""
    from PIL import Image
    h, w = VIDEO_SRC
    for v, (name, n_f) in enumerate(VIDEO_TRAIN_SET):
        alpha = video_alphas(n_f, h, w, seed=60 + v)[0]
        rs = np.random.RandomState(70 + v)
        for t in range(n_f):
            small = Image.fromarray(rs.randint(0, 256, (h // 16, w // 16, 3)).astype(np.uint8))
            frame = np.asarray(small.resize((w, h), Image.BILINEAR)).astype(np.int16)
            frame = np.clip(frame + rs.randint(-12, 13, frame.shape), 0, 255).astype(np.uint8)
            path = os.path.join(root, "V", "fgr", name, f"{t:04d}.jpg")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(frame).save(path, quality=90)
            for j in range(N_INST):
                path = os.path.join(root, "V", "pha", name, f"{t:04d}", f"{j:02d}.png")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                Image.fromarray(np.round(alpha[t, j] * 255).astype(np.uint8)).save(path)


def video_trainer(detail) -> dict:
    """9.3: ``main.main`` training configs/maggie_video.yaml at full width
    (batch 1, clips of 8) for VIDEO_TRAINER_ITERS iterations on a synthetic
    train split, validating every VIDEO_TRAINER_VAL_ITER through eval_video
    on a VIM set from phase 8's writer (VIDEO_TRAINER_VAL_SET); the host cost
    of one clip by transform. In f32, as 9.2's clip-8 steps."""
    import tempfile
    from maggie_tpu_torch.config import load_config
    out = {"precision": "fp32", "videos": [list(v) for v in VIDEO_TRAIN_SET],
           "source_hw": list(VIDEO_SRC)}
    with tempfile.TemporaryDirectory() as root:
        video_train_set(root)
        video_set(root, VIDEO_TRAINER_VAL_SET)
        opts = ["name", "video_train", "output_dir", os.path.join(root, "out"),
                "dataset.train.root_dir", root, "dataset.train.split", "V",
                "dataset.test.root_dir", root, "dataset.test.split", "chip",
                "train.batch_size", "1", "train.max_iter", str(VIDEO_TRAINER_ITERS),
                "train.val_iter", str(VIDEO_TRAINER_VAL_ITER), "train.log_iter", "1",
                "test.log_iter", "100"]
        out["host_ms_per_clip"] = host_cost_by_transform(load_config(VIDEO_CONFIG, opts), 2)
        run = trainer_run(["--config", VIDEO_CONFIG] + opts, {})
        n_windows = sum(n - VIDEO_FRAMES + 1 for _, n in VIDEO_TRAINER_VAL_SET)
        out.update(check_trainer_run(
            "video", run, os.path.join(root, "out", "video_train"), VIDEO_TRAINER_ITERS,
            VIDEO_TRAINER_ITERS // VIDEO_TRAINER_VAL_ITER, per_val=PER_VAL_WINDOW,
            val_units=n_windows))
    detail["video_trainer"] = out
    return out


def phase_video_train(dev, detail) -> dict:
    """Phase 9: the card-vs-CPU video step, the timed steps in f32 and bf16,
    K1's backward at the video train shapes, and the trainer through the CLI.
    Returns the launches of the f32 steps and of the trainer."""
    t0 = time.perf_counter()
    check = video_card_vs_cpu_step(dev)
    torch.cuda.empty_cache()
    print(f"phase 9: one f32 video step on the card vs the CPU port ({check['size']}; CPU step "
          f"{check['cpu_step_s']:.1f} s): loss terms max rel {check['loss_max_rel']:.3g}, "
          f"gradients rel L2 "
          f"{check['grad_rel_l2']:.3g}, params max |d| {check['param_max_abs']:.3g} (share "
          f"beyond 1e-6 {check['param_far_share']:.3g}), BN stats max |d| "
          f"{check['batch_stats_max_abs']:.3g}, SN u/v max |d| {check['spectral_max_abs']:.3g}",
          flush=True)
    if not check["within"]:
        fail(f"video train step on the card differs from the CPU port beyond the limits: {check}")
    runs = {"reduced_check": check}
    t = time_gather_bwd(dev, detail, video=True)
    for precision in ("fp32", "bf16"):
        r = runs[precision] = video_train_run(dev, precision)
        torch.cuda.empty_cache()
        k = r["ported_kernels_ms_per_step"]
        print(f"phase 9: video train {precision} (batch 1 x clip {VIDEO_TRAIN_CLIP}, "
              f"{TRAIN_HW}x{TRAIN_HW}, {TRAIN_SLOTS} slots): {r['ms_per_step_median']:.3f} "
              f"ms/step (median of steps "
              f"2-{TRAIN_STEPS}: {[round(x, 3) for x in r['ms_per_step']]}), peak device memory "
              f"{r['peak_mem_bytes']} of {r['card_total_bytes']} bytes, launches per step "
              f"{r['launches_per_step']}; kernels {r['kernel_ms_per_step']:.3f} ms/step (busy "
              f"share {r['busy_share']:.3f}), of which K1 {k['gather_patches']:.3f}, K1 backward "
              f"{k['gather_patches_bwd']:.3f}, K2 {k['compute_unknown']:.3f}, cuDNN FFT "
              f"{r['fft_ms_per_step']:.3f}; largest: "
              + "; ".join(f"{t['name'][:50]} {t['ms']:.2f} ms x{t['calls']}"
                          for t in r["top_kernels_per_step"])
              + f"; losses {[round(ld['total'], 6) for ld in r['losses']]}", flush=True)
        if r["fft_ms_per_step_by_op"]:
            print(f"phase 9: cuDNN FFT by op ({precision}, ms/step): " + "; ".join(
                f"{op} {ms:.3f}" for op, ms in r["fft_ms_per_step_by_op"].items()), flush=True)
    detail["video_train"] = runs
    for frame in ("fp32", "bf16"):
        f = t[frame]
        print(f"phase 9: K1 backward per {frame} video step (6 calls, cap {VIDEO_TRAIN_CAP}): "
              f"kernel {f['ms']:.4f} ms (index pass {f['index_ms']:.4f}, pull {f['pull_ms']:.4f}), "
              f"bound {f['bound_ms']:.4f} ms, twin {f['plain_ms']:.4f} ms, index_put_ "
              f"{f['library_ms']:.4f} ms", flush=True)
    trainer = video_trainer(detail)
    m, h = trainer["meters"], trainer["host_ms_per_clip"]
    print(f"phase 9: video trainer fp32 (main --config {VIDEO_CONFIG}, batch 1 x clip "
          f"{VIDEO_TRAIN_CLIP}, {m['iters_measured']} iterations after the first, validation "
          f"through eval_video every {VIDEO_TRAINER_VAL_ITER}): "
          f"{m['samples_per_sec_sustained']:.4f} clips/s, {m['batch_time_avg_s'] * 1e3:.1f} "
          f"ms/iteration against 9.2's {runs['fp32']['ms_per_step_median']:.1f} ms/step, data_time "
          f"{m['data_time_avg_s'] * 1e3:.1f} ms, stall share {m['infeed_stall_frac']:.3f}, peak "
          f"device memory {m['peak_mem_mb']:.0f} MB; launches {trainer['launches']}; losses "
          f"finite {trainer['logged_losses']}", flush=True)
    print("phase 9: host ms per train clip by transform (one thread, mean over about 2 clips "
          "spread over the set): " + ", ".join(f"{k} {v:.1f}" for k, v in h.items()), flush=True)
    print(f"phase 9: done in {time.perf_counter() - t0:.1f} s", flush=True)
    return {"steps": runs["fp32"]["launches"], "trainer": trainer["launches"]}


def video_train_only(dev) -> int:
    """``--video-train``: build the kernels, hold them against their twins at
    the video train shapes, then phase 9."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    out, worst = {"gather": [], "unknown": []}, {"gather": 0.0, "unknown": 0.0}
    check_train_gathers(dev, np.random.RandomState(7), out, worst, video=True)
    check_video_train_unknown(dev, out, worst)
    print(f"video train kernels equal to their plain twins ({len(out['gather'])} gather, "
          f"{len(out['gather_bwd'])} gather backward, {len(out['unknown'])} compute_unknown "
          f"cases)", flush=True)
    detail = {"kernel_checks": out}
    phase_video_train(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_video_train.json"), "w") as f:
        json.dump(detail, f, indent=1)
    return 0


# ---------------------------------------------------------------- phase 10
# rematerialisation (maggie_tpu_torch/models/remat.py): the image and video
# train steps under model.remat none, full and selective
REMAT_MODES = ("none", "full", "selective")
# the kernels' calls of one train forward by stage of remat.py: K1 at rung 1
# (x8, m8, m4, fea3: stage 4), rung 2 (x4, m2, fea2: stage 5) and rung 3
# (x2, m1, fea1: stage 6); K2's uncertainty map in stage 4. A stage that is
# recomputed runs its calls again in the backward; K1's backward runs once.
STAGE_K1 = {1: 0, 2: 0, 3: 0, 4: 4, 5: 3, 6: 3}
STAGE_K2 = {1: 0, 2: 0, 3: 0, 4: 1, 5: 0, 6: 0}
# "full" recomputes the whole forward; "selective" every stage, each in a
# segment of its own (the video model's 3 and 4 as one)
RECOMPUTED = {"none": (), "full": tuple(STAGE_K1), "selective": tuple(STAGE_K1)}
REMAT_FIT_FRACTION = 0.95     # of the card's memory
REMAT_IMAGE_SIZES = (1, TRAIN_BATCH)           # batches at 512x512 for the fit
REMAT_VIDEO_SIZES = (4, VIDEO_TRAIN_CLIP)      # clips at batch 1 for the fit
REMAT_YAML_BATCH = {"image": 12, "video": 4}   # configs/maggie_{image,video}.yaml
REMAT_CLI_ITERS = 3
# steps of each mode at phase 6's (9's) size: ms/step is the median of steps
# 2-3, to keep the whole script within its time limit
REMAT_STEPS = 3
# the precisions whose modes are timed and fitted; bf16 runs the compare steps
# only, their launches checked (its timings: PERF.md, PRs 11-14), to keep the
# script within its limit
REMAT_TIMED = ("fp32",)
# K1's backward lists a call's entries and tiles in one thread block's shared
# memory (ops/kernels/gather.py MAX_SMEM_BYTES): cap + tiles <= 57087; the
# ladder's largest call has 0.5 * 64 entries and 64 tiles a map at 512x512
KERNEL_MAX_MAPS = (232448 // 4 - 1024 - 1) // 96


def remat_per_step(mode: str) -> dict:
    again = RECOMPUTED[mode]
    return {"gather_patches": sum(STAGE_K1.values()) + sum(STAGE_K1[s] for s in again),
            "gather_patches_bwd": 6,
            "compute_unknown": sum(STAGE_K2.values()) + sum(STAGE_K2[s] for s in again)}


def remat_steps(dev, cfg, model, init, batch, mode: str, steps: int) -> dict:
    """``card_steps`` of ``mode`` from the weights ``init``, each step's
    launches checked against ``remat_per_step``."""
    run = card_steps(cfg, batch, dev, f"10 remat {mode}", steps, remat=mode, model=model,
                     init=init)
    if any(c != remat_per_step(mode) for c in run["launches_by_step"]):
        fail(f"remat {mode}: launches by step {run['launches_by_step']} != "
             f"{remat_per_step(mode)}")
    run["launches_per_step"] = remat_per_step(mode)
    return run


def on_thread(fn):
    """``fn()`` on a new thread (its own cuDNN plan cache, as autograd's
    device thread, where a recompute runs); its result or its exception."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as exc:  # re-raised on the caller's thread
            box["exc"] = exc
    t = threading.Thread(target=run)
    t.start()
    t.join()
    if "exc" in box:
        raise box["exc"]
    return box["out"]


# the plain step against itself: run again, and with its forward on a new thread
REMAT_BASELINES = ("none_again", "none_thread")


def remat_compare(dev, cfg, model, init, batch) -> dict:
    """One step of each mode from the same weights, batch and CUDA generator
    seed, held against the plain step within phase 6's STEP_* limits; the
    generator's state after each step equal to the plain step's; with
    ``remat.check_replay``, each recompute's block indices equal the first
    pass's; each step's launches as ``remat_per_step`` says. Beside them,
    the card's own repeatability: a second plain step, and one whose
    forward runs on a new thread, as a recompute's does."""
    from maggie_tpu_torch.models import remat
    steps = {}
    remat.check_replay, remat.replay_checks = True, 0
    try:
        for name, mode in (("none", "none"),) + tuple((b, "none") for b in REMAT_BASELINES) + (
                ("full", "full"), ("selective", "selective")):
            model.load_state_dict(init)
            before, counts = remat.replay_checks, kernel_counts()
            run = lambda: one_step(model, batch, torch.Generator(device=dev).manual_seed(3), cfg,
                                   remat=mode)
            steps[name] = on_thread(run) if name == "none_thread" else run()
            steps[name]["replay_checks"] = remat.replay_checks - before
            steps[name]["launches"] = {k: v - counts[k] for k, v in kernel_counts().items()}
            if steps[name]["launches"] != remat_per_step(mode):
                fail(f"remat {name}: the compare step launched {steps[name]['launches']}, not "
                     f"{remat_per_step(mode)}")
    finally:
        remat.check_replay = False
    model.zero_grad(set_to_none=True)
    ref = steps["none"]
    out = {}
    for name in REMAT_BASELINES + ("full", "selective"):
        r = steps[name]
        c = compare_steps(r, ref)
        c["bit_equal"] = (c["loss_max_rel"] == 0 and c["grad_rel_l2"] == 0
                          and c["param_max_abs"] == 0 and c["batch_stats_max_abs"] == 0
                          and c["spectral_max_abs"] == 0)
        c["generator_equal"] = bool(torch.equal(r["generator"], ref["generator"]))
        c["replay_checks"] = r["replay_checks"]
        c["launches"] = r["launches"]
        out[name] = c
        if not c["within"] or not c["generator_equal"]:
            fail(f"remat {name} step vs the plain step: {c}")
        if name not in REMAT_BASELINES and c["replay_checks"] != 1:
            fail(f"remat {name}: {c['replay_checks']} block-index replays checked, not 1")
    return out


def remat_fit(points) -> dict:
    """peak = fixed + per_frame * frames through two (frames, peak) points."""
    (f1, p1), (f2, p2) = points
    per = (p2 - p1) / (f2 - f1)
    return {"fixed_bytes": p1 - per * f1, "per_frame_bytes": per}


def remat_model(kind: str, precision: str, dev):
    from maggie_tpu_torch.flagship import flagship_cfg
    from maggie_tpu_torch.models import build_model
    cfg = flagship_cfg(precision) if kind == "image" else video_train_cfg(precision)
    model = build_model(cfg.model, device=dev, generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    return cfg, model, init


def remat_batch(kind: str, size: int, dev) -> dict:
    """An image batch of ``size`` frames at 512x512, or a video batch of
    one clip of ``size`` frames; a batch of several clips repeats the clip."""
    from maggie_tpu_torch.flagship import train_batch
    if kind == "image":
        b = train_batch(size, TRAIN_HW, TRAIN_HW, TRAIN_SLOTS, seed=0)
    else:
        b = video_train_batch(size, TRAIN_HW, seed=0)
    return {k: v.to(dev) for k, v in b.items()}


def remat_kind(dev, kind: str, budget: int) -> dict:
    """10.1 (image) or 10.2 (video): per precision, the compare steps; in
    REMAT_TIMED's, the timed modes at phase 6's (9's) size, the fit's
    second size, the fit and the largest batch it predicts (not run: the
    predictions ran at the yamls' batches in earlier runs, PERF.md)."""
    label = "10.1 image" if kind == "image" else "10.2 video"
    sizes = REMAT_IMAGE_SIZES if kind == "image" else REMAT_VIDEO_SIZES
    clip = 1 if kind == "image" else VIDEO_TRAIN_CLIP
    out = {}
    for precision in ("fp32", "bf16"):
        cfg, model, init = remat_model(kind, precision, dev)
        r = out[precision] = {}
        main_batch = remat_batch(kind, sizes[1], dev)
        r["compare"] = remat_compare(dev, cfg, model, init, main_batch)
        for name, c in r["compare"].items():
            worst = max(c["loss_max_rel"], c["grad_rel_l2"], c["param_max_abs"],
                        c["batch_stats_max_abs"], c["spectral_max_abs"])
            print(f"phase {label} {precision}: {name} step vs none: bit-equal {c['bit_equal']}, "
                  f"largest difference {worst:.3g} (loss rel {c['loss_max_rel']:.3g}, grad rel L2 "
                  f"{c['grad_rel_l2']:.3g}, params {c['param_max_abs']:.3g}, BN "
                  f"{c['batch_stats_max_abs']:.3g}, u/v {c['spectral_max_abs']:.3g}); generator "
                  f"equal {c['generator_equal']}; block-index replays checked "
                  f"{c['replay_checks']}; launches {c['launches']}", flush=True)
        if precision not in REMAT_TIMED:
            del model, init, main_batch
            torch.cuda.empty_cache()
            continue
        small_batch = remat_batch(kind, sizes[0], dev)
        r["modes"] = {}
        for mode in REMAT_MODES:
            m = r["modes"][mode] = remat_steps(dev, cfg, model, init, main_batch, mode,
                                               REMAT_STEPS)
            m["small"] = remat_steps(dev, cfg, model, init, small_batch, mode, 2)
            fit = m["fit"] = remat_fit(((sizes[0], m["small"]["peak_mem_bytes"]),
                                        (sizes[1], m["peak_mem_bytes"])))
            max_frames = int((REMAT_FIT_FRACTION * budget - fit["fixed_bytes"])
                             // fit["per_frame_bytes"])
            m["predicted_max_batch_memory"] = max_frames // clip
            m["predicted_max_batch"] = min(max_frames, KERNEL_MAX_MAPS // TRAIN_SLOTS) // clip
            print(f"phase {label} {precision} {mode}: {m['ms_per_step_median']:.3f} ms/step "
                  f"(median of steps 2-{REMAT_STEPS}: {[round(x, 3) for x in m['ms_per_step']]}), "
                  f"peak {m['peak_mem_bytes'] / 1e9:.3f} GB (steps "
                  f"{[round(p / 1e9, 3) for p in m['peak_bytes']]}); size {sizes[0]}: peak "
                  f"{m['small']['peak_mem_bytes'] / 1e9:.3f} GB, "
                  f"{m['small']['ms_per_step'][-1]:.3f} ms; launches per step "
                  f"{m['launches_per_step']}; fit {fit['fixed_bytes'] / 1e9:.3f} GB + "
                  f"{fit['per_frame_bytes'] / 1e9:.4f} GB a frame: largest batch "
                  f"{m['predicted_max_batch_memory']} under {REMAT_FIT_FRACTION:.0%} of "
                  f"{budget / 1e9:.2f} GB, {m['predicted_max_batch']} with K1 backward's "
                  f"limit of {KERNEL_MAX_MAPS} maps"
                  + ("" if kind == "image" else f" (batches of clip {clip})"), flush=True)
        del model, init, main_batch, small_batch
        torch.cuda.empty_cache()
    return out


def remat_cli(detail) -> dict:
    """10.4: ``main.main`` training configs/maggie_image.yaml with ``model.remat
    selective`` on phase 7's synthetic HIM set, REMAT_CLI_ITERS iterations
    without validation: each iteration launches the selective step's counts."""
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        trainer_set(root)
        opts = ["output_dir", os.path.join(root, "out"), "name", "remat",
                "dataset.train.root_dir", root, "dataset.train.split", "train",
                "dataset.test.root_dir", root, "dataset.test.split", "val",
                "train.batch_size", str(TRAIN_BATCH), "train.val_iter", "1000",
                "train.log_iter", "1", "test.log_iter", "1",
                "train.max_iter", str(REMAT_CLI_ITERS), "model.remat", "selective"]
        run = trainer_run(["--config", "configs/maggie_image.yaml"] + opts, {})
        out = check_trainer_run("remat selective", run, os.path.join(root, "out", "remat"),
                                REMAT_CLI_ITERS, 0, files=("train_meters.json", "config.yaml"),
                                per_iter=remat_per_step("selective"))
    detail["remat_cli"] = out
    print(f"phase 10.4: main --config configs/maggie_image.yaml opts model.remat selective: "
          f"{REMAT_CLI_ITERS} iterations, launches {out['launches']} "
          f"({remat_per_step('selective')} an iteration), losses {out['logged_losses']}, peak "
          f"{out['log_max_mem_mb']:.0f} MB", flush=True)
    return out


def phase_remat(dev, detail) -> dict:
    """Phase 10: 10.1 and 10.2 (with 10.3's fits and predictions), 10.4 the
    CLI. Returns each kernel's launches per remat mode and
    model, and the CLI run's.

    The allocator maps memory in expandable segments during the phase, as a
    run at the card's limit would: in fixed segments, a video step at the
    batch its fit predicted ran out of memory on an H100 at 68.3 GiB
    allocated with 5.9 GiB reserved but unallocated.
    The fits predict against the memory this process can hold (free on the
    card plus what its allocator reserves) as the phase starts."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        free, total = torch.cuda.mem_get_info(dev)
        budget = free + torch.cuda.memory_reserved(dev)
        out = {"card_total_bytes": total, "budget_bytes": budget}
        print(f"phase 10: card {total / 1e9:.2f} GB, this process can hold {budget / 1e9:.2f} GB; "
              f"fits against {REMAT_FIT_FRACTION:.0%} of it", flush=True)
        for kind in ("image", "video"):
            out[kind] = remat_kind(dev, kind, budget)
        out["cli"] = remat_cli(detail)
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    detail["remat"] = out
    print(f"phase 10: done in {time.perf_counter() - t0:.1f} s", flush=True)
    launches = {}
    for k in PER_ITER:
        launches[k] = {f"{kind}_{mode}": out[kind]["fp32"]["modes"][mode]["launches"][k]
                       for kind in ("image", "video") for mode in REMAT_MODES[1:]}
        launches[k]["cli_selective"] = out["cli"]["launches"][k]
    return launches


def remat_only(dev) -> int:
    """``--remat``: build the kernels, then phase 10; details to
    output/torch_port/chip_smoke_remat.json."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    detail = {}
    phase_remat(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_remat.json"), "w") as f:
        json.dump(detail, f, indent=1)
    return 0


# ---------------------------------------------------------------- phase 11
# data parallel (maggie_tpu_torch/parallel/): ranks in processes of their own.
# NCCL refuses two ranks on one card, so 11.1 and 11.2 put two gloo ranks on
# cuda:0 (gloo all-reduces CUDA tensors through the host); 11.3 runs the CLI
# under torchrun at world size 1 with NCCL.
DDP_WORLD = 2
DDP_TIMEOUT_S = 400           # a rank's whole run; the group's own timeout is shorter
DDP_GROUP_TIMEOUT_S = 300
DDP_TIMED_STEPS = 3           # steps 2-3 timed (CUDA events) after the checked step
DDP_VIDEO = (3, 512)          # 11.2: one clip of 3 frames a rank (2 frames: dtSSD 0/0)
DDP_CLI_ITERS = 2
# 11.3: the logs print each loss's running mean with 4 decimals; two plain f32
# steps on the card differ by 2.9e-5 in gradient (cuDNN may sum in another
# order; PERF.md §6), so a value may round either way of a last digit: the two
# logs have read 0 and 1e-4 apart on an H100 (PERF.md §6); a wrong loss moves
# by far more
DDP_LOG_ATOL = 2.5e-4


def ddp_selection(record: list, split: int = 1):
    """The ladder's ``select_blocks`` recording, a call at a time, the
    capacity, the active blocks, the kept blocks and their (map, by, bx) in
    the global batch's numbering. With ``split`` > 1 (one process) each of
    ``split`` contiguous parts of the maps selects its own blocks at its
    share of the capacity, as that many ranks do (the per-rank rule, ROADMAP
    "Known differences, by design")."""
    import maggie_tpu_torch.models.decoder_sparse as ds
    from maggie_tpu_torch import parallel
    select = ds.select_blocks

    def recording(mask, block, cap):
        n = mask.shape[0] // split
        if split == 1:
            idx_n, by, bx, valid = select(mask, block, cap)
        else:
            parts = [select(mask[i * n:(i + 1) * n], block, cap // split) for i in range(split)]
            idx_n = torch.cat([q[0] + i * n for i, q in enumerate(parts)])
            by, bx, valid = (torch.cat([q[j] for q in parts]) for j in (1, 2, 3))
        h, w = mask.shape[1] // block, mask.shape[2] // block
        scores = mask[:, :h * block, :w * block].reshape(-1, h, block, w, block).sum((2, 4))
        keep = valid.nonzero()[:, 0]
        blocks = torch.stack([idx_n[keep] + parallel.data_rank() * mask.shape[0], by[keep],
                              bx[keep]], 1)
        record.append({"cap": cap, "active": int((scores > 0).sum()), "kept": int(valid.sum()),
                       "blocks": sorted(map(tuple, blocks.tolist()))})
        return idx_n, by, bx, valid
    return select, recording


def ddp_timed_steps(model, cfg, batch, dev, remat: str) -> dict:
    """DDP_TIMED_STEPS steps of a fresh optimizer, CUDA events around each
    one: the median of steps 2 on, and the peak memory allocated."""
    from maggie_tpu_torch.engine.optim import build_optimizer
    from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
    opt, schedule = build_optimizer(cfg, model.parameters())
    state, step = TrainState(model, opt), make_train_step(model, opt, schedule, remat=remat)
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start_bytes = torch.cuda.memory_allocated()
    ms = []
    for _ in range(DDP_TIMED_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch, gen, **TRAIN_FLAGS)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return {"ms_per_step_median": float(np.median(ms[1:])), "ms_per_step": ms,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(), "start_bytes": start_bytes}


def ddp_steps(model, cfg, batch, dev, modes, split: int = 1, timed: bool = True) -> dict:
    """For each remat mode: one checked ``one_step`` from the same start (the
    kernels' launches counted from 0 around it, the ladder's selections
    recorded, ``ddp_selection``'s ``split``), then ``ddp_timed_steps``."""
    import maggie_tpu_torch.models.decoder_sparse as ds
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    start = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    for mode in modes:
        model.load_state_dict(start)
        torch.cuda.synchronize()
        select, recording = ddp_selection(selections := [], split)
        ds.select_blocks = recording
        kg.launches = kg.bwd_launches = ku.launches = 0
        try:
            res = one_step(model, batch, torch.Generator().manual_seed(3), cfg, remat=mode)
            torch.cuda.synchronize()
        finally:
            ds.select_blocks = select
        res.update(launches=kernel_counts(), selections=selections)
        if timed:
            model.load_state_dict(start)
            res.update(ddp_timed_steps(model, cfg, batch, dev, mode))
        out[mode] = res
    return out


def ddp_rank_main(case: str, in_path: str, out_path: str) -> int:
    """One rank of 11.1-11.2 / 14.3 (``--ddp-rank``): joins the gloo group
    on cuda:0, takes its rows of the global batch and runs ``ddp_steps``
    (for each run of ``runs``, where the payload has several)."""
    from datetime import timedelta
    from maggie_tpu_torch import parallel
    from maggie_tpu_torch.config import ConfigNode
    from maggie_tpu_torch.models import build_model
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    p = torch.load(in_path, weights_only=False)
    dev = parallel.init_from_env(device="cuda:0", backend="gloo",
                                 timeout=timedelta(seconds=DDP_GROUP_TIMEOUT_S))
    try:
        res = []
        for run in p.get("runs", [p]):   # 11.1-11.2, 14.3 and 18 run in one pair
            t0 = time.perf_counter()
            cfg = ConfigNode(run["cfg"])
            model = build_model(cfg.model, device=dev)
            model.load_state_dict(run["state"])
            if run.get("space", 1) > 1:
                res.append(space_rank_run(model, cfg, run, dev))
            else:
                rows = parallel.shard_rows(run["batch"], parallel.rank(), parallel.world())
                res.append(ddp_steps(model, cfg, {k: v.to(dev) for k, v in rows.items()}, dev,
                                     run["modes"], timed=run.get("timed", True)))
                del rows
            res[-1]["seconds"] = time.perf_counter() - t0
            del model
            torch.cuda.empty_cache()
        torch.save(res if "runs" in p else res[0], out_path)
    finally:
        parallel.destroy()
    return 0


def ddp_spawn(case: str, payload: dict, root: str, meanwhile=None) -> list:
    """``case`` in DDP_WORLD processes (``chip_smoke.py --ddp-rank``) with
    torchrun's variables; their results by rank. ``meanwhile()`` runs in
    this process while the ranks do. Any rank's failure or time-out fails
    the script, and every process is ended."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    in_path = os.path.join(root, f"{case}_in.pt")
    torch.save(payload, in_path)
    procs, outs = [], []
    for r in range(DDP_WORLD):
        outs.append(os.path.join(root, f"{case}_rank{r}.pt"))
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(DDP_WORLD), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(DDP_WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--ddp-rank",
                                       case, in_path, outs[-1]], env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    logs = []
    try:
        if meanwhile is not None:
            meanwhile()
        for proc in procs:
            logs.append(proc.communicate(timeout=DDP_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        fail(f"data-parallel case {case!r}: a rank ran past {DDP_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for r, (proc, log) in enumerate(zip(procs, logs)):
        if proc.returncode != 0:
            fail(f"data-parallel case {case!r}: rank {r} exited {proc.returncode}:\n"
                 f"{log[-3000:]}")
    return [torch.load(o, weights_only=False) for o in outs]


def ddp_check(name: str, ranks: list, single: dict, per_step: dict,
              top_cap: dict | None = None) -> dict:
    """The world-2 step (the ranks' loss parts summed) against one process's
    on the global batch within phase 6's STEP_* limits, every rank's model
    equal bit for bit, the launches per rank, the ladder's blocks (the ranks'
    together those of ``single``); the readings and times. ``top_cap``, one
    process selecting the global top-cap blocks where ``single`` selected
    per rank, gives the gap of the per-rank rule (reported)."""
    differ = [f"{part} {k}" for part in ("params", "batch_stats", "spectral", "grads")
              for k, v in ranks[0][part].items() if not torch.equal(v, ranks[1][part][k])]
    if differ:
        fail(f"phase {name}: the ranks' models differ after the step at {differ[:5]}")
    losses = {k: sum(r["losses"][k] for r in ranks) for k in ranks[0]["losses"]}
    check = compare_steps(dict(ranks[0], losses=losses), single)
    if not check["within"]:
        fail(f"phase {name}: world 2 differs from one process beyond the STEP_* limits: "
             f"{check}")
    for r, res in enumerate(ranks):
        if res["launches"] != per_step:
            fail(f"phase {name}: rank {r} launched {res['launches']}, not {per_step}")
    for i, want in enumerate(single["selections"]):
        got = sorted(b for r in ranks for b in r["selections"][i]["blocks"])
        if got != want["blocks"]:
            fail(f"phase {name}: the ranks kept other blocks than one process at the "
                 f"ladder's call {i}")
    check.update(launches_per_rank=[r["launches"] for r in ranks],
                 selections_per_rank=[[{k: v for k, v in sel.items() if k != "blocks"}
                                       for sel in r["selections"]] for r in ranks])
    timed = "ms_per_step_median" in single
    if timed:
        check.update(ms_per_step_world2=[r["ms_per_step_median"] for r in ranks],
                     ms_per_step_one_process=single["ms_per_step_median"],
                     peak_mem_bytes_per_rank=[r["peak_mem_bytes"] for r in ranks],
                     peak_mem_bytes_one_process=single["peak_mem_bytes"])
    overflow = any(sel["active"] > sel["cap"] for r in ranks for sel in r["selections"])
    if top_cap is not None:
        kept = set(top_cap["selections"][0]["blocks"])
        check["top_cap_gap"] = {
            "blocks_differ": len(kept ^ set(single["selections"][0]["blocks"])),
            "blocks_kept": len(kept),
            "loss_rel": {k: abs(losses[k] - v) / max(abs(v), STEP_LOSS_ATOL / STEP_LOSS_RTOL)
                         for k, v in top_cap["losses"].items()}}
    ladder = (f"ladder {'overflows' if overflow else 'fits'} (per rank: "
              f"{check['selections_per_rank'][0][0]})" if single["selections"] else "no ladder")
    times = (f"; ms/step ranks {[round(v, 3) for v in check['ms_per_step_world2']]} vs one "
             f"process {check['ms_per_step_one_process']:.3f}; peak per rank "
             f"{[round(v / 1e9, 3) for v in check['peak_mem_bytes_per_rank']]} GB vs one "
             f"process {check['peak_mem_bytes_one_process'] / 1e9:.3f} GB") if timed else ""
    print(f"phase {name}: world 2 on one card vs one process: loss terms max rel "
          f"{check['loss_max_rel']:.3g}, gradients rel L2 {check['grad_rel_l2']:.3g}, params max "
          f"|d| {check['param_max_abs']:.3g}, BN stats {check['batch_stats_max_abs']:.3g}, SN "
          f"u/v {check['spectral_max_abs']:.3g}; ranks bit-equal; launches per rank "
          f"{check['launches_per_rank'][0]}; {ladder}{times}", flush=True)
    if "top_cap_gap" in check:
        gap = check["top_cap_gap"]
        print(f"  per-rank selection vs the global top-cap (the JAX package's): "
              f"{gap['blocks_differ']} of {2 * gap['blocks_kept']} kept blocks differ, total "
              f"loss {gap['loss_rel']['total']:.3g} relative", flush=True)
    return check


def ddp_logged_losses(path: str) -> dict:
    """{iteration: {loss: value}} of a trainer log."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.search(r"Iter: (\d+)/\d+, (.*?), lr:", line)
            if m:
                out[int(m[1])] = {k: float(v) for k, v in
                                  (kv.split(": ") for kv in m[2].split(", "))}
    return out


def ddp_cli(root: str) -> dict:
    """11.3: ``python -m maggie_tpu_torch.main`` on phase 7's set for
    DDP_CLI_ITERS iterations, as a user runs it (in a process of its own, so
    that both runs take PyTorch's default TF32 settings), and beside it, at
    the same time on the card, the same under ``torchrun --standalone
    --nproc_per_node 1`` (NCCL on cuda:0): the same losses logged at every
    iteration, within DDP_LOG_ATOL."""
    trainer_set(root)
    opts = ["output_dir", os.path.join(root, "out"), "dataset.train.root_dir", root,
            "dataset.train.split", "train", "dataset.test.root_dir", root,
            "dataset.test.split", "val", "train.batch_size", str(TRAIN_BATCH),
            "train.val_iter", "1000", "train.log_iter", "1", "test.log_iter", "1",
            "train.max_iter", str(DDP_CLI_ITERS)]
    cli = ["-m", "maggie_tpu_torch.main", "--config", "configs/maggie_image.yaml"] + opts
    launchers = {"alone": [sys.executable],
                 "torchrun": [sys.executable, "-m", "torch.distributed.run", "--standalone",
                              "--nproc_per_node", "1"]}
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(launcher + cli + ["name", name], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, launcher in launchers.items()}
    wall = {}
    try:
        for name, proc in procs.items():
            try:
                left = max(DDP_TIMEOUT_S - (time.perf_counter() - t0), 1)
                log = proc.communicate(timeout=left)[0]
            except subprocess.TimeoutExpired:
                fail(f"phase 11.3: the {name} run took more than {DDP_TIMEOUT_S} s")
            wall[name] = time.perf_counter() - t0
            if proc.returncode != 0:
                fail(f"phase 11.3: the {name} run exited {proc.returncode}:\n{log[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    logs = {name: ddp_logged_losses(os.path.join(root, "out", name, "log_rank0.log"))
            for name in launchers}
    want = list(range(1, DDP_CLI_ITERS + 1))
    worst = 0.0
    for name, log in logs.items():
        if sorted(log) != want:
            fail(f"phase 11.3: {name} logged iterations {sorted(log)}, not {want}")
    for it in want:
        a, b = logs["alone"][it], logs["torchrun"][it]
        if set(a) != set(b):
            fail(f"phase 11.3: iteration {it} logged {sorted(b)} under torchrun, {sorted(a)} alone")
        worst = max([worst] + [abs(a[k] - b[k]) for k in a])
    if worst > DDP_LOG_ATOL:
        fail(f"phase 11.3: torchrun's logged losses differ from the run without it by {worst}: "
             f"{logs}")
    with open(os.path.join(root, "out", "torchrun", "log_rank0.log")) as f:
        if "rank 0 of 1 on cuda:0, backend nccl" not in f.read():
            fail("phase 11.3: the torchrun run did not log its NCCL group on cuda:0")
    out = {"iterations": DDP_CLI_ITERS, "logged_losses_max_abs_diff": worst,
           "total": {it: (logs["alone"][it]["total"], logs["torchrun"][it]["total"])
                     for it in want},
           "wall_s_concurrent": max(wall.values())}
    print(f"phase 11.3: the trainer under torchrun (world 1, NCCL) logged the losses of the run "
          f"without it at iterations {want} (max |d| {worst:.3g}); the two ran side by side on "
          f"the card, both done after {max(wall.values()):.1f} s (not a launcher's own time)",
          flush=True)
    return out


def ddp_add_launches(launches: dict, ranks: list, modes) -> None:
    for r in ranks:
        for mode in modes:
            for k in launches:
                launches[k] += r[mode]["launches"][k]


def ddp_image_run(modes=("none", "selective")) -> dict:
    """11.1's run for the ranks: phase 6's image step (batch 2 x 512x512, 10
    slots, f32), a row a rank, under each remat mode of ``modes``."""
    from maggie_tpu_torch.flagship import flagship_cfg, train_batch
    from maggie_tpu_torch.models import build_model
    cfg = flagship_cfg()
    state = build_model(cfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(0)).state_dict()
    batch = train_batch(TRAIN_BATCH, TRAIN_HW, TRAIN_HW, TRAIN_SLOTS, seed=0)
    return {"cfg": cfg.to_dict(), "state": state, "batch": batch, "modes": modes}


def ddp_image_check(dev, run: dict, ranks: list) -> tuple[dict, dict]:
    """11.1: the ranks' results of ``run`` against one process on the card on
    the global batch; phase 6's batch overflows the ladder (every slot
    uncertain), so that process selects blocks per rank as the ranks do,
    and once more globally for the rule's gap. Returns the checks by mode
    and the ranks' launches."""
    from maggie_tpu_torch.config import ConfigNode
    from maggie_tpu_torch.models import build_model
    cfg, modes = ConfigNode(run["cfg"]), run["modes"]
    model = build_model(cfg.model, device=dev)
    model.load_state_dict(run["state"])
    on_dev = {k: v.to(dev) for k, v in run["batch"].items()}
    single = ddp_steps(model, cfg, on_dev, dev, modes, split=DDP_WORLD)
    top_cap = ddp_steps(model, cfg, on_dev, dev, ("none",), timed=False)["none"]
    del model, on_dev
    per_step = {mode: PER_ITER if mode == "none" else remat_per_step(mode) for mode in modes}
    out = {mode: ddp_check(f"11.1 image {mode}", [r[mode] for r in ranks], single[mode],
                           per_step[mode], top_cap if mode == "none" else None)
           for mode in modes}
    launches = dict.fromkeys(PER_ITER, 0)
    ddp_add_launches(launches, ranks, modes)
    return out, launches


def ddp_image(dev, root: str, modes=("none", "selective")) -> tuple[dict, dict]:
    """11.1 alone: ``ddp_image_run`` on two gloo ranks on the card, then
    ``ddp_image_check``."""
    run = ddp_image_run(modes)
    return ddp_image_check(dev, run, ddp_spawn("image", run, root))


def ddp_video_run() -> dict:
    """11.2's run for the ranks: the video step (``configs/maggie_video.yaml``,
    f32) on two clips of DDP_VIDEO frames at 512x512, a clip a rank."""
    from maggie_tpu_torch.models import build_model
    cfg = video_train_cfg()
    state = build_model(cfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(0)).state_dict()
    clips = [video_train_batch(*DDP_VIDEO, seed=s) for s in (0, 1)]
    batch = {k: torch.cat([c[k] for c in clips]) for k in clips[0]}
    return {"cfg": cfg.to_dict(), "state": state, "batch": batch, "modes": ("none",)}


def ddp_video_check(dev, run: dict, ranks: list) -> tuple[dict, dict]:
    """11.2: the ranks' results of ``run`` against one process; the ladder
    must fit (3 instances in 10 slots)."""
    from maggie_tpu_torch.config import ConfigNode
    from maggie_tpu_torch.models import build_model
    cfg = ConfigNode(run["cfg"])
    model = build_model(cfg.model, device=dev)
    model.load_state_dict(run["state"])
    single = ddp_steps(model, cfg, {k: v.to(dev) for k, v in run["batch"].items()}, dev,
                       ("none",))
    del model
    out = ddp_check("11.2 video", [r["none"] for r in ranks], single["none"], PER_ITER)
    if any(sel["active"] > sel["cap"] for r in out["selections_per_rank"] for sel in r):
        fail("phase 11.2 video: the ladder overflowed; the clips were meant to fit")
    launches = dict.fromkeys(PER_ITER, 0)
    ddp_add_launches(launches, ranks, ("none",))
    return out, launches


# ---------------------------------------------------------------- phase 18
# Row sharding (maggie_tpu_torch/parallel/space.py): the flagship step at
# full width on one 1024x1024 frame (3 instances in 10 slots, cap 0.5, f32),
# its rows split over a space group of two gloo ranks on the card (1 x 2),
# run in phase 11's rank pair after 11.1-11.2 and 14.3, against one process
# on the whole frame. Each rank runs the bands' dense stages and its
# blocks of the ladder (K1 at 10 sites, its backward at 6, K2 once) and the
# os8 stages on the whole frame.
SPACE_HW = 1024
SPACE_N_INST = 3
SPACE = 2
# 18.2: the video step (configs/maggie_video.yaml at full width, 3 instances
# in 10 slots, f32) on one clip of 3 frames at 512x512, rows split 1 x 2 on
# the same pair, after phase 18, against one process on the whole clip
SPACE_VIDEO = (3, 512)


def space_run() -> dict:
    """Phase 18's run for the ranks: the flagship (seed 0) and its batch."""
    from maggie_tpu_torch.flagship import flagship_cfg, train_batch
    from maggie_tpu_torch.models import build_model
    cfg = flagship_cfg()
    state = build_model(cfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(0)).state_dict()
    batch = train_batch(1, SPACE_HW, SPACE_HW, SPACE_N_INST, seed=0)
    return {"cfg": cfg.to_dict(), "state": state, "batch": batch, "modes": ("none",),
            "space": SPACE}


def space_video_run() -> dict:
    """18.2's run for the ranks: the video yaml's model (seed 0, f32) and one
    clip of SPACE_VIDEO[0] frames at SPACE_VIDEO[1] x SPACE_VIDEO[1]."""
    from maggie_tpu_torch.models import build_model
    cfg = video_train_cfg()
    state = build_model(cfg.model, device="cpu",
                        generator=torch.Generator().manual_seed(0)).state_dict()
    return {"cfg": cfg.to_dict(), "state": state, "batch": video_train_batch(*SPACE_VIDEO),
            "modes": ("none",), "space": SPACE}


@contextlib.contextmanager
def kernel_calls():
    """Records the inputs' geometry of every K1, K1 backward and K2 launch
    (first occurrence of each geometry), indices on the host."""
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    calls = {"gather": {}, "gather_bwd": {}, "unknown": {}}
    fwd, bwd, k2 = kg._forward, kg.gather_patches_bwd, ku._launch

    def rec_fwd(feat, idx_n, idx_by, idx_bx, block, halo):
        layout = "pixel" if feat.is_contiguous() else "plane"
        key = (tuple(feat.shape), layout, str(feat.dtype), block, halo, idx_n.shape[0])
        if key not in calls["gather"]:
            calls["gather"][key] = [t.cpu() for t in (idx_n, idx_by, idx_bx)]
        return fwd(feat, idx_n, idx_by, idx_bx, block, halo)

    def rec_bwd(g, idx_n, idx_by, idx_bx, shape, block, halo, plane=False):
        key = (tuple(shape), "plane" if plane else "pixel", str(g.dtype), block, halo,
               idx_n.shape[0])
        if key not in calls["gather_bwd"]:
            calls["gather_bwd"][key] = [t.cpu() for t in (idx_n, idx_by, idx_bx)]
        return bwd(g, idx_n, idx_by, idx_bx, shape, block, halo, plane)

    def rec_k2(masks, k_size):
        calls["unknown"].setdefault((tuple(masks.shape), k_size), None)
        return k2(masks, k_size)
    kg._forward, kg.gather_patches_bwd, ku._launch = rec_fwd, rec_bwd, rec_k2
    try:
        yield calls
    finally:
        kg._forward, kg.gather_patches_bwd, ku._launch = fwd, bwd, k2


def recorded_kernel_checks(calls: dict, dev, label: str) -> dict:
    """K1, its backward and K2 at every geometry ``kernel_calls`` recorded
    (phase 18: the band-plus-halo maps and the bands' entries; 19: the
    studies' maps) against their plain twins on random inputs of those
    shapes and the recorded entries: equal bits."""
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    out, worst = {"gather": [], "gather_bwd": [], "unknown": []}, {"unknown": 0.0}
    for i, ((shape, layout, dtype, block, halo, cap), idx) in enumerate(calls["gather"].items()):
        idx = [t.to(dev) for t in idx]
        feat = gather_map(shape, layout, getattr(torch, dtype.split(".")[1]), dev, seed=i)
        got = kg.gather_patches(feat, *idx, block, halo)
        ref = kg.gather_patches_plain(feat, *idx, block, halo)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"phase {label}: K1 at {shape} {layout} {dtype} ({block}, {halo}) != its plain "
                 f"twin")
        out["gather"].append({"shape": list(shape), "layout": layout, "dtype": dtype,
                              "block": block, "halo": halo, "cap": cap, "equal": True})
    for i, ((shape, layout, dtype, block, halo, cap), idx) in enumerate(
            calls["gather_bwd"].items()):
        idx = [t.to(dev) for t in idx]
        size = block + 2 * halo
        g = torch.randn((cap, size, size, shape[-1]), generator=torch.Generator().manual_seed(i))
        check_bwd(f"{label}_{block}_{halo}", g.to(dev, getattr(torch, dtype.split(".")[1])), idx,
                  shape, block, halo, layout, out, worst)
    for i, (shape, k) in enumerate(calls["unknown"]):
        a = torch.rand(shape, generator=torch.Generator().manual_seed(i)).to(dev)
        check_unknown(a, k, f"phase {label}", out, worst)
    return out


def space_rank_run(model, cfg, run: dict, dev) -> dict:
    """A rank's phase-18 run: the space group (``space.init_groups``), its
    band of the batch (``space.shard_batch_2d``), ``ddp_steps`` with every
    kernel call's geometry recorded in the checked step, then those
    geometries against the plain twins."""
    from maggie_tpu_torch import parallel
    from maggie_tpu_torch.parallel import space
    space.init_groups(run["space"])
    try:
        rows = space.shard_batch_2d(run["batch"], parallel.rank(), parallel.world(),
                                    run["space"])
        with kernel_calls() as calls:
            res = ddp_steps(model, cfg, {k: v.to(dev) for k, v in rows.items()}, dev,
                            run["modes"])
        res["kernel_checks"] = recorded_kernel_checks(calls, dev, "18")
        return res
    finally:
        space.init_groups(1)


def space_check(dev, run: dict, ranks: list, label: str = "18") -> dict:
    """Phase 18 (18.2 the video step): the ranks' row-sharded step against
    one process on the whole frame on the card within phase 6's STEP_*
    limits (the loss terms' rank parts summed), the ranks bit-equal, each
    rank's selection the one process's, K1 10 / its backward 6 / K2 1
    launched on each rank; their ms/step and peak memory beside the one
    process's."""
    from maggie_tpu_torch.config import ConfigNode
    from maggie_tpu_torch.models import build_model
    cfg = ConfigNode(run["cfg"])
    model = build_model(cfg.model, device=dev)
    model.load_state_dict(run["state"])
    single = ddp_steps(model, cfg, {k: v.to(dev) for k, v in run["batch"].items()}, dev,
                       ("none",))["none"]
    del model
    torch.cuda.empty_cache()
    got = [r["none"] for r in ranks]
    differ = [f"{part} {k}" for part in ("params", "batch_stats", "spectral", "grads")
              for k, v in got[0][part].items() if not torch.equal(v, got[1][part][k])]
    if differ:
        fail(f"phase {label}: the space ranks' models differ after the step at {differ[:5]}")
    losses = {k: sum(r["losses"][k] for r in got) for k in got[0]["losses"]}
    check = compare_steps(dict(got[0], losses=losses), single)
    if not check["within"]:
        fail(f"phase {label}: space {SPACE} differs from one process beyond the STEP_* limits: "
             f"{check}")
    for r, res in enumerate(got):
        if res["selections"] != single["selections"]:
            fail(f"phase {label}: space rank {r} selected other blocks than one process")
        if res["launches"] != PER_ITER:
            fail(f"phase {label}: space rank {r} launched {res['launches']}, not {PER_ITER}")
    checks = ranks[0]["kernel_checks"]
    check.update(
        launches_per_rank=[r["launches"] for r in got],
        launches_one_process=single["launches"],
        selection={k: v for k, v in single["selections"][0].items() if k != "blocks"},
        ms_per_step_ranks=[r["ms_per_step_median"] for r in got],
        ms_per_step_one_process=single["ms_per_step_median"],
        peak_mem_bytes_ranks=[r["peak_mem_bytes"] for r in got],
        peak_above_start_bytes_ranks=[r["peak_mem_bytes"] - r["start_bytes"] for r in got],
        peak_mem_bytes_one_process=single["peak_mem_bytes"],
        peak_above_start_bytes_one_process=single["peak_mem_bytes"] - single["start_bytes"],
        rank_seconds=[r["seconds"] for r in ranks],
        kernel_geometries={k: len(v) for k, v in checks.items()}, kernel_checks=checks)
    ratio = max(check["peak_above_start_bytes_ranks"]) / check["peak_above_start_bytes_one_process"]
    check["peak_ratio"] = ratio
    if ratio >= 1.0:
        fail(f"phase {label}: a space rank's peak ({check['peak_above_start_bytes_ranks']}) is not "
             f"below one process's ({check['peak_above_start_bytes_one_process']})")
    n_f, h, w = run["batch"]["image"].shape[1:4]
    print(f"phase {label}: space {SPACE} ({n_f} frame(s) of {h}x{w} in {TRAIN_SLOTS} slots, "
          f"two gloo ranks on one card) vs one process: loss terms max rel "
          f"{check['loss_max_rel']:.3g}, gradients rel L2 {check['grad_rel_l2']:.3g}, params max "
          f"|d| {check['param_max_abs']:.3g}, BN stats {check['batch_stats_max_abs']:.3g}, SN "
          f"u/v {check['spectral_max_abs']:.3g}; ranks bit-equal, selections equal "
          f"({check['selection']}); launches per rank {check['launches_per_rank'][0]}; "
          f"ms/step ranks {[round(v, 3) for v in check['ms_per_step_ranks']]} vs one process "
          f"{check['ms_per_step_one_process']:.3f}; step peak above start per rank "
          f"{[round(v / 2 ** 30, 3) for v in check['peak_above_start_bytes_ranks']]} GiB vs one "
          f"process {check['peak_above_start_bytes_one_process'] / 2 ** 30:.3f} GiB (ratio "
          f"{ratio:.3f}; absolute peaks {[round(v / 2 ** 30, 3) for v in check['peak_mem_bytes_ranks']]}"
          f" vs {check['peak_mem_bytes_one_process'] / 2 ** 30:.3f} GiB); kernels equal to "
          f"their twins at {check['kernel_geometries']} band geometries", flush=True)
    return check


def space_dryrun_start() -> tuple:
    """``python -m maggie_tpu_torch.dryrun 2`` started on the card (data 2,
    gloo ranks on one card, against one process in its own), as a user
    runs it: a process of its own, which shares no module state with this
    one."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), os.environ.get("PYTHONPATH", "")]))
    return time.perf_counter(), subprocess.Popen(
        [sys.executable, "-m", "maggie_tpu_torch.dryrun", "2"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def space_dryrun_wait(started) -> dict:
    """The dryrun's result: fails the script unless it printed its OK line
    and exited 0 (it raises unless it equals one process)."""
    t0, proc = started
    try:
        log = proc.communicate(timeout=DDP_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"dryrun_multichip(2) ran past {DDP_TIMEOUT_S} s")
    ok = [line for line in log.splitlines() if line.startswith("dryrun_multichip(2) OK")]
    if proc.returncode != 0 or not ok:
        fail(f"dryrun_multichip(2) on the card exited {proc.returncode}:\n{log[-3000:]}")
    print(ok[0], flush=True)
    return {"line": ok[0], "seconds": time.perf_counter() - t0}


def space_dryrun() -> dict:
    return space_dryrun_wait(space_dryrun_start())


def with_space_dryrun(wait):
    """``wait()``'s result, with ``space_dryrun`` on the card beside it
    (``wait`` times nothing); its result after."""
    started = space_dryrun_start()
    try:
        out = wait()
    except BaseException:
        started[1].kill()
        started[1].communicate()
        raise
    return out, space_dryrun_wait(started)


def space_only(dev) -> int:
    """``--space``: build the kernels, then phase 18 (with 18.2) alone in a
    rank pair of its own and ``dryrun_multichip(2)``; details to
    output/torch_port/chip_smoke_space.json."""
    import tempfile
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        run, video = space_run(), space_video_run()
        ranks = ddp_spawn("space", {"runs": [run, video]}, root)
        detail = {"space": space_check(dev, run, [r[0] for r in ranks]),
                  "space_video": space_check(dev, video, [r[1] for r in ranks], "18.2 video")}
    detail["space"]["dryrun"] = space_dryrun()
    detail["space"]["phase_s"] = time.perf_counter() - t0
    print(f"phase 18: done in {detail['space']['phase_s']:.1f} s; dryrun_multichip(2) on the "
          f"card {detail['space']['dryrun']}", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_space.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    return 0


def phase_ddp(dev, detail, ahead=()) -> tuple[dict, dict]:
    """Phase 11 and, in its rank pair, 14.3 and phase 18: one pair of rank
    processes runs 11.1 and 11.2 (``ddp_image_run``, ``ddp_video_run``),
    14.3's configs (``b14_runs``) and phase 18's row-sharded steps
    (``space_run``, 18.2 ``space_video_run``) in turn; then each one's check
    against one process (``ddp_image_check``, ``ddp_video_check``,
    ``space_check`` twice, then, with
    nothing timed after, ``b14_check``), then 11.3 ``ddp_cli`` with the
    specs ``ahead`` computed meanwhile (``cpu_steps_meanwhile``);
    ``dryrun_multichip(2)`` runs on the card beside 14.3's check and 11.3
    (``with_space_dryrun``). Returns each kernel's launches over 11.1-11.2's
    ranks' checked steps, over phase 18's and over 18.2's."""
    import tempfile
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        runs = [ddp_image_run(), ddp_video_run()]
        b14 = b14_runs()
        space, space_video = space_run(), space_video_run()
        ranks = ddp_spawn("train", {"runs": runs + b14 + [space, space_video]}, root)
        out["image"], image = ddp_image_check(dev, runs[0], [r[0] for r in ranks])
        torch.cuda.empty_cache()
        out["video"], video = ddp_video_check(dev, runs[1], [r[1] for r in ranks])
        torch.cuda.empty_cache()
        t18 = time.perf_counter()
        out["space"] = space_check(dev, space, [r[-2] for r in ranks])
        torch.cuda.empty_cache()
        out["space"]["check_s"] = time.perf_counter() - t18
        t18 = time.perf_counter()
        out["space_video"] = space_check(dev, space_video, [r[-1] for r in ranks], "18.2 video")
        torch.cuda.empty_cache()
        out["space_video"]["check_s"] = time.perf_counter() - t18
        # nothing is timed from here on: 18's dryrun runs beside 14.3's
        # check and 11.3's CLI processes
        out["cli"], out["space"]["dryrun"] = with_space_dryrun(lambda: (
            b14_check(dev, b14, [r[2:2 + len(b14)] for r in ranks], out),
            cpu_steps_meanwhile(ahead, lambda: ddp_cli(root)))[1])
    launches = {k: image[k] + video[k] for k in image}
    out["launches"] = launches
    space_launches, video_launches = ({k: sum(r[k] for r in out[name]["launches_per_rank"])
                                       for k in PER_ITER} for name in ("space", "space_video"))
    out["space"]["launches"] = space_launches
    out["space_video"]["launches"] = video_launches
    # phase 18's seconds: its ranks' runs and its checks, 18.2's too (11.3's
    # wall holds its dryrun)
    out["space"]["phase_s"] = sum(max(out[name]["rank_seconds"]) + out[name]["check_s"]
                                  for name in ("space", "space_video"))
    detail["ddp"] = out
    print(f"phase 11: done in {time.perf_counter() - t0:.1f} s (phase 18's "
          f"{out['space']['phase_s']:.1f} s with 18.2 and 14.3's included); launches over the "
          f"ranks' checked steps {launches}; phase 18's {space_launches}, 18.2's "
          f"{video_launches}; dryrun_multichip(2) on the card beside 11.3: "
          f"{out['space']['dryrun']}", flush=True)
    for k, n in launches.items():
        if n == 0:
            fail(f"phase 11: {k} was not launched on the data-parallel path")
    for name, counts in (("18", space_launches), ("18.2 video", video_launches)):
        for k, n in counts.items():
            if n == 0:
                fail(f"phase {name}: {k} was not launched on the row-sharded path")
    return launches, space_launches, video_launches


def ddp_only(dev) -> int:
    """``--ddp``: build the kernels, then phase 11; details to
    output/torch_port/chip_smoke_ddp.json."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    detail = {}
    phase_ddp(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_ddp.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    return 0


# ---------------------------------------------------------------- phase 12
# The MGM baseline family (configs/mgm*.yaml) at full width from seed 0,
# spectral norm folded for eval: the image configs answer BASE_REQUESTS
# frames (576x1024, N_INST blob instances) in f32 and bf16, the video configs
# stream one 576x1024 video of BASE_VIDEO_FRAMES frames through eval_video
# (3-frame windows, overlap 2); then one f32 train step of mgm_stacked and of
# mgm_tcvom each on the card and on the CPU. The family's decoders have no
# fusion of their own: the harness's (MaGGIe.fuse) launches K2 twice a
# forward, k=30 then k=15, and once per instance for the SingInst archs,
# which run one instance at a time; K1 never launches.
BASE_IMAGE = ("mgm", "mgm_stacked")
BASE_VIDEO = ("mgm_tcvom", "mgm_stacked_tcvom")
BASE_SINGLE = ("mgm", "mgm_tcvom")           # arch MGM_SingInst / TCVOM_SingInst
BASE_REQUESTS = 2
BASE_VIDEO_FRAMES = 4                         # 2 windows of 3 frames
BASE_TIMING_REPS = 2
# (config, batch, clip, size): the yamls' crops and clip, a smaller batch
BASE_TRAIN = (("mgm_stacked", 2, 1, 512), ("mgm_tcvom", 1, 8, 512))
# 12.3's card-vs-CPU step at the timed size, as (batch, clip) at most:
# mgm_tcvom's clip cut to 3 (the CPU step of its clip of 8 took 42.1 s at
# 512x512 on the H100's host), mgm_stacked's batch to 1 (17.2 s at batch 2)
BASE_CHECK = {"mgm_stacked": (1, 1), "mgm_tcvom": (1, 3)}
BASE_TRAIN_STEPS = 3
# the card-vs-CPU rule of phase 3 on the family's outputs: the alphas within
# REFINED_ATOL, except where a discrete threshold may have flipped between the
# two: the pixels within the k=30 band's reach (width 15) of an os8 or os4
# alpha within NEAR of K2's thresholds, and for TCVOM within BASE_BAND_REACH
# of a first-pass os1 alpha within NEAR of the FAM band's 0.01 and 0.99 (its
# 15x15 max pool, one os8 site, and the decoder's receptive field after it)
BASE_BAND_REACH = 63
# bf16 vs f32 refined_masks of the family and of the dense ablation, same
# weights and frame (deterministic). The highest mean reading was the dense
# ablation's 3.0e-4 (PR 14), so the mean may grow to 1e-3 (3.3x). Pixels off
# by more than BF16_FAR are where a bf16 alpha crossed K2's thresholds and a
# fusion band moved, so the fused alpha took another head's value: 0 for the
# family, 2.66e-4 of the ablation's pixels (471 of 1,769,472), so their share
# may grow to 1e-3 (3.8x).
BASE_BF16_MEAN_ATOL = 1e-3
BASE_BF16_FAR_SHARE = 1e-3
BASE_KEYS = ("alpha_os1", "alpha_os4", "alpha_os8", "refined_masks")


def base_cfg(name: str, precision: str = "fp32"):
    from maggie_tpu_torch.config import load_config
    cfg = load_config(os.path.join("configs", f"{name}.yaml"))
    cfg.model.precision = precision
    return cfg


def base_eval_models(name, dev, bf16: bool = False):
    """The model of config ``name`` (or of ``name(precision)``, a function
    giving the config) from seed 0, SN folded where it has any: on the CPU,
    its copy on ``dev`` in f32, and (``bf16``) on ``dev`` in bf16 with the
    same weights."""
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.utils.checkpoint import fold_spectral_norm
    cfg = name if callable(name) else lambda p="fp32": base_cfg(name, p)
    cpu = build_model(cfg().model, device="cpu", generator=torch.Generator().manual_seed(0))
    fold_spectral_norm(cpu)
    out = [cpu, copy.deepcopy(cpu).to(dev)]
    if bf16:
        out.append(bf16_copy(cpu).to(dev))
    return out


class K2Spy:
    """Counts and keeps (a copy of) what K2 gets on the harness's fusion
    (``models.maggie.compute_unknown``) and the dense ablation decoder's
    ``detail_mask`` (``models.decoder_inst_dense.compute_unknown``), the
    first ``keep`` calls, and each first-pass os1 alpha that draws TCVOM's
    band; the calls go on to the real functions."""

    def __init__(self, keep: int = 2):
        self.keep, self.k2, self.band = keep, [], []

    def __enter__(self):
        import maggie_tpu_torch.models.decoder_inst_dense as di
        import maggie_tpu_torch.models.maggie as mg
        from maggie_tpu_torch.models.tcvom import TCVOM
        self.modules, self.tcvom = (mg, di), TCVOM
        self.unknown, self.dilate = mg.compute_unknown, TCVOM.dilate

        def unknown(a, k):
            if len(self.k2) < self.keep:
                self.k2.append((a.detach().clone(), k))
            return self.unknown(a, k)

        def dilate(a):
            self.band.append(a.detach().clone())
            return self.dilate(a)
        for m in self.modules:
            m.compute_unknown = unknown
        TCVOM.dilate = staticmethod(dilate)
        return self

    def __exit__(self, *exc):
        for m in self.modules:
            m.compute_unknown = self.unknown
        self.tcvom.dilate = staticmethod(self.dilate)


def base_cpu_check(card_out: dict, cpu_out: dict, bands=(), label: str = "12") -> dict:
    """Phase 3's rule on one frame or window of the family (see
    BASE_BAND_REACH); ``bands`` the CPU run's first-pass os1 alphas. Where
    the outputs hold ``detail_mask`` (the dense ablation), it must be equal
    but where an os8 alpha within 1e-4 of K2's thresholds explains a flip."""
    from maggie_tpu_torch.ops.morphology import LOWER_THRES, UPPER_THRES, dilate_ellipse
    near = lambda a, lo, hi: ((a - lo).abs() < NEAR) | ((a - hi).abs() < NEAR)
    a8, a4 = cpu_out["alpha_os8"], cpu_out["alpha_os4"]
    k2_near = near(a8, LOWER_THRES, UPPER_THRES) | near(a4, LOWER_THRES, UPPER_THRES)
    allowed = dilate_ellipse(k2_near.float(), 15) > 0
    band_near = 0
    for a1 in bands:                                   # (b*n_f, slots, H, W)
        m = near(a1, 0.01, 0.99).amax(dim=1)           # any slot
        band_near += int(m.sum())
        if bool(m.any()):
            reach = torch.nn.functional.max_pool2d(m[:, None].float(), 2 * BASE_BAND_REACH + 1,
                                                   1, BASE_BAND_REACH)[:, 0] > 0
            allowed = allowed | reach.reshape((1, -1, 1) + reach.shape[-2:])
    out = {"k2_near_threshold_pixels": int(k2_near.sum()), "band_near_threshold_pixels": band_near}
    if "detail_mask" in cpu_out:
        n_near, n_diff, unexplained, _ = detail_mask_check(card_out, cpu_out)
        out["detail_mask"] = {"near_threshold_pixels": n_near, "diff": n_diff,
                              "unexplained_diff": unexplained}
        if unexplained:
            fail(f"phase {label}: detail_mask differs from the CPU port's at {unexplained} "
                 f"pixels no near-threshold os8 alpha explains ({out})")
    for k in BASE_KEYS:
        err = (card_out[k].float().cpu() - cpu_out[k]).abs()
        outside = err[~allowed.expand_as(err)]
        out[k] = {"max_abs_err": float(err.max()), "mean_abs_err": float(err.mean()),
                  "max_abs_err_outside_flips": float(outside.max()) if outside.numel() else 0.0}
        if out[k]["max_abs_err_outside_flips"] > REFINED_ATOL:
            fail(f"phase {label}: {k} differs from the CPU port by "
                 f"{out[k]['max_abs_err_outside_flips']} > {REFINED_ATOL} outside the pixels "
                 f"that near-threshold values explain ({out})")
    return out


def base_check_outputs(label: str, outs: list, shape: tuple, keys=BASE_KEYS) -> None:
    for i, o in enumerate(outs):
        if sorted(o) != sorted(keys):
            fail(f"phase {label}: output {i} has keys {sorted(o)}, want {sorted(keys)}")
        for k, v in o.items():
            if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
                fail(f"phase {label}: output {i} {k} has shape {tuple(v.shape)} (want "
                     f"{shape}) or non-finite values")
        r = o["refined_masks"]
        if float(r.min()) < 0 or float(r.max()) > 1:
            fail(f"phase {label}: refined_masks outside [0, 1]")


def base_k2_twins(spy: K2Spy, label: str, out: dict, worst: dict) -> None:
    """K2 at the shapes this config gave it, against its plain twin."""
    for a, k in spy.k2:
        check_unknown(a, k, f"{label} {tuple(a.shape)}", out, worst)


def time_forward(models, batch: dict, iters: int) -> tuple[dict, dict]:
    """Each (precision, model)'s ms a frame on ``batch``: BASE_TIMING_REPS
    times ``iters`` forwards between CUDA events (2 warm-ups before the
    first, 1 before the others), and its peak memory over one more forward,
    whose output it returns."""
    timing, outs = {}, {}
    with torch.inference_mode():
        for prec, m in models:
            reps = [cuda_ms(lambda: m(batch), iters=iters, warmup=2 if not i else 1)
                    for i in range(BASE_TIMING_REPS)]
            torch.cuda.reset_peak_memory_stats()
            outs[prec] = m(batch)
            timing[prec] = {"ms_per_frame_median": float(np.median(reps)), "reps_ms": reps,
                            "peak_mem_bytes": torch.cuda.max_memory_allocated()}
    return timing, outs


def fusion_bands(out: dict) -> tuple:
    """The eval fusion's k=30 and k=15 bands (``maggie.prm_fuse``) redrawn
    from ``out``'s os8 and os4 alphas by K2's plain twin (no launch)."""
    from maggie_tpu_torch.ops.kernels.unknown import compute_unknown_plain
    a8, a4 = out["alpha_os8"].float(), out["alpha_os4"].float()
    w4 = compute_unknown_plain(a8, 30)
    return w4, compute_unknown_plain(torch.where(w4 > 0, a4, a8), 15)


def bf16_drift(bf: dict, f32: dict, label: str) -> dict:
    """bf16 against f32 refined_masks, held to BASE_BF16_*; and the share of
    the pixels off by more than BF16_FAR where a fusion band differs
    between the two."""
    d = (bf["refined_masks"].float() - f32["refined_masks"]).abs()
    far = d > BF16_FAR
    out = {"mean_abs": float(d.mean()), "max_abs": float(d.max()),
           "far_share": float(far.float().mean())}
    if bool(far.any()):
        moved = [x != y for x, y in zip(fusion_bands(bf), fusion_bands(f32))]
        out["far_in_moved_bands"] = float((far & (moved[0] | moved[1])).sum()) / float(far.sum())
    if out["mean_abs"] > BASE_BF16_MEAN_ATOL or out["far_share"] > BASE_BF16_FAR_SHARE:
        fail(f"phase {label}: bf16 refined_masks drift {out}: limits mean "
             f"{BASE_BF16_MEAN_ATOL}, share above {BF16_FAR} {BASE_BF16_FAR_SHARE}")
    return out


def base_image(name: str, dev, checks: dict, worst: dict, cfg=None, k2_per_forward: int = 2,
               keys=BASE_KEYS, label: str = "12") -> dict:
    """12.1 (and 13.4): ``name`` (its config, or ``cfg(precision)``) answers
    BASE_REQUESTS frames in f32 with K2 launched ``k2_per_forward`` times a
    forward, the first forward's calls against K2's twin; one frame against
    the CPU port; ms/frame f32 and bf16, bf16 vs f32 (``bf16_drift``),
    peak memory."""
    from maggie_tpu_torch.flagship import blob_batch
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    label = f"{label} {name}"
    cpu, model, half = base_eval_models(cfg or name, dev, bf16=True)
    requests = [{k: v.to(dev) for k, v in blob_batch(H, W, N_INST, seed).items()}
                for seed in range(BASE_REQUESTS)]
    forwards = BASE_REQUESTS * (N_INST if name in BASE_SINGLE else 1)
    torch.cuda.synchronize()
    with K2Spy(keep=k2_per_forward) as spy, torch.inference_mode():
        kg.launches = ku.launches = 0
        outs = [model(r) for r in requests]
        torch.cuda.synchronize()
        launches = {"gather_patches": kg.launches, "compute_unknown": ku.launches}
    want = {"gather_patches": 0, "compute_unknown": k2_per_forward * forwards}
    if launches != want:
        fail(f"phase {label}: launches {launches} != {want} over {BASE_REQUESTS} frames")
    base_check_outputs(label, outs, (1, 1, N_INST, H, W), keys)
    base_k2_twins(spy, name, checks, worst)
    with torch.inference_mode():
        cpu_out = cpu(blob_batch(H, W, N_INST, 0))
    check = base_cpu_check(outs[0], cpu_out, label=label)
    timing, timed = time_forward((("fp32", model), ("bf16", half)), requests[0], iters=5)
    base_check_outputs(f"{label} bf16", [timed["bf16"]], (1, 1, N_INST, H, W), keys)
    timing["bf16_vs_fp32"] = bf16_drift(timed["bf16"], outs[0], label)
    print(f"phase {label}: {BASE_REQUESTS} frames ({H}x{W}, {N_INST} instances), launches "
          f"{launches}; CPU check {check['refined_masks']} (near K2's thresholds "
          f"{check['k2_near_threshold_pixels']} px{'; detail_mask ' if 'detail_mask' in check else ''}"
          f"{check.get('detail_mask', '')}); f32 "
          f"{timing['fp32']['ms_per_frame_median']:.3f} ms/frame, peak "
          f"{timing['fp32']['peak_mem_bytes'] / 1e9:.3f} GB; bf16 "
          f"{timing['bf16']['ms_per_frame_median']:.3f} ms/frame, peak "
          f"{timing['bf16']['peak_mem_bytes'] / 1e9:.3f} GB; bf16 vs f32 "
          f"{timing['bf16_vs_fp32']}", flush=True)
    return {"launches": launches, "forwards": forwards, "cpu_check": check, "timing": timing}


def base_video(name: str, dev, root: str, checks: dict, worst: dict) -> dict:
    """12.2: ``eval_video`` streams the set's video through ``name`` (the
    whole forward on every window: TCVOM does not split); launches, metrics,
    window 0 against the CPU port, ms/window, peak memory."""
    from maggie_tpu_torch.data import build_dataset
    from maggie_tpu_torch.data.loader import DataLoader
    from maggie_tpu_torch.engine.test import eval_video
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    from maggie_tpu_torch.utils.metrics import build_metric
    cfg = base_cfg(name)
    cfg.dataset.test.root_dir, cfg.dataset.test.split = root, "chip"
    loader = DataLoader(build_dataset(cfg, is_train=False, device=dev), batch_size=1)
    cpu, model = base_eval_models(name, dev)
    windows = BASE_VIDEO_FRAMES - VIDEO_FRAMES + 1
    forwards = windows * (N_INST if name in BASE_SINGLE else 1)
    metrics = build_metric(["MAD", "MSE", "SAD", "dtSSD"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with K2Spy() as spy:
        kg.launches = ku.launches = 0
        t0 = time.perf_counter()
        batch_s, data_s, host_s = eval_video(model, loader, 100, metrics)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"gather_patches": kg.launches, "compute_unknown": ku.launches}
    peak = torch.cuda.max_memory_allocated()
    want = {"gather_patches": 0, "compute_unknown": 2 * forwards}
    if launches != want:
        fail(f"phase 12 {name}: eval_video launches {launches} != {want} over {windows} windows")
    values = {k: v.average() for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in values.values()):
        fail(f"phase 12 {name}: non-finite metrics {values}")
    base_k2_twins(spy, name, checks, worst)
    win = {k: torch.as_tensor(v)[:, :VIDEO_FRAMES].to(dev)
           for k, v in next(iter(loader)).items() if k in ("image", "mask")}
    with torch.inference_mode():
        card_out = model(win)
    with K2Spy() as cpu_spy, torch.inference_mode():
        cpu_out = cpu({k: v.cpu() for k, v in win.items()})
    base_check_outputs(f"12 {name}", [card_out],
                       (1, VIDEO_FRAMES) + tuple(win["mask"].shape[2:3]) + (H, W))
    check = base_cpu_check(card_out, cpu_out, cpu_spy.band)
    timed = base_window_times(model, win)
    reps = timed["frame_at_a_time"]
    out = {"launches": launches, "forwards": forwards, "windows": windows, "metrics": values,
           "cpu_check": check, "ms_per_window_median": float(np.median(reps)), "reps_ms": reps,
           "batched_encoder_ms_per_window_median": float(np.median(timed["batched"])),
           "batched_encoder_reps_ms": timed["batched"],
           "engine": {"batch_time_s": batch_s, "data_time_s": data_s, "host_time_s": host_s,
                      "wall_s": wall}, "peak_mem_bytes": peak}
    print(f"phase 12 {name}: eval_video over {BASE_VIDEO_FRAMES} frames ({windows} windows of "
          f"{VIDEO_FRAMES}, {H}x{W}, {win['mask'].shape[2]} instances), launches {launches}; "
          f"metrics {values}; CPU check window 0 {check['refined_masks']} (near thresholds: "
          f"K2 {check['k2_near_threshold_pixels']} px, band "
          f"{check['band_near_threshold_pixels']} px); {out['ms_per_window_median']:.3f} "
          f"ms/window (the window's frames encoded at once: "
          f"{out['batched_encoder_ms_per_window_median']:.3f}), engine {wall:.2f} s, peak "
          f"{peak / 1e9:.3f} GB", flush=True)
    return out


def base_window_times(model, win: dict) -> dict:
    """ms per window of TCVOM's eval forward as it runs (the encoder a frame
    at a time, ``TCVOM._encoded``) and with the window's frames encoded in
    one batch, as the JAX package does, in turns (one, batched, batched,
    one, ...): BASE_TIMING_REPS of each."""
    from maggie_tpu_torch.models.tcvom import TCVOM
    per_frame = TCVOM._encoded

    def batched(self, inp):
        out, mid_fea = self.encoder(inp)
        return self.aspp(out), mid_fea["shortcut"]
    times = {"frame_at_a_time": [], "batched": []}
    order = ["frame_at_a_time", "batched", "batched", "frame_at_a_time"]
    with torch.inference_mode():
        for i in range(2 * BASE_TIMING_REPS):
            kind = order[i % 4]
            TCVOM._encoded = per_frame if kind == "frame_at_a_time" else batched
            try:
                times[kind].append(cuda_ms(lambda: model(win), iters=3, warmup=1))
            finally:
                TCVOM._encoded = per_frame
    return times


def base_train_batch(b: int, n_f: int, hw: int, slots: int, seed: int = 0) -> dict:
    """Moving soft discs in min(N_INST, slots) of ``slots`` slots; masks the
    alphas above 0.5, transitions their edges; uniform frames."""
    n_i = min(N_INST, slots)
    alpha = np.zeros((b, n_f, slots, hw, hw), np.float32)
    for i in range(b):
        alpha[i, :, :n_i] = video_alphas(n_f, hw, hw, n_i=n_i, seed=seed + i)[0]
    rs = np.random.RandomState(seed + 100)
    batch = {"image": rs.rand(b, n_f, hw, hw, 3).astype(np.float32),
             "mask": (alpha > 0.5).astype(np.float32), "alpha": alpha,
             "transition": ((alpha > 0) & (alpha < 1)).astype(np.float32)}
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def card_steps(cfg, batch: dict, dev, label: str, steps: int = BASE_TRAIN_STEPS,
               remat: str = "none", model=None, init=None, first: bool = False) -> dict:
    """``steps`` f32 steps of ``cfg``'s model under ``remat`` on the card on
    ``batch``, with a fresh optimizer and a card generator of seed 0 (the
    fusions' random widths): ms a step (CUDA events; the median of the
    steps after the first), the losses (which must be finite), the peak
    memory of each step and of all, each kernel's launches a step (the
    counts set to 0 first) and over all. ``model`` is loaded with ``init``
    where given, else built from seed 0; with ``first``, the first step as
    ``step_record`` gives it."""
    from maggie_tpu_torch.engine.optim import build_optimizer
    from maggie_tpu_torch.engine.train_step import TrainState, make_train_step
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    if model is None:
        model = build_model(cfg.model, device=dev, generator=torch.Generator().manual_seed(0))
    else:
        model.load_state_dict(init)
    model.train().zero_grad(set_to_none=True)
    opt, schedule = build_optimizer(cfg, model.parameters())
    state, step = TrainState(model, opt), make_train_step(model, opt, schedule, remat=remat)
    gen = torch.Generator(device=dev).manual_seed(0)
    dbatch = {k: v.to(dev) for k, v in batch.items()}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kg.launches = kg.bwd_launches = ku.launches = 0
    ms, losses, peaks, launches, record = [], [], [], [], None
    for i in range(steps):
        before = kernel_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with clip_inputs() if first and i == 0 else contextlib.nullcontext() as grads:
            start.record()
            ld = step(state, dbatch, gen, **TRAIN_FLAGS)
            end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        launches.append({k: v - before[k] for k, v in kernel_counts().items()})
        losses.append({k: float(v) for k, v in ld.items()})
        if grads is not None:
            record = step_record(model, state, ld, grads, schedule, gen)
    model.zero_grad(set_to_none=True)
    del opt, state, step, dbatch
    if not all(np.isfinite(v) for ld in losses for v in ld.values()):
        fail(f"phase {label}: non-finite losses {losses}")
    return {"losses": losses, "ms_per_step_median": float(np.median(ms[1:] or ms)),
            "ms_per_step": ms, "peak_bytes": peaks, "peak_mem_bytes": max(peaks),
            "launches_by_step": launches, "first": record,
            "launches": {k: sum(c[k] for c in launches) for k in launches[0]}}


def base_check_step(name: str, b: int, n_f: int, hw: int, check: tuple | None = None) -> tuple:
    """The ``cpu_step`` spec of 12.3's step of ``name`` at ``hw`` with at most
    ``check`` = (batch, clip) of (``b``, ``n_f``)."""
    check_b, check_f = min(b, (check or (b, n_f))[0]), min(n_f, (check or (b, n_f))[1])

    def inputs():
        cfg = base_cfg(name)
        return cfg, base_train_batch(check_b, check_f, hw, int(cfg.model.encoder_args.num_mask))
    return ("base", name, check_b, check_f, hw), inputs, 3


def base_train(name: str, b: int, n_f: int, hw: int, dev, check: tuple | None = None) -> dict:
    """12.3: one f32 step of ``name`` on the card against the CPU port at
    ``hw`` with at most ``check`` = (batch, clip) (the random widths
    from CPU generators of one seed on both sides) within phase 6's STEP_*
    limits, then BASE_TRAIN_STEPS steps on the card at the whole clip
    (``card_steps``): ms/step, peak memory, launches."""
    cfg = base_cfg(name)
    slots = int(cfg.model.encoder_args.num_mask)
    batch = base_train_batch(b, n_f, hw, slots)
    spec = base_check_step(name, b, n_f, hw, check)
    check_b, check_f = spec[0][2:4]
    check = card_step(spec, dev)
    cpu_s, losses_card = check.pop("cpu_step_s"), check.pop("losses_card")
    del check["losses_cpu"]
    if not check["within"]:
        fail(f"phase 12 {name}: the card's step differs from the CPU port's beyond phase 6's "
             f"STEP_* limits: {check}")
    out = card_steps(cfg, batch, dev, f"12 {name}")
    launches = out["launches"]
    if any(launches.values()):
        fail(f"phase 12 {name}: the train step launched {launches}; the family's train "
             f"fusion dilates with random widths in plain torch")
    out.update(size=f"batch {b} x clip {n_f} x {hw}x{hw}, {slots} slots", check=check,
               cpu_step_s=cpu_s, losses_card=losses_card)
    out["check_size"] = f"batch {check_b} x clip {check_f} x {hw}x{hw}"
    print(f"phase 12 {name} train ({out['size']}, f32): card vs CPU (at "
          f"{out['check_size']}) loss terms max rel "
          f"{check['loss_max_rel']:.3g}, gradients rel L2 {check['grad_rel_l2']:.3g}, params max "
          f"|d| {check['param_max_abs']:.3g}, BN stats {check['batch_stats_max_abs']:.3g}, SN u/v "
          f"{check['spectral_max_abs']:.3g} (CPU step {cpu_s:.1f} s); "
          f"{out['ms_per_step_median']:.3f} ms/step, peak {out['peak_mem_bytes'] / 1e9:.3f} GB, "
          f"launches {launches}", flush=True)
    return out


def phase_baselines(dev, detail) -> dict:
    """Phase 12: 12.1 ``base_image`` per image config, 12.2 ``base_video`` per
    video config, 12.3 ``base_train``; K2 held against its twin at each
    config's shapes. Returns each kernel's launches over the counted runs."""
    import tempfile
    t0 = time.perf_counter()
    checks, worst = {"unknown": []}, {"unknown": 0.0}
    out = {}
    for name in BASE_IMAGE:
        out[name] = base_image(name, dev, checks, worst)
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        video_set(root, (("vid0", BASE_VIDEO_FRAMES),))
        for name in BASE_VIDEO:
            out[name] = base_video(name, dev, root, checks, worst)
            torch.cuda.empty_cache()
    out["train"] = {}
    for name, b, n_f, hw in BASE_TRAIN:
        out["train"][name] = base_train(name, b, n_f, hw, dev, BASE_CHECK.get(name))
        torch.cuda.empty_cache()
    launches = {k: sum(out[n]["launches"][k] for n in BASE_IMAGE + BASE_VIDEO)
                for k in ("gather_patches", "compute_unknown")}
    out.update(launches=launches, kernel_checks=checks, k2_max_abs_err=worst["unknown"],
               phase_s=time.perf_counter() - t0)
    detail["baselines"] = out
    print(f"phase 12: K2 equal to its plain twin at the family's {len(checks['unknown'])} "
          f"shapes; launches {launches}; done in {out['phase_s']:.1f} s", flush=True)
    if launches["compute_unknown"] == 0:
        fail("phase 12: compute_unknown was not launched on the baselines' path")
    return out


def baselines_only(dev) -> int:
    """``--baselines``: build the kernels, then phase 12; details to
    output/torch_port/chip_smoke_baselines.json."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    detail = {}
    phase_baselines(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_baselines.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    return 0


# ---- phase 13: SparseMat and the dense InstMatt ablation decoder ----
SM_IMAGE, SM_VIDEO = "sparsemat_image", "sparsemat_video"
SM_REQUESTS = 2
SM_VIDEO_FRAMES = 4                       # 2 windows of 3 frames
# (config, batch, clip, size) of the card-vs-CPU step: at 256x256 the LPN's
# last stages see 4x4 sites a frame (at 128x128, 2x2, and its f32 step is
# ill-conditioned: tests/test_torch_sparsemat.py)
SM_CHECK_STEPS = ((SM_IMAGE, 2, 1, 256), (SM_VIDEO, 1, 3, 256))
# eval scales the LPN's last head (lpn.decoder.p0x) by SM_HEAD_SCALE on the
# card and the CPU alike, as tests/test_torch_sparsemat.py does: at seed 0 the
# random LPN leaves every pixel uncertain, and the SHM's masked path (active
# set, strided and inverse convs) would run as a dense one. At 32 the CPU
# port leaves 0.31 of a blob frame uncertain and 0.68 active (seed 0); each
# eval forward's active share must lie in SM_ACTIVE_RANGE
SM_HEAD_SCALE = 32.0
SM_ACTIVE_RANGE = (0.1, 0.99)
# the card and the CPU port draw other active sets (or ``shared`` maps) only
# where a low-resolution alpha (or a frame difference) rounds across a
# threshold. Their outputs may then differ within the SHM's receptive field
# of a pixel whose active set differs (a one-pixel change of the active set
# reached 125 pixels on the CPU port), at a pixel whose ``shared`` differs,
# and, through the streaming fusion, there in the frames after; the rest of
# the output, at least SM_MIN_HELD of it, is held to REFINED_ATOL
SM_SHM_REACH = 128
SM_MIN_HELD = 0.5
DENSE_DECODER = "res_shortcut_inst_matt_22"
DENSE_KEYS = BASE_KEYS + ("detail_mask",)


def sm_cfg(name: str, precision: str = "fp32"):
    cfg = base_cfg(name, precision)
    cfg.dataset.train.max_inst = 1
    return cfg


def sm_eval_models(name: str, dev) -> tuple:
    """``name``'s model from seed 0 with its LPN's last head scaled by
    SM_HEAD_SCALE: on the CPU, and its copy on ``dev``."""
    cpu = base_eval_models(lambda p="fp32": sm_cfg(name, p), dev)[0]
    with torch.no_grad():
        cpu.lpn.decoder.p0x.conv.weight.mul_(SM_HEAD_SCALE)
    return cpu, copy.deepcopy(cpu).to(dev)


def dense_cfg(precision: str = "fp32"):
    """``configs/maggie_image.yaml`` with the dense InstMatt decoder and the
    128-channel os8 features its reference's ``layer3`` takes."""
    cfg = base_cfg("maggie_image", precision)
    cfg.model.decoder = DENSE_DECODER
    cfg.model.decoder_args.final_channel = 128
    return cfg


class SparsityRecord:
    """What SparseMat's thresholds drew on a run: each SHM call's active set
    and each ``shared`` map (copied to the host while ``keep`` is set) and
    their shares."""

    def __init__(self, keep: bool = False):
        self.keep, self.masks, self.active, self.shared, self.shared_share = keep, [], [], [], []

    def __enter__(self):
        from maggie_tpu_torch.models import sparsemat as sm
        self.sm, self.orig = sm, (sm.SparseMat._run_shm, sm.SparseMat.generate_sparsity_map)
        rec = self

        def run_shm(model, img, lr_pred, mask, ctx):
            if rec.keep:
                rec.masks.append(mask.detach().cpu())
            rec.active.append(float(mask.mean()))
            return rec.orig[0](model, img, lr_pred, mask, ctx)

        def sparsity(model, lr_pred, curr, last):
            out = rec.orig[1](model, lr_pred, curr, last)
            if rec.keep:
                rec.shared.append(out[3].detach().cpu())
            rec.shared_share.append(float(out[3].mean()))
            return out
        sm.SparseMat._run_shm, sm.SparseMat.generate_sparsity_map = run_shm, sparsity
        return self

    def __exit__(self, *exc):
        self.sm.SparseMat._run_shm, self.sm.SparseMat.generate_sparsity_map = self.orig


def sm_check_active(label: str, active: list) -> None:
    lo, hi = SM_ACTIVE_RANGE
    if not all(lo < a < hi for a in active):
        fail(f"phase {label}: active shares {active} outside {SM_ACTIVE_RANGE}: the SHM's "
             f"masked path would not be exercised")


def sm_cpu_check(card_out: dict, cpu_out: dict, card: SparsityRecord, cpu: SparsityRecord,
                 label: str) -> dict:
    """The card's refined_masks (1, n_f, n_i, H, W) against the CPU port's
    within REFINED_ATOL, but where the two runs' active sets or ``shared``
    maps differ (see SM_SHM_REACH); the records kept one forward an instance,
    masks (n_f, 1, H, W) and shared maps (n_f - 1, 1, H, W)."""
    if len(card.masks) != len(cpu.masks) or len(card.shared) != len(cpu.shared):
        fail(f"phase {label}: the card ran {len(card.masks)} SHM calls, the CPU port "
             f"{len(cpu.masks)}")
    pool = torch.nn.functional.max_pool2d
    k, r = 2 * SM_SHM_REACH + 1, SM_SHM_REACH
    allowed, mask_diff, shared_diff = [], 0, 0
    for i, (mc, mp) in enumerate(zip(card.masks, cpu.masks)):
        d = (mc != mp).float()
        mask_diff += int(d.sum())
        # the square max pool as two 1-D ones: k x k windows take minutes on the host
        a = pool(pool(d, (k, 1), 1, (r, 0)), (1, k), 1, (0, r)) > 0
        if cpu.shared:
            s = card.shared[i] != cpu.shared[i]
            shared_diff += int(s.sum())
            a[1:] |= s
        allowed.append(torch.cummax(a.int(), dim=0).values[:, 0] > 0)  # and the frames after
    allowed = torch.stack(allowed, dim=1)[None]
    err = (card_out["refined_masks"].cpu() - cpu_out["refined_masks"]).abs()
    outside = err[~allowed]
    check = {"active_set_diff_pixels": mask_diff, "shared_diff_pixels": shared_diff,
             "held_share": outside.numel() / err.numel(), "max_abs_err": float(err.max()),
             "max_abs_err_held": float(outside.max()) if outside.numel() else 0.0}
    if check["held_share"] < SM_MIN_HELD or check["max_abs_err_held"] > REFINED_ATOL:
        fail(f"phase {label}: refined_masks differ from the CPU port's by more than "
             f"{REFINED_ATOL}, or less than {SM_MIN_HELD} of them is held to it: {check}")
    return check


def sm_image(dev) -> dict:
    """13.1: ``sparsemat_image.yaml`` answers SM_REQUESTS frames (a forward
    per instance), no kernel launched, each active share in SM_ACTIVE_RANGE;
    frame 0 against the CPU port (``sm_cpu_check``); ms/frame and peak
    memory, in f32 only: SparseMat reads no precision."""
    from maggie_tpu_torch.flagship import blob_batch
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    label = "13.1 sparsemat_image"
    cpu, model = sm_eval_models(SM_IMAGE, dev)
    requests = [{k: v.to(dev) for k, v in blob_batch(H, W, N_INST, seed).items()}
                for seed in range(SM_REQUESTS)]
    torch.cuda.synchronize()
    with SparsityRecord(keep=True) as rec, torch.inference_mode():
        kg.launches = ku.launches = 0
        outs = [model(r) for r in requests]
        torch.cuda.synchronize()
        launches = {"gather_patches": kg.launches, "compute_unknown": ku.launches}
    if any(launches.values()) or len(rec.active) != SM_REQUESTS * N_INST:
        fail(f"phase {label}: launches {launches} (none expected), {len(rec.active)} "
             f"forwards (want {SM_REQUESTS * N_INST})")
    sm_check_active(label, rec.active)
    base_check_outputs(label, outs, (1, 1, N_INST, H, W), keys=("refined_masks",))
    rec.masks = rec.masks[:N_INST]                      # frame 0's forwards
    t0 = time.perf_counter()
    with SparsityRecord(keep=True) as cpu_rec, torch.inference_mode():
        cpu_out = cpu(blob_batch(H, W, N_INST, 0))
    cpu_s = time.perf_counter() - t0
    check = sm_cpu_check(outs[0], cpu_out, rec, cpu_rec, label)
    check["cpu_forward_s"] = cpu_s
    timing, _ = time_forward((("fp32", model),), requests[0], iters=3)
    out = {"launches": launches, "active_share": rec.active, "cpu_check": check,
           "timing": timing}
    print(f"phase {label}: {SM_REQUESTS} frames ({H}x{W}, {N_INST} instances, a forward "
          f"each; p0x x{SM_HEAD_SCALE:g}), active share {np.mean(rec.active):.4f} (min "
          f"{min(rec.active):.4f}, max {max(rec.active):.4f}); CPU check {check}; f32 "
          f"{timing['fp32']['ms_per_frame_median']:.3f} ms/frame, peak "
          f"{timing['fp32']['peak_mem_bytes'] / 1e9:.3f} GB", flush=True)
    return out


def sm_video_set(root: str) -> None:
    """A VIM eval set (``video_set``'s layout) of one SM_VIDEO_FRAMES-frame
    720x1280 video whose background stays still: 3 moving discs over one
    frame of noise, so that consecutive frames share most pixels."""
    from PIL import Image
    h, w = VIDEO_SRC
    alpha = video_alphas(SM_VIDEO_FRAMES, h, w, seed=40)[0]
    rs = np.random.RandomState(50)
    small = Image.fromarray(rs.randint(0, 256, (h // 16, w // 16, 3)).astype(np.uint8))
    bg = np.asarray(small.resize((w, h), Image.BILINEAR)).astype(np.float32)
    for t in range(SM_VIDEO_FRAMES):
        a = alpha[t].max(axis=0)[..., None]
        frame = np.round(bg * (1 - a) + 230.0 * a).astype(np.uint8)
        path = os.path.join(root, "chip", "fgr", "vid0", f"{t:04d}.jpg")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(frame).save(path, quality=90)
        for j in range(N_INST):
            m = np.round(alpha[t, j] * 255).astype(np.uint8)
            for d, arr in (("pha", m), ("xmem", ((m > 127) * 255).astype(np.uint8))):
                path = os.path.join(root, "chip", d, "vid0", f"{t:04d}", f"{j:02d}.png")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                Image.fromarray(arr).save(path)


def sm_video(dev, root: str) -> dict:
    """13.2: ``eval_video`` streams the set's video through
    ``sparsemat_video.yaml`` (the whole forward on every window, one
    instance at a time): metrics, each active share in SM_ACTIVE_RANGE, the
    share of ``shared`` (above 0); window 0's first instance against the
    CPU port (``sm_cpu_check``); ms/window."""
    from maggie_tpu_torch.data import build_dataset
    from maggie_tpu_torch.data.loader import DataLoader
    from maggie_tpu_torch.engine.test import eval_video
    from maggie_tpu_torch.utils.metrics import build_metric
    label = "13.2 sparsemat_video"
    cfg = sm_cfg(SM_VIDEO)
    cfg.dataset.test.root_dir, cfg.dataset.test.split = root, "chip"
    loader = DataLoader(build_dataset(cfg, is_train=False, device=dev), batch_size=1)
    cpu, model = sm_eval_models(SM_VIDEO, dev)
    windows = SM_VIDEO_FRAMES - VIDEO_FRAMES + 1
    metrics = build_metric(["MAD", "MSE", "SAD", "dtSSD"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with SparsityRecord() as rec:
        t0 = time.perf_counter()
        batch_s, data_s, host_s = eval_video(model, loader, 100, metrics)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    values = {k: v.average() for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in values.values()):
        fail(f"phase {label}: non-finite metrics {values}")
    if len(rec.shared_share) != windows * N_INST or not max(rec.shared_share) > 0:
        fail(f"phase {label}: shared shares {rec.shared_share} over {windows} windows x "
             f"{N_INST} instances: want one each, some above 0")
    sm_check_active(label, rec.active)
    win = {k: torch.as_tensor(v)[:, :VIDEO_FRAMES].to(dev)
           for k, v in next(iter(loader)).items() if k in ("image", "mask")}
    one = {"image": win["image"], "mask": win["mask"][:, :, :1]}
    with SparsityRecord(keep=True) as card_rec, torch.inference_mode():
        card_out = model(one)
    with SparsityRecord(keep=True) as cpu_rec, torch.inference_mode():
        cpu_out = cpu({k: v.cpu() for k, v in one.items()})
    check = sm_cpu_check(card_out, cpu_out, card_rec, cpu_rec, label)
    with torch.inference_mode():
        reps = [cuda_ms(lambda: model(win), iters=3, warmup=1) for _ in range(BASE_TIMING_REPS)]
    out = {"windows": windows, "metrics": values, "shared_share": rec.shared_share,
           "active_share": rec.active, "cpu_check": check,
           "ms_per_window_median": float(np.median(reps)), "reps_ms": reps,
           "engine": {"batch_time_s": batch_s, "data_time_s": data_s, "host_time_s": host_s,
                      "wall_s": wall}, "peak_mem_bytes": peak}
    print(f"phase {label}: eval_video over {SM_VIDEO_FRAMES} frames ({windows} windows of "
          f"{VIDEO_FRAMES}, {H}x{W}, {N_INST} instances), metrics {values}; shared share "
          f"{np.mean(rec.shared_share):.4f} (min {min(rec.shared_share):.4f}, max "
          f"{max(rec.shared_share):.4f}), active share {np.mean(rec.active):.4f} (min "
          f"{min(rec.active):.4f}, max {max(rec.active):.4f}); CPU check window 0, instance 0 "
          f"{check}; {out['ms_per_window_median']:.3f} ms/window, engine {wall:.2f} s, peak "
          f"{peak / 1e9:.3f} GB", flush=True)
    return out


def sm_step(name: str, b: int, n_f: int, hw: int) -> tuple:
    """The ``cpu_step`` spec of 13.3's step of ``name`` (one slot)."""
    return ("sparsemat", name, b, n_f, hw), lambda: (sm_cfg(name), base_train_batch(b, n_f, hw, 1)), None


def sm_check_step(name: str, b: int, n_f: int, hw: int, dev) -> dict:
    """13.3: one f32 step of ``name`` at one slot on the card against the
    CPU port within phase 6's STEP_* limits."""
    check = card_step(sm_step(name, b, n_f, hw), dev)
    for k in ("losses_card", "losses_cpu"):
        del check[k]
    cpu_s = check["cpu_step_s"]
    print(f"phase 13.3 {name} card vs CPU step (batch {b} x clip {n_f} x {hw}x{hw}, f32): loss "
          f"terms max rel {check['loss_max_rel']:.3g}, gradients rel L2 "
          f"{check['grad_rel_l2']:.3g}, params max |d| {check['param_max_abs']:.3g} (far share "
          f"{check['param_far_share']:.3g}), BN stats {check['batch_stats_max_abs']:.3g} (CPU "
          f"step {cpu_s:.1f} s)", flush=True)
    if not check["within"]:
        fail(f"phase 13 {name}: the card's step differs from the CPU port's beyond phase 6's "
             f"STEP_* limits: {check}")
    return check


def dense_train(dev) -> dict:
    """13.4: BASE_TRAIN_STEPS f32 steps (``card_steps``) of the dense
    ablation at batch 2 x 512x512, 10 slots: K2 once a step
    (``detail_mask``), the fusion's bands random widths."""
    out = card_steps(dense_cfg(), base_train_batch(2, 1, 512, 10), dev, "13.4 dense")
    want = {"gather_patches": 0, "gather_patches_bwd": 0, "compute_unknown": BASE_TRAIN_STEPS}
    if out["launches"] != want:
        fail(f"phase 13.4 dense: {BASE_TRAIN_STEPS} train steps launched {out['launches']}, "
             f"want K2 once a step")
    print(f"phase 13.4 dense train (batch 2 x 512x512, 10 slots, f32): K2 launches "
          f"{out['launches']['compute_unknown']} over {BASE_TRAIN_STEPS} steps, total loss "
          f"{out['losses'][-1]['total']:.4f}, {out['ms_per_step_median']:.3f} ms/step, peak "
          f"{out['peak_mem_bytes'] / 1e9:.3f} GB", flush=True)
    return out


def phase_sparsemat(dev, detail) -> dict:
    """Phase 13: 13.1 ``sm_image``, 13.2 ``sm_video``, 13.3 the card-vs-CPU
    steps (the yamls' batches are phase 14.2's), 13.4 the dense InstMatt ablation
    (``base_image``, ``dense_train``). Returns K2's launches over the
    counted runs (3 per dense forward, 1 per dense step; SparseMat launches
    none)."""
    import tempfile
    t0 = time.perf_counter()
    checks, worst = {"unknown": []}, {"unknown": 0.0}
    out = {"image": sm_image(dev)}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        sm_video_set(root)
        out["video"] = sm_video(dev, root)
    torch.cuda.empty_cache()
    out["train_check"] = {n: sm_check_step(n, b, f, hw, dev) for n, b, f, hw in SM_CHECK_STEPS}
    out["dense_eval"] = base_image("dense", dev, checks, worst, cfg=dense_cfg, k2_per_forward=3,
                                   keys=DENSE_KEYS, label="13.4")
    torch.cuda.empty_cache()
    out["dense_train"] = dense_train(dev)
    torch.cuda.empty_cache()
    launches = {"gather_patches": 0, "gather_patches_bwd": 0,
                "compute_unknown": (out["dense_eval"]["launches"]["compute_unknown"]
                                    + out["dense_train"]["launches"]["compute_unknown"])}
    out.update(launches=launches, kernel_checks=checks, k2_max_abs_err=worst["unknown"],
               phase_s=time.perf_counter() - t0)
    detail["sparsemat"] = out
    print(f"phase 13: K2 equal to its plain twin at the dense decoder's "
          f"{len(checks['unknown'])} calls; launches {launches}; done in {out['phase_s']:.1f} s",
          flush=True)
    return out


def sparsemat_only(dev) -> int:
    """``--sparsemat``: build the kernels, then phase 13; details to
    output/torch_port/chip_smoke_sparsemat.json."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    detail = {}
    phase_sparsemat(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_sparsemat.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    return 0


# ---------------------------------------------------------------- phase 14
# remat and data parallel for the baselines (models/remat.py's layouts: the
# harness with a dense decoder 3 segments, TCVOM 2, SparseMat 1), f32, TF32
# off, seed-0 weights, at the yamls' widths and 512x512 crops
B14_HW = 512
# 14.1 (config, batch, clip): one step of each mode held against the plain one
B14_CHECK = (("mgm_stacked", 2, 1), ("mgm_stacked_tcvom", 1, 8), ("sparsemat_video", 1, 8),
             ("dense", 2, 1))
B14_STEPS = 3                 # the checked step, then steps 2-3 timed (median)
# K2's launches a step, from the stage layout: the dense InstMatt decoder's
# detail_mask sits in its decoder's segment, the last, which "full" and
# "selective" both compute again in the backward; the MGM and TCVOM train
# fusions dilate with random widths (plain torch) and SparseMat launches none
B14_K2 = {"dense": {"none": 1, "full": 2, "selective": 2}}
# 14.2 (config, batch, clip, modes): the yaml's own train batch that fits
# only under ``selective``, for the script's time limit (the others, on an
# H100 80GB HBM3, 700 W: mgm_stacked's 12 images fit in every mode,
# mgm_stacked_tcvom's 4 clips only under selective, sparsemat_video's in
# every mode at 83.5-83.8 GB, and sparsemat_image's 12 images in every mode
# at 31.8 GB; PERF.md §5)
B14_YAML = (("mgm_stacked_tcvom", 4, 8, ("selective",)),)
B14_YAML_STEPS = 2            # ms/step: the second step's
# 14.3 (config, global batch, clip): two gloo ranks on the card, a row a rank
B14_DDP = (("mgm_stacked_tcvom", 2, 3), ("sparsemat_image", 2, 1))


def b14_cfg(name: str):
    if name == "dense":
        return dense_cfg()
    return sm_cfg(name) if name.startswith("sparsemat") else base_cfg(name)


def b14_model(name: str, dev):
    """``name``'s config, its model on ``dev`` from seed 0 and the initial
    state dict, and its slots."""
    from maggie_tpu_torch.models import build_model
    cfg = b14_cfg(name)
    model = build_model(cfg.model, device=dev, generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    return cfg, model, init, int(cfg.model.encoder_args.num_mask)


def b14_remat(dev) -> tuple[dict, dict]:
    """14.1: per config of B14_CHECK, B14_STEPS steps of each remat mode from
    the same weights, batch and generator seed; each remat mode's first step
    against the plain one's within phase 6's STEP_* limits (and whether
    bit-equal), the generator's state after it equal; K2's launches a step
    as B14_K2 says, K1 and its backward none. Returns the readings and
    each (config, mode)'s (frames, peak) for 14.2's fits."""
    out, points = {}, {}
    for name, b, n_f in B14_CHECK:
        t0 = time.perf_counter()
        cfg, model, init, slots = b14_model(name, dev)
        batch = {k: v.to(dev) for k, v in base_train_batch(b, n_f, B14_HW, slots).items()}
        runs = {mode: card_steps(cfg, batch, dev, f"14.1 {name} {mode}", B14_STEPS, remat=mode,
                                 model=model, init=init, first=True)
                for mode in REMAT_MODES}
        r = out[name] = {"size": f"batch {b} x clip {n_f} x {B14_HW}x{B14_HW}, {slots} slots"}
        for mode, run in runs.items():
            want = {"gather_patches": 0, "gather_patches_bwd": 0,
                    "compute_unknown": B14_K2.get(name, {}).get(mode, 0)}
            if any(c != want for c in run["launches_by_step"]):
                fail(f"phase 14.1 {name} {mode}: launches by step {run['launches_by_step']}, "
                     f"want {want} a step")
            entry = r[mode] = {k: run[k] for k in ("ms_per_step", "ms_per_step_median",
                                                   "peak_mem_bytes", "launches")}
            entry["launches_per_step"] = want
            points[(name, mode)] = (b * n_f, run["peak_mem_bytes"])
            if mode != "none":
                c = compare_steps(run["first"], runs["none"]["first"])
                c["bit_equal"] = (c["loss_max_rel"] == 0 and c["grad_rel_l2"] == 0
                                  and c["param_max_abs"] == 0 and c["batch_stats_max_abs"] == 0
                                  and c["spectral_max_abs"] == 0)
                c["generator_equal"] = bool(torch.equal(run["first"]["generator"],
                                                        runs["none"]["first"]["generator"]))
                entry["vs_none"] = c
                if not c["within"] or not c["generator_equal"]:
                    fail(f"phase 14.1 {name}: the {mode} step vs the plain one: {c}")
        r["seconds"] = time.perf_counter() - t0
        print(f"phase 14.1 {name} ({r['seconds']:.1f} s; {r['size']}, f32): "
              + "; ".join(f"{m} {r[m]['ms_per_step_median']:.3f} ms/step, peak "
                          f"{r[m]['peak_mem_bytes'] / 1e9:.3f} GB, K2 "
                          f"{r[m]['launches_per_step']['compute_unknown']}/step"
                          for m in REMAT_MODES), flush=True)
        for m in REMAT_MODES[1:]:
            c = r[m]["vs_none"]
            print(f"  {m} vs none: bit-equal {c['bit_equal']} (loss rel {c['loss_max_rel']:.3g}, "
                  f"grad rel L2 {c['grad_rel_l2']:.3g}, params {c['param_max_abs']:.3g}, BN "
                  f"{c['batch_stats_max_abs']:.3g}, u/v {c['spectral_max_abs']:.3g}); generator "
                  f"equal {c['generator_equal']}", flush=True)
        del model, init, batch, runs
        torch.cuda.empty_cache()
    return out, points


def b14_yaml(dev, points: dict, budget: int) -> dict:
    """14.2: per yaml of B14_YAML and mode, B14_YAML_STEPS steps at the
    yaml's batch, or, where it does not fit, at the largest smaller batch
    that does (each batch that ran out of memory reported); for a mode
    that does not fit, phase 10.3's fit through 14.1's point and the
    fitting batch's, and the largest batch it predicts under
    REMAT_FIT_FRACTION of the memory this process holds."""
    import functools
    import gc
    out = {}
    for name, b, n_f, modes in B14_YAML:
        t0 = time.perf_counter()
        cfg, model, init, slots = b14_model(name, dev)
        host_batch = functools.lru_cache(lambda size: base_train_batch(size, n_f, B14_HW, slots))
        r = out[name] = {"yaml_batch": b, "clip": n_f}
        for mode in modes:
            tried, run = [], None
            for size in range(b, 0, -1):
                batch = {k: v.to(dev) for k, v in host_batch(size).items()}
                try:
                    run = card_steps(cfg, batch, dev, f"14.2 {name} {mode}", B14_YAML_STEPS,
                                     remat=mode, model=model, init=init)
                except torch.cuda.OutOfMemoryError:
                    tried.append(size)
                del batch
                gc.collect()
                torch.cuda.empty_cache()
                if run is not None:
                    break
            if run is None:
                fail(f"phase 14.2 {name} {mode}: no batch fits on the card (tried {tried})")
            entry = r[mode] = {"batch": size, "fits": size == b, "out_of_memory_at": tried,
                               "ms_per_step": run["ms_per_step"],
                               "ms_per_step_last": run["ms_per_step"][-1],
                               "peak_mem_bytes": run["peak_mem_bytes"]}
            p1 = points.get((name, mode))
            if size < b and p1 is not None and p1[0] != size * n_f:
                fit = remat_fit((p1, (size * n_f, run["peak_mem_bytes"])))
                entry["fit"] = dict(fit, points=[p1, (size * n_f, run["peak_mem_bytes"])])
                entry["fit_max_batch"] = int((REMAT_FIT_FRACTION * budget - fit["fixed_bytes"])
                                             // fit["per_frame_bytes"]) // n_f
                entry["fit_peak_at_yaml_batch"] = (fit["fixed_bytes"]
                                                   + fit["per_frame_bytes"] * b * n_f)
        r["seconds"] = time.perf_counter() - t0
        print(f"phase 14.2 {name} ({r['seconds']:.1f} s; the yaml's batch {b}"
              + (f" x clip {n_f}" if n_f > 1 else "")
              + f", {B14_HW}x{B14_HW}, {slots} slots, f32): "
              + "; ".join(
                  f"{m} " + ("fits" if r[m]["fits"] else
                             f"does not fit (out of memory at {r[m]['out_of_memory_at']}; runs "
                             f"at {r[m]['batch']}" + (
                                 f"; 10.3's fit {r[m]['fit']['fixed_bytes'] / 1e9:.2f} GB + "
                                 f"{r[m]['fit']['per_frame_bytes'] / 1e9:.3f} GB a frame "
                                 f"predicts {r[m]['fit_peak_at_yaml_batch'] / 1e9:.1f} GB at "
                                 f"{b} and at most {r[m]['fit_max_batch']}"
                                 if "fit" in r[m] else "; no second point for a fit") + ")")
                  + f": {r[m]['ms_per_step_last']:.3f} ms/step, peak "
                  f"{r[m]['peak_mem_bytes'] / 1e9:.3f} GB" for m in modes), flush=True)
        del model, init, host_batch
        gc.collect()
        torch.cuda.empty_cache()
    return out


B14_MODES = ("none", "selective")


def b14_runs() -> list:
    """14.3's runs for phase 11's rank pair: each config of B14_DDP, a row a
    rank, plain and under selective, untimed."""
    from maggie_tpu_torch.models import build_model
    runs = []
    for name, b, n_f in B14_DDP:
        cfg = b14_cfg(name)
        state = build_model(cfg.model, device="cpu",
                            generator=torch.Generator().manual_seed(0)).state_dict()
        batch = base_train_batch(b, n_f, B14_HW, int(cfg.model.encoder_args.num_mask))
        runs.append({"cfg": cfg.to_dict(), "state": state, "batch": batch,
                     "modes": B14_MODES, "timed": False})
    return runs


def b14_check(dev, runs: list, ranks: list, into: dict) -> None:
    """14.3: the ranks' results of ``b14_runs`` (run in phase 11's pair)
    against one process on the card on the same global batch within phase
    6's STEP_* limits, the ranks' models bit-equal after the update; no
    kernel launched (no ladder, random-width fusions, SparseMat). The
    checks go to ``into["baselines"]``."""
    from maggie_tpu_torch.config import ConfigNode
    from maggie_tpu_torch.models import build_model
    modes = B14_MODES
    singles = []
    for run in runs:
        cfg = ConfigNode(run["cfg"])
        model = build_model(cfg.model, device=dev)
        model.load_state_dict(run["state"])
        on_dev = {k: v.to(dev) for k, v in run["batch"].items()}
        singles.append(ddp_steps(model, cfg, on_dev, dev, modes, timed=False))
        del model, on_dev
        torch.cuda.empty_cache()
    none = dict.fromkeys(PER_ITER, 0)
    out = into["baselines"] = {}
    for i, (name, b, n_f) in enumerate(B14_DDP):
        size = f"batch {b}" + (f" x clip {n_f}" if n_f > 1 else "") + f", {B14_HW}x{B14_HW}"
        out[name] = {mode: ddp_check(f"14.3 {name} {mode} ({size}, a row a rank)",
                                     [r[i][mode] for r in ranks], singles[i][mode], none)
                     for mode in modes}


def phase_baselines_train(dev, detail) -> dict:
    """Phase 14: 14.1 ``b14_remat``, 14.2 ``b14_yaml`` (14.3 runs in phase
    11's rank pair, ``b14_check``). The allocator maps expandable segments
    during 14.1 and 14.2, as in phase 10. Returns each kernel's launches
    over 14.1's steps."""
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        free, total = torch.cuda.mem_get_info(dev)
        budget = free + torch.cuda.memory_reserved(dev)
        out = {"budget_bytes": budget}
        out["remat"], points = b14_remat(dev)
        t1 = time.perf_counter()
        out["yaml"] = b14_yaml(dev, points, budget)
        t2 = time.perf_counter()
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")
    out["seconds"] = {"14.1": t1 - t0, "14.2": t2 - t1}
    launches = {k: sum(out["remat"][n][m]["launches"][k]
                       for n, _, _ in B14_CHECK for m in REMAT_MODES) for k in PER_ITER}
    out.update(launches=launches, phase_s=time.perf_counter() - t0)
    detail["baselines_train"] = out
    print(f"phase 14: launches over 14.1's steps {launches}; done in {out['phase_s']:.1f} s "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in out['seconds'].items())})", flush=True)
    if launches["compute_unknown"] == 0:
        fail("phase 14: compute_unknown was not launched on the baselines' train path")
    return out


def baselines_train_only(dev) -> int:
    """``--baselines-train``: build the kernels, then phase 14; details to
    output/torch_port/chip_smoke_baselines_train.json."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    detail = {}
    phase_baselines_train(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_baselines_train.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    return 0


# ---------------------------------------------------------------- phase 15
# the demo's serving path (maggie_tpu_torch/demo/): its HTTP server on the
# card, the flagship image and video models from .safetensors weights
DEMO_IMAGE_SRC = (720, 1280)   # ResizeShort(576) -> 576x1024, no padding
DEMO_REQUESTS = 4              # image requests; ms from the median of 2-4
DEMO_VIDEO_FRAMES = 5          # 576x1024, masks for frame 0 only: 3 windows
PER_DEMO_FORWARD = {"gather_patches": 5, "compute_unknown": 3}   # a frame or a window
_ST_NAMES = {"float32": "F32", "float16": "F16", "int64": "I64", "int32": "I32", "uint8": "U8",
             "bool": "BOOL", "float64": "F64"}


def write_safetensors(path: str, state_dict: dict) -> None:
    """``state_dict`` as a .safetensors file, with numpy and json: an 8-byte
    little-endian header length, the JSON header, the raw arrays."""
    header, blobs, offset = {}, [], 0
    for name in sorted(state_dict):
        a = state_dict[name].detach().cpu().contiguous().numpy()
        data = a.tobytes()
        header[name] = {"dtype": _ST_NAMES[a.dtype.name], "shape": list(a.shape),
                        "data_offsets": [offset, offset + len(data)]}
        blobs.append(data)
        offset += len(data)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(np.array([len(head)], "<u8").tobytes() + head)
        for b in blobs:
            f.write(b)


def demo_image_request(seed: int) -> tuple:
    """(PIL image, [PNG bytes of each mask]): a 720x1280 frame of noise and 3
    blob instances (``flagship.blob_alpha``) as 0/255 mask PNGs."""
    import io
    from PIL import Image
    from maggie_tpu_torch.flagship import blob_alpha
    rs = np.random.RandomState(seed)
    h, w = DEMO_IMAGE_SRC
    alpha = blob_alpha(h, w, N_INST, rs)
    image = Image.fromarray((rs.rand(h, w, 3) * 255).astype(np.uint8))
    masks = []
    for a in alpha:
        buf = io.BytesIO()
        Image.fromarray(((a > 0.5) * 255).astype(np.uint8)).save(buf, "PNG")
        masks.append(buf.getvalue())
    return image, masks


def demo_video_dir(root: str) -> tuple:
    """(frames dir, masks dir): phase 8's moving blobs (``video_alphas``) on
    noise, DEMO_VIDEO_FRAMES PNG frames at 576x1024, masks for frame 0 only."""
    from PIL import Image
    alpha = video_alphas(DEMO_VIDEO_FRAMES, H, W, seed=3)
    rs = np.random.RandomState(4)
    fdir, mdir = os.path.join(root, "frames"), os.path.join(root, "masks", "f0")
    os.makedirs(fdir)
    os.makedirs(mdir)
    for t in range(DEMO_VIDEO_FRAMES):
        frame = rs.rand(H, W, 3) * 160 + alpha[0, t].max(0)[..., None] * 90
        Image.fromarray(frame.astype(np.uint8)).save(os.path.join(fdir, f"f{t}.png"))
    for j in range(N_INST):
        Image.fromarray(((alpha[0, 0, j] > 0.5) * 255).astype(np.uint8)).save(
            os.path.join(mdir, f"{j:02d}.png"))
    return fdir, os.path.dirname(mdir)


class DemoRecorder:
    """Forward hooks on the demo's models (added as ``matte`` first meets
    each, through ``app`` or ``predict.video_windows``): per forward, the K1
    and K2 launches, the model's device ms (CUDA events around the forward)
    and, for the next ``keep`` forwards, its outputs on the host; and the
    propagator's host seconds and masks."""

    def __init__(self):
        self.forwards, self.keep, self.hooked = [], False, set()
        self.propagated = []

    def _pre(self, module, args, kwargs):
        from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
        rec = {"k0": (kg.launches, ku.launches)}
        if next(module.parameters()).is_cuda:
            rec["start"] = torch.cuda.Event(enable_timing=True)
            rec["start"].record()
        self.forwards.append(rec)

    def _post(self, module, args, kwargs, out):
        from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
        rec = self.forwards[-1]
        if "start" in rec:
            rec["end"] = torch.cuda.Event(enable_timing=True)
            rec["end"].record()
        k0, u0 = rec.pop("k0")
        rec["launches"] = {"gather_patches": kg.launches - k0, "compute_unknown": ku.launches - u0}
        if self.keep:
            rec["out"] = {k: v.detach().float().cpu() for k, v in out.items()}
            self.keep -= 1

    def __enter__(self):
        import maggie_tpu_torch.demo.app as app
        import maggie_tpu_torch.demo.predict as predict
        self.app, self.predict = app, predict
        self.matte, self.prop = app.matte, app._propagated_masks

        def matte(model, *a, **k):
            if id(model) not in self.hooked:
                model.register_forward_pre_hook(self._pre, with_kwargs=True)
                model.register_forward_hook(self._post, with_kwargs=True)
                self.hooked.add(id(model))
            return self.matte(model, *a, **k)

        def propagated(*a, **k):
            t0 = time.perf_counter()
            out = self.prop(*a, **k)
            self.propagated.append((time.perf_counter() - t0, out))
            return out
        app.matte = predict.matte = matte
        app._propagated_masks = propagated
        return self

    def __exit__(self, *exc):
        self.app.matte = self.predict.matte = self.matte
        self.app._propagated_masks = self.prop

    def take(self) -> list:
        """The forwards since the last ``take``, device ms filled in."""
        out, self.forwards = self.forwards, []
        for rec in out:
            if "end" in rec:
                rec["end"].synchronize()
                rec["ms"] = rec.pop("start").elapsed_time(rec.pop("end"))
        return out


def _multipart(fields) -> tuple:
    """(body, content type) of a multipart form: (name, filename, bytes)."""
    import uuid
    boundary = uuid.uuid4().hex
    body = b""
    for name, filename, data in fields:
        body += (f"--{boundary}\r\nContent-Disposition: form-data; name=\"{name}\"; "
                 f"filename=\"{filename}\"\r\nContent-Type: image/png\r\n\r\n").encode()
        body += data + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def demo_post(url: str, body: bytes, ctype: str) -> tuple:
    """(status, response bytes, host seconds) of one POST; an error page
    (the server's 500 with the exception) fails the phase."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body, method="POST", headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            data = r.read()
            return r.status, data, time.perf_counter() - t0
    except urllib.error.HTTPError as e:
        fail(f"phase 15: {url} answered {e.code}: {e.read()[:2000]!r}")


def demo_check_forwards(label: str, forwards: list, n: int) -> dict:
    """Each of ``n`` forwards launched K1 5 and K2 3 times; their sums."""
    if len(forwards) != n:
        fail(f"phase 15: {label}: {len(forwards)} forwards, not {n}")
    for i, f in enumerate(forwards):
        if f["launches"] != PER_DEMO_FORWARD:
            fail(f"phase 15: {label}: forward {i} launched {f['launches']}, not {PER_DEMO_FORWARD}")
    return {k: sum(f["launches"][k] for f in forwards) for k in PER_DEMO_FORWARD}


def phase_demo(dev, detail) -> dict:
    """Phase 15: ``maggie_tpu_torch.demo.app``'s HTTP server in this process
    on the card (port 0, a thread), the flagship image and video models from
    seed-0 weights written as .safetensors; DEMO_REQUESTS image requests
    (a 720x1280 frame and 3 mask PNGs each, through ``POST /image``) and a
    video request (DEMO_VIDEO_FRAMES frames at 576x1024 with masks for frame
    0 only, ``POST /video``: ``FlowPropagator`` fills in the rest), window
    0's outputs and decisions recorded (the recorder copies to the host
    inside the forward, so the windows after it are the timed ones). Checks
    status 200 and decodable outputs, K1 5 and K2 3 launches per frame and
    per window, and request 0's and window 0's model outputs against the
    same inputs answered by the port on the CPU (phase 3's rule for the
    frame, phase 8's for the window, the card's propagated masks reused).
    Returns the launches over the requests."""
    import argparse
    import io
    import shutil
    import tempfile
    import maggie_tpu_torch.demo.app as app
    from PIL import Image
    from urllib.parse import urlencode
    from maggie_tpu_torch.config import load_config
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    t0 = time.perf_counter()
    out = {}
    root = tempfile.mkdtemp(prefix="demo_")
    torch.cuda.reset_peak_memory_stats()
    try:
        weights = {}
        for kind, cfg_path in (("image", "configs/maggie_image.yaml"), ("video", VIDEO_CONFIG)):
            model = build_model(load_config(cfg_path).model, device="cpu",
                                generator=torch.Generator().manual_seed(0))
            weights[kind] = os.path.join(root, f"{kind}.safetensors")
            write_safetensors(weights[kind], model.state_dict())
            del model
        args = argparse.Namespace(weights=weights["image"], video_weights=weights["video"],
                                  config=None, video_config=None, port=0, device=None)
        cpu_args = argparse.Namespace(**{**vars(args), "device": "cpu"})
        app._STATE.clear()
        ready = threading.Event()
        box = {}

        def on_ready(srv):
            box["srv"] = srv
            ready.set()
        server = threading.Thread(target=app.launch_http, args=(args, on_ready), daemon=True)
        server.start()
        if not ready.wait(60):
            fail("phase 15: the demo server did not start")
        url = f"http://127.0.0.1:{box['srv'].server_address[1]}"
        with DemoRecorder() as rec:
            # ---- image requests ----
            kg.launches = ku.launches = 0
            image_ms, host_ms, model_ms = [], [], []
            for i in range(DEMO_REQUESTS):
                image, masks = demo_image_request(i)
                buf = io.BytesIO()
                image.save(buf, "PNG")
                fields = [("image", "img.png", buf.getvalue())]
                fields += [("masks", f"{j:02d}.png", m) for j, m in enumerate(masks)]
                rec.keep = int(i == 0)
                status, data, sec = demo_post(url + "/image", *_multipart(fields))
                torch.cuda.synchronize()
                fwd = rec.take()
                if status != 200:
                    fail(f"phase 15: image request {i} answered {status}")
                row = np.array(Image.open(io.BytesIO(data)))
                h, w = DEMO_IMAGE_SRC
                if row.shape != (h, w * (N_INST + 1), 3):
                    fail(f"phase 15: image request {i}: a {row.shape} PNG")
                demo_check_forwards(f"image request {i}", fwd, 1)
                if i == 0:
                    first = (image, masks, fwd[0])
                image_ms.append(sec * 1e3)
                model_ms.append(fwd[0]["ms"])
                host_ms.append(sec * 1e3 - fwd[0]["ms"])
            launches = {"gather_patches": kg.launches, "compute_unknown": ku.launches}
            if launches != {k: v * DEMO_REQUESTS for k, v in PER_DEMO_FORWARD.items()}:
                fail(f"phase 15: image requests launched {launches}")
            out["image"] = {"request_ms": image_ms, "model_ms": model_ms, "host_ms": host_ms,
                            "ms_per_request_median_2_4": float(np.median(image_ms[1:])),
                            "model_ms_median_2_4": float(np.median(model_ms[1:])),
                            "host_ms_median_2_4": float(np.median(host_ms[1:]))}
            # ---- the video request: window 0's outputs and decisions recorded ----
            fdir, mdir = demo_video_dir(os.path.join(root, "video"))
            windows = DEMO_VIDEO_FRAMES - 2
            form = urlencode({"frames": fdir, "masks": mdir, "prop": "flow"}).encode()
            rec.keep = 1
            with ThresholdRecorder(1) as card_thr:
                status, data, sec = demo_post(url + "/video", form,
                                              "application/x-www-form-urlencoded")
            torch.cuda.synchronize()
            vfwd = rec.take()
            prop_s, prop_masks = rec.propagated[-1]
            if status != 200:
                fail(f"phase 15: the video request answered {status}")
            listed = data.decode().split("<br>")
            files = [p for p in listed if not p.startswith("video: ")]
            if len(files) != DEMO_VIDEO_FRAMES:
                fail(f"phase 15: the video request listed {len(files)} frames")
            for p in files:
                if np.array(Image.open(p)).shape != (H, W * N_INST, 3):
                    fail(f"phase 15: the video frame {p} does not decode to its grid")
            videos = [p[len("video: "):] for p in listed if p.startswith("video: ")]
            if not videos or os.path.getsize(videos[0]) == 0:
                fail("phase 15: the video request muxed no video")
            video_launches = demo_check_forwards("video request", vfwd, windows)
            timed = [f["ms"] for f in vfwd[1:]]      # window 0 copied its records to the host
            out["video"] = {"request_s": sec, "window_ms": [f["ms"] for f in vfwd],
                            "ms_per_window_median": float(np.median(timed)),
                            "propagator_s": prop_s,
                            "propagator_s_per_frame": prop_s / (DEMO_VIDEO_FRAMES - 1),
                            "video_file": os.path.basename(videos[0])}
            out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
            box["srv"].shutdown()
            server.join(60)
            # ---- the same requests on the CPU port ----
            t1 = time.perf_counter()
            app._STATE.clear()      # the CPU port's models from here on
            image, masks, card_fwd = first
            paths = []
            for j, m in enumerate(masks):
                paths.append(os.path.join(root, f"m{j}.png"))
                with open(paths[-1], "wb") as f:
                    f.write(m)
            rec.keep = 1
            app.inference_image(cpu_args, image, paths)
            cpu_fwd = rec.take()
            near, n_diff, unexplained, region = detail_mask_check(card_fwd["out"],
                                                                  cpu_fwd[0]["out"])
            err = (card_fwd["out"]["refined_masks"] - cpu_fwd[0]["out"]["refined_masks"]
                   ).abs()[0, 0]
            err_out = float(err[~region].max()) if bool((~region).any()) else 0.0
            out["image_cpu_check"] = {"near_threshold_pixels": near, "detail_mask_diff": n_diff,
                                      "unexplained_diff": unexplained,
                                      "refined_max_abs_err": float(err.max()),
                                      "refined_max_abs_err_outside_flips": err_out}
            if unexplained or err_out > REFINED_ATOL:
                fail(f"phase 15: image request 0 against the CPU port: "
                     f"{out['image_cpu_check']} (limit {REFINED_ATOL})")
            # window 0 on the CPU port: the video's first 3 frames, the card's masks
            fdir0 = os.path.join(root, "video_cpu_frames")
            os.makedirs(fdir0)
            for f in sorted(os.listdir(fdir))[:3]:
                shutil.copy(os.path.join(fdir, f), fdir0)
            app._propagated_masks = lambda *a, **k: prop_masks[:3]
            rec.keep = 1
            try:
                with ThresholdRecorder(1) as cpu_thr:
                    app.inference_video(cpu_args, fdir0, mdir, "flow",
                                        os.path.join(root, "video_cpu"))
            finally:
                app._propagated_masks = rec.prop
            cpu_vfwd = rec.take()
            c = video_window_check(vfwd[0]["out"], cpu_vfwd[0]["out"], card_thr.records[0],
                                   cpu_thr.records[0], None)
            c.pop("frame1_flips")
            bad = video_window_failures(c)
            if bad:
                fail(f"phase 15: video window 0 against the CPU port: {bad}: {c}")
            checks = [c]
            out["video_cpu_checks"] = checks
            out["cpu_check_s"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(root, ignore_errors=True)
        app._STATE.clear()
    out["launches"] = {k: launches[k] + video_launches[k] for k in PER_DEMO_FORWARD}
    out["launches"]["gather_patches_bwd"] = 0
    out["phase_s"] = time.perf_counter() - t0
    detail["demo"] = out
    i, v = out["image"], out["video"]
    print(f"phase 15: the demo server answered {DEMO_REQUESTS} image requests "
          f"({DEMO_IMAGE_SRC[0]}x{DEMO_IMAGE_SRC[1]}, "
          f"{N_INST} masks) and a video request ({DEMO_VIDEO_FRAMES} frames at {H}x{W}, "
          f"{windows} windows) from .safetensors weights; launches {out['launches']}", flush=True)
    print(f"  image request {i['ms_per_request_median_2_4']:.1f} ms (median of requests 2-4): "
          f"model {i['model_ms_median_2_4']:.3f} ms (CUDA events), host "
          f"{i['host_ms_median_2_4']:.1f} ms; video {v['ms_per_window_median']:.3f} ms a window "
          f"(model, CUDA events, median of windows 1-{windows - 1}; all windows "
          f"{[round(m, 3) for m in v['window_ms']]}, window 0 recorded), request "
          f"{v['request_s']:.2f} s, propagator "
          f"{v['propagator_s_per_frame']:.3f} host s a frame; peak "
          f"{out['peak_mem_bytes'] / 2**30:.2f} GiB; CPU checks {out['cpu_check_s']:.1f} s "
          f"(image refined max |err| off flips "
          f"{out['image_cpu_check']['refined_max_abs_err_outside_flips']:.3g}; video window 0 "
          f"flips {out['video_cpu_checks'][0]['refined_flips']}); phase "
          f"{out['phase_s']:.1f} s", flush=True)
    return out


def demo_only(dev) -> int:
    """``--demo``: build the kernels, then phase 15; details to
    output/torch_port/chip_smoke_demo.json."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    detail = {}
    phase_demo(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_demo.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    return 0



# phase 16: the tools
TOOLS_MASKS = "gen_full"       # gen_mask --variant full writes masks_gen_full/
TOOLS_SPLIT = "val"
TOOLS_TRAIN_ITERS, TOOLS_FAULT_ITER = 4, 3
TOOLS_CHILD_TIMEOUT_S = 400
PER_TOOLS_FRAME = {"gather_patches": 5, "gather_patches_bwd": 0, "compute_unknown": 3}
# trainer flags and overrides the supervised run and the eval take besides
# the yaml's (none on the card; a CPU rehearsal sets --device cpu and
# narrower widths)
TOOLS_FLAGS: list = []
TOOLS_OPTS: list = []


def tools_eval_set(root: str) -> None:
    """``root/images/val/*.jpg`` and ``root/alphas/val/<image>/*.png`` written
    with PIL: ENGINE_FRAMES frames at ENGINE_SRC with N_INST blob alphas,
    from seeds; the guidance masks are left to ``gen_mask``."""
    from PIL import Image
    from maggie_tpu_torch.flagship import blob_alpha
    h, w = ENGINE_SRC
    for i in range(ENGINE_FRAMES):
        rs = np.random.RandomState(400 + i)
        img_dir = os.path.join(root, "images", TOOLS_SPLIT)
        os.makedirs(img_dir, exist_ok=True)
        Image.fromarray(rs.randint(0, 256, (h, w, 3)).astype(np.uint8)).save(
            os.path.join(img_dir, f"t{i}.jpg"), quality=90)
        adir = os.path.join(root, "alphas", TOOLS_SPLIT, f"t{i}")
        os.makedirs(adir, exist_ok=True)
        for j, a in enumerate(blob_alpha(h, w, N_INST, rs)):
            Image.fromarray(np.round(a * 255).astype(np.uint8)).save(
                os.path.join(adir, f"{j:02d}.png"))


def tools_eval(root: str) -> dict:
    """16.1: ``gen_mask --variant full`` on the set, then ``main.main
    --eval-only`` on the card with the generated masks; the masks the
    dataset decoded must be the tool's, the launches 5 K1 and 3 K2 a frame,
    and results.csv one row of finite metrics."""
    import maggie_tpu_torch.data.transforms as tf
    from maggie_tpu_torch import main as cli
    from maggie_tpu_torch.tools import gen_mask
    written, decoded = {}, {}
    save_png, decode = gen_mask._save_png, tf.pil_decode

    def keep_written(mask, path):
        written[os.path.abspath(path)] = mask.copy()
        save_png(mask, path)

    def keep_decoded(path, mode):
        arr = decode(path, mode)
        if f"masks_{TOOLS_MASKS}" in path:
            decoded[os.path.abspath(path)] = arr.copy()
        return arr

    gen_mask._save_png = keep_written
    try:
        t0 = time.perf_counter()
        n = gen_mask.main(["--root", root, "--subsets", TOOLS_SPLIT, "--name", TOOLS_MASKS,
                           "--variant", "full", "--seed", "0"])
        gen_s = time.perf_counter() - t0
    finally:
        gen_mask._save_png = save_png
    if n != ENGINE_FRAMES * N_INST or len(written) != n:
        fail(f"gen_mask wrote {n} masks ({len(written)} recorded), not {ENGINE_FRAMES * N_INST}")
    out_dir = os.path.join(root, "out")
    args = ["--config", "configs/maggie_image.yaml", "--eval-only", *TOOLS_FLAGS,
            "output_dir", out_dir, "name", "tools_eval", "dataset.test.root_dir", root,
            "dataset.test.split", TOOLS_SPLIT, "dataset.test.mask_dir_name",
            f"masks_{TOOLS_MASKS}", "test.log_iter", "1", *TOOLS_OPTS]
    tf.pil_decode = keep_decoded
    try:
        torch.cuda.synchronize()
        before = kernel_counts()
        t0 = time.perf_counter()
        results = cli.main(args)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in kernel_counts().items()}
    finally:
        tf.pil_decode = decode
    want = {k: v * ENGINE_FRAMES for k, v in PER_TOOLS_FRAME.items()}
    if launches != want:
        fail(f"tools eval: launches {launches} != {want} ({PER_TOOLS_FRAME} a frame)")
    if decoded.keys() != written.keys() or any(
            not np.array_equal(decoded[p], m) for p, m in written.items()):
        fail(f"tools eval: the dataset decoded {len(decoded)} masks that are not the "
             f"{len(written)} the tool wrote")
    with open(os.path.join(out_dir, "tools_eval", "results.csv")) as f:
        rows = f.read().strip().splitlines()
    header, values = rows[0].split(","), rows[1:]
    metrics = dict(zip(header[2:], (float(v) for v in values[0].split(",")[2:]))) if values else {}
    if len(values) != 1 or not metrics or not all(np.isfinite(v) for v in metrics.values()) \
            or set(metrics) != set(results):
        fail(f"tools eval: results.csv holds {rows}")
    return {"masks": n, "gen_mask_s": gen_s, "gen_mask_s_per_mask": gen_s / n,
            "eval_s": eval_s, "launches": launches, "results_csv": metrics,
            "masks_checked": len(decoded)}


def supervisor_times(stdout: str) -> dict:
    """The seconds the supervisor printed: each probe's and each child's."""
    return {"probe_s": [float(x) for x in re.findall(r"backend probe ok in ([\d.]+) s", stdout)],
            "child_s": [float(x) for x in re.findall(
                r"(?:after|child) ([\d.]+) s", stdout)]}


CHILD_MARKS = ("Creating train dataset", "Creating val dataset", "Building model",
               "Number of trainable parameters", "Resuming from", "Start training")


def child_splits(log: str, child_s: list) -> list:
    """Where each child's seconds went, from its log's timestamps: before its
    first line (the interpreter, imports, CUDA), from there to "Start
    training..." (data, model, resume), the iterations, and after its last
    iteration (saves, exit)."""
    stamp = re.compile(r"^(\d{4}-\d\d-\d\d \d\d:\d\d:\d\d),(\d{3}) \w+ [\w.]+: (.*)$")
    children = []
    for line in log.splitlines():
        m = stamp.match(line)
        if not m:
            continue
        t = time.mktime(time.strptime(m[1], "%Y-%m-%d %H:%M:%S")) + int(m[2]) / 1e3
        if m[3].startswith("Config:"):
            children.append({"first": t, "train": None, "iters": [], "last": t, "marks": {}})
        elif children:
            c = children[-1]
            c["last"] = t
            if m[3].startswith("Start training"):
                c["train"] = t
            elif m[3].startswith("Iter: "):
                c["iters"].append(t)
            for mark in CHILD_MARKS:
                if m[3].startswith(mark):
                    c["marks"][mark] = round(t - c["first"], 3)
    out = []
    for c, total in zip(children, child_s):
        if c["train"] is None or not c["iters"]:
            fail(f"supervisor: a child's log has no training lines: {c}")
        out.append({"before_log_s": total - (c["last"] - c["first"]),
                    "setup_s": c["train"] - c["first"],
                    "iterations_s": c["iters"][-1] - c["train"],
                    "after_iterations_s": c["last"] - c["iters"][-1],
                    "setup_marks_s": c["marks"]})
    return out


def tools_supervised_start(root: str) -> tuple:
    """16.2 started in the background: ``python -m
    maggie_tpu_torch.tools.train_supervisor`` training phase 7's set at phase
    7's batch for TOOLS_TRAIN_ITERS iterations with a fault injected at
    TOOLS_FAULT_ITER."""
    trainer_set(root)
    cmd = [sys.executable, "-m", "maggie_tpu_torch.tools.train_supervisor",
           "--config", "configs/maggie_image.yaml", "--backoff", "0.1", "--", *TOOLS_FLAGS,
           "output_dir", os.path.join(root, "out"), "name", "supervised",
           "dataset.train.root_dir", root, "dataset.train.split", "train",
           "dataset.test.root_dir", root, "dataset.test.split", "val",
           "train.batch_size", str(TRAIN_BATCH), "train.max_iter", str(TOOLS_TRAIN_ITERS),
           "train.ckpt_iter", "1", "train.val_iter", "1000", "train.log_iter", "1",
           *TOOLS_OPTS]
    env = dict(os.environ, MAGGIE_FAULT_INJECT_ITER=str(TOOLS_FAULT_ITER))
    t0 = time.perf_counter()
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env), t0


def tools_supervised_check(proc, t0: float, root: str) -> dict:
    """16.2's checks: one restart that resumes, each child's iterations logged
    with finite losses, the checkpoint at the last step."""
    try:
        stdout, stderr = proc.communicate(timeout=2 * TOOLS_CHILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"supervisor: no exit within {2 * TOOLS_CHILD_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    tail = f"\n{stdout[-3000:]}\n{stderr[-3000:]}"
    launches = [line for line in stdout.splitlines() if "] launch #" in line]
    if proc.returncode != 0 or len(launches) != 2:
        fail(f"supervisor: rc {proc.returncode}, {len(launches)} launches (want 0 and 2){tail}")
    if "train.resume_last" in launches[0] or not launches[1].endswith("train.resume_last True") \
            or f"fault injection at iter {TOOLS_FAULT_ITER}" not in stderr:
        fail(f"supervisor: the relaunch did not resume after the injected fault{tail}")
    run_dir = os.path.join(root, "out", "supervised")
    with open(os.path.join(run_dir, "log_rank0.log")) as f:
        log = f.read()
    first, _, second = log.partition(f"Resuming from iter {TOOLS_FAULT_ITER - 1}")
    logged = []
    for part in (first, second):
        logged.append([(int(m[1]), float(m[2])) for m in re.finditer(
            r"Iter: (\d+)/\d+, .*?total: ([-\w.]+)", part)])
    want = [list(range(1, TOOLS_FAULT_ITER)), list(range(TOOLS_FAULT_ITER, TOOLS_TRAIN_ITERS + 1))]
    if [[i for i, _ in part] for part in logged] != want or not all(
            np.isfinite(v) for part in logged for _, v in part):
        fail(f"supervisor: the children logged {logged}, want iterations {want} with finite "
             f"losses")
    with open(os.path.join(run_dir, "last_step.txt")) as f:
        last_step = int(f.read().strip())
    state_step = torch.load(os.path.join(run_dir, "last_state.pt"), map_location="cpu",
                            weights_only=True)["step"]
    if last_step != TOOLS_TRAIN_ITERS or state_step != TOOLS_TRAIN_ITERS:
        fail(f"supervisor: last_step.txt {last_step}, last_state.pt step {state_step}; "
             f"want {TOOLS_TRAIN_ITERS}")
    times = supervisor_times(stdout)
    if len(times["probe_s"]) != 2 or len(times["child_s"]) != 2:
        fail(f"supervisor: printed times {times}{tail}")
    return {"wall_s": wall, **times, "child_split": child_splits(log, times["child_s"]),
            "logged": logged, "restarts": 1, "last_step": last_step}


def phase_tools(detail) -> dict:
    """Phase 16: 16.2's supervised run starts in the background, 16.1 (the
    eval on generated masks) runs in this process meanwhile, then 16.2 is
    checked; returns 16.1's launches."""
    import tempfile
    out = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as train_root, tempfile.TemporaryDirectory() as root:
        proc, t_sup = tools_supervised_start(train_root)
        try:
            tools_eval_set(root)
            out["eval"] = tools_eval(root)
        finally:
            if "eval" not in out:   # 16.1 failed: stop the supervisor before leaving
                proc.kill()
                proc.communicate()
        out["supervised"] = tools_supervised_check(proc, t_sup, train_root)
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = out["eval"]["launches"]
    detail["tools"] = out
    e, s = out["eval"], out["supervised"]
    print(f"phase 16: gen_mask --variant full wrote {e['masks']} masks of {ENGINE_SRC[0]}x"
          f"{ENGINE_SRC[1]} in {e['gen_mask_s']:.3f} host s ({e['gen_mask_s_per_mask']:.4f} s a "
          f"mask); main --eval-only on them in {e['eval_s']:.3f} s, launches {e['launches']}, "
          f"the {e['masks_checked']} masks decoded equal to the tool's; results.csv "
          f"{e['results_csv']}", flush=True)
    print(f"phase 16: the supervisor restarted once after the fault at iteration "
          f"{TOOLS_FAULT_ITER} and resumed to {s['last_step']} in {s['wall_s']:.3f} s (16.1 ran "
          f"beside its start): children {s['child_s']} s, probes {s['probe_s']} s; each "
          f"child's split {s['child_split']}; logged (iteration, loss) {s['logged']}",
          flush=True)
    return out


def tools_only() -> int:
    """``--tools``: build the kernels, then phase 16; details to
    output/torch_port/chip_smoke_tools.json."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    detail = {}
    t0 = time.perf_counter()
    phase_tools(detail)
    print(f"phase 16 done in {time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_tools.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    return 0


# ---------------------------------------------------------------- phase 17
# the flagship's off-by-default alternatives (ROADMAP 14a-14c) at full width:
# s2d_stem and lazy_os2_shortcut build the default model; phase_rung and
# atten_stride 2 each with one f32 frame on the card against the port on the
# CPU (phase 3's checks), ms/frame in f32 and bf16 beside the default model
# timed in the same rounds, K1 and K2 launches a frame; the K1 call shapes
# the phase rung adds, by graph replay; one video window with lazy os2 and
# the phase rung through the feature cache against the CPU; one train step
# with atten_stride 2 against the CPU.
ALT_AS_DEFAULT = (
    ("s2d_stem", {"encoder_args": {"s2d_stem": True}}),
    ("lazy_os2_shortcut", {"encoder_args": {"lazy_os2_shortcut": True}}),
)
ALTERNATIVES = (
    ("default", {}),
    ("phase_rung", {"decoder_args": {"phase_rung": True}}),
    ("atten_stride_2", {"decoder_args": {"atten_stride": 2}}),
)
# K1 and K2 a frame (decoder_sparse.py): the phase rung gathers its hand-off
# buffer and fea1 at os1 halo 4 where the default gathers the lazy os1 input
# (lazy os1 is off with it)
ALT_PER_FRAME = {"default": (5, 3), "phase_rung": (6, 3), "atten_stride_2": (5, 3)}
ALT_ROUNDS, ALT_FRAMES = 3, 5  # timing: rounds over every model, CUDA-event windows of frames
# the K1 call shapes the phase rung adds at the bench condition: (name, map
# (N, H, W, C), block, halo, per-image index?, layout)
ALT_GATHER_CALLS = (
    ("phase_hand_off", (3, 288, 512, 32), 32, 2, False, "pixel"),
    ("phase_fea1", (1, 576, 1024, 32), 64, 4, True, "plane"),
)
ALT_COLD_BYTES = 200 * 2 ** 20  # the rotating copies of a map: 4x the card's 50 MB L2
ALT_VIDEO_HW = (256, 512)      # one 3-frame window: its CPU side stays short
ALT_VIDEO_FLAGS = {"encoder_args": {"lazy_os2_shortcut": True},
                   "decoder_args": {"phase_rung": True}}
ALT_VIDEO_PER_WINDOW = {"gather_patches": 6, "compute_unknown": 3}
ALT_TRAIN_FLAGS = {"decoder_args": {"atten_stride": 2}}
ALT_TRAIN_BATCH = 1            # at TRAIN_HW: the stride pools phase 6's 64x64 os8 map


def alt_as_default() -> dict:
    """The flags that the port takes and runs as the default model
    (``models/__init__.py``): each builds, from seed 0 on the CPU, the
    default's modules and weights."""
    from maggie_tpu_torch.flagship import flagship_cfg
    from maggie_tpu_torch.models import build_model

    def build(flags):
        return build_model(with_flags(flagship_cfg(), flags).model, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    default = build(None)
    want = default.state_dict()
    out = {}
    for name, flags in ALT_AS_DEFAULT:
        model = build(flags)
        got = model.state_dict()
        if (str(model) != str(default) or got.keys() != want.keys()
                or not all(torch.equal(got[k], want[k]) for k in want)):
            fail(f"alternative {name}: the model differs from the default's")
        out[name] = {"flags": flags, "default_model": True}
    return out


def alt_frame(name: str, flags: dict, dev, request: dict, batch: dict) -> dict:
    """One alternative's models (``build_models``), its launches on one f32
    frame on the card, and that frame against the CPU port (not for the
    default, which phase 3 checks). Returns the record with the card models
    under ``models``."""
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    cpu_model, model, bf16_model = build_models(dev, flags)
    torch.cuda.synchronize()
    kg.launches = ku.launches = 0
    with torch.inference_mode():
        card = model(batch)
    torch.cuda.synchronize()
    got = (kg.launches, ku.launches)
    if got != ALT_PER_FRAME[name]:
        fail(f"alternative {name}: K1, K2 launches a frame {got}, not {ALT_PER_FRAME[name]}")
    for k, v in card.items():
        if tuple(v.shape) != (1, 1, N_INST, H, W) or not bool(torch.isfinite(v).all()):
            fail(f"alternative {name}: {k} has shape {tuple(v.shape)} or non-finite values")
    out = {"flags": flags, "launches_per_frame": {"gather_patches": got[0],
                                                  "compute_unknown": got[1]},
           "models": (model, bf16_model)}
    if name == "default":
        return out
    t0 = time.perf_counter()
    with torch.inference_mode():
        cpu = cpu_model(request)
    out["cpu_forward_s"] = time.perf_counter() - t0
    near, n_diff, unexplained, region = detail_mask_check(card, cpu)
    err = (card["refined_masks"].cpu() - cpu["refined_masks"]).abs()[0, 0]
    outside = float(err[~region].max()) if bool((~region).any()) else 0.0
    out["cpu_check"] = {"near_threshold_pixels": near, "detail_mask_diff": n_diff,
                        "unexplained_diff": unexplained, "refined_max_abs_err": float(err.max()),
                        "refined_max_abs_err_outside_flips": outside,
                        "refined_mean_abs_err": float(err.mean()), "tolerance": REFINED_ATOL}
    if unexplained:
        fail(f"alternative {name}: detail_mask differs from the CPU port at {unexplained} "
             f"pixels not explained by {near} near-threshold alpha_os8 pixels")
    if outside > REFINED_ATOL:
        fail(f"alternative {name}: refined_masks differ from the CPU port by {outside}")
    return out


def alt_gathers(dev) -> list:
    """K1 at the alternatives' new call shapes: equal to its twin (f32 and
    bf16), then timed by graph replay with its byte bound, warm (``ms``: one
    map, which the L2 may hold) and cold (``cold_ms``: each call on the next
    of copies of the map that together fill ALT_COLD_BYTES)."""
    from maggie_tpu_torch.ops.kernels import gather as kg
    rows = []
    for i, (name, shape, block, halo, per_image, layout) in enumerate(ALT_GATHER_CALLS):
        idx = sample_indices(shape, block, per_image, dev, np.random.RandomState(17 + i))
        for dt in gather_dtypes(shape):
            feat = gather_map(shape, layout, dt, dev, seed=i)
            got = kg.gather_patches(feat, *idx, block, halo)
            if not torch.equal(got, kg.gather_patches_plain(feat, *idx, block, halo)):
                fail(f"gather {name} {dt}: kernel != plain twin")
        timed = gather_call_rows(name, shape, block, halo, per_image, layout, dev,
                                 np.random.RandomState(17 + i))
        for dt, row in timed.items():
            feat = gather_map(shape, layout, dt, dev)
            copies = [feat] + [gather_map(shape, layout, dt, dev) for _ in
                               range(-(-ALT_COLD_BYTES // (feat.numel() * feat.element_size())) - 1)]
            turn = itertools.cycle(copies)
            row["cold_ms"] = graph_ms(lambda: kg.gather_patches(next(turn), *idx, block, halo))
            row["cold_copies"] = len(copies)
            del copies, feat
        rows.extend({**r, "shape": list(shape), "block": block, "halo": halo, "equal": True}
                    for r in timed.values())
    return rows


def alt_video(dev) -> dict:
    """One 3-frame window of the video yaml with lazy os2 and the phase rung
    through ``encode_frames`` / ``decode_window`` on the card and on the CPU
    (phase 8's window check)."""
    from maggie_tpu_torch.config import load_config
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    from maggie_tpu_torch.utils.checkpoint import fold_spectral_norm
    cfg = with_flags(load_config(VIDEO_CONFIG), ALT_VIDEO_FLAGS)
    cpu_model = fold_spectral_norm(build_model(cfg.model, device="cpu",
                                               generator=torch.Generator().manual_seed(0)))
    model = copy.deepcopy(cpu_model).to(dev)
    video = video_stream(VIDEO_FRAMES, hw=ALT_VIDEO_HW)
    on_dev = {k: v.to(dev) for k, v in video.items()}
    with torch.inference_mode():
        pack = sorted(model.encode_frames({k: v[:, :1] for k, v in on_dev.items()}))
    if "x1" in pack or "fea2" not in pack or "inp" in pack or "fea1" not in pack:
        fail(f"video feature pack with lazy os2 and the phase rung holds {pack}")
    torch.cuda.synchronize()
    kg.launches = ku.launches = 0
    with torch.inference_mode(), ThresholdRecorder(1) as card_rec:
        card = stream_windows(model, on_dev, True, keep=(0,))
    torch.cuda.synchronize()
    launches = {"gather_patches": kg.launches, "compute_unknown": ku.launches}
    if launches != ALT_VIDEO_PER_WINDOW:
        fail(f"alternative video window: launches {launches}, not {ALT_VIDEO_PER_WINDOW}")
    t0 = time.perf_counter()
    with torch.inference_mode(), ThresholdRecorder(1) as cpu_rec:
        cpu = stream_windows(cpu_model, video, True, keep=(0,))
    cpu_s = time.perf_counter() - t0
    c = video_window_check(card[0], cpu[0], card_rec.records[0], cpu_rec.records[0])
    c.pop("frame1_flips")
    if video_window_failures(c):
        fail(f"alternative video window vs the CPU port: "
             f"{'; '.join(video_window_failures(c))}: {c}")
    return {"flags": ALT_VIDEO_FLAGS, "hw": list(ALT_VIDEO_HW), "pack": pack,
            "launches": launches, "cpu_window_s": cpu_s, "cpu_check": c}


def phase_alternatives(dev, detail) -> dict:
    """Phase 17; returns the launches of its card work by kernel."""
    from maggie_tpu_torch.flagship import blob_batch
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    t0 = time.perf_counter()
    request = blob_batch(H, W, N_INST, 0)
    batch = {k: v.to(dev) for k, v in request.items()}
    out, launches = {"models": {}}, {"gather_patches": 0, "gather_patches_bwd": 0,
                                      "compute_unknown": 0}
    out["as_default"] = alt_as_default()
    for name, flags in ALTERNATIVES:
        out["models"][name] = alt_frame(name, flags, dev, request, batch)
        for k, v in out["models"][name]["launches_per_frame"].items():
            launches[k] += v
    # timing: every model in each round, so that the host's drift falls on all
    windows = {(n, p): [] for n, _ in ALTERNATIVES for p in ("fp32", "bf16")}
    with torch.inference_mode():
        for r in range(ALT_ROUNDS):
            for name, _ in ALTERNATIVES:
                for prec, m in zip(("fp32", "bf16"), out["models"][name]["models"]):
                    windows[name, prec].append(
                        cuda_ms(lambda: m(batch), iters=ALT_FRAMES, warmup=2 if not r else 1))
    for name, _ in ALTERNATIVES:
        rec = out["models"][name]
        del rec["models"]
        rec["timing"] = {p: {"ms_per_frame_median": float(np.median(windows[name, p])),
                             "windows_ms": windows[name, p]} for p in ("fp32", "bf16")}
    torch.cuda.empty_cache()
    out["gathers"] = alt_gathers(dev)
    kg.launches = ku.launches = 0       # the comparisons' launches above are not the path's
    out["video"] = alt_video(dev)
    for k, v in out["video"]["launches"].items():
        launches[k] += v
    kg.launches = kg.bwd_launches = ku.launches = 0
    step = card_vs_cpu_step(dev, ALT_TRAIN_FLAGS, ALT_TRAIN_BATCH, TRAIN_HW)
    step["launches"] = {"gather_patches": kg.launches, "gather_patches_bwd": kg.bwd_launches,
                        "compute_unknown": ku.launches}
    step["flags"] = ALT_TRAIN_FLAGS
    out["train_check"] = step
    if not step["within"]:
        fail(f"alternative train step on the card differs from the CPU port: {step}")
    if step["launches"] != {"gather_patches": 10, "gather_patches_bwd": 6, "compute_unknown": 1}:
        fail(f"alternative train step: launches {step['launches']}")
    for k, v in step["launches"].items():
        launches[k] += v
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    detail["alternatives"] = out
    base = out["models"]["default"]["timing"]
    for name, _ in ALT_AS_DEFAULT:
        print(f"phase 17: {name}: builds the default model (its modules and seed-0 weights), "
              f"so the default's numbers below are its own", flush=True)
    for name, _ in ALTERNATIVES:
        rec = out["models"][name]
        t = rec["timing"]
        check = rec.get("cpu_check")
        print(f"phase 17: {name}: f32 {t['fp32']['ms_per_frame_median']:.3f} ms/frame "
              f"(default {base['fp32']['ms_per_frame_median']:.3f}), bf16 "
              f"{t['bf16']['ms_per_frame_median']:.3f} (default "
              f"{base['bf16']['ms_per_frame_median']:.3f}); K1, K2 a frame "
              f"{rec['launches_per_frame']['gather_patches']}, "
              f"{rec['launches_per_frame']['compute_unknown']}"
              + ("" if check is None else
                 f"; CPU check: detail_mask diff {check['detail_mask_diff']} px "
                 f"({check['near_threshold_pixels']} near-threshold), refined max |err| "
                 f"{check['refined_max_abs_err_outside_flips']:.3g}, CPU forward "
                 f"{rec['cpu_forward_s']:.1f} s"), flush=True)
    for r in out["gathers"]:
        print(f"phase 17: K1 {r['call']} {r['dtype']} {r['layout']} {r['shape']} ({r['block']}, "
              f"{r['halo']}): kernel {r['ms'] * 1e3:.2f} us, over {r['cold_copies']} rotating "
              f"copies {r['cold_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us, "
              f"plain {r['plain_ms'] * 1e3:.2f} us, library {r['library_ms'] * 1e3:.2f} us",
              flush=True)
    v = out["video"]
    c = v["cpu_check"]
    print(f"phase 17: video window ({VIDEO_CONFIG}, lazy os2 + phase rung, {ALT_VIDEO_HW[0]}x"
          f"{ALT_VIDEO_HW[1]}; pack {v['pack']}): launches {v['launches']}; vs the CPU port "
          f"refined max |err| outside the region {c['refined_max_abs_err_outside_flips']:.3g}, "
          f"flips {c['refined_flips']}, detail_mask diff {c['detail_mask_diff']} px; CPU window "
          f"{v['cpu_window_s']:.1f} s", flush=True)
    print(f"phase 17: train step with atten_stride 2 ({step['size']}), card vs CPU: "
          f"loss terms max rel {step['loss_max_rel']:.3g}, gradients rel L2 "
          f"{step['grad_rel_l2']:.3g}, params max |d| {step['param_max_abs']:.3g}, BN stats max "
          f"|d| {step['batch_stats_max_abs']:.3g}; launches {step['launches']}; CPU step "
          f"{step['cpu_step_s']:.1f} s", flush=True)
    print(f"phase 17 done in {out['wall_s']:.1f} s; launches {launches}", flush=True)
    return launches


def alternatives_only(dev) -> int:
    """``--alternatives``: build the kernels, then phase 17; details to
    output/torch_port/chip_smoke_alternatives.json."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    build.build_all()
    detail = {}
    phase_alternatives(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_alternatives.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    return 0


# ---------------------------------------------------------------- phase 19
# The block-capacity studies (maggie_tpu_torch/tools/), shortened for the
# script's time limit: cap_quality on STUDY_SCENES procedural scenes at the
# bench frame's size (K2 once a scene), train_curve's two ladders and
# train_long's condition (bf16, selective remat, cap 0.5, a check on 8
# held-out scenes every STUDY_VAL_EVERY) for STUDY_ITERS iterations each at
# STUDY_SIZE, the studies' model (attention and final width 32) from seed 0.
# The CPU halves (cap_quality's first STUDY_CPU_SCENES scenes, each
# ladder's first STUDY_CHECK_ITERS iterations) run beside 11.3's CLI
# processes (``--studies``: beside the kernel build).
STUDY_SCENES = 10
STUDY_HW = (576, 1024)
STUDY_CPU_SCENES = 2
STUDY_ITERS = 20
STUDY_SIZE = 192
STUDY_CHECK_ITERS = 2
STUDY_VAL_EVERY = 10
STUDY_CAP = 0.5
# launches a step by ladder: the dense oracle ladder gathers nothing and K2
# makes its uncertainty map; train_long's selective step recomputes every
# stage (remat_per_step), and its check is the eval forward (K1 5, K2 3 a scene)
STUDY_PER_STEP = {"block": PER_ITER,
                  "oracle": {"gather_patches": 0, "gather_patches_bwd": 0, "compute_unknown": 1}}


def study_cpu() -> dict:
    """The studies' CPU halves: cap_quality's first scenes and each ladder's
    first iterations on the CPU port (plain twins)."""
    from maggie_tpu_torch.tools import cap_quality, train_curve
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    out = {"cap_quality": cap_quality.run(STUDY_CPU_SCENES, *STUDY_HW, cpu), "curve": {}}
    for mode in ("oracle", "block"):
        record = out["curve"][mode] = {}
        train_curve.run(mode, STUDY_CHECK_ITERS, STUDY_SIZE, STUDY_SIZE, STUDY_CAP, cpu, record)
    out["seconds"] = time.perf_counter() - t0
    return out


def study_spec() -> tuple:
    """The ``cpu_steps_meanwhile`` spec of the studies' CPU halves."""
    return ("studies",), study_cpu


def study_losses_check(card: list, cpu: list, label: str) -> float:
    """The first iterations' loss terms on the card against the CPU port's
    within STEP_LOSS_RTOL above STEP_LOSS_ATOL; the largest reading."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(card, cpu)):
        for k, v in b.items():
            worst = max(worst, abs(a[k] - v) / max(abs(v), STEP_LOSS_ATOL / STEP_LOSS_RTOL))
        if worst > STEP_LOSS_RTOL:
            fail(f"phase 19 {label}: iteration {i}'s loss terms differ from the CPU port's by "
                 f"{worst:.3g} relative (limit {STEP_LOSS_RTOL}): {a} vs {b}")
    return worst


def phase_studies(dev, detail) -> dict:
    """Phase 19: 19.1 cap_quality, 19.2 train_curve, 19.3 train_long on the
    card through the tools' own functions, every kernel launch's geometry
    recorded (``kernel_calls``); 19.4 each recorded geometry against the
    plain twins (``recorded_kernel_checks``). Returns each kernel's launches
    over 19.1-19.3."""
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    from maggie_tpu_torch.tools import cap_quality, train_curve, train_long
    t0 = time.perf_counter()
    cpu = computed(*study_spec())
    out, total = {"cpu_halves_s": cpu["seconds"]}, dict.fromkeys(PER_ITER, 0)
    calls = {"gather": {}, "gather_bwd": {}, "unknown": {}}

    def counted(fn):
        torch.cuda.synchronize()
        kg.launches = kg.bwd_launches = ku.launches = 0
        t = time.perf_counter()
        with kernel_calls() as seen:
            res = fn()
            torch.cuda.synchronize()
        counts = kernel_counts()
        for k in total:
            total[k] += counts[k]
        for kind, geometries in seen.items():
            for key, idx in geometries.items():
                calls[kind].setdefault(key, idx)
        return res, counts, time.perf_counter() - t

    # 19.1
    res, counts, secs = counted(lambda: cap_quality.run(STUDY_SCENES, *STUDY_HW, dev))
    if counts != {"gather_patches": 0, "gather_patches_bwd": 0, "compute_unknown": STUDY_SCENES}:
        fail(f"phase 19.1 cap_quality: launches {counts}, not K2 once a scene x {STUDY_SCENES}")
    c = cpu["cap_quality"]
    n = STUDY_CPU_SCENES
    if not (np.array_equal(res["drops"][:n], c["drops"]) and res["actives"][:n] == c["actives"]):
        fail(f"phase 19.1 cap_quality: scenes 0-{n - 1} differ from the CPU port: "
             f"{res['drops'][:n].tolist()} {res['actives'][:n]} vs {c['drops'].tolist()} "
             f"{c['actives']}")
    checks = {"unknown": []}
    for n_i in (2, 4):   # K2 at each scene's shape against its twin
        seed = next(s for s in range(100) if np.random.RandomState(s).randint(2, 5) == n_i)
        a = torch.from_numpy(cap_quality.procedural_alpha(seed, *STUDY_HW)).to(dev)[None]
        check_unknown(a, 30, f"cap_quality scene {seed}", checks, {"unknown": 0.0})
    table = cap_quality.table(res, STUDY_SCENES, *STUDY_HW)
    out["cap_quality"] = {"launches": counts, "seconds": secs, "table": table,
                          "drops": res["drops"].tolist(), "actives": res["actives"],
                          "alpha_host_s": res["alpha_s"],
                          "alpha_host_s_median": float(np.median(res["alpha_s"])),
                          "k2_checks": checks["unknown"]}
    print(f"phase 19.1: cap_quality {STUDY_SCENES} scenes at {STUDY_HW[0]}x{STUDY_HW[1]} in "
          f"{secs:.1f} s (procedural_alpha {out['cap_quality']['alpha_host_s_median']:.4f} host "
          f"s a scene, median); launches {counts}; scenes 0-{n - 1} equal to the CPU port; K2 "
          f"equal to its twin at n_i 2 and 4", flush=True)
    for line in table.splitlines():
        print("  " + line, flush=True)
    # 19.2
    out["curve"] = {}
    for mode in ("oracle", "block"):
        record = {}
        losses, counts, secs = counted(lambda: train_curve.run(
            mode, STUDY_ITERS, STUDY_SIZE, STUDY_SIZE, STUDY_CAP, dev, record))
        want = {k: v * STUDY_ITERS for k, v in STUDY_PER_STEP[mode].items()}
        if counts != want:
            fail(f"phase 19.2 train_curve {mode}: launches {counts}, not {want}")
        if not np.all(np.isfinite(losses)):
            fail(f"phase 19.2 train_curve {mode}: non-finite losses {losses}")
        worst = study_losses_check(record["loss_dicts"], cpu["curve"][mode]["loss_dicts"],
                                   f"train_curve {mode}")
        out["curve"][mode] = {"losses": losses, "launches": counts, "seconds": secs,
                              "ms_per_step": [1e3 * t for t in record["seconds"]],
                              "ms_per_step_median": 1e3 * float(np.median(record["seconds"][1:])),
                              "cpu_loss_max_rel": worst}
        print(f"phase 19.2: train_curve {mode} {STUDY_ITERS} iterations at {STUDY_SIZE}x"
              f"{STUDY_SIZE} in {secs:.1f} s: {out['curve'][mode]['ms_per_step_median']:.3f} "
              f"ms/step (median of 2-{STUDY_ITERS}), launches a step "
              f"{STUDY_PER_STEP[mode]}, loss {losses[0]:.4f} -> {losses[-1]:.4f}; the first "
              f"{STUDY_CHECK_ITERS} iterations' loss terms within {worst:.3g} of the CPU port's",
              flush=True)
    # 19.3
    record = {}
    res, counts, secs = counted(lambda: train_long.run(STUDY_ITERS, STUDY_SIZE,
                                                       STUDY_VAL_EVERY, dev, record))
    val_counts = record["val_launches"]
    n_val = len(val_counts)
    per_val = {k: v * train_long.VAL_SCENES for k, v in PER_VAL_FRAME.items()}
    steps = {k: counts[k] - sum(v[k] for v in val_counts) for k in counts}
    want = {k: v * STUDY_ITERS for k, v in remat_per_step("selective").items()}
    if steps != want or any(v != per_val for v in val_counts):
        fail(f"phase 19.3 train_long: launches {steps} in the steps (not {want}) and "
             f"{val_counts} in the checks (not {per_val} each)")
    if len(res["losses"]) != STUDY_ITERS or not np.all(np.isfinite(res["losses"])):
        fail(f"phase 19.3 train_long: losses {res['losses']}")
    out["long"] = dict(res, launches=counts, seconds=secs,
                       ms_per_step=[1e3 * t for t in record["seconds"]],
                       ms_per_step_median=1e3 * float(np.median(record["seconds"][1:])),
                       val_seconds=record["val_seconds"])
    print(f"phase 19.3: train_long (bf16, selective, cap {STUDY_CAP}) {STUDY_ITERS} iterations "
          f"at {STUDY_SIZE}x{STUDY_SIZE} in {secs:.1f} s: {out['long']['ms_per_step_median']:.3f} "
          f"ms/step (median of 2-{STUDY_ITERS}), launches a step "
          f"{remat_per_step('selective')} and a check scene {PER_VAL_FRAME}; loss "
          f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}; val MADx1e3 "
          f"{[round(v['MADx1e3'], 2) for v in res['val']]} over {n_val} checks "
          f"({[round(t, 2) for t in record['val_seconds']]} s)", flush=True)
    # 19.4
    t = time.perf_counter()
    out["kernel_checks"] = recorded_kernel_checks(calls, dev, "19")
    geometries = {k: len(v) for k, v in calls.items()}
    out["kernel_checks"]["geometries"], out["kernel_checks"]["seconds"] = (
        geometries, time.perf_counter() - t)
    print(f"phase 19.4: every geometry of 19.1-19.3's launches ({geometries} K1 / its backward "
          f"/ K2 geometries, train and check, f32 and bf16) equal to the plain twins "
          f"({out['kernel_checks']['seconds']:.1f} s)", flush=True)
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t0
    detail["studies"] = out
    print(f"phase 19: done in {out['phase_s']:.1f} s; launches {total} (the CPU halves "
          f"{cpu['seconds']:.1f} s, computed beforehand)", flush=True)
    return total


def studies_only(dev) -> int:
    """``--studies``: build the kernels with phase 19's CPU halves beside
    the build, then phase 19; details to
    output/torch_port/chip_smoke_studies.json."""
    from maggie_tpu_torch.ops.kernels import build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("card: " + subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                     "--format=csv,noheader"], capture_output=True,
                                    text=True, check=True).stdout.strip(), flush=True)
    cpu_steps_meanwhile([study_spec()], build.build_all)
    detail = {}
    phase_studies(dev, detail)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_studies.json"), "w") as f:
        json.dump(detail, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
