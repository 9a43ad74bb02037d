"""Drive the PyTorch/CUDA port of MaGGIe on one NVIDIA GPU, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --outputs PATH [--against REF]
    python3 chip_smoke.py --gather-bwd
    python3 chip_smoke.py --video

The second form only answers requests 0 and 1 in f32 and bf16 and saves the
outputs to PATH; with REF, saved by the same form from another version, it
exits non-zero unless every output is equal bit for bit. The third runs only
K1's backward: its checks of phase 2 and its timing of phase 6.3 (run it in a
copy of another version to compare the two in one call). The fourth runs the
video path only: phase 2's video shapes and phase 8.

Phases (any failure exits non-zero):
1. print the card's name and power limit; build the CUDA kernels from the
   sources in this checkout (one nvcc per source, in parallel);
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
5. the eval engine on the card: an HIM-style set of 4 frames at 720x1280
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
   then 60 f32 iterations logging every 10 without validation (long enough to
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
   random weights, SN folded: one synthetic video of 10 frames at 576x1024
   (3 blob instances that move a few pixels a frame) streamed in 8 windows of
   3 frames with the feature cache (``encode_frames`` on the new frame,
   ``decode_window`` on the rolled pack) in f32, TF32 off; checks 5 K1 and 3
   K2 launches and one encoded frame per window after the first, and holds
   windows 0 and 1 against the CPU port within phase 3's budget (flips only
   where a value lies near a threshold of the path, at most 16 of them;
   detail_mask equal outside K2's reach of such values); times ms per
   window cached and uncached in f32 and bf16 (CUDA events, host launch cost
   included) and prints peak memory. Then the video eval engine:
   ``maggie_tpu_torch.main.main`` with ``--eval-only --config
   configs/maggie_video.yaml`` on a synthetic VIM set written with PIL (2
   videos of 6 frames at 720x1280, 3 instances, JPEG frames, PNG alphas and
   masks) at full width with the seven metrics; checks the run's launches
   (counted from 0) and those of each window, finite metrics and
   results.csv; prints frames/s with metrics on, the forward / loader / host
   split per window and MESSDdt's host seconds.
   Phase 2 holds K1 and K2 at the video path's shapes too.

Prints a ``{"kernels": [...]}`` line and the card line, and last
``{"ok": true, "device": {...}}``. Details go to output/torch_port/chip_smoke.json.
"""

from __future__ import annotations

import copy
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
N_REQUESTS = 8
SPLIT_FRAMES = 10             # frames per stage split and per profiled window
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
ENGINE_FRAMES = 4
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


def train_indices(shape, block, per_image, dev, rs):
    """TRAIN_CAP entries over the train maps' 8x8 block grid, as select_blocks
    gives them: distinct (map, by, bx) tiles in random order; per-image calls
    index with n // TRAIN_SLOTS (up to 10 entries per tile). A map with fewer
    tiles than TRAIN_CAP gets them all, then entries repeating tile 0, as
    select_blocks pads a capacity past the tile count."""
    nb = TRAIN_HW // 64
    assert shape[1] // block == nb and shape[2] // block == nb, (shape, block)
    maps = shape[0] * (TRAIN_SLOTS if per_image else 1)
    tiles = rs.permutation(maps * nb * nb)[:TRAIN_CAP]
    tiles = np.concatenate([tiles, np.zeros(TRAIN_CAP - len(tiles), np.int64)])
    idx_n = tiles // (nb * nb) // (TRAIN_SLOTS if per_image else 1)
    rem = tiles % (nb * nb)
    return [torch.from_numpy(a.astype(np.int64)).to(dev) for a in (idx_n, rem // nb, rem % nb)]


def train_gather_cases():
    """(name, shape, block, halo, per_image, layout, differentiable) at every
    train call; each differentiable per-instance call also on an 8-map copy,
    whose 512 tiles the 640 entries overflow."""
    for name, shape, block, halo, per_image, layout, grad in TRAIN_GATHER_CALLS:
        yield name, shape, block, halo, per_image, layout, grad
        if grad and not per_image:
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


def check_train_gathers(dev, rs, out, worst) -> None:
    """The train path: K1's forward at every train call, and its backward (bit
    for bit: the twin sums in the kernel's order) at every differentiable one,
    with the twin's strides. Appends to ``out`` and ``worst``."""
    from maggie_tpu_torch.ops.kernels import gather as kg
    out.setdefault("gather", [])
    out["gather_bwd"] = []
    worst["gather_bwd"] = 0.0
    gen = torch.Generator(device=dev).manual_seed(1)
    for name, shape, block, halo, per_image, layout, grad in train_gather_cases():
        idx = train_indices(shape, block, per_image, dev, rs)
        for dt in gather_dtypes(shape):
            feat = gather_map(shape, layout, dt, dev)
            got = kg.gather_patches(feat, *idx, block, halo)
            ref = kg.gather_patches_plain(feat, *idx, block, halo)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"gather train {name} {dt}: kernel != plain twin "
                     f"(max |diff| {float((got.float() - ref.float()).abs().max())})")
            out["gather"].append({"call": "train_" + name, "dtype": str(dt), "shape": list(shape),
                                  "layout": layout, "out": list(got.shape), "equal": True})
            if not grad:
                continue
            g = torch.randn(got.shape, device=dev, generator=gen).to(dt)
            check_bwd(name, g, idx, shape, block, halo, layout, out, worst)
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
    check_bwd_edges(dev, out, worst)

    check_video_unknown(dev, out, worst)
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


def build_models(dev):
    """The flagship model from seed 0 with SN folded: on the CPU, its copy on
    ``dev`` in f32, and the bf16 model on ``dev`` with the same weights."""
    from maggie_tpu_torch.flagship import flagship_cfg
    from maggie_tpu_torch.models import build_model
    from maggie_tpu_torch.utils.checkpoint import fold_spectral_norm
    cpu_model = build_model(flagship_cfg().model, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    fold_spectral_norm(cpu_model)
    bf16_model = build_model(flagship_cfg("bf16").model, device="cpu")
    fold_spectral_norm(bf16_model)
    bf16_model.load_state_dict(cpu_model.state_dict())
    return cpu_model, copy.deepcopy(cpu_model).to(dev), bf16_model.to(dev)


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
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs an NVIDIA GPU")
    if "--outputs" in sys.argv:
        args = sys.argv[1:]
        against = args[args.index("--against") + 1] if "--against" in args else None
        return forward_outputs(args[args.index("--outputs") + 1], against)
    if "--video" in sys.argv:
        return video_only(torch.device("cuda"))
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

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    build.build_all()
    detail["build_s"] = time.perf_counter() - t0
    print(f"phase 1: kernels built in {detail['build_s']:.1f} s", flush=True)

    # ---- phase 2: kernels vs plain twins ----
    worst = phase_kernels(dev, detail)
    print(f"phase 2: kernels equal to their plain twins at every main-path shape "
          f"({len(detail['kernel_checks']['gather'])} gather, "
          f"{len(detail['kernel_checks']['gather_bwd'])} gather backward, "
          f"{len(detail['kernel_checks']['unknown'])} compute_unknown cases)", flush=True)

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

    # ---- phase 5: the eval engine ----
    engine = phase_engine(cpu_model, model, bf16_model, detail)
    for kern in kernels:
        kern["engine_launches"] = engine["launches"][kern["name"]]

    # ---- phase 6: the train step ----
    kernels.append(phase_train(dev, worst, detail))
    for kern in kernels[:2]:
        kern["train_launches"] = detail["train"]["fp32"]["launches"][kern["name"]]

    # ---- phase 7: the trainer through the CLI ----
    trainer = phase_trainer(detail)
    for kern in kernels:
        kern["trainer_launches"] = trainer["launches"][kern["name"]]

    # ---- phase 8: the video model and the video eval engine ----
    video = phase_video(dev, detail)
    for kern in kernels[:2]:
        kern["video_launches"] = video["model"]["launches"][kern["name"]]
        kern["video_engine_launches"] = video["engine"]["launches"][kern["name"]]

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(detail, f, indent=1)
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
# step sets the pace (60 until phase 8 came, which needed the time)
SUSTAINED_ITERS = 30
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
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    return {"gather_patches": kg.launches, "gather_patches_bwd": kg.bwd_launches,
            "compute_unknown": ku.launches}


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
    make, evaluate, save_npz, metrics = (tr.make_train_step, tr.eval_image,
                                         ck.save_variables_npz, eng.compute_metrics)
    frames = []

    def counted_make(model, optimizer, schedule):
        step = make(model, optimizer, schedule)

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

    def counted_eval(*a, **kw):
        before, n0 = kernel_counts(), len(frames)
        out = evaluate(*a, **kw)
        vals.append({"frames": len(frames) - n0,
                     **{k: v - before[k] for k, v in kernel_counts().items()}})
        return out

    def counted_metrics(*a, **kw):
        frames.append(1)
        return metrics(*a, **kw)

    def keep_best(path, model):
        record["best_model"] = copy.deepcopy(model).eval()
        save_npz(path, model)
    tr.make_train_step, tr.eval_image, ck.save_variables_npz, eng.compute_metrics = (
        counted_make, counted_eval, keep_best, counted_metrics)
    try:
        torch.cuda.synchronize()
        before = kernel_counts()
        t0 = time.perf_counter()
        state = cli.main(args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v - before[k] for k, v in kernel_counts().items()}
    finally:
        tr.make_train_step, tr.eval_image, ck.save_variables_npz, eng.compute_metrics = (
            make, evaluate, save_npz, metrics)
    return {"state_step": state.step, "wall_s": wall, "steps": steps, "vals": vals,
            "launches": launches, "start": start}


def check_trainer_run(name: str, run: dict, out_dir: str, n_steps: int, n_vals: int,
                      log_iter: int = 1, files=CKPT_FILES, first_iter: int = 0) -> dict:
    """Launches per iteration and per val frame, the run's own logged
    iterations (those after ``first_iter``, where it started) with finite
    losses, the files; returns the run's meters and log numbers."""
    if len(run["steps"]) != n_steps or len(run["vals"]) != n_vals:
        fail(f"trainer {name}: {len(run['steps'])} iterations and {len(run['vals'])} "
             f"validations, not {n_steps} and {n_vals}")
    for i, c in enumerate(run["steps"]):
        if c != PER_ITER:
            fail(f"trainer {name}: iteration {i + 1} launched {c}, not {PER_ITER}")
    for v in run["vals"]:
        want = {k: n * v["frames"] for k, n in PER_VAL_FRAME.items()}
        if v["frames"] != TRAINER_VAL_FRAMES or {k: v[k] for k in want} != want:
            fail(f"trainer {name}: a validation launched {v}, not {PER_VAL_FRAME} per frame "
                 f"over {TRAINER_VAL_FRAMES} frames")
    total = {k: n_steps * PER_ITER[k] + n_vals * TRAINER_VAL_FRAMES * PER_VAL_FRAME[k]
             for k in PER_ITER}
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


def host_cost_by_transform(cfg) -> dict:
    """Host ms of one train sample by transform, mean over the train frames
    (each drawn once), with the transition band and the rest of the sample;
    only this thread's calls count."""
    from maggie_tpu_torch.data import build_dataset
    import maggie_tpu_torch.data.him as him
    ds = build_dataset(cfg, is_train=True, random_seed=0)
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
    transition = him.gen_transition_gt
    him.gen_transition_gt = timed("transition_gt", transition)
    try:
        t0 = time.perf_counter()
        for i in range(len(ds)):
            ds[i]
        total = (time.perf_counter() - t0) * 1e3
    finally:
        him.gen_transition_gt = transition
    out = {k: v / len(ds) for k, v in ms.items()}
    out["rest"] = total / len(ds) - sum(out.values())
    out["total"] = total / len(ds)
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


def one_step(model, batch, generator, cfg) -> dict:
    """One ``make_train_step`` step of ``model`` (train mode) from a fresh
    optimizer: the loss dict, every gradient before the clip, the learning
    rate, and the parameters, BatchNorm statistics and spectral u/v after."""
    from maggie_tpu_torch.engine import train_step as ts
    from maggie_tpu_torch.engine.optim import build_optimizer
    model.train()
    opt, schedule = build_optimizer(cfg, model.parameters())
    state = ts.TrainState(model, opt)
    step = ts.make_train_step(model, opt, schedule)
    grads, clip = [], ts.clip_by_global_norm_

    def keep(gs, *args, **kwargs):   # the gradients as the clip receives them
        grads.extend(g.detach().float().cpu().clone() for g in gs)
        return clip(gs, *args, **kwargs)
    ts.clip_by_global_norm_ = keep
    try:
        losses = step(state, batch, generator, **TRAIN_FLAGS)
    finally:
        ts.clip_by_global_norm_ = clip
    cpu = lambda d: {k: v.detach().float().cpu() for k, v in d.items()}
    return {"losses": {k: float(v) for k, v in losses.items()}, "lr": schedule(0),
            "grads": dict(zip((k for k, _ in model.named_parameters()), grads)),
            "params": cpu(state.params()), "batch_stats": cpu(state.batch_stats()),
            "spectral": cpu(state.spectral())}


def compare_steps(a: dict, b: dict) -> dict:
    """The largest differences between two ``one_step`` results, and whether
    each is within its STEP_* limit."""
    loss = max(abs(a["losses"][k] - v) / max(abs(v), STEP_LOSS_ATOL / STEP_LOSS_RTOL)
               for k, v in b["losses"].items())
    num = sum(float(((a["grads"][k] - g).double() ** 2).sum()) for k, g in b["grads"].items())
    den = sum(float((g.double() ** 2).sum()) for g in b["grads"].values())
    d = {k: (a["params"][k] - v).abs() for k, v in b["params"].items()}
    n_far = sum(int((v > 1e-6).sum()) for v in d.values())
    out = {"loss_max_rel": loss, "grad_rel_l2": (num / den) ** 0.5,
           "param_max_abs": max(float(v.max()) for v in d.values()),
           "param_far_share": n_far / sum(v.numel() for v in d.values()),
           "batch_stats_max_abs": max(float((a["batch_stats"][k] - v).abs().max())
                                      for k, v in b["batch_stats"].items()),
           "spectral_max_abs": max(float((a["spectral"][k] - v).abs().max())
                                   for k, v in b["spectral"].items())}
    out["within"] = (loss <= STEP_LOSS_RTOL and out["grad_rel_l2"] <= STEP_GRAD_REL_L2
                     and out["param_max_abs"] <= 2 * b["lr"] + 1e-6
                     and out["param_far_share"] <= STEP_PARAM_FAR_SHARE
                     and out["batch_stats_max_abs"] <= STEP_STATS_ATOL
                     and out["spectral_max_abs"] <= STEP_SN_ATOL)
    return out


def card_vs_cpu_step(dev) -> dict:
    """Phase 6.1: one f32 step of the full-width model (seed 0) on the card and
    on the CPU (plain twins) on the same reduced batch, the random draws
    (dropout, dilation widths) from CPU generators of one seed on both sides."""
    from maggie_tpu_torch.flagship import flagship_cfg, train_batch
    from maggie_tpu_torch.models import build_model
    cfg = flagship_cfg()
    cpu_model = build_model(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).to(dev)
    batch = train_batch(REDUCED_BATCH, REDUCED_HW, REDUCED_HW, TRAIN_SLOTS, seed=1)
    t0 = time.perf_counter()
    cpu = one_step(cpu_model, batch, torch.Generator().manual_seed(3), cfg)
    cpu_s = time.perf_counter() - t0
    card = one_step(card_model, {k: v.to(dev) for k, v in batch.items()},
                    torch.Generator().manual_seed(3), cfg)
    out = compare_steps(card, cpu)
    out.update(cpu_step_s=cpu_s, size=f"batch {REDUCED_BATCH}, {REDUCED_HW}x{REDUCED_HW}, "
               f"{TRAIN_SLOTS} slots", losses_card=card["losses"], losses_cpu=cpu["losses"])
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
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(2):
            step(state, batch, gen, **TRAIN_FLAGS)
        torch.cuda.synchronize()
    launched = {k: v - before[k] for k, v in counts().items()}
    split = dict.fromkeys(KERNEL_NAMES, 0.0)
    total = 0.0
    for e in prof.key_averages():
        if e.key.startswith(("aten::", "cuda")):
            continue
        us = device_us(e)
        total += us
        for k, subs in KERNEL_NAMES.items():
            if any(sub in e.key for sub in subs):
                split[k] += us
    for k, n in launched.items():
        if n and split[k] <= 0.0:
            fail(f"profiled train steps: {k} launched {n} times but no device time was found "
                 f"under {KERNEL_NAMES[k]}")
    kernel_ms = total / 1e3 / 2
    return {"kernel_ms_per_step": kernel_ms, "busy_share": kernel_ms / step_ms,
            "ported_kernels_ms_per_step": {k: v / 1e3 / 2 for k, v in split.items()}}


def bwd_split_ms(fn, reps: int = 10) -> dict:
    """Device ms per launch of K1 backward's index pass and of its pull, by
    their CUDA function names under torch.profiler over ``reps`` eager calls:
    each name's device time over the launches the profiler recorded under it
    (after earlier profilers in one process it may record fewer than
    ``reps``). Fails if either name recorded none."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    names = dict(zip(("index_ms", "pull_ms"), KERNEL_NAMES["gather_patches_bwd"]))
    us, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in prof.key_averages():
        for k, name in names.items():
            if name in e.key and not e.key.startswith(("aten::", "cuda")):
                us[k] += device_us(e)
                count[k] += e.count
    if min(count.values()) == 0 or min(us.values()) <= 0.0:
        fail(f"K1 backward: no device time under {tuple(names.values())}: {us} over {count}")
    return {k: us[k] / 1e3 / count[k] for k in names}


def time_gather_bwd(dev, detail) -> dict:
    """Phase 6.3: K1's backward per call at the train shapes, f32 and bf16, by
    CUDA-graph replay, split into its index pass and pull (device time by
    name, torch.profiler over eager calls), beside its byte bound (each
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
    for name, shape, block, halo, per_image, layout, grad in TRAIN_GATHER_CALLS:
        if not grad:
            continue
        n, h, w, c = shape
        idx = train_indices(shape, block, per_image, dev, rs)
        size = block + 2 * halo
        ar = torch.arange(size, device=dev)
        ii = (idx[0][:, None, None], ((idx[1] * block)[:, None] + ar)[:, :, None],
              ((idx[2] * block)[:, None] + ar)[:, None, :])
        plane = layout == "plane"
        for frame, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            g = torch.randn((TRAIN_CAP, size, size, c), device=dev).to(dt)
            padded = torch.zeros((n, h + 2 * halo, w + 2 * halo, c), dtype=dt, device=dev)

            def library():
                padded.zero_()
                padded.index_put_(ii, g, accumulate=True)
            kern = lambda: kg.gather_patches_bwd(g, *idx, shape, block, halo, plane)
            row = {"call": name, "dtype": str(dt), "layout": layout, "ms": graph_ms(kern),
                   **bwd_split_ms(kern),
                   "plain_ms": cuda_ms(lambda: kg.gather_patches_bwd_plain(
                       g, *idx, shape, block, halo, plane), iters=3, warmup=1),
                   "library_ms": cuda_ms(library, iters=5, warmup=1)}
            row["bytes"] = (window_bytes(shape, *idx, block, halo, g.element_size())
                            + n * h * w * c * g.element_size() + 3 * TRAIN_CAP * 8)
            row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
            res["calls"].append(row)
            for k in keys:
                res[frame][k] += row[k]
    detail["gather_bwd_times_per_step"] = res
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


def time_kernels(dev, worst, launches, detail) -> list:
    """Per-frame kernel, plain-twin and yardstick times at the main-path shapes."""
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
    rs = np.random.RandomState(11)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms")
    g = {"calls": [], "fp32": dict.fromkeys(keys, 0.0), "bf16": dict.fromkeys(keys, 0.0)}
    for name, shape, block, halo, per_image, layout in GATHER_CALLS:
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
            g["calls"].append(row)
            rows[dt] = row
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
VIDEO_STREAM_FRAMES = 10      # 8 windows of 3 frames, overlap 2
PER_WINDOW = {"gather_patches": 5, "compute_unknown": 3}
VIDEO_TIMING_REPS = 3
VIDEO_SRC = (720, 1280)       # ResizeShort(576) -> 576x1024
VIDEO_SET = (("vid0", 6), ("vid1", 6))   # (video, frames): 4 windows each
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


def video_stream(n_f: int, seed: int = 0) -> dict:
    """One synthetic video at 576x1024: uniform frames and 3 moving blob
    instances, masks the alphas above 0.5 (full size, as VIM eval gives)."""
    alpha = video_alphas(n_f, H, W, seed=seed)
    rs = np.random.RandomState(seed + 1)
    return {"image": torch.from_numpy(rs.rand(1, n_f, H, W, 3).astype(np.float32)),
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
    cfg.model.precision = "bf16"
    bf16_model = fold_spectral_norm(build_model(cfg.model, device="cpu"))
    bf16_model.load_state_dict(cpu_model.state_dict())
    return cfg, cpu_model, copy.deepcopy(cpu_model).to(dev), bf16_model.to(dev)


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


def video_set(root: str) -> None:
    """Write a VIM eval set with PIL: ``root/chip/fgr/<video>/<frame>.jpg``,
    ``root/chip/{pha,xmem}/<video>/<frame>/<instance>.png``: VIDEO_SET's videos
    at 720x1280, 3 moving blob instances, the masks the alphas binarized."""
    from PIL import Image
    h, w = VIDEO_SRC
    for v, (name, n_f) in enumerate(VIDEO_SET):
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


if __name__ == "__main__":
    sys.exit(main())
