"""Drive the PyTorch/CUDA port of MaGGIe on one NVIDIA GPU, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --outputs PATH [--against REF]

The second form only answers requests 0 and 1 in f32 and bf16 and saves the
outputs to PATH; with REF, saved by the same form from another version, it
exits non-zero unless every output is equal bit for bit.

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
   forward / loader / host split and peak memory.

Prints a ``{"kernels": [...]}`` line and the card line, and last
``{"ok": true, "device": {...}}``. Details go to output/torch_port/chip_smoke.json.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
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


def sample_indices(shape, block, per_image, dev, rs):
    """CAP entries over the block grid: every corner and edge block first, then
    random blocks; per-image calls index with n // N_INST (repeated tiles)."""
    n, h, w, _ = shape
    nby, nbx = 576 // 64, 1024 // 64
    assert (h // block, w // block) == (nby, nbx), (shape, block)
    border = [(0, 0), (0, nbx - 1), (nby - 1, 0), (nby - 1, nbx - 1)]
    border += [(0, x) for x in range(nbx)] + [(nby - 1, x) for x in range(nbx)]
    border += [(y, 0) for y in range(nby)] + [(y, nbx - 1) for y in range(nby)]
    by = np.array([b[0] for b in border] + list(rs.randint(0, nby, CAP)))[:CAP]
    bx = np.array([b[1] for b in border] + list(rs.randint(0, nbx, CAP)))[:CAP]
    inst = rs.randint(0, N_INST, CAP)
    idx_n = inst // N_INST if per_image else inst
    return [torch.from_numpy(a.astype(np.int64)).to(dev) for a in (idx_n, by, bx)]


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


def phase_kernels(dev, detail) -> dict:
    from maggie_tpu_torch.flagship import blob_alpha
    from maggie_tpu_torch.ops.kernels import gather as kg, unknown as ku
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

    def check_unknown(a, k, label):
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

    for k in UNKNOWN_K:
        for seed in range(2):
            rr = np.random.RandomState(seed)
            alpha = blob_alpha(H, W, N_INST, rr)
            if seed == 1:  # speckle: isolated uncertain pixels everywhere, tile seams too
                alpha = np.where(rr.rand(*alpha.shape) < 0.002, 0.5, np.round(alpha))
            check_unknown(torch.from_numpy(alpha.astype(np.float32))[None].to(dev), k,
                          f"seed={seed}")
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
            check_unknown(a, k, label)
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
            kernel_us += (e.self_device_time_total if hasattr(e, "self_device_time_total")
                          else e.self_cuda_time_total)
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


if __name__ == "__main__":
    sys.exit(main())
