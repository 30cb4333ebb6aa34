"""Smoke run of the PyTorch port (``nerfdet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, the TF32 flags as the port sets them (off);
2. build of every CUDA kernel of the path from ``nerfdet_tpu_torch/csrc``
   (one nvcc per source, started together), with the compiler's
   register / shared-memory report;
3. each kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, with its time, the plain version's
   time and the least time the card could take (bound);
4. the main path: NeRF-Det-R50 low-res detection inference at full width
   (50 views at 240x320, a 40x40x16 volume, random weights from a seed)
   through ``init_detector`` -> ``eval_step`` -> host NMS, with the
   kernels' launch counts, finiteness, the same graph with the plain
   fusion, a per-stage time breakdown and scenes/s on this card.

The second-to-last line is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``. Any failure exits non-zero and
prints no result; so does a machine without CUDA.
"""

import json
import os
import subprocess
import sys
import time

CONFIG = "configs/nerfdet/nerfdet_res50_2x_low_res.py"
N_VIEWS = 50
SEED = 0
FP32_PEAK = 67e12  # H100 SXM, fp32 outside the tensor cores, FLOP/s
HBM_RATE = 3.35e12  # H100 SXM, bytes/s
# the random weights keep the focal prior, so scores sit near
# sigmoid(-4.6) * sigmoid(centerness) ~ 0.005, under the config's 0.01:
# the smoke keeps every candidate above 0 so NMS has work
SCORE_THR = 0.0


def log(*args):
    print(*args, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def fusion_bound(pix, c, m, elt):
    """Least time of K1 on these inputs: bytes (each referenced feature
    row, the indices, W/b and the outputs, once) over HBM rate against
    the operations these inputs need over the fp32 rate."""
    import torch

    n = pix.shape[1]
    valid = pix >= 0
    rows = sum(int(torch.unique(p[v]).numel()) for p, v in zip(pix, valid))
    n_valid = int(valid.sum())
    nbytes = rows * c * elt + pix.numel() * 4 + (2 * n * c + n) * 4
    ops = 3 * n_valid * c
    if m:
        nbytes += (c * m + m + n * m) * 4
        ops += 2 * n_valid * c * m + 3 * pix.numel() * m
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def check_fusion(voxel, pix, hw, gen):
    """K1 vs its plain version at the main path's shape, four forms."""
    import torch

    dev = pix.device
    v, (fh, fw), c, m = pix.shape[0], hw, 256, 32
    feats32 = torch.randn((v, fh, fw, c), generator=gen, device=dev)
    w = torch.randn((c, m), generator=gen, device=dev) / c ** 0.5
    b = torch.randn((m,), generator=gen, device=dev)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        feats = feats32.to(dtype).contiguous()
        for mapped in (False, True):
            wm, bm = (w, b) if mapped else (None, None)
            got = voxel.fusion_carry(feats, pix, wm, bm)
            want = voxel.fusion_carry_plain(feats, pix, wm, bm)
            torch.cuda.synchronize()
            if not torch.equal(got[2], want[2]):
                raise SystemExit("K1 count differs from the plain version")
            abs_err, rel_err = 0.0, 0.0
            for g, p in zip(got[:2] + got[3:4], want[:2] + want[3:4]):
                if g is None:
                    continue
                e = float((g - p).abs().max())
                abs_err = max(abs_err, e)
                rel_err = max(rel_err, e / max(float(p.abs().max()), 1e-30))
            ms = cuda_time_ms(lambda: voxel.fusion_carry(feats, pix, wm, bm),
                              20)
            plain_ms = cuda_time_ms(
                lambda: voxel.fusion_carry_plain(feats, pix, wm, bm), 5)
            bound_ms, bound_by, nbytes, ops = fusion_bound(
                pix, c, m if mapped else 0, feats.element_size())
            name = f"{str(dtype)[6:]}{' mapped' if mapped else ''}"
            log(f"[kernel] fused_mean_cov {name}: V={v} map={fh}x{fw} "
                f"C={c} N={pix.shape[1]} M={m if mapped else 0}: "
                f"max_abs_err={abs_err:.3e} max_rel_err={rel_err:.3e} "
                f"(tol: count exact, rel 1e-5) ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
                f"({bound_by}; {nbytes} B, {ops} FLOP)")
            if rel_err > 1e-5:
                raise SystemExit(f"K1 {name} disagrees: rel {rel_err:.3e}")
            results[name] = dict(max_abs_err=abs_err, ms=ms,
                                 plain_ms=plain_ms, bound_ms=bound_ms,
                                 bound_by=bound_by)
    return results


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)
    from nerfdet_tpu_torch import api
    from nerfdet_tpu_torch.config import Config
    from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfdet_tpu_torch.device import resolve_device
    from nerfdet_tpu_torch.nn.heads import get_candidate_bboxes
    from nerfdet_tpu_torch.ops import cuda_build, voxel

    # ---- 1. the card -------------------------------------------------
    card = card_line()
    dev = resolve_device("cuda")
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    log(f"[env] TF32 set off by the port: cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32}")

    # ---- 2. build ----------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build()
    log(f"[build] {len(cuda_build.KERNELS)} CUDA sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (secs, msgs) in cuda_build.BUILD_LOG.items():
        log(f"[build] {name}.cu: nvcc {secs:.1f} s")
        for line in msgs.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build]   {line.strip()}")

    # ---- the scene and the model (shared by phases 3 and 4) ----------
    t0 = time.perf_counter()
    model = api.init_detector(CONFIG, device="cuda", seed=SEED)
    meta = model.meta
    h, w = meta.img_shape
    scene = make_synthetic_scene(seed=SEED, n_views=N_VIEWS, n_targets=1,
                                 hw=(h, w), pad_hw=meta.pad_shape,
                                 n_boxes=4, max_gt=8)
    batch = api.device_batch(model, scene)
    log(f"[setup] model {sum(p.numel() for p in model.parameters())} "
        f"parameters, scene {N_VIEWS} views {meta.pad_shape}, volume "
        f"{model.n_voxels}: {time.perf_counter() - t0:.1f} s")

    # pixel indices exactly as the main path computes them
    stride = 4
    fh, fw = meta.pad_shape[0] // stride, meta.pad_shape[1] // stride
    proj = voxel.compute_projection(
        scene["intrinsic"], scene["extrinsics"],
        meta.ori_shape[0] / (h / stride), dev)
    points = voxel.get_points(model.n_voxels, model.voxel_size,
                              scene["origin"], dev).reshape(-1, 3)
    x, y, _, valid = voxel.project_points(points, proj, h // stride,
                                          w // stride)
    pix = voxel.pixel_index(x, y, valid, fw).contiguous()

    # ---- 3. kernels against their plain versions ----------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fusion = check_fusion(voxel, pix, (fh, fw), gen)

    # ---- 4. the main path ---------------------------------------------
    test_cfg = Config.fromfile(CONFIG).test_cfg
    nms_pre, iou_thr = test_cfg["nms_pre"], test_cfg["iou_thr"]
    voxel.fusion_carry.launches = 0
    out = api.eval_step(model, batch, nms_pre)
    det = api.detections_from_candidates(
        out["boxes"].cpu().numpy(), out["scores"].cpu().numpy(),
        SCORE_THR, iou_thr)
    launches = voxel.fusion_carry.launches
    log(f"[path] eval_step -> {tuple(out['boxes'].shape)} candidates, "
        f"NMS kept {len(det['labels_3d'])} boxes; fused_mean_cov launches "
        f"{launches}")
    if launches < 1:
        raise SystemExit("the main path did not launch fused_mean_cov")
    if not (torch.isfinite(out["boxes"]).all()
            and torch.isfinite(out["scores"]).all()):
        raise SystemExit("non-finite candidates")

    with torch.inference_mode():
        head_k, valid_k = model(batch)
        kernel_fn = voxel.fusion_carry
        voxel.fusion_carry = voxel.fusion_carry_plain
        try:
            head_p, valid_p = model(batch)
        finally:
            voxel.fusion_carry = kernel_fn
    torch.cuda.synchronize()
    expect = [(model.n_voxels[0] >> i, model.n_voxels[1] >> i,
               model.n_voxels[2] >> i) for i in range(model.n_scales)]
    diff, scale = 0.0, 0.0
    for s, (hk, hp) in enumerate(zip(head_k, head_p)):
        for t, (a, b) in enumerate(zip(hk, hp)):
            if tuple(a.shape[:3]) != expect[s] or not torch.isfinite(a).all():
                raise SystemExit(f"head output {s}.{t}: shape {a.shape} "
                                 f"or non-finite values")
            diff = max(diff, float((a - b).abs().max()))
            scale = max(scale, float(b.abs().max()))
    if not torch.equal(valid_k, valid_p):
        raise SystemExit("view counts differ between kernel and plain")
    log(f"[path] head outputs finite, shapes {expect}; kernel vs plain "
        f"fusion through the whole graph: max |diff| {diff:.3e} "
        f"(max |out| {scale:.3e}, tol 1e-4 relative)")
    if diff > 1e-4 * max(scale, 1.0):
        raise SystemExit("kernel and plain fusion graphs disagree")

    # per-stage breakdown (CUDA events; 3 iterations each)
    with torch.inference_mode():
        feats = model.extract_2d(batch["imgs"])
        rgb = (batch["rgb_s1"], batch["rgb_s2"])
        vol = model.build_volume(feats, batch["intrinsic"],
                                 batch["extrinsics"], batch["origin"], rgb)
        heads = model.detect(vol["det_volume"])
        mlvl = model.mlvl_points(batch["origin"])
        stages = {
            "extract_2d (ResNet-50 + FPN)": lambda: model.extract_2d(
                batch["imgs"]),
            "build_volume (projection + K1 + density)":
                lambda: model.build_volume(
                    feats, batch["intrinsic"], batch["extrinsics"],
                    batch["origin"], rgb),
            "detect (3D neck + head)": lambda: model.detect(
                vol["det_volume"]),
            "get_candidate_bboxes": lambda: get_candidate_bboxes(
                heads, vol["valid"], mlvl, nms_pre, model.n_classes),
        }
        for name, fn in stages.items():
            log(f"[stage] {name}: {cuda_time_ms(fn, 3, warmup=1):.3f} ms")

    # throughput: host clock over eval_step + candidate copy + host NMS
    # at the config's thresholds
    iters = 5
    for _ in range(2):
        out = api.eval_step(model, batch, nms_pre)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = api.eval_step(model, batch, nms_pre)
        det = api.detections_from_candidates(
            out["boxes"].cpu().numpy(), out["scores"].cpu().numpy(),
            test_cfg["score_thr"], iou_thr)
    dt = time.perf_counter() - t0
    log(f"[path] {iters / dt:.3f} scenes/s ({dt / iters * 1e3:.2f} ms per "
        f"scene: eval_step + host NMS at score_thr "
        f"{test_cfg['score_thr']}, {len(det['labels_3d'])} boxes kept; "
        f"host rgb sums excluded), measured on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    main = fusion["float32 mapped"]
    record = {"kernels": [{
        "name": "fused_mean_cov",
        "route": "cuda",
        "source": "nerfdet_tpu_torch/csrc/fused_mean_cov.cu",
        "replaces": "nerfdet_tpu/ops/voxel.py:370",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in fusion.values()),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
    }]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
