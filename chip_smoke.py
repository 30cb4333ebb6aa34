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
   time and the least time the card could take (bound); K1's two phases'
   times, ``torch.addmm`` on the same maps (phase A's yardstick) and one
   more f32 mapped line at the intrinsic scaled to ``ori_shape``; K3's
   cluster size and time a step;
4. the first path: NeRF-Det-R50 low-res detection inference at full
   width (50 views at 240x320, a 40x40x16 volume, random weights from a
   seed) through ``init_detector`` -> ``eval_step`` -> host NMS, with
   the kernels' launch counts (K1 exactly once), finiteness, the same
   graph with the plain fusion, a per-stage time breakdown and scenes/s
   on this card;
5. the second path: VoteNet-ScanNet inference at full width (a seeded
   40000-point synthetic cloud, random weights) through
   ``init_detector`` -> ``points_eval_step`` -> ``votenet_nms``, with
   the launch counts (K3 exactly 5 per forward), finiteness, the same
   graph with the plain FPS, a per-stage time breakdown, clouds/s and
   peak memory;
6. the third path: NeRF-Det-R50 novel-view rendering (image mode, 64
   samples per ray) of one full 219x300 target view (65,700 rays) from
   the 50 views of phase 4's scene with phase 4's model, through
   ``run_nvs_eval`` -> ``render_full`` (exactly 33 K2 launches at chunk
   2048), then ``eval_step`` on a batch that carries 2048 rays; the
   outputs' range, the view-mask shares, the same render with the plain
   K2, a per-stage time breakdown, the share of feature windows a sample
   shares with the previous one, views/s and peak memory;
7. the fourth path: NeRF-Det-R50 detection training at full width
   (``rgb_supervision=False``, one scene a step as the config's
   ``samples_per_gpu=1``) through ``init_trainer`` -> ``train_batch`` ->
   ``Trainer.step`` on a seeded 4-box scene without rays: 2 warm-up
   steps and 5 timed ones with K1's forward and backward launched once a
   step and K2 never, finite loss terms with positives, frozen
   parameters bitwise unchanged and a parameter changed in each trained
   part, the loss and gradients of one step with the plain K1 forward and
   backward, the forward / backward / optimizer times, steps/s and peak
   memory;
8. the fifth path: NeRF-Det-R50 joint detection + NVS training at full
   width (the config's ``rgb_supervision``, N_rand = 2048 rays of 64
   samples a step, the host ray stream drawn and summed on the host,
   outside the timed step, its time on a line of its own) through
   ``init_trainer`` -> ``train_batch`` -> ``Trainer.step`` on a seeded
   4-box scene: one step's loss and ``mapping`` / FPN-output gradients
   against the same step with the plain K2 forward and backward, a
   ``mapping`` gradient from ``loss_nvs`` alone, 2 warm-up steps and 5
   timed ones with K1's and K2's forward and backward launched once a
   step, finite loss terms (``loss_nvs`` included) with positives, the
   forward / backward / optimizer times, steps/s and peak memory.

9. the runtime from files: a ScanNet-layout dataset written as PNG at
   484x648 (one train scene of 60 views, one val scene of 110, in 8
   processes; ``--options ori_shape=(484,648)``, so the pipeline's
   keep-ratio resize gives the flagship's 239x320 padded to 240x320),
   then in process ``tools/train.main`` on the flagship config (RepeatDataset
   x6, so 6 steps an epoch) for 8 steps with the config's one loader
   thread: a checkpoint and a validation (``run_eval``) after each epoch,
   K1's and K2's forward and backward launched once a step, finite
   losses; the same 8 steps with 8 loader threads; each run's steps/s
   from files over steps 3-8 on the host clock, its mean loader wait and
   the loader threads' host time a scene (decode + resize, rgb sums, ray
   stream); a resume from ``ckpt_1`` for one step (the step count and the
   rate continue); then ``tools/test.main --eval mAP nvs`` from
   ``ckpt_2`` with K1 once a scene and K2 33 times a target view, the
   metrics, ``run_eval`` scenes/s at 100 source views, ``run_nvs_eval``
   views/s, peak memory and the phase's wall time.

Phase 3 also holds K1's backward kernel against its plain version at
phase 4's pixel indices and at phase 8's (the intrinsic scaled to
``ori_shape``), in the main path's form (no s2 cotangent), with the
times of its passes (the index preparation, passes 1, 2 and 3) and
``torch.mm`` on the two products it contains as its yardstick; and, at
phase 8's shape, K2's training form (host rgb sums) against its plain
version, and K2's backward against its plain version (two runs bitwise
equal), with the times of its passes (pass 0, the index preparation,
passes 1 and 2) and ``index_add_`` of the weighted tap rows as its
yardstick.

Each path runs with every launch count set to 0 just before it and
read just after; phase 9 also counts each train step's launches.

The second-to-last line is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``. Any failure exits non-zero and
prints no result; so does a machine without CUDA.
"""

import json
import os
import subprocess
import sys
import time
import types

CONFIG = "configs/nerfdet/nerfdet_res50_2x_low_res.py"
VOTENET_CONFIG = "configs/votenet/votenet_8x8_scannet-3d-18class.py"
N_VIEWS = 50
N_POINTS = 40000  # IndoorPointSample of the ScanNet pipeline
FPS_LAUNCHES = 5  # 4 SA levels + the vote aggregation, per forward
MARGIN = 10  # ray-grid margin of the config's pipeline
CHUNK = 2048  # rays per render chunk, one K2 launch each
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
    the operations these inputs need over the fp32 rate. Operations: 3 a
    valid (voxel, view) pair and channel for s1 and s2; with the mapped
    stream, the product of each referenced pixel row once (2·rows·C·M:
    the mapped value depends on the pixel, not the voxel) and 3 a pair
    and mapped channel for the square and its sum. Also returns the
    valid pairs and the referenced rows."""
    import torch

    n = pix.shape[1]
    valid = pix >= 0
    rows = sum(int(torch.unique(p[v]).numel()) for p, v in zip(pix, valid))
    n_valid = int(valid.sum())
    nbytes = rows * c * elt + pix.numel() * 4 + (2 * n * c + n) * 4
    ops = 3 * n_valid * c
    if m:
        nbytes += (c * m + m + n * m) * 4
        ops += 2 * rows * c * m + 3 * pix.numel() * m
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops, n_valid, rows)


def mapped_rows_bound(feats, m):
    """Least time of K1's phase A: the maps read once and the mapped rows
    written once, against 2·C·M operations a pixel row."""
    v, fh, fw, c = feats.shape
    rows = v * fh * fw
    nbytes = feats.numel() * feats.element_size() + (rows * m + c * m
                                                     + m) * 4
    ops = 2 * rows * c * m
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_fusion(voxel, cases, hw, gen):
    """K1 vs its plain version at the main path's shape: count, s1 and
    s2 bitwise equal, s2m within 1e-5 relative. ``cases``: (name, pix,
    dtype, mapped). Each line gives K1's time, its phases' (the uncounted
    launches ``_mapped_rows_launch`` and ``_carry_launch``), the plain
    version's and the bound; the f32 mapped forms also time
    ``torch.addmm`` on the same maps, phase A's one-call yardstick."""
    import torch

    dev = cases[0][1].device
    v, (fh, fw), c, m = cases[0][1].shape[0], hw, 256, 32
    feats32 = torch.randn((v, fh, fw, c), generator=gen, device=dev)
    w = torch.randn((c, m), generator=gen, device=dev) / c ** 0.5
    b = torch.randn((m,), generator=gen, device=dev)
    maps = {torch.float32: feats32, torch.bfloat16: feats32.bfloat16()}
    results = {}
    for name, pix, dtype, mapped in cases:
        feats = maps[dtype]
        wm, bm = (w, b) if mapped else (None, None)
        got = voxel.fusion_carry(feats, pix, wm, bm)
        want = voxel.fusion_carry_plain(feats, pix, wm, bm)
        torch.cuda.synchronize()
        if not all(torch.equal(g, p) for g, p in zip(got[:3], want[:3])):
            raise SystemExit(f"K1 {name}: count, s1 or s2 differs from the "
                             f"plain version")
        abs_err = max(float((g - p).abs().max())
                      for g, p in zip(got, want) if g is not None)
        rel_err = 0.0
        if mapped:
            rel_err = float((got[3] - want[3]).abs().max()) / max(
                float(want[3].abs().max()), 1e-30)
        ms = cuda_time_ms(lambda: voxel.fusion_carry(feats, pix, wm, bm), 20)
        plain_ms = cuda_time_ms(
            lambda: voxel.fusion_carry_plain(feats, pix, wm, bm), 5)
        rows_p = voxel._mapped_rows_launch(feats, w, b) if mapped else None
        a_ms = cuda_time_ms(lambda: voxel._mapped_rows_launch(feats, w, b),
                            20) if mapped else 0.0
        b_ms = cuda_time_ms(lambda: voxel._carry_launch(feats, pix, rows_p,
                                                        bm), 20)
        del rows_p
        bound_ms, bound_by, nbytes, ops, n_valid, rows = fusion_bound(
            pix, c, m if mapped else 0, feats.element_size())
        result = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by, phase_a_ms=a_ms,
                      phase_b_ms=b_ms, library_ms=None)
        line = (f"[kernel] fused_mean_cov {name}: V={v} map={fh}x{fw} C={c} "
                f"N={pix.shape[1]} M={m if mapped else 0}; {n_valid} valid "
                f"pairs ({n_valid / pix.numel():.4f}), {rows} referenced "
                f"rows: count, s1, s2 bitwise equal, max_abs_err="
                f"{abs_err:.3e} s2m max_rel_err={rel_err:.3e} (tol: s2m rel "
                f"1e-5) ms={ms:.4f} (phase A {a_ms:.4f}, phase B "
                f"{b_ms:.4f}) plain_ms={plain_ms:.4f} bound_ms="
                f"{bound_ms:.4f} ({bound_by}; {nbytes} B, {ops} FLOP)")
        if mapped:
            a_bound, a_by = mapped_rows_bound(feats, m)
            line += f"; phase A bound_ms={a_bound:.4f} ({a_by})"
        if mapped and dtype == torch.float32:
            flat = feats.reshape(-1, c)
            result["library_ms"] = cuda_time_ms(
                lambda: torch.addmm(b, flat, w), 20)
            line += (f"; library_ms={result['library_ms']:.4f} "
                     f"(torch.addmm, phase A's work)")
        log(line)
        if rel_err > 1e-5:
            raise SystemExit(f"K1 {name} disagrees: rel {rel_err:.3e}")
        results[name] = result
    return results


def fusion_backward_bound(pix, hw, c, m, with_g2):
    """Least time of K1's backward on these inputs. Bytes: each referenced
    pixel row of the maps and of phase A's mapped rows read once, the
    whole d-features map written once, the cotangents g1 (g2), gm, the
    indices, counts, W, b read once and dW, db written once. Operations:
    per valid (voxel, view) pair, C adds for G1 (2C with g2) and M for
    GM; per referenced row, 2M for dY, 2CM for dY @ W^T, C for the sum
    (3C more with g2), 2CM for dW and M for db; 2M per voxel for the
    unseen views' bias term. Also returns the referenced rows."""
    import torch

    v, n = pix.shape
    valid = pix >= 0
    rows = sum(int(torch.unique(p[k]).numel()) for p, k in zip(pix, valid))
    n_valid = int(valid.sum())
    g = 2 if with_g2 else 1
    nbytes = 4 * (rows * (c + m) + v * hw * c + g * n * c + n * m
                  + pix.numel() + n + 2 * (c * m + m))
    ops = (n_valid * (g * c + m) + rows * (2 * m + 4 * c * m + c + m
                                           + (3 * c if with_g2 else 0))
           + 2 * n * m)
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops, rows)


def check_fusion_backward(voxel, pix, hw, gen, label):
    """K1's backward kernel vs ``fusion_carry_backward_plain`` at the main
    path's form (C = 256, M = 32, f32 maps, cotangents of s1 and s2m, none
    of s2): d features within 1e-5 x max, dW and db within 1e-4 x max,
    two runs bitwise equal. Times the kernel, its passes (the index
    preparation, pass 1, 2 and 3, each on the last one's outputs), the
    plain version and ``torch.mm`` on the two products it contains (dY @
    W^T and x^T dY over the referenced rows)."""
    import torch

    dev = pix.device
    v, n = pix.shape
    c, m = 256, 32
    feats = torch.randn((v,) + hw + (c,), generator=gen, device=dev)
    w = torch.randn((c, m), generator=gen, device=dev) / c ** 0.5
    b = torch.randn((m,), generator=gen, device=dev)
    g1 = torch.randn((n, c), generator=gen, device=dev)
    gm = torch.randn((n, m), generator=gen, device=dev)
    count = (pix >= 0).float().sum(0)
    rows_p = voxel.mapped_rows_plain(feats, w, b)
    args = (feats, pix, count, g1, None, gm, w, b, rows_p)
    got = voxel.fusion_carry_backward(*args)
    again = voxel.fusion_carry_backward(*args)
    want = voxel.fusion_carry_backward_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise SystemExit("K1 backward: two runs differ")
    errs = [float((x - y).abs().max()) for x, y in zip(got, want)]
    rels = [e / max(float(y.abs().max()), 1e-30) for e, y in zip(errs, want)]
    ms = cuda_time_ms(lambda: voxel.fusion_carry_backward(*args), 20)
    n_pix = hw[0] * hw[1]
    order, off, rows, n_rows = voxel.pixel_order(pix, n_pix)
    _, dy = voxel._pixel_sums(feats, order, off, g1, None, gm, rows_p, w)
    parts = voxel._weight_parts(feats, dy, rows, n_rows, gm, count)
    passes = {
        "index_ms": cuda_time_ms(lambda: voxel.pixel_order(pix, n_pix), 20),
        "pass1_ms": cuda_time_ms(lambda: voxel._pixel_sums(
            feats, order, off, g1, None, gm, rows_p, w), 20),
        "pass2_ms": cuda_time_ms(lambda: voxel._weight_parts(
            feats, dy, rows, n_rows, gm, count), 20),
        "pass3_ms": cuda_time_ms(lambda: voxel._weight_reduce(*parts, b),
                                 20)}
    plain_ms = cuda_time_ms(lambda: voxel.fusion_carry_backward_plain(*args),
                            3, warmup=1)
    # the yardstick: the two products over the referenced rows
    keys = torch.where(pix >= 0, pix.long() + torch.arange(
        v, device=dev)[:, None] * n_pix, -1).flatten()
    ref = torch.unique(keys[keys >= 0])
    x_r = feats.reshape(-1, c)[ref]
    dy_r = torch.randn((ref.numel(), m), generator=gen, device=dev)
    wt = w.t().contiguous()
    library_ms = cuda_time_ms(
        lambda: (torch.mm(dy_r, wt), torch.mm(x_r.t(), dy_r)), 20)
    bound_ms, bound_by, nbytes, ops, n_ref = fusion_backward_bound(
        pix, n_pix, c, m, False)
    log(f"[kernel] fused_mean_cov_backward float32 mapped, no s2 cotangent, "
        f"{label}: V={v} map={hw[0]}x{hw[1]} C={c} N={n} M={m}; {n_ref} "
        f"referenced rows: two runs bitwise equal; max_abs_err d features "
        f"{errs[0]:.3e} (rel {rels[0]:.3e}, tol 1e-5), dW {errs[1]:.3e} "
        f"(rel {rels[1]:.3e}, tol 1e-4), db {errs[2]:.3e} (rel "
        f"{rels[2]:.3e}, tol 1e-4) ms={ms:.4f} (index preparation "
        f"{passes['index_ms']:.4f}, pass 1 {passes['pass1_ms']:.4f}, pass 2 "
        f"{passes['pass2_ms']:.4f}, pass 3 {passes['pass3_ms']:.4f}) "
        f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (torch.mm: "
        f"dY @ W^T and x^T dY over the referenced rows) "
        f"bound_ms={bound_ms:.4f} ({bound_by}; {nbytes} B, {ops} FLOP)")
    if rels[0] > 1e-5 or rels[1] > 1e-4 or rels[2] > 1e-4:
        raise SystemExit("K1 backward disagrees with its plain version")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                **passes)


def fps_bound(n, c, s):
    """Least time of K3 on an (N, C) cloud and S picks: bytes (points
    read once, indices written once) over HBM rate against operations
    (per point and step: C subtractions, multiplies and adds, the
    minimum and the comparison) over the fp32 rate."""
    nbytes = n * c * 4 + s * 4
    ops = (s - 1) * n * (3 * c + 2)
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def check_fps(pointnet, cases):
    """K3 vs its plain version on the card: indices must be equal. Each
    line gives the plan's cluster size and the time a step."""
    import torch

    results = {}
    for name, pts, s in cases:
        n, c = pts.shape
        k = pointnet.fps_plan(n, c)[0]
        got = pointnet.furthest_point_sample(pts, s)
        want = pointnet.furthest_point_sample_plain(pts, s)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"K3 {name} indices differ from the plain "
                             f"version at {int((got != want).sum())} of {s}")
        err = float((got - want).abs().max())
        ms = cuda_time_ms(lambda: pointnet.furthest_point_sample(pts, s), 10)
        plain_ms = cuda_time_ms(
            lambda: pointnet.furthest_point_sample_plain(pts, s), 2,
            warmup=1)
        bound_ms, bound_by, nbytes, ops = fps_bound(n, c, s)
        us_step = ms * 1e3 / max(s - 1, 1)
        log(f"[kernel] furthest_point_sample {name}: N={n} C={c} S={s}: "
            f"cluster {k} CTAs; indices equal (max_abs_err={err:.0f}, tol: "
            f"exact) ms={ms:.4f} ({us_step:.3f} us per step) "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
            f"({bound_by}; {nbytes} B, {ops} FLOP)")
        results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             cluster=k, us_step=us_step)
    return results


def stage_times(model, pts, iters=5):
    """Per-stage CUDA-event times (ms, mean of ``iters``) of the real
    VoteNet forward ``model(pts)``, in the order the stages start.

    Forward hooks record an event pair around each module of the path;
    the SA modules' FPS, ball query and grouping are timed by wrappers
    in a stand-in for the point-op namespace their module calls through
    (the kernel wrapper and its launch count are left as they are)."""
    import types

    import torch
    from nerfdet_tpu_torch.nn import pointnet2

    bb, head = model.backbone, model.bbox_head
    sa = [(f"sa{i}", getattr(bb, f"sa{i}")) for i in range(bb.n_sa)]
    sa.append(("vote_aggregation", head.vote_aggregation))
    mods = [("forward", model), ("backbone", bb)]
    for name, m in sa:
        mods += [(name, m), (f"{name} MLP", m.mlp)]
    mods += [(f"fp{i}", getattr(bb, f"fp{i}")) for i in range(bb.n_fp)]
    mods += [("vote head", head), ("vote module", head.vote_module),
             ("prediction MLP", head.pred_mlp)]

    spans, stack = [], []

    def begin(label):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        spans.append([label, start, None])
        return spans[-1]

    def finish(span):
        span[2] = torch.cuda.Event(enable_timing=True)
        span[2].record()

    def timed(label, fn):
        def run(*args, **kwargs):
            span = begin(f"{stack[-1][0]} {label}")
            out = fn(*args, **kwargs)
            finish(span)
            return out
        return run

    ops = pointnet2.pointnet
    proxy = types.SimpleNamespace(**vars(ops))
    proxy.furthest_point_sample = timed("FPS", ops.furthest_point_sample)
    proxy.ball_query = timed("ball query", ops.ball_query)
    proxy.group_points = timed("group", ops.group_points)
    hooks = []
    for name, m in mods:
        hooks.append(m.register_forward_pre_hook(
            lambda m, args, name=name: stack.append(begin(name))))
        hooks.append(m.register_forward_hook(
            lambda m, args, out: finish(stack.pop())))
    pointnet2.pointnet = proxy
    try:
        with torch.inference_mode():
            model(pts)  # warm-up
            spans.clear()
            for _ in range(iters):
                model(pts)
        torch.cuda.synchronize()
    finally:
        pointnet2.pointnet = ops
        for h in hooks:
            h.remove()
    totals = {}
    for label, start, end in spans:
        totals[label] = totals.get(label, 0.0) + start.elapsed_time(end)
    return {label: t / iters for label, t in totals.items()}


def forward_with_fps(model, pts):
    """One VoteNet forward: the (points, S) and the picks of each FPS
    call, one per SA module in call order, and the prediction dict.
    Hooks on the SA modules collect them."""
    import torch

    calls, picks = [], []
    mods = [getattr(model.backbone, f"sa{i}")
            for i in range(model.backbone.n_sa)]
    mods.append(model.bbox_head.vote_aggregation)
    hooks = [m.register_forward_pre_hook(
        lambda m, args: calls.append((args[0], m.num_point))) for m in mods]
    hooks += [m.register_forward_hook(
        lambda m, args, out: picks.append(out[2])) for m in mods]
    try:
        with torch.inference_mode():
            preds = model(pts)
    finally:
        for h in hooks:
            h.remove()
    return calls, picks, preds


def plain_fps(pointnet, fn, *args):
    """``fn(*args)`` with the plain FPS in place of K3."""
    kernel_fn = pointnet.furthest_point_sample
    pointnet.furthest_point_sample = pointnet.furthest_point_sample_plain
    try:
        return fn(*args)
    finally:
        pointnet.furthest_point_sample = kernel_fn


def votenet_path(api, pointnet, voxel, model, cloud, card):
    """Phase 5: VoteNet-ScanNet inference at full width."""
    import torch

    from nerfdet_tpu_torch.models.votenet import votenet_nms
    from nerfdet_tpu_torch.nn.vote_head import vote_head_get_bboxes
    from nerfdet_tpu_torch.ops import render

    points = cloud["points"]
    dev = next(model.parameters()).device
    voxel.fusion_carry.launches = 0
    pointnet.furthest_point_sample.launches = 0
    render.streaming_sample_mean_var.launches = 0
    boxes, obj, sem = api.points_eval_step(model, points)
    det = votenet_nms(boxes.cpu().numpy(), obj.cpu().numpy(),
                      sem.cpu().numpy(), points[:, :3])
    launches = pointnet.furthest_point_sample.launches
    log(f"[votenet] points_eval_step -> boxes {tuple(boxes.shape)}, obj "
        f"{tuple(obj.shape)}, sem {tuple(sem.shape)}; votenet_nms kept "
        f"{len(det['labels_3d'])} (box, class) proposals; launches: "
        f"furthest_point_sample {launches}, fused_mean_cov "
        f"{voxel.fusion_carry.launches}, streaming_sample_mean_var "
        f"{render.streaming_sample_mean_var.launches}")
    if launches != FPS_LAUNCHES:
        raise SystemExit(f"VoteNet launched furthest_point_sample "
                         f"{launches} times, expected {FPS_LAUNCHES}")
    n_prop = model.bbox_head.vote_aggregation.num_point
    if (tuple(boxes.shape) != (n_prop, 7)
            or tuple(sem.shape) != (n_prop, model.num_classes)
            or not all(bool(torch.isfinite(t).all())
                       for t in (boxes, obj, sem))):
        raise SystemExit("VoteNet outputs: wrong shape or non-finite")

    # the same graph with the plain FPS: equal indices, outputs 1e-5
    pts = torch.as_tensor(points, device=dev)
    _, picks_k, preds_k = forward_with_fps(model, pts)
    _, picks_p, preds_p = plain_fps(pointnet, forward_with_fps, model, pts)
    torch.cuda.synchronize()
    if len(picks_k) != FPS_LAUNCHES or not all(
            torch.equal(a, b) for a, b in zip(picks_k, picks_p)):
        raise SystemExit("VoteNet FPS indices differ between kernel and "
                         "plain graphs")
    diff, scale = 0.0, 0.0
    for key, a in preds_k.items():
        b = preds_p[key]
        for x, y in zip(a if isinstance(a, list) else [a],
                        b if isinstance(b, list) else [b]):
            if not x.is_floating_point():
                if not torch.equal(x, y):
                    raise SystemExit(f"VoteNet {key} indices differ")
                continue
            diff = max(diff, float((x - y).abs().max()))
            scale = max(scale, float(y.abs().max()))
    log(f"[votenet] kernel vs plain FPS through the whole graph: "
        f"{FPS_LAUNCHES} FPS calls with equal indices, max |diff| "
        f"{diff:.3e} (max |out| {scale:.3e}, tol 1e-5 relative)")
    if diff > 1e-5 * max(scale, 1.0):
        raise SystemExit("kernel and plain FPS graphs disagree")

    # per-stage breakdown of the real forward (CUDA events, 5 forwards)
    for label, ms in stage_times(model, pts).items():
        log(f"[stage] votenet {label}: {ms:.3f} ms")
    with torch.inference_mode():
        ms = cuda_time_ms(
            lambda: vote_head_get_bboxes(preds_k, model.bbox_coder), 5,
            warmup=1)
    log(f"[stage] votenet decode: {ms:.3f} ms")
    host = [b.cpu().numpy() for b in (boxes, obj, sem)]
    t0 = time.perf_counter()
    for _ in range(3):
        votenet_nms(*host, points[:, :3])
    log(f"[stage] votenet host tail (votenet_nms, host clock): "
        f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms")

    # throughput on the host clock, and peak memory
    iters = 5
    for _ in range(2):
        api.points_eval_step(model, points)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        api.points_eval_step(model, points)
    torch.cuda.synchronize()
    dev_dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    for _ in range(iters):
        det = api.single_cloud_test(model, points)
    dt = time.perf_counter() - t0
    log(f"[votenet] {iters / dev_dt:.3f} clouds/s device path "
        f"({dev_dt / iters * 1e3:.2f} ms per cloud: points_eval_step); "
        f"{iters / dt:.3f} clouds/s with the host tail "
        f"({dt / iters * 1e3:.2f} ms: single_cloud_test, "
        f"{len(det['labels_3d'])} proposals kept at score_thr 0.05); "
        f"peak memory {peak / 2**30:.2f} GiB; measured on {card}")
    return launches


def ray_bound(pts, images, feats):
    """Least time of K2 on these inputs: bytes (points, images, feature
    maps and projections read once, globalfeat (2(3 + C) floats a point)
    and the one-byte mask written once) over HBM rate against the
    operations over the fp32 rate. Per (point, view): 20 for the
    projection and its divides, 14 per map for the scale, the window and
    the tap weights, 12 per channel (4 products and 3 sums of the taps, 5
    for the three accumulators) and 1 for the count; per point: 10 per
    channel for the statistics (mean's divide, the variance's 3 products,
    2 sums and divide, the negation and exp, the two stores' moves) and
    2 for the denominator and the mask."""
    n = pts.numel() // 3
    v, c = images.shape[0], 3 + feats.shape[-1]
    nbytes = (pts.numel() + images.numel() + feats.numel() + v * 16
              + n * 2 * c) * 4 + n
    ops = n * v * (20 + 2 * 14 + 12 * c + 1) + n * (10 * c + 2)
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def check_k2(render, cases, img_hw):
    """The fused K2 vs its plain version (the carry, then the epilogue)
    on the card: pixel_mask and the unseen count exact, globalfeat within
    1e-5 relative. The unseen count is read from each side's own output:
    a point no view counts has s1m = 0, so every mean is exactly 0.
    ``cases``: (name, pts, images, featmaps, proj, timed); the first is
    the timed render chunk, and each later case of its shape records
    whether its globalfeat equals the chunk's (``same_as_chunk``)."""
    import torch

    results, chunk_gf = {}, None
    for name, pts, images, feats, proj, timed in cases:
        args = (pts, images, proj, img_hw, feats)
        got = render.streaming_sample_mean_var(*args)
        want = render.streaming_sample_mean_var_plain(*args)
        torch.cuda.synchronize()
        cs = got[0].shape[-1] // 2
        unseen = [int((g[0][..., :cs] == 0).all(-1).sum()) for g in
                  (got, want)]
        if not torch.equal(got[1], want[1]) or unseen[0] != unseen[1]:
            raise SystemExit(f"K2 {name}: pixel_mask or the unseen count "
                             f"differs from the plain version")
        abs_err = float((got[0] - want[0]).abs().max())
        rel_err = abs_err / max(float(want[0].abs().max()), 1e-30)
        n_pts = got[1].numel()
        line = (f"[kernel] streaming_sample_mean_var {name}: "
                f"V={images.shape[0]} N={n_pts} C={cs}: pixel_mask and "
                f"unseen count equal (pixel_mask share "
                f"{float(got[1].float().mean()):.4f}, unseen "
                f"{unseen[0]} of {n_pts}); globalfeat max_abs_err="
                f"{abs_err:.3e} max_rel_err={rel_err:.3e} (tol: mask exact, "
                f"rel 1e-5); bitwise equal "
                f"{all(torch.equal(g, p) for g, p in zip(got, want))}")
        result = dict(max_abs_err=abs_err, mask=got[1], unseen=unseen[0])
        if chunk_gf is None:
            chunk_gf = got[0]
        elif chunk_gf.shape == got[0].shape:
            result["same_as_chunk"] = torch.equal(got[0], chunk_gf)
        if timed:
            ms = cuda_time_ms(lambda: render.streaming_sample_mean_var(
                *args), 10)
            plain_ms = cuda_time_ms(lambda: render.streaming_sample_mean_var_plain(
                *args), 2, warmup=1)
            bound_ms, bound_by, nbytes, ops = ray_bound(pts, images, feats)
            line += (f" ms={ms:.4f} plain_ms={plain_ms:.4f} "
                     f"bound_ms={bound_ms:.4f} ({bound_by}; {nbytes} B, "
                     f"{ops} FLOP)")
            result.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by)
        log(line)
        if rel_err > 1e-5:
            raise SystemExit(f"K2 {name} disagrees: rel {rel_err:.3e}")
        results[name] = result
    return results


def k2_train_bound(pts, feats, n_host):
    """Least time of K2's training form: bytes (points, feature maps,
    projections and the ``n_host`` floats a point of host sums and count
    read once, globalfeat and the mask written once) over HBM rate against
    the operations of ``ray_bound`` without the rgb taps and the count."""
    n = pts.numel() // 3
    v, c = feats.shape[0], feats.shape[-1]
    nbytes = (pts.numel() + feats.numel() + v * 16 + n * n_host
              + n * 2 * (3 + c)) * 4 + n
    ops = n * v * (20 + 14 + 12 * c) + n * (10 * (3 + c) + 2)
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def k2_scatter_rows(render, pts, proj, img_hw, feats, g, gf, s1u, cnt):
    """What K2's backward scatters, as its plain version computes it: the
    flat texel index (V FH FW) and weighted tap row (C) of every in-map
    tap of every (point, view) pair, and the count of pairs with a
    non-zero weight (the pairs the kernel keeps)."""
    import torch

    from nerfdet_tpu_torch.ops.grid_sample import _window

    v, fh, fw, c = feats.shape
    h, w = img_hw
    xyz = pts.reshape(-1, 3)
    d_s1u, d_s2u, d_s1m = render._point_cotangents(g, gf, s1u, cnt, v)
    idx, rows, kept = [], [], 0
    for i in range(v):
        px, py, m = render._view_pixels(xyz, proj[i:i + 1], img_hw)
        px, py = px * render._scale(fw, w), py * render._scale(fh, h)
        f = render.grid_sample_2d_packed(render.pack_bilinear(feats[i]),
                                         px, py)
        df = (d_s1u + (2.0 * f) * d_s2u) + m * d_s1m
        sx, wx0, wx1 = _window(px, fw)
        sy, wy0, wy1 = _window(py, fh)
        x0, y0 = sx.long(), sy.long()
        nonzero = torch.zeros_like(x0, dtype=torch.bool)
        for dy, dx, wk in ((0, 0, wy0 * wx0), (0, 1, wy0 * wx1),
                           (1, 0, wy1 * wx0), (1, 1, wy1 * wx1)):
            nonzero |= wk != 0
            keep = (x0 + dx < fw) & (y0 + dy < fh)
            idx.append((i * fh * fw + (y0 + dy) * fw + x0 + dx)[keep])
            rows.append((df * wk[:, None])[keep])
        kept += int(nonzero.sum())
    return torch.cat(idx), torch.cat(rows), kept


def k2_backward_bound(pts, feats, kept):
    """Least time of K2's backward on these inputs. Bytes: the feature
    maps read and their gradient written once; g's and globalfeat's
    feature halves, s1u, cnt, the points and projections read once; the
    pairs' keys written and read by the sort once, the kept pairs'
    sorted indices written and read once. Operations: 20 per (kept pair,
    channel) (the sample's 4 products and 3 sums, df's 3 products and 2
    sums, the four taps' products and sums) and 40 per kept pair for its
    projection and weights; 15 per (point, channel) for the
    cotangents."""
    n = pts.numel() // 3
    v, fh, fw, c = feats.shape
    pairs = n * v
    nbytes = (2 * v * fh * fw * c + 2 * n * 2 * c + n * c + n + 3 * n
              + 16 * v) * 4 + 8 * pairs + 8 * kept
    ops = kept * (20 * c + 40) + 15 * n * c
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def check_k2_training(render, pts, proj, img_hw, feats, host, gen):
    """K2's training form (host rgb sums) against its plain version at the
    training path's shape (pixel_mask exact, globalfeat within 1e-5
    relative), then K2's backward against
    ``streaming_sample_mean_var_backward_plain`` on a random cotangent
    (within 1e-5 x max, two runs bitwise equal), with times, bounds and
    ``index_add_`` of the weighted tap rows into the flat feature map as
    the backward's yardstick (it does the scatter alone)."""
    import torch

    args = (pts, None, proj, img_hw, feats, host)
    got = render.streaming_sample_mean_var(*args)
    want = render.streaming_sample_mean_var_plain(*args)
    torch.cuda.synchronize()
    fwd_err = float((got[0] - want[0]).abs().max())
    fwd_rel = fwd_err / max(float(want[0].abs().max()), 1e-30)
    if not torch.equal(got[1], want[1]) or fwd_rel > 1e-5:
        raise SystemExit(f"K2's training form disagrees with its plain "
                         f"version (rel {fwd_rel:.3e})")
    ms = cuda_time_ms(lambda: render.streaming_sample_mean_var(*args), 10)
    plain_ms = cuda_time_ms(
        lambda: render.streaming_sample_mean_var_plain(*args), 2, warmup=1)
    bound_ms, bound_by, nbytes, ops = k2_train_bound(pts, feats, 10)
    n_pts = got[1].numel()
    log(f"[kernel] streaming_sample_mean_var training form (host rgb): "
        f"V={feats.shape[0]} N={n_pts} C={feats.shape[-1]}: pixel_mask "
        f"equal (share {float(got[1].float().mean()):.4f}); globalfeat "
        f"max_abs_err={fwd_err:.3e} max_rel_err={fwd_rel:.3e} (tol: mask "
        f"exact, rel 1e-5); bitwise equal "
        f"{all(torch.equal(a, b) for a, b in zip(got, want))} ms={ms:.4f} "
        f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}; "
        f"{nbytes} B, {ops} FLOP)")
    train_form = dict(max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound_ms, bound_by=bound_by)

    gf, _, s1u, cnt = render._k2_launch(*args, for_grad=True)
    g = torch.randn(gf.shape, generator=gen, device=gf.device)
    bargs = (pts, proj, img_hw, feats, g, gf, s1u, cnt)
    d = render.streaming_sample_mean_var_backward(*bargs)
    again = render.streaming_sample_mean_var_backward(*bargs)
    want = render.streaming_sample_mean_var_backward_plain(*bargs)
    torch.cuda.synchronize()
    if not torch.equal(d, again):
        raise SystemExit("K2 backward: two runs differ")
    err = float((d - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    b_ms = cuda_time_ms(
        lambda: render.streaming_sample_mean_var_backward(*bargs), 10)
    b_plain_ms = cuda_time_ms(
        lambda: render.streaming_sample_mean_var_backward_plain(*bargs), 2,
        warmup=1)
    # its passes, each on the last one's outputs: pass 0 (keys and
    # cotangents), the index preparation (the counting sort), pass 1 (the
    # windows' sums), pass 2 (the unpack)
    keys, coef = render._backward_keys(*bargs)
    n_win = feats.shape[1] * feats.shape[2]
    order, off = render._window_order_launch(keys, n_win)
    packed = render._window_sums(pts, proj, img_hw, feats, coef, order, off)
    passes = {
        "pass0_ms": cuda_time_ms(lambda: render._backward_keys(*bargs), 10),
        "index_ms": cuda_time_ms(
            lambda: render._window_order_launch(keys, n_win), 10),
        "pass1_ms": cuda_time_ms(lambda: render._window_sums(
            pts, proj, img_hw, feats, coef, order, off), 10),
        "pass2_ms": cuda_time_ms(lambda: render._unpack(packed, off, feats),
                                 10)}
    held = int(((off[1:] - off[:-1]) > 0).sum())
    longest = int((off[1:] - off[:-1]).max())
    del keys, coef, order, off, packed
    idx, rows, kept = k2_scatter_rows(render, *bargs)
    flat = torch.zeros((feats.numel() // feats.shape[-1], feats.shape[-1]),
                       device=feats.device)
    library_ms = cuda_time_ms(lambda: flat.index_add_(0, idx, rows), 5)
    n_rows = idx.numel()
    del idx, rows, flat
    b_bound, b_by, b_bytes, b_ops = k2_backward_bound(pts, feats, kept)
    pairs = n_pts * feats.shape[0]
    unseen = int((cnt == 0).sum())
    log(f"[kernel] streaming_sample_mean_var_backward: V={feats.shape[0]} "
        f"N={n_pts} C={feats.shape[-1]}; {pairs} (point, view) pairs, "
        f"{kept} with a non-zero tap weight ({kept / pairs:.4f}), {unseen} "
        f"points seen by no view: two runs bitwise equal; d featmaps "
        f"max_abs_err={err:.3e} (rel {rel:.3e} of max "
        f"{float(want.abs().max()):.3e}, tol 1e-5); {held} of "
        f"{feats.numel() // feats.shape[-1]} windows hold a pair, the "
        f"longest {longest} ms={b_ms:.4f} (pass 0 {passes['pass0_ms']:.4f}, "
        f"index preparation {passes['index_ms']:.4f}, pass 1 "
        f"{passes['pass1_ms']:.4f}, pass 2 {passes['pass2_ms']:.4f}) "
        f"plain_ms={b_plain_ms:.4f} library_ms={library_ms:.4f} "
        f"(index_add_ of {n_rows} weighted tap rows into the flat map) "
        f"bound_ms={b_bound:.4f} ({b_by}; {b_bytes} B, {b_ops} FLOP)")
    if rel > 1e-5:
        raise SystemExit(f"K2 backward disagrees with its plain version: "
                         f"rel {rel:.3e}")
    return train_form, dict(max_abs_err=err, ms=b_ms, plain_ms=b_plain_ms,
                            bound_ms=b_bound, bound_by=b_by,
                            library_ms=library_ms, **passes)


def window_reuse(render, model, batch):
    """Shares of the (sample, view) pairs of ``batch``'s first chunk of
    rays whose feature window (its start pixel) equals the previous
    sample's on the ray, and of those K2 can reuse (the second of each
    lane group's two consecutive points)."""
    import torch

    with torch.inference_mode():
        feats = model.render_featmaps(model.extract_2d(batch["imgs"]))
        proj = model.render_projection(batch["intrinsic"],
                                       batch["extrinsics"], feats.device)
        pts, _ = render.sample_along_camera_ray(
            batch["ray_o"].reshape(-1, 3)[:CHUNK],
            batch["ray_d"].reshape(-1, 3)[:CHUNK], *model.near_far_range,
            model.n_samples)
    r, s, _ = pts.shape
    fh, fw = feats.shape[1:3]
    h, w = model.meta.img_shape
    fsx, fsy = render._scale(fw, w), render._scale(fh, h)
    pix, _ = render.project_to_views(pts.reshape(-1, 3), proj)
    fx = torch.clamp(torch.floor(pix[..., 0] * fsx), 0, fw - 1)
    fy = torch.clamp(torch.floor(pix[..., 1] * fsy), 0, fh - 1)
    idx = (fy * fw + fx).reshape(-1, r, s)
    same = idx[..., 1:] == idx[..., :-1]
    pairs = idx.numel()
    return (float(same.sum()) / pairs,
            float(same[..., 0::2].sum()) / pairs)


def ray_cases(model, scene, batch, img_hw):
    """K2's inputs at one chunk of the render path (the first 2048 rays
    of ``scene``'s target view, 64 samples, the 50 views: the first
    launch of ``render_full(batch)``), and the edge cases:
    points above the scene (behind every camera: they look down),
    points whose pixels fall in the partial windows (-1, 0) and
    (size - 1, size) of view 0, and a view that sees no point."""
    import numpy as np
    import torch

    from nerfdet_tpu_torch.ops import render

    dev = batch["imgs"].device
    with torch.inference_mode():
        feats = model.render_featmaps(model.extract_2d(batch["imgs"]))
    images = batch["denorm_images"]
    proj = model.render_projection(scene["intrinsic"], scene["extrinsics"],
                                   dev)
    pts, _ = render.sample_along_camera_ray(
        torch.as_tensor(scene["ray_o"][0, :CHUNK], device=dev),
        torch.as_tensor(scene["ray_d"][0, :CHUNK], device=dev),
        *model.near_far_range, model.n_samples)
    above = pts[:64].clone()
    above[..., 2] += 100.0
    h, w = img_hw
    k = scene["intrinsic"][:3, :3].astype(np.float64)
    k[:2] /= model.meta.ori_shape[0] / model.meta.img_shape[0]
    c2w = np.linalg.inv(scene["extrinsics"][0].astype(np.float64))
    pix = [(x, y) for y in np.linspace(1, h - 2, 16)
           for x in (-0.5, -0.9, -0.02, w - 0.5, w - 1 + 0.3, w - 0.01)]
    pix += [(x, y) for x in np.linspace(1, w - 2, 16)
            for y in (-0.5, -0.9, h - 0.5, h - 1 + 0.3)]
    edge = [c2w[:3, :3] @ (d * np.linalg.solve(k, [x, y, 1.0]))
            + c2w[:3, 3] for d in (1.0, 2.5, 5.0) for x, y in pix]
    edge = torch.as_tensor(np.asarray(edge, np.float32).reshape(
        3, len(pix), 3), device=dev)
    blind = proj.clone()
    blind[0, 0] += 1e4 * blind[0, 2]  # view 0's pixels move 1e4 right
    return [("render chunk", pts, images, feats, proj, True),
            ("behind every camera", above, images, feats, proj, False),
            ("partial edge windows", edge, images, feats, proj, False),
            ("a view with no valid point", pts, images, feats, blind,
             False)]


class NvsScenes(list):
    """Scenes as ``run_nvs_eval`` reads a dataset: ``len``, ``[i]`` and
    ``pipeline.pad_size`` / ``.margin`` of the target views' ray grid."""

    def __init__(self, scenes, grid_hw, margin):
        super().__init__(scenes)
        self.pipeline = types.SimpleNamespace(pad_size=grid_hw,
                                              margin=margin)


def nvs_dataset(scene, intrinsic, hw):
    """The scene's one target view as an ``NvsScenes`` item: its rays
    and targets put back in image order, (1, R, ...). The rays come
    shuffled; each one's pixel is recovered from the target camera
    (every synthetic camera looks at ``LOOK_AT``, from ``ray_o``)."""
    import numpy as np

    from nerfdet_tpu_torch.data.synthetic import LOOK_AT, _look_at

    rot = _look_at(scene["ray_o"][0], LOOK_AT)[:3, :3]
    cam = scene["ray_d"].astype(np.float64) @ rot  # rows (x, y, 1)
    px = np.rint(cam[:, 0] / cam[:, 2] * intrinsic[0, 0] + intrinsic[0, 2]
                 - 0.5).astype(np.int64) - MARGIN
    py = np.rint(cam[:, 1] / cam[:, 2] * intrinsic[1, 1] + intrinsic[1, 2]
                 - 0.5).astype(np.int64) - MARGIN
    flat = py * (hw[1] - 2 * MARGIN) + px
    order = np.argsort(flat)
    if not np.array_equal(flat[order], np.arange(len(flat))):
        raise SystemExit("the target rays do not tile the target view")
    item = dict(scene)
    for key in ("ray_o", "ray_d", "gt_rgb", "gt_depth"):
        item[key] = scene[key][order][None]
    return NvsScenes([item], hw, MARGIN)


def render_stage_times(model, render, batch, n_rays, iters=2):
    """Per-stage CUDA-event times (ms, mean of ``iters``) of the real
    ``render_full(batch, CHUNK)``, and the last run's shares of sample
    points seen by more than one view and of rays whose mask is set.

    Events come from forward hooks on ``mapping`` and the NeRF MLP, and
    from wrappers of ``extract_2d`` (an instance attribute over the
    method) and of the renderer functions ``render_rays_chunk`` calls
    through its module: ``_k2_launch`` (K2, its statistics fused in,
    which the counted wrapper ``streaming_sample_mean_var`` calls) and
    ``raw2outputs``; the kernel wrapper and its launch count are left as
    they are."""
    import torch

    spans, masks = [], {"pixel": [], "ray": []}

    def begin(label):
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        spans.append([label, start, None])
        return spans[-1]

    def finish(span):
        span[2] = torch.cuda.Event(enable_timing=True)
        span[2].record()

    def timed(label, fn, keep=None):
        def run(*args, **kwargs):
            span = begin(label)
            out = fn(*args, **kwargs)
            finish(span)
            if keep is not None:
                masks[keep].append(out[1] if keep == "pixel"
                                   else out["mask"])
            return out
        return run

    originals = {name: getattr(render, name) for name in (
        "_k2_launch", "raw2outputs")}
    render._k2_launch = timed("K2 (fused)", originals["_k2_launch"],
                              "pixel")
    render.raw2outputs = timed("compositing (raw2outputs)",
                               originals["raw2outputs"], "ray")
    model.extract_2d = timed("extract_2d (ResNet-50 + FPN)",
                             type(model).extract_2d.__get__(model))
    hooks = []
    for label, m in (("mapping (cropped featmaps)", model.mapping),
                     ("NeRF MLP", model.nerf_mlp)):
        hooks.append(m.register_forward_pre_hook(
            lambda m, args, label=label: stack.append(begin(label))))
        hooks.append(m.register_forward_hook(
            lambda m, args, out: finish(stack.pop())))
    stack, totals = [], {}
    try:
        with torch.inference_mode():
            model.render_full(batch, CHUNK)  # warm-up
            for _ in range(iters):
                spans.clear()
                masks["pixel"].clear()
                masks["ray"].clear()
                span = begin("render_full")
                model.render_full(batch, CHUNK)
                finish(span)
                for label, start, end in spans:
                    totals.setdefault(label, []).append((start, end))
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            setattr(render, name, fn)
        del model.extract_2d
        for h in hooks:
            h.remove()
    out = {label: sum(a.elapsed_time(b) for a, b in pairs) / iters
           for label, pairs in totals.items()}
    pixel = torch.cat(masks["pixel"])[:n_rays]
    ray = torch.cat(masks["ray"])[:n_rays]
    return out, float(pixel.float().mean()), float(ray.float().mean())


def render_path(api, render, voxel, pointnet, model, dataset, card, nms_pre):
    """Phase 6: novel-view rendering of one full target view."""
    import math

    import numpy as np
    import torch

    item = dataset[0]
    n_rays = item["ray_o"].shape[1]
    expect = math.ceil(n_rays / CHUNK)
    for fn in (voxel.fusion_carry, pointnet.furthest_point_sample,
               render.streaming_sample_mean_var):
        fn.launches = 0
    t0 = time.perf_counter()
    metrics = api.run_nvs_eval(model, dataset, chunk=CHUNK, progress=False)
    first_s = time.perf_counter() - t0
    launches = render.streaming_sample_mean_var.launches
    log(f"[render] run_nvs_eval: {n_rays} rays x {model.n_samples} samples "
        f"from {item['imgs'].shape[0]} views at chunk {CHUNK}: psnr "
        f"{metrics['psnr']:.4f} ssim {metrics['ssim']:.4f} rmse "
        f"{metrics['rmse']:.4f} (random weights); launches: "
        f"streaming_sample_mean_var {launches}, fused_mean_cov "
        f"{voxel.fusion_carry.launches}, furthest_point_sample "
        f"{pointnet.furthest_point_sample.launches}; first call "
        f"{first_s:.2f} s")
    if launches != expect:
        raise SystemExit(f"render_full launched streaming_sample_mean_var "
                         f"{launches} times, expected {expect}")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise SystemExit(f"non-finite NVS metrics {metrics}")

    batch = api.render_batch(model, item)
    near, far = model.near_far_range
    with torch.inference_mode():
        rgb, depth = model.render_full(batch, CHUNK)
        kernel_fn = render.streaming_sample_mean_var
        render.streaming_sample_mean_var = \
            render.streaming_sample_mean_var_plain
        try:
            rgb_p, depth_p = model.render_full(batch, CHUNK)
        finally:
            render.streaming_sample_mean_var = kernel_fn
    torch.cuda.synchronize()
    if (tuple(rgb.shape) != (n_rays, 3) or tuple(depth.shape) != (n_rays,)
            or not (torch.isfinite(rgb).all() and torch.isfinite(depth).all())
            or float(rgb.min()) < 0 or float(rgb.max()) > 1
            or float(depth.min()) < near or float(depth.max()) > far):
        raise SystemExit("render_full outputs: wrong shape, non-finite or "
                         "out of range")
    rgb_diff = float((rgb - rgb_p).abs().max())
    depth_diff = float((depth - depth_p).abs().max())
    log(f"[render] rgb in [{float(rgb.min()):.4f}, {float(rgb.max()):.4f}], "
        f"depth in [{float(depth.min()):.4f}, {float(depth.max()):.4f}] "
        f"(near/far {near}/{far}); kernel vs plain K2 through render_full: "
        f"rgb max |diff| {rgb_diff:.3e} (tol 1e-5), depth {depth_diff:.3e}")
    if rgb_diff > 1e-5:
        raise SystemExit("kernel and plain K2 renders disagree")

    # the forward on a batch that carries the first chunk's rays
    fwd = dict(item, ray_o=item["ray_o"][0, :CHUNK],
               ray_d=item["ray_d"][0, :CHUNK])
    fbatch = {**api.device_batch(model, fwd), **api.render_batch(model, fwd)}
    render.streaming_sample_mean_var.launches = 0
    out = api.eval_step(model, fbatch, nms_pre)
    fwd_launches = render.streaming_sample_mean_var.launches
    fwd_diff = float((out["render_rgb"] - rgb[:CHUNK]).abs().max())
    log(f"[render] eval_step with {CHUNK} rays: {fwd_launches} "
        f"streaming_sample_mean_var launch, {tuple(out['boxes'].shape)} "
        f"candidates, "
        f"render_rgb vs render_full's first chunk max |diff| "
        f"{fwd_diff:.3e} (tol 1e-5)")
    if fwd_launches != 1 or fwd_diff > 1e-5:
        raise SystemExit("the forward with rays did not render as "
                         "render_full does")

    stages, pixel_share, ray_share = render_stage_times(
        model, render, batch, n_rays)
    # the MLP's work from its layer shapes, over the padded chunks
    mlp_flop = 2 * expect * CHUNK * model.n_samples * sum(
        m.in_features * m.out_features for m in model.nerf_mlp.modules()
        if isinstance(m, torch.nn.Linear))
    for label, ms in stages.items():
        extra = ""
        if label == "NeRF MLP":
            extra = (f" ({mlp_flop / 1e9:.1f} GFLOP f32, "
                     f"{mlp_flop / ms / 1e9:.2f} TFLOP/s)")
        elif label.startswith("K2"):
            extra = f" ({ms / expect:.4f} ms per chunk, {expect} chunks)"
        log(f"[stage] render {label}: {ms:.3f} ms{extra}")
    log(f"[render] sample points seen by more than one view: "
        f"{pixel_share:.4f}; rays with the mask set: {ray_share:.4f}")
    same, reused = window_reuse(render, model, batch)
    log(f"[render] first chunk's (sample, view) pairs whose feature window "
        f"equals the previous sample's: {same:.4f}; reused by K2 (the "
        f"second of each lane group's two points): {reused:.4f}")

    # throughput on the host clock, and peak memory
    iters = 3
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(iters):
            model.render_full(batch, CHUNK)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    api.run_nvs_eval(model, dataset, chunk=CHUNK, progress=False)
    nvs_dt = time.perf_counter() - t0
    log(f"[render] {1 / dt:.3f} views/s ({dt * 1e3:.2f} ms per view: "
        f"render_full, {n_rays} rays); {1 / nvs_dt:.3f} views/s with "
        f"run_nvs_eval's host copies and metrics ({nvs_dt * 1e3:.2f} ms); "
        f"peak memory {peak / 2**30:.2f} GiB; measured on {card}")
    return launches


TRAINED_PARTS = ("backbone.layer3.", "neck.", "mapping.", "nerf_mlp.",
                 "neck_3d.", "bbox_head.")


def train_grads(api, model, scene):
    """Loss, metrics and gradients of one train-step forward + backward
    (no update) on ``scene``, and the FPN output's gradient."""
    import torch

    from nerfdet_tpu_torch.train.step import (reduce_loss_terms,
                                              scene_loss_terms)

    fpn_out = []

    def keep(module, args, out):
        out[0].retain_grad()
        fpn_out.append(out[0])

    hook = model.neck.register_forward_hook(keep)
    model.zero_grad()
    try:
        loss, metrics = reduce_loss_terms(
            [scene_loss_terms(model, b) for b in api.train_batch(model,
                                                                  [scene])])
        loss.backward()
    finally:
        hook.remove()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(loss.detach()), metrics, grads, fpn_out[0].grad.clone()


def timed_steps(tr, batch, counters, iters=5):
    """2 warm-up steps of ``tr``, then ``iters`` timed on the host clock
    with every count of ``counters`` set to 0 just before. Returns the
    metrics of each timed step, the seconds a step, the counts and the
    peak memory."""
    import torch

    for _ in range(2):
        tr.step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    history = []
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    for _ in range(iters):
        history.append(tr.step(batch))
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    return (history, dt, [fn.launches for fn in counters],
            torch.cuda.max_memory_allocated())


def step_stage_times(tr, batch, iters=3):
    """CUDA-event times (ms, mean of ``iters``) of one train step's
    stages: the forward and loss, the backward, the optimizer."""
    import torch

    from nerfdet_tpu_torch.train.step import (reduce_loss_terms,
                                              scene_loss_terms)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    stage = {"forward + loss": 0.0, "backward": 0.0, "optimizer": 0.0}
    for _ in range(iters):
        tr.optimizer.zero_grad()
        ev[0].record()
        loss, _ = reduce_loss_terms([scene_loss_terms(tr.model, b)
                                     for b in batch])
        ev[1].record()
        loss.backward()
        ev[2].record()
        tr.optimizer.step()
        ev[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(stage):
            stage[k] += ev[i].elapsed_time(ev[i + 1]) / iters
    return stage


RAY_KEYS = ("ray_o", "ray_d", "gt_rgb", "gt_depth")


def train_path(api, voxel, pointnet, render, card):
    """Phase 7: NeRF-Det-R50 detection training at full width
    (``rgb_supervision=False``, a scene without rays)."""
    import torch

    from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfdet_tpu_torch.train.optim import param_labels

    from nerfdet_tpu_torch.config import Config

    t0 = time.perf_counter()
    cfg = Config.fromfile(CONFIG)
    cfg.model["rgb_supervision"] = False
    tr = api.init_trainer(cfg, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    model = tr.model
    meta = model.meta
    scene = make_synthetic_scene(seed=SEED + 1, n_views=N_VIEWS,
                                 n_targets=1, hw=meta.img_shape,
                                 pad_hw=meta.pad_shape, n_rand=8, n_boxes=4,
                                 max_gt=8, margin=MARGIN)
    scene = {k: v for k, v in scene.items() if k not in RAY_KEYS}
    labels = param_labels(model)
    n_label = {k: sum(v == k for v in labels.values())
               for k in ("frozen", "backbone", "main")}
    start = {k: v.clone() for k, v in model.state_dict().items()}
    log(f"[train] init_trainer: {sum(p.numel() for p in model.parameters())} "
        f"parameters ({n_label['frozen']} tensors frozen, "
        f"{n_label['backbone']} backbone at lr x{tr.optimizer.lr_mult}, "
        f"{n_label['main']} main), lr {tr.optimizer.schedule(0):.1e}, clip "
        f"{tr.optimizer.max_norm}; scene {N_VIEWS} views, "
        f"{int(scene['gt_mask'].sum())} boxes: "
        f"{time.perf_counter() - t0:.1f} s")

    # one forward + backward with the kernels, then with the plain K1
    # forward and backward, from the same weights (train mode)
    model.train()
    loss_k, _, grads_k, fpn_k = train_grads(api, model, scene)
    kernel_fn = voxel.fusion_carry
    voxel.fusion_carry = voxel.fusion_carry_plain  # autograd through it
    try:
        model.load_state_dict(start)
        loss_p, _, grads_p, fpn_p = train_grads(api, model, scene)
    finally:
        voxel.fusion_carry = kernel_fn
    model.load_state_dict(start)
    model.zero_grad()
    torch.cuda.synchronize()
    if float(fpn_p.abs().max()) == 0.0:
        raise SystemExit("no gradient reached the FPN output")
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    map_rel = max(float((grads_k[n] - grads_p[n]).abs().max())
                  / float(grads_p[n].abs().max())
                  for n in ("mapping.0.weight", "mapping.0.bias"))
    fpn_rel = float((fpn_k - fpn_p).norm() / fpn_p.norm())
    log(f"[train] kernel vs plain K1 (forward and backward) for one step's "
        f"gradients: loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}, "
        f"tol 1e-5); mapping gradients max rel {map_rel:.3e} (tol 1e-3 x "
        f"max); FPN-output gradient rel norm {fpn_rel:.3e} (tol 1e-3)")
    if loss_rel > 1e-5 or map_rel > 1e-3 or fpn_rel > 1e-3:
        raise SystemExit("kernel and plain K1 training steps disagree")

    # the path: 2 warm-up steps, then 5 timed, K1 forward and backward
    # once a step, K2 never
    batch = api.train_batch(model, [scene])
    counters = (voxel.fusion_carry, voxel.fusion_carry_backward,
                pointnet.furthest_point_sample,
                render.streaming_sample_mean_var)
    iters = 5
    history, dt, launches, peak = timed_steps(tr, batch, counters, iters)
    last = {k: float(v) for k, v in history[-1].items()}
    log(f"[train] {iters} steps: launches fused_mean_cov {launches[0]}, "
        f"fused_mean_cov_backward {launches[1]}, furthest_point_sample "
        f"{launches[2]}, streaming_sample_mean_var {launches[3]}; last "
        f"step " + ", ".join(f"{k} {v:.6g}" for k, v in last.items()))
    if launches != [iters, iters, 0, 0]:
        raise SystemExit(f"the training path launched {launches}, expected "
                         f"K1 forward and backward once a step, K2 never")
    import math

    for m in history:
        if not all(math.isfinite(float(v)) for v in m.values()):
            raise SystemExit(f"non-finite train metrics {m}")
    if float(history[-1]["n_pos"]) <= 0:
        raise SystemExit("no positive voxels in the training scene")
    state = model.state_dict()
    moved = {part: False for part in TRAINED_PARTS}
    for name, label in labels.items():
        changed = not torch.equal(state[name], start[name])
        if label == "frozen" and changed:
            raise SystemExit(f"frozen parameter {name} changed")
        for part in TRAINED_PARTS:
            moved[part] |= name.startswith(part) and changed
    if not all(moved.values()):
        raise SystemExit(f"parts without a changed parameter: "
                         f"{[p for p, v in moved.items() if not v]}")
    log(f"[train] frozen parameters bitwise unchanged; a parameter changed "
        f"in each of {', '.join(p.rstrip('.') for p in TRAINED_PARTS)}")

    for k, ms in step_stage_times(tr, batch).items():
        log(f"[stage] train {k}: {ms:.3f} ms")
    log(f"[train] {1 / dt:.3f} steps/s ({dt * 1e3:.2f} ms per step: "
        f"Trainer.step, one scene of {N_VIEWS} views, host clock after 2 "
        f"warm-up steps); peak memory {peak / 2**30:.2f} GiB; measured on "
        f"{card}")
    return launches[1]


def train_scene(model, seed):
    """A seeded 4-box scene of the config's geometry with every ray of its
    target view (the intrinsic scaled to ``ori_shape``, as the renderer
    and the fusion take it)."""
    import numpy as np

    from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene

    meta = model.meta
    h, w = meta.img_shape
    scene = make_synthetic_scene(seed=seed, n_views=N_VIEWS, n_targets=1,
                                 hw=(h, w), pad_hw=meta.pad_shape,
                                 n_rand=(h - 2 * MARGIN) * (w - 2 * MARGIN),
                                 n_boxes=4, max_gt=8, margin=MARGIN)
    scene["intrinsic"] = scene["intrinsic"].copy()
    scene["intrinsic"][:2] *= np.float32(meta.ori_shape[0] / h)
    return scene


def host_ray_stream(ray_stats, model, scene):
    """``prepare_rays`` at the model's N_rand, near/far and samples from
    a seeded RandomState, and its host-clock seconds."""
    import numpy as np

    t0 = time.perf_counter()
    out = ray_stats.prepare_rays(
        scene, np.random.RandomState(SEED), model.n_rand,
        model.near_far_range, model.n_samples, model.meta.ori_shape,
        model.meta.img_shape)
    return out, time.perf_counter() - t0


def joint_train_path(api, voxel, pointnet, render, card):
    """Phase 8: NeRF-Det-R50 joint detection + NVS training at full
    width: the config's ``rgb_supervision`` (True), N_rand rays of 64
    samples a step with the host ray stream, K2 in its training form and
    its backward."""
    import math

    import torch

    from nerfdet_tpu_torch.data import ray_stats
    from nerfdet_tpu_torch.train.step import scene_loss_terms

    t0 = time.perf_counter()
    tr = api.init_trainer(CONFIG, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    model = tr.model
    scene = train_scene(model, SEED + 1)
    n_all = scene["ray_o"].shape[0]
    prepared, host_s = host_ray_stream(ray_stats, model, scene)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    log(f"[train+nvs] init_trainer: rgb_supervision from the config, "
        f"N_rand {model.n_rand} rays x {model.n_samples} samples in "
        f"{model.near_far_range}; scene {N_VIEWS} views, "
        f"{int(scene['gt_mask'].sum())} boxes: "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"[train+nvs] host ray stream (prepare_rays: {model.n_rand} of "
        f"{n_all} rays drawn, stratified z, rgb sums over {N_VIEWS} views, "
        f"numpy, outside the timed step): {host_s * 1e3:.2f} ms on the "
        f"host")

    # one forward + backward with the kernels, then with the plain K2
    # forward (autograd through it) from the same weights
    model.train()
    loss_k, metrics_k, grads_k, fpn_k = train_grads(api, model, prepared)
    kernel_fn = render.streaming_sample_mean_var
    render.streaming_sample_mean_var = render.streaming_sample_mean_var_plain
    try:
        model.load_state_dict(start)
        loss_p, _, grads_p, fpn_p = train_grads(api, model, prepared)
    finally:
        render.streaming_sample_mean_var = kernel_fn
    model.load_state_dict(start)
    torch.cuda.synchronize()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    map_rel = max(float((grads_k[n] - grads_p[n]).norm())
                  / float(grads_p[n].norm())
                  for n in ("mapping.0.weight", "mapping.0.bias"))
    fpn_rel = float((fpn_k - fpn_p).norm() / fpn_p.norm())
    log(f"[train+nvs] kernel vs plain K2 (forward and backward) for one "
        f"step's gradients: loss {loss_k:.6f} vs {loss_p:.6f} (rel "
        f"{loss_rel:.3e}, tol 1e-5; bitwise {loss_k == loss_p}), loss_nvs "
        f"{float(metrics_k['loss_nvs'].detach()):.6f}; mapping gradients rel "
        f"norm {map_rel:.3e} (tol 1e-4); FPN-output gradient rel norm "
        f"{fpn_rel:.3e} (tol 1e-4)")
    if loss_rel > 1e-5 or map_rel > 1e-4 or fpn_rel > 1e-4:
        raise SystemExit("kernel and plain K2 training steps disagree")

    # the render side alone trains mapping (through K2's backward)
    batch = api.train_batch(model, [prepared])
    model.zero_grad()
    terms = scene_loss_terms(model, batch[0])
    terms["loss_nvs"].backward()
    nvs_map = float(model.mapping[0].weight.grad.abs().max())
    model.zero_grad()
    model.load_state_dict(start)
    log(f"[train+nvs] loss_nvs alone: max |d mapping.weight| {nvs_map:.3e}")
    if not nvs_map > 0:
        raise SystemExit("no gradient reached mapping from the render")

    # the path: 2 warm-up steps, then 5 timed; K1 forward and backward and
    # K2's training form and backward once a step
    counters = (voxel.fusion_carry, voxel.fusion_carry_backward,
                pointnet.furthest_point_sample,
                render.streaming_sample_mean_var,
                render.streaming_sample_mean_var_backward)
    iters = 5
    history, dt, launches, peak = timed_steps(tr, batch, counters, iters)
    last = {k: float(v) for k, v in history[-1].items()}
    log(f"[train+nvs] {iters} steps: launches fused_mean_cov {launches[0]}, "
        f"fused_mean_cov_backward {launches[1]}, furthest_point_sample "
        f"{launches[2]}, streaming_sample_mean_var {launches[3]}, "
        f"streaming_sample_mean_var_backward {launches[4]}; last step "
        + ", ".join(f"{k} {v:.6g}" for k, v in last.items()))
    if launches != [iters, iters, 0, iters, iters]:
        raise SystemExit(f"the joint training path launched {launches}, "
                         f"expected K1 and K2 forward and backward once a "
                         f"step, K3 never")
    for m in history:
        if not all(math.isfinite(float(v)) for v in m.values()):
            raise SystemExit(f"non-finite train metrics {m}")
    if float(history[-1]["n_pos"]) <= 0 or "loss_nvs" not in last:
        raise SystemExit("no positive voxels or no NVS loss")

    for k, ms in step_stage_times(tr, batch).items():
        log(f"[stage] joint train {k}: {ms:.3f} ms")
    log(f"[train+nvs] {1 / dt:.3f} steps/s ({dt * 1e3:.2f} ms per step: "
        f"Trainer.step, one scene of {N_VIEWS} views and {model.n_rand} "
        f"rays, host clock after 2 warm-up steps; the host ray stream "
        f"excluded); peak memory {peak / 2**30:.2f} GiB; measured on "
        f"{card}")
    return launches[4]


# phase 9: the flagship trained and evaluated from files
RUNTIME_HW = (484, 648)  # half ScanNet's 968x1296: keep-ratio to 239x320
RUNTIME_TRAIN_VIEWS = 60
RUNTIME_VAL_VIEWS = 110  # the test pipeline's 101 draws without repeats
RUNTIME_MAX_STEPS = 8  # through one epoch boundary (6 steps an epoch)
RUNTIME_WORKERS = 8  # the second run's loader threads
RUNTIME_TIMED = slice(2, None)  # steps 3.. on the host clock


class HostClock:
    """Seconds the loader threads spend in named host functions, by
    wrapping module attributes (restored by ``restore``); calls from the
    main thread (validation, evaluation) are not counted."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.main = threading.main_thread
        self.current = threading.current_thread
        self.secs, self.calls, self.saved = {}, {}, []

    def wrap(self, owner, name, key):
        fn = getattr(owner, name)

        def timed(*args, **kwargs):
            if self.current() is self.main():
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                with self.lock:
                    self.secs[key] = (self.secs.get(key, 0.0)
                                      + time.perf_counter() - t0)
                    self.calls[key] = self.calls.get(key, 0) + 1

        setattr(owner, name, timed)
        self.saved.append((owner, name, fn))

    def take(self):
        """(scenes, seconds a scene by key) since the last take."""
        with self.lock:
            n = max(self.calls.get("scene", 0), 1)
            out = {k: v / n for k, v in self.secs.items()}
            self.secs, self.calls = {}, {}
        return n, out

    def restore(self):
        for owner, name, fn in reversed(self.saved):
            setattr(owner, name, fn)
        self.saved = []


def counted_trainers(api, counters, per_step):
    """Wrap ``api.init_trainer`` so every ``Trainer.step`` appends the
    launches of ``counters`` it made to ``per_step``. Returns the
    original, to put back."""
    original = api.init_trainer

    def init_trainer(*args, **kwargs):
        tr = original(*args, **kwargs)
        step = tr.step

        def counted(batch):
            before = [fn.launches for fn in counters]
            out = step(batch)
            per_step.append([fn.launches - b
                             for fn, b in zip(counters, before)])
            return out

        tr.step = counted
        return tr

    api.init_trainer = init_trainer
    return original


def runtime_options(cfg, train_root, val_root):
    """``--options`` pointing the config's data at the written scenes."""
    train = ("data.train.dataset." if cfg.data["train"].get("type")
             == "RepeatDataset" else "data.train.")
    return [f"{train}data_root={train_root}/",
            f"{train}ann_file={train_root}/scannet_infos_train.pkl",
            f"data.val.data_root={val_root}/",
            f"data.val.ann_file={val_root}/scannet_infos_val.pkl",
            f"data.test.data_root={val_root}/",
            f"data.test.ann_file={val_root}/scannet_infos_val.pkl",
            f"ori_shape=({RUNTIME_HW[0]},{RUNTIME_HW[1]})"]


def report_run(tag, result, per_step, names, clock, peak, card):
    """Print a train run's steps, its rates from files and its host
    split; return (steps/s over the timed steps, mean loader wait)."""
    import math

    hist = result["history"]
    for h, launches in zip(hist, per_step):
        losses = ", ".join(f"{k} {h[k]:.5g}" for k in (
            "loss", "loss_cls", "loss_bbox", "loss_centerness", "loss_nvs",
            "grad_norm") if k in h)
        log(f"[runtime] {tag} step {h['step']} (epoch {h['epoch']}, lr "
            f"{h['lr']:.3e}): waited {h['data_s']:.3f} s on the loader, "
            f"step {h['step_s']:.3f} s; launches "
            + ", ".join(f"{n} {c}" for n, c in zip(names, launches))
            + f"; {losses}")
        if not all(math.isfinite(h[k]) for k in h if k.startswith(
                ("loss", "grad"))) or "loss_nvs" not in h:
            raise SystemExit(f"{tag}: non-finite or missing losses {h}")
    timed = hist[RUNTIME_TIMED]
    total = sum(h["data_s"] + h["step_s"] for h in timed)
    wait = sum(h["data_s"] for h in timed) / len(timed)
    n, split = clock.take()
    decode = split.get("decode", 0.0) + split.get("resize", 0.0)
    log(f"[runtime] {tag}: {len(timed) / total:.3f} steps/s from files "
        f"(steps {timed[0]['step']}-{timed[-1]['step']} on the host clock, "
        f"loader wait + Trainer.step), mean loader wait {wait:.3f} s a "
        f"step; peak memory {peak / 2**30:.2f} GiB; measured on {card}")
    log(f"[runtime] {tag}: host time a scene in the loader threads "
        f"({n} scenes): {split.get('scene', 0.0):.3f} s, of it decode + "
        f"resize {decode:.3f} s (decode {split.get('decode', 0.0):.3f}, "
        f"resize {split.get('resize', 0.0):.3f}), rgb sums "
        f"{split.get('rgb sums', 0.0):.3f} s, ray stream "
        f"{split.get('ray stream', 0.0):.3f} s")
    return len(timed) / total, wait


def runtime_path(api, voxel, pointnet, render, card):
    """Phase 9: the flagship trained and evaluated from a ScanNet-layout
    dataset on disk through the port's CLIs, in process. Returns the
    kernels' launches in the first training run."""
    import math
    import tempfile

    import torch

    from nerfdet_tpu_torch.config import Config
    from nerfdet_tpu_torch.data import dataset as dataset_mod
    from nerfdet_tpu_torch.data import pipeline as pipeline_mod
    from nerfdet_tpu_torch.data.dataset import (build_dataset,
                                                rgb_stats_spec_from_config)
    from nerfdet_tpu_torch.data.synthetic import write_synthetic_scannet
    from nerfdet_tpu_torch.models.nerfdet import NerfDet
    from nerfdet_tpu_torch.tools import test as test_cli
    from nerfdet_tpu_torch.tools import train as train_cli

    t_phase = time.perf_counter()
    names = ("fused_mean_cov", "fused_mean_cov_backward",
             "streaming_sample_mean_var",
             "streaming_sample_mean_var_backward")
    counters = (voxel.fusion_carry, voxel.fusion_carry_backward,
                render.streaming_sample_mean_var,
                render.streaming_sample_mean_var_backward)
    every = counters + (pointnet.furthest_point_sample,)
    cfg = Config.fromfile(CONFIG)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runtime_") as tmp:
        # ---- data on disk ----
        t0 = time.perf_counter()
        train_root = write_synthetic_scannet(
            os.path.join(tmp, "train"), n_scenes=1,
            n_images=RUNTIME_TRAIN_VIEWS, hw=RUNTIME_HW, seed=SEED,
            splits=("train",), workers=8)
        val_root = write_synthetic_scannet(
            os.path.join(tmp, "val"), n_scenes=1,
            n_images=RUNTIME_VAL_VIEWS, hw=RUNTIME_HW, seed=SEED + 1,
            splits=("val",), workers=8)
        log(f"[runtime] wrote a ScanNet-layout dataset (one train scene of "
            f"{RUNTIME_TRAIN_VIEWS} views, one val scene of "
            f"{RUNTIME_VAL_VIEWS}, PNG at {RUNTIME_HW[0]}x{RUNTIME_HW[1]}, "
            f"8 processes): {time.perf_counter() - t0:.1f} s")
        opts = runtime_options(cfg, train_root, val_root)
        cfg.merge_from_options(opts)
        meta = api.scene_meta_from_config(cfg)
        log(f"[runtime] config {CONFIG} with --options ori_shape="
            f"{meta.ori_shape}: img_shape {meta.img_shape}, pad "
            f"{meta.pad_shape}, workers_per_gpu "
            f"{cfg.data['workers_per_gpu']}")

        clock = HostClock()
        clock.wrap(pipeline_mod, "imread", "decode")
        clock.wrap(pipeline_mod, "imresize", "resize")
        clock.wrap(dataset_mod, "host_rgb_stats", "rgb sums")
        clock.wrap(dataset_mod, "host_sample_z", "ray stream")
        clock.wrap(dataset_mod, "host_ray_rgb_stats", "ray stream")
        clock.wrap(dataset_mod.ScanNetMultiViewDataset, "__getitem__",
                   "scene")
        per_step = []
        original_init = counted_trainers(api, counters, per_step)
        try:
            # ---- train, the config's loader threads, with validation ----
            work = os.path.join(tmp, "work")
            args = [CONFIG, "--work-dir", work, "--max-steps",
                    str(RUNTIME_MAX_STEPS), "--options", *opts]
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for fn in every:
                fn.launches = 0
            t0 = time.perf_counter()
            result = train_cli.main(args)
            train_s = time.perf_counter() - t0
            totals = [fn.launches for fn in every]
            peak = torch.cuda.max_memory_allocated()
            log(f"[runtime] tools/train: {len(result['history'])} steps, "
                f"{result['steps_per_epoch']} an epoch, checkpoints "
                f"{[os.path.basename(p) for p in result['checkpoints']]}, "
                f"{len(result['val'])} validations: {train_s:.1f} s")
            rate_1, wait_1 = report_run(
                f"train ({cfg.data['workers_per_gpu']} loader thread)",
                result, per_step, names, clock, peak, card)
            if per_step != [[1, 1, 1, 1]] * RUNTIME_MAX_STEPS:
                raise SystemExit(f"launches a step {per_step}, expected "
                                 f"each kernel once a step")
            n_val = len(result["val"])
            if totals != [RUNTIME_MAX_STEPS + n_val, RUNTIME_MAX_STEPS,
                          RUNTIME_MAX_STEPS, RUNTIME_MAX_STEPS, 0]:
                raise SystemExit(f"run launches {totals}: expected K1 once "
                                 f"a step and a validation scene, the "
                                 f"backwards and K2 once a step, K3 never")
            ckpts = [os.path.basename(p) for p in result["checkpoints"]]
            if ckpts != ["ckpt_1.pth", "ckpt_2.pth"] or n_val != 2:
                raise SystemExit(f"checkpoints {ckpts}, {n_val} validations")
            for m in result["val"]:
                if not all(math.isfinite(v) for v in m.values()):
                    raise SystemExit(f"non-finite validation {m}")
            log(f"[runtime] validation after each epoch (run_eval, "
                f"{cfg.model['nerf_density'] and 'density on'}): "
                + "; ".join(f"mAP_0.25 {m['mAP_0.25']:.4f} mAR_0.25 "
                            f"{m['mAR_0.25']:.4f}" for m in result["val"]))

            # ---- the same from files with more loader threads ----
            per_step.clear()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            result_8 = train_cli.main([
                CONFIG, "--work-dir", os.path.join(tmp, "work8"),
                "--max-steps", str(RUNTIME_MAX_STEPS), "--no-validate",
                "--options", *opts,
                f"data.workers_per_gpu={RUNTIME_WORKERS}"])
            rate_8, wait_8 = report_run(
                f"train ({RUNTIME_WORKERS} loader threads)", result_8,
                per_step, names, clock, torch.cuda.max_memory_allocated(),
                card)
            log(f"[runtime] steps/s from files: {rate_1:.3f} with "
                f"{cfg.data['workers_per_gpu']} loader thread (wait "
                f"{wait_1:.3f} s a step), {rate_8:.3f} with "
                f"{RUNTIME_WORKERS} (wait {wait_8:.3f} s); measured on "
                f"{card}")

            # ---- resume from the first epoch's checkpoint, one step ----
            per_step.clear()
            ckpt_1 = result["checkpoints"][0]
            resumed = train_cli.main([
                CONFIG, "--work-dir", os.path.join(tmp, "resume"),
                "--resume-from", ckpt_1, "--max-steps",
                str(result["steps_per_epoch"] + 1), "--no-validate",
                "--options", *opts])
            step = resumed["history"]
            want = result["history"][result["steps_per_epoch"]]
            log(f"[runtime] resumed from {os.path.basename(ckpt_1)} "
                f"(step {result['steps_per_epoch']}): start epoch "
                f"{resumed['start_epoch'] + 1}, took step "
                f"{[h['step'] for h in step]} at lr "
                f"{[h['lr'] for h in step]} (the first run's step "
                f"{want['step']}: lr {want['lr']}); loss "
                f"{step[0]['loss']:.5g}; launches {per_step}")
            if ([h["step"] for h in step] != [want["step"]]
                    or step[0]["lr"] != want["lr"]
                    or per_step != [[1, 1, 1, 1]]):
                raise SystemExit("the resumed run did not continue the "
                                 "step count and the schedule")
        finally:
            api.init_trainer = original_init
            clock.restore()

        # ---- test: mAP and NVS from the second checkpoint ----
        ckpt_2 = result["checkpoints"][1]
        timers = {}
        models = []

        def timed(owner, name, key):
            fn = getattr(owner, name)

            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                timers[key] = timers.get(key, 0.0) + (time.perf_counter()
                                                      - t0)
                if key == "init_detector":
                    models.append(out)
                return out

            setattr(owner, name, wrapper)
            return owner, name, fn

        saved = [timed(api, "init_detector", "init_detector"),
                 timed(api, "run_eval", "run_eval"),
                 timed(api, "single_scene_test", "eval_step + NMS"),
                 timed(api, "run_nvs_eval", "run_nvs_eval"),
                 timed(NerfDet, "render_full", "render_full")]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for fn in every:
            fn.launches = 0
        try:
            metrics = test_cli.main([CONFIG, ckpt_2, "--eval", "mAP", "nvs",
                                     "--options", *opts])
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
        launches = [fn.launches for fn in every]
        peak = torch.cuda.max_memory_allocated()
        pipe = cfg.data["test"]["pipeline"][0]
        pad = [t for t in pipe["transforms"] if t["type"] == "Pad"][0]["size"]
        rays = ((pad[0] - 2 * pipe["margin"]) * (pad[1] - 2 * pipe["margin"]))
        chunks = -(-rays // cfg.model["N_rand"])
        n_scenes = 1
        sources = pipe["n_images"] - pipe["nerf_target_views"]
        log(f"[runtime] tools/test --eval mAP nvs from "
            f"{os.path.basename(ckpt_2)}: launches fused_mean_cov "
            f"{launches[0]} ({n_scenes} scene), streaming_sample_mean_var "
            f"{launches[2]} ({pipe['nerf_target_views']} target view of "
            f"{pad[0] - 2 * pipe['margin']}x{pad[1] - 2 * pipe['margin']} = "
            f"{rays} rays in chunks of {cfg.model['N_rand']}: {chunks} "
            f"expected), backward kernels {launches[1]} / {launches[3]}, "
            f"furthest_point_sample {launches[4]}")
        if launches != [n_scenes, 0, chunks * pipe["nerf_target_views"],
                        0, 0]:
            raise SystemExit(f"the test CLI launched {launches}")
        keys = sorted(k for k in metrics if k.startswith(
            ("mAP", "mAR", "psnr", "ssim", "rmse")))
        if not all(math.isfinite(metrics[k]) for k in keys):
            raise SystemExit(f"non-finite test metrics {metrics}")
        per_class = sorted(k for k in metrics if "_AP_0.25" in k)
        log("[runtime] test mAP/mAR table: "
            + ", ".join(f"{k} {metrics[k]:.4f}" for k in keys))
        log("[runtime] test AP_0.25 by class (the val scene's GT and "
            "detected classes): " + ", ".join(
                f"{k[:-8]} {metrics[k]:.4f}/{metrics[k[:-8] + '_rec_0.25']:.4f}"
                for k in per_class))
        data_s = timers["run_eval"] - timers["eval_step + NMS"]
        log(f"[runtime] tools/test timings (first calls): init_detector "
            f"{timers['init_detector']:.2f} s; run_eval "
            f"{n_scenes / timers['run_eval']:.3f} scenes/s "
            f"({timers['run_eval']:.3f} s a scene of {sources} source "
            f"views: {data_s:.3f} s loading it from files with its rgb "
            f"sums, {timers['eval_step + NMS']:.3f} s eval_step + NMS); "
            f"run_nvs_eval {1 / timers['run_nvs_eval']:.3f} views/s "
            f"({timers['run_nvs_eval']:.3f} s a view, render_full "
            f"{timers['render_full']:.3f} s); peak memory "
            f"{peak / 2**30:.2f} GiB")

        # warm: the same model and scene once more
        model = models[0]
        ds = build_dataset(cfg.data["test"], test_mode=True,
                           rgb_stats_spec=rgb_stats_spec_from_config(cfg))
        t0 = time.perf_counter()
        scene = ds[0]
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        api.single_scene_test(model, scene, cfg.test_cfg["score_thr"],
                              cfg.test_cfg["iou_thr"],
                              cfg.test_cfg["nms_pre"])
        torch.cuda.synchronize()
        det_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        api.run_nvs_eval(model, ds, chunk=cfg.model["N_rand"],
                         progress=False)
        nvs_s = time.perf_counter() - t0
        log(f"[runtime] warm: a val scene of {sources} source views loads "
            f"in {load_s:.3f} s; eval_step + NMS {det_s * 1e3:.2f} ms "
            f"({1 / det_s:.3f} scenes/s on the card, "
            f"{1 / (load_s + det_s):.3f} from files); run_nvs_eval "
            f"{1 / nvs_s:.3f} views/s ({nvs_s:.3f} s, loading included); "
            f"measured on {card}")
        del model, models, ds
    log(f"[runtime] phase 9 in {time.perf_counter() - t_phase:.1f} s")
    return totals


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    os.chdir(root)
    from nerfdet_tpu_torch import api
    from nerfdet_tpu_torch.config import Config
    from nerfdet_tpu_torch.data import ray_stats
    from nerfdet_tpu_torch.data.synthetic import (make_synthetic_cloud,
                                                  make_synthetic_scene)
    from nerfdet_tpu_torch.device import resolve_device
    from nerfdet_tpu_torch.nn.heads import get_candidate_bboxes
    from nerfdet_tpu_torch.ops import cuda_build, pointnet, render, voxel

    # ---- 1. the card -------------------------------------------------
    t_start = time.perf_counter()
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

    # ---- the scene and the model (shared by phases 3, 4 and 6) -------
    t0 = time.perf_counter()
    model = api.init_detector(CONFIG, device="cuda", seed=SEED)
    meta = model.meta
    h, w = meta.img_shape
    scene = make_synthetic_scene(seed=SEED, n_views=N_VIEWS, n_targets=1,
                                 hw=(h, w), pad_hw=meta.pad_shape,
                                 n_rand=(h - 2 * MARGIN) * (w - 2 * MARGIN),
                                 n_boxes=4, max_gt=8, margin=MARGIN)
    batch = api.device_batch(model, scene)
    log(f"[setup] model {sum(p.numel() for p in model.parameters())} "
        f"parameters, scene {N_VIEWS} views {meta.pad_shape}, volume "
        f"{model.n_voxels}: {time.perf_counter() - t0:.1f} s")

    # pixel indices exactly as the main path computes them, and at the
    # intrinsic scaled to ori_shape (as phase 6 takes it)
    stride = 4
    fh, fw = meta.pad_shape[0] // stride, meta.pad_shape[1] // stride
    points = voxel.get_points(model.n_voxels, model.voxel_size,
                              scene["origin"], dev).reshape(-1, 3)
    intrinsic = scene["intrinsic"].copy()
    intrinsic[:2] *= np.float32(meta.ori_shape[0] / h)

    def pixel_indices(k):
        proj = voxel.compute_projection(k, scene["extrinsics"],
                                        meta.ori_shape[0] / (h / stride),
                                        dev)
        x, y, _, valid = voxel.project_points(points, proj, h // stride,
                                              w // stride)
        return voxel.pixel_index(x, y, valid, fw).contiguous()

    # the VoteNet model, its cloud, and the inputs of its five FPS calls
    t0 = time.perf_counter()
    vmodel = api.init_detector(VOTENET_CONFIG, device="cuda", seed=SEED)
    cloud = make_synthetic_cloud(seed=SEED, n_points=N_POINTS)
    fps_calls, _, _ = plain_fps(pointnet, forward_with_fps, vmodel,
                                torch.as_tensor(cloud["points"], device=dev))
    log(f"[setup] VoteNet {sum(p.numel() for p in vmodel.parameters())} "
        f"parameters, cloud {cloud['points'].shape}, FPS calls "
        f"{[(tuple(p.shape), s) for p, s in fps_calls]}: "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- 3. kernels against their plain versions ----------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pix = pixel_indices(scene["intrinsic"])
    f32, bf16 = torch.float32, torch.bfloat16
    fusion = check_fusion(voxel, [
        ("float32", pix, f32, False), ("float32 mapped", pix, f32, True),
        ("bfloat16", pix, bf16, False), ("bfloat16 mapped", pix, bf16, True),
        ("float32 mapped, intrinsic scaled to ori_shape",
         pixel_indices(intrinsic), f32, True)], (fh, fw), gen)
    fusion_bwd = check_fusion_backward(voxel, pix, (fh, fw), gen,
                                       "phase 4/7's pix")
    fusion_bwd_scaled = check_fusion_backward(
        voxel, pixel_indices(intrinsic), (fh, fw), gen,
        "phase 8's pix (intrinsic scaled to ori_shape)")
    path_names = ["sa0", "sa1", "sa2", "sa3", "vote_aggregation"]
    half = torch.rand((N_POINTS // 2, 3), generator=gen, device=dev) * 8
    extra = [("F-FPS C=19", torch.randn((4096, 19), generator=gen,
                                        device=dev), 512),
             ("duplicated points", torch.cat([half, half]), 2048)]
    fps = check_fps(pointnet, [(n, p, s) for n, (p, s) in
                               zip(path_names, fps_calls)] + extra)

    # the render path's scene: the synthetic intrinsic is at the rendered
    # size; the renderer takes it at ori_shape (scaled up above)
    nvs = nvs_dataset(dict(scene, intrinsic=intrinsic), scene["intrinsic"],
                      (h, w))
    rbatch = api.render_batch(model, nvs[0])
    ray = check_k2(render, ray_cases(model, nvs[0], rbatch, (h, w)), (h, w))
    above = ray["behind every camera"]
    if above["unseen"] != above["mask"].numel() or bool(above["mask"].any()):
        raise SystemExit("K2 counted a view for a point behind every camera")
    blind, seen = ray["a view with no valid point"], ray["render chunk"]
    if not (bool((blind["mask"] <= seen["mask"]).all())
            and not blind["same_as_chunk"]):
        raise SystemExit("K2 counted the view that sees no point")

    # K2's training form and its backward at the training path's shape:
    # phase 8's scene, N_rand rays at the host's stratified depths
    tscene, _ = host_ray_stream(ray_stats, model,
                                train_scene(model, SEED + 1))
    with torch.no_grad():
        tfeats = model.render_featmaps(model.extract_2d(
            torch.as_tensor(tscene["imgs"], device=dev)))
    ray_t = {k: torch.as_tensor(tscene[k], device=dev) for k in (
        "ray_o", "ray_d") + ray_stats.RAY_STREAM_KEYS}
    k2_train, k2_bwd = check_k2_training(
        render, render.points_at(ray_t["ray_o"], ray_t["ray_d"],
                                 ray_t["z_vals"]),
        model.render_projection(tscene["intrinsic"], tscene["extrinsics"],
                                dev), (h, w), tfeats,
        tuple(ray_t[k] for k in ray_stats.RAY_STREAM_KEYS[1:]), gen)
    del tscene, tfeats, ray_t

    # ---- 4. the first path: NeRF-Det ------------------------------------
    test_cfg = Config.fromfile(CONFIG).test_cfg
    nms_pre, iou_thr = test_cfg["nms_pre"], test_cfg["iou_thr"]
    voxel.fusion_carry.launches = 0
    pointnet.furthest_point_sample.launches = 0
    render.streaming_sample_mean_var.launches = 0
    out = api.eval_step(model, batch, nms_pre)
    det = api.detections_from_candidates(
        out["boxes"].cpu().numpy(), out["scores"].cpu().numpy(),
        SCORE_THR, iou_thr)
    launches = voxel.fusion_carry.launches
    log(f"[path] eval_step -> {tuple(out['boxes'].shape)} candidates, "
        f"NMS kept {len(det['labels_3d'])} boxes; fused_mean_cov launches "
        f"{launches}, furthest_point_sample launches "
        f"{pointnet.furthest_point_sample.launches}, "
        f"streaming_sample_mean_var launches "
        f"{render.streaming_sample_mean_var.launches}")
    if launches != 1:
        raise SystemExit(f"the main path launched fused_mean_cov {launches} "
                         f"times, expected 1")
    if not (torch.isfinite(out["boxes"]).all()
            and torch.isfinite(out["scores"]).all()):
        raise SystemExit("non-finite candidates")

    with torch.inference_mode():
        head_k, valid_k, _ = model(batch)
        kernel_fn = voxel.fusion_carry
        voxel.fusion_carry = voxel.fusion_carry_plain
        try:
            head_p, valid_p, _ = model(batch)
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

    # ---- 5. the second path: VoteNet-ScanNet ----------------------------
    fps_launches = votenet_path(api, pointnet, voxel, vmodel, cloud, card)

    # ---- 6. the third path: novel-view rendering ------------------------
    ray_launches = render_path(api, render, voxel, pointnet, model, nvs,
                               card, nms_pre)

    # ---- 7. the fourth path: detection training --------------------------
    del model
    torch.cuda.empty_cache()
    bwd_launches = train_path(api, voxel, pointnet, render, card)

    # ---- 8. the fifth path: joint detection + NVS training ---------------
    torch.cuda.empty_cache()
    k2_bwd_launches = joint_train_path(api, voxel, pointnet, render, card)
    log(f"[done] phases 1-8 in {time.perf_counter() - t_start:.1f} s")

    # ---- 9. the runtime from files: train, resume, test -----------------
    torch.cuda.empty_cache()
    runtime = runtime_path(api, voxel, pointnet, render, card)

    main = fusion["float32 mapped"]
    on_path = [fps[n] for n in path_names]  # one forward's five calls
    fps_bound_by = max(on_path, key=lambda r: r["bound_ms"])["bound_by"]
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
        "library_ms": main["library_ms"],
        "phase_a_ms": main["phase_a_ms"],
        "phase_b_ms": main["phase_b_ms"],
        "library_of": "phase A: torch.addmm(b, features.reshape(-1, C), "
                      "W); K1 as a whole has no one-call counterpart",
    }, {
        "name": "furthest_point_sample",
        "route": "cuda",
        "source": "nerfdet_tpu_torch/csrc/furthest_point_sample.cu",
        "replaces": "nerfdet_tpu/ops/pallas_fps.py:99",
        "launches": fps_launches,
        "max_abs_err": max(r["max_abs_err"] for r in fps.values()),
        "ms": sum(r["ms"] for r in on_path),
        "plain_ms": sum(r["plain_ms"] for r in on_path),
        "bound_ms": sum(r["bound_ms"] for r in on_path),
        "bound_by": fps_bound_by,
        "library_ms": None,
    }, {
        "name": "streaming_sample_mean_var",
        "route": "cuda",
        "source": "nerfdet_tpu_torch/csrc/streaming_sample_mean_var.cu",
        "replaces": "nerfdet_tpu/ops/render.py:162",
        "launches": ray_launches,
        "max_abs_err": max([r["max_abs_err"] for r in ray.values()]
                           + [k2_train["max_abs_err"]]),
        "ms": ray["render chunk"]["ms"],
        "plain_ms": ray["render chunk"]["plain_ms"],
        "bound_ms": ray["render chunk"]["bound_ms"],
        "bound_by": ray["render chunk"]["bound_by"],
        "library_ms": None,
        "training_form": k2_train,
    }, {
        "name": "fused_mean_cov_backward",
        "route": "cuda",
        "source": "nerfdet_tpu_torch/csrc/fused_mean_cov_backward.cu",
        "replaces": "nerfdet_tpu/ops/voxel.py:370",
        "launches": bwd_launches,
        "max_abs_err": fusion_bwd["max_abs_err"],
        "ms": fusion_bwd["ms"],
        "plain_ms": fusion_bwd["plain_ms"],
        "bound_ms": fusion_bwd["bound_ms"],
        "bound_by": fusion_bwd["bound_by"],
        "library_ms": fusion_bwd["library_ms"],
        **{k: fusion_bwd[k] for k in ("index_ms", "pass1_ms", "pass2_ms",
                                      "pass3_ms")},
        "intrinsic_scaled": {k: fusion_bwd_scaled[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "index_ms", "pass1_ms", "pass2_ms", "pass3_ms")},
        "library_of": "torch.mm on dY @ W^T and x^T dY over the referenced "
                      "rows; the per-pixel sums have no one-call counterpart",
    }, {
        "name": "streaming_sample_mean_var_backward",
        "route": "cuda",
        "source": "nerfdet_tpu_torch/csrc/"
                  "streaming_sample_mean_var_backward.cu",
        "replaces": "nerfdet_tpu/ops/render.py:162",
        "launches": k2_bwd_launches,
        "max_abs_err": k2_bwd["max_abs_err"],
        "ms": k2_bwd["ms"],
        "plain_ms": k2_bwd["plain_ms"],
        "bound_ms": k2_bwd["bound_ms"],
        "bound_by": k2_bwd["bound_by"],
        "library_ms": k2_bwd["library_ms"],
        **{k: k2_bwd[k] for k in ("pass0_ms", "index_ms", "pass1_ms",
                                  "pass2_ms")},
        "library_of": "index_add_ of the weighted tap rows into the flat "
                      "feature map: the scatter alone",
    }]}
    for entry, n in zip(record["kernels"], (runtime[0], runtime[4],
                                            runtime[2], runtime[1],
                                            runtime[3])):
        entry["runtime_launches"] = n  # phase 9's first training run
    log(f"[done] phases 1-9 in {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
