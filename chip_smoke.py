"""Smoke run of the PyTorch port (``nerfdet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own lines:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions, the TF32 flags as the port sets them (off);
2. build of every CUDA kernel of the path from ``nerfdet_tpu_torch/csrc``
   (one nvcc per source) and of the JPEG decoder's host source (the
   host compiler), all started together, with the compiler's register /
   shared-memory report;
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

10. NeRF-Det-R101* (``nerfdet_res101_2x_low_res_depth_sp.py``: R101 +
    FPN(256), depth maps gating every (voxel, view) pair to +-0.2 m of
    the sensed depth, the density volume's rgb stream summed on the card
    by the rgb-stream kernel), random weights, synthetic scenes with
    depth at the intrinsic scaled to ``ori_shape``: the rgb-stream kernel
    bitwise against its plain version at 48 and 100 views (its time, the
    wrapper back to back, and beside it its device time from a full queue,
    ``queued_time_ms``: the kernel is shorter than its wrapper's host
    work), K1 and K1's
    backward at the depth-gated indices, the share of pairs the gate
    keeps in each stream; ``eval_step`` + host NMS at 100 views (K1 and
    the rgb stream once; kernels vs plain through the graph; stage times
    with the gate and the rgb kernel broken out; scenes/s); joint
    training with ``loss_depth`` at 48 views and 2048 rays (2 + 5 steps,
    every kernel of the path once a step; stage times, steps/s, peak
    memory); ``tools/train.main`` for 3 steps and ``tools/test.main
    --eval mAP nvs`` on a dataset written with ``.npy`` depth at 484x648
    (steps/s from files, the loader's depth load + resize a scene); one
    ``eval_step`` of ``nerfdet_res101_2x_orign_res_depth_sp.py`` at
    478x640 (51 views from those files) with the rgb kernel held to its
    plain version there too.

11. bfloat16 compute (``compute_dtype=bfloat16``, the JAX package's
    ``--bf16`` path, parameters and optimizer float32): the bf16 kernel
    forms against their plain versions at the path's shapes (K1's
    forward on maps that need a gradient, phase A (on the tensor cores)
    and phase B timed apart, with ``torch.addmm`` on phase A's work and
    a cuBLAS bf16 GEMM of the rows by W's three bf16 pieces beside it,
    its bound with the product at the bf16 tensor-core rate and at the
    fp32 rate; K1's backward at phase 8's indices within 2
    bfloat16 ulps, and bitwise on integer inputs whose pair products are
    exact in any order, with the times of its passes; K2's eval form at
    one render chunk and its training form bitwise; K2's backward
    bitwise, with the times of its passes: pass 0, the index preparation,
    pass 1a (each kept pair's df at its slot), pass 1b (the windows'
    sums), pass 2; the rgb stream on bfloat16 images bitwise), each with
    its time, bound and plain time; then at full width NeRF-Det-R50
    ``eval_step`` + host NMS (K1
    once; stage times beside phase 4's float32 ones; scenes/s), one view
    through ``run_nvs_eval`` (K2 33 times; the render's stages and the
    MLP's TFLOP/s; views/s), the joint ``Trainer.step`` at 2048 rays
    (2 + 5 steps, K1's and K2's forward and backward once a step; stage
    times, steps/s, peak memory); NeRF-Det-R101* at 50 views (one
    ``eval_step`` and, at 48 views, one train step with ``loss_depth``,
    each through the rgb stream on bfloat16 images); ``tools/train
    --bf16`` for 2 steps on phase 9's files (a checkpoint of float32
    weights and a validation), then ``tools/test`` on it.

12. JPEG: the JAX writer's views committed under ``tests/data/torch_jpeg``
    (8 of one scene at 484x648, one at 968x1296) decoded by the port's
    own decoder (``data/jpeg.py``; the machine has no cv2) to the SHA-256
    of ``cv2.imread``'s RGB output recorded beside them, with the host
    ms a view at both sizes; then ``tools/test --eval mAP`` from phase
    9's ``ckpt_2`` on a val scene laid out from the 484x648 views
    (``run_eval`` through the loader, every view a JPEG decode, K1 once).

13. data parallel, one process a card (``parallel/dist.py``), each
    child started from a launcher file written to the run's temporary
    directory (cuDNN deterministic, then ``ddp_child``): 13.1
    ``tools/train --distributed`` under ``torchrun`` at world 1 (NCCL)
    for 3 steps on phase 9's files against the same run without
    ``--distributed`` (loss terms and grad_norm within 1e-6 relative,
    each step launching K1, K1's backward, K2's training form and K2's
    backward once; steps/s of both, the all-reduces' ms a step by CUDA
    events); 13.2 phase 8's joint step over two ranks on this card over
    gloo (CUDA tensors), one scene a rank, against one process stepping
    both scenes (loss terms and grad_norm 1e-5 relative, every parameter
    and running statistic within 1e-6 of its tensor's max, the ranks'
    parameters bitwise equal; the step's ms) and, where the machine has
    two cards, over NCCL a card a rank; 13.3 ``tools/test --distributed``
    at world 2 (gloo, this card) on phase 9's val scene listed twice,
    its mAP dict equal to world 1's.

14. the 2-D data x views sharding (``--mesh-views 2``), two gloo ranks on
    this card, one views group, each child through phase 13's launcher
    file: K2's sums form (a rank's raw sums, no epilogue) in both forms
    at a rank's half of phase 8's batch (25 views) bitwise against its
    plain version, with its time and bound; 14.1 phase 8's joint step at
    ``--mesh-views 2`` (25 views and 1024 rays a rank) against one
    process (loss terms 1e-4 relative, grad_norm 1e-3, the ranks'
    parameters bitwise equal; each rank launching K1, K1's backward,
    K2's sums form and K2's backward once a step; the step's ms and the
    all-reduces'); 14.2 R101*'s ``eval_step`` at 50 views with the views
    sharded (the depth gate and the rgb stream on each rank's half)
    against one process (head outputs and the candidates' sorted scores
    1e-4 of their max, the view counts exact); 14.3 ``tools/test
    --distributed --mesh-views 2`` on phase 13.3's files, its metrics
    within 1e-6 of world 1's.

15. ``tools/benchmark`` (``nerfdet_tpu_torch.tools.benchmark.main``) on
    the flagship at its defaults: detection scenes/s in float32 and
    bfloat16, ``--nvs`` rays/s, ``--train`` ms/step (bfloat16); and
    detection again with the synthetic intrinsic scaled to
    ``ori_shape``, the tool's own functions timing it.

16. the fast_cov family (``fast_cov_path``: NeRF-Det configs typed
    ``ImVoxelNet``, no host streams) at 480x640 with depth.

17. the indoor ImVoxelNet on ScanNet (``indoor_path``: ``ImVoxelNet``
    configs without NeRF keys, and the lowercase ``imvoxelnet`` type),
    random weights, phase 16's scene maker at 478x640: 17.0 K1's
    plain-mean form (no mapped or rgb stream) at 50 views of (120, 160,
    64) maps into the 80x80x32 volume in float32 and bfloat16 (count, s1,
    s2 bitwise), its g1-only backward at the 20-view training pixel
    indices in both dtypes (``index_add_`` of the g1 rows as the
    yardstick), C = 1, 8 and 16 run padded to 32, C = 256 depth-gated at
    40x40x16, each with its time, bound and plain time; 17.1
    ``imvoxelnet_scannet.py`` (the Atlas neck, the V1 head):
    ``eval_step`` + host NMS at 50 views (K1 once; kernels vs plain
    through the graph; stage times: backbone, K1, Atlas neck, head,
    decode; scenes/s), ``Trainer.step`` at 20 views (2 + 5 steps, K1 and
    its backward once a step, positives, steps/s, peak memory) and one
    step against the same step with the plain K1; 17.2 the fast and
    fast_depth configs (the fast neck, the V2 head; the gate's kept
    share); 17.3 ``imvoxelnet_scannet_swin_t.py`` (Swin-T, NeRF-Det
    without the density: K2's eval form and its backward in the step);
    17.4 bfloat16; 17.5 ``tools/train`` for 2 steps then ``tools/test
    --eval mAP`` on 484x648 files; the phase's wall time.

18. the SUN RGB-D ImVoxelNet (``sunrgbd_path``: one view a scene, the
    yawed heads, rotated NMS and mAP on the host), random weights, on
    530x730 PNG views and an info pkl it writes (``sunrgbd_fixture``)
    read through the port's dataset: 18.0 K1's plain-mean form at one
    view, (1, 120, 160, 64) maps into 80x80x32 in float32 and bfloat16
    and ``_fast``'s C = 256 into 40x40x16 (count, s1, s2 bitwise, with
    time, bound and plain time); 18.1 ``imvoxelnet_sunrgbd.py``:
    ``eval_step`` + host rotated NMS (K1 once; kernels vs plain through
    the graph; stage times: backbone, K1, Atlas neck, yawed V1 head,
    decode, the host NMS at the config's score threshold and over every
    candidate; scenes/s); 18.2 ``_fast`` (the yawed V2 head), 18.3 the
    perspective split (30 classes), 18.4 bfloat16, one scene each; 18.5
    ``tools/test --eval mAP`` from the files in float32, on the
    perspective split and with ``--bf16``, finite mAP at 0.25 / 0.5
    (0.15 for the perspective split); 18.6 K1's s1-only backward at one
    view (the same maps and ``_fast``'s, float32 within 1e-6 x max,
    bfloat16 bitwise, two runs bitwise; its time, bound, plain time and
    ``index_add_`` of the valid pairs' g1 rows); 18.7 training:
    ``tools/train --batch-size 4`` (the configs' ``samples_per_gpu``)
    for 2 steps on a train split the phase writes, then ``tools/test
    --eval mAP`` from its checkpoint, for ``imvoxelnet_sunrgbd.py`` in
    float32, ``_fast`` in float32 and ``imvoxelnet_sunrgbd.py`` with
    ``--bf16`` (finite losses, grad_norm and mAP; K1 and its backward 4
    times a step), and for each a ``Trainer.step`` of the same 4 scenes:
    steps/s, peak memory, the step's stages and the rotated 3D IoU loss
    alone (forward and backward over every point of the 4 scenes).

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

K2 is held bit for bit to its plain version in both forms and both
dtypes (phases 3 and 11).

Each path runs with every launch count set to 0 just before it and
read just after; phases 9 and 13 also count each train step's launches
(phases 13 and 14 in their child processes, whose counts start at 0).

The JPEG decoder's record (host code, not a kernel) is a ``[jpeg]`` line
of its own. The second-to-last line is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``. Any failure exits non-zero and
prints no result; so does a machine without CUDA.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
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
BF16_PEAK = 989e12  # H100 SXM, bf16 dense on the tensor cores, FLOP/s
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


def queued_time_ms(fn, iters=100):
    """Device ms a call of ``fn`` with the host out of the way: a sleep
    kernel holds the card while the host enqueues ``iters`` calls, and
    the events time them back to back from the full queue. For kernels
    shorter than their wrapper's host work (checks, allocation, the
    ctypes call), which ``cuda_time_ms`` would measure instead. The sleep
    doubles until it outlasts the enqueue."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    cycles = 20_000_000
    while True:
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        torch.cuda._sleep(cycles)
        marks[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        marks[2].record()
        torch.cuda.synchronize()
        if host_ms < 0.8 * marks[0].elapsed_time(marks[1]):
            return marks[1].elapsed_time(marks[2]) / iters
        cycles *= 2


def fusion_bound(pix, c, m, elt):
    """Least time of K1 on these inputs: bytes (each referenced feature
    row, the indices, W/b and the outputs, once) over HBM rate against
    the operations these inputs need over the peak rate of their type.
    Operations: 3 a valid (voxel, view) pair and channel for s1 and s2;
    with the mapped stream, the product of each referenced pixel row once
    (2·rows·C·M: the mapped value depends on the pixel, not the voxel) and
    3 a pair and mapped channel for the square and its sum. On float32
    maps all of them at the fp32 rate. On bfloat16 maps (``elt`` 2) the
    product is W's three bfloat16 pieces on the tensor cores (3 x
    2·rows·C·M at the bf16 dense rate, the rest at the fp32 rate, the two
    units in parallel); ``fp32_bound_ms`` keeps the count of every
    operation at the fp32 rate beside it. Returns a dict with the valid
    pairs and the referenced rows."""
    import torch

    n = pix.shape[1]
    valid = pix >= 0
    rows = sum(int(torch.unique(p[v]).numel()) for p, v in zip(pix, valid))
    n_valid = int(valid.sum())
    nbytes = rows * c * elt + pix.numel() * 4 + (2 * n * c + n) * 4
    ops = 3 * n_valid * c
    product = 0
    if m:
        nbytes += (c * m + m + n * m) * 4
        product = 2 * rows * c * m
        ops += 3 * pix.numel() * m
    t_bytes = nbytes / HBM_RATE * 1e3
    t_fp32 = (ops + product) / FP32_PEAK * 1e3
    out = dict(bytes=nbytes, ops=ops + product, n_valid=n_valid, rows=rows)
    if elt == 2 and m:
        t_ops = max(ops / FP32_PEAK * 1e3, 3 * product / BF16_PEAK * 1e3)
        out.update(fp32_bound_ms=max(t_bytes, t_fp32),
                   fp32_bound_by="bytes" if t_bytes >= t_fp32
                   else "operations", tc_flop=3 * product)
    else:
        t_ops = t_fp32
    out.update(bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


def mapped_rows_bound(feats, m):
    """Least time of K1's phase A: the maps read once and the mapped rows
    written once, against 2·C·M operations a pixel row at the fp32 rate;
    on bfloat16 maps against 3 x 2·C·M at the bf16 dense tensor-core rate
    (W's three pieces), with the fp32-rate count beside it. Returns
    (bound_ms, bound_by, fp32 bound_ms or None)."""
    v, fh, fw, c = feats.shape
    rows = v * fh * fw
    nbytes = feats.numel() * feats.element_size() + (rows * m + c * m
                                                     + m) * 4
    ops = 2 * rows * c * m
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    fp32 = max(t_bytes, t_ops)
    if feats.element_size() == 2:
        t_ops = 3 * ops / BF16_PEAK * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    return (max(t_bytes, t_ops), by,
            fp32 if feats.element_size() == 2 else None)


def bound_text(bound):
    """A fusion_bound as text: the bound, what bounds it, the bytes and
    operations, and on bfloat16 maps the fp32-rate count beside it."""
    text = (f"bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']}; "
            f"{bound['bytes']} B, {bound['ops']} FLOP")
    if "fp32_bound_ms" in bound:
        text += (f", the product's {bound['tc_flop']} on the bf16 tensor "
                 f"cores; every operation at the fp32 rate: bound_ms="
                 f"{bound['fp32_bound_ms']:.4f}, {bound['fp32_bound_by']}")
    return text + ")"


def check_fusion(voxel, cases, hw, gen, m=32, c=256):
    """K1 vs its plain version at the main path's shape: count, s1 and
    s2 bitwise equal, s2m within 1e-5 relative. ``cases``: (name, pix,
    dtype, mapped); ``m`` the mapped stream's width (32, or 16 where
    ``squeeze_scale`` is 8); ``c`` the maps' channels (off
    ``voxel.K1_CHANNELS`` the wrappers pad them). Each line gives K1's
    time, its phases' (the uncounted launches ``_mapped_rows_launch`` and
    ``_carry_launch``), the plain version's and the bound; the f32 mapped
    forms also time ``torch.addmm`` on the same maps, phase A's one-call
    yardstick (the plain-mean form has no phase A, and no one-call
    counterpart)."""
    import torch

    dev = cases[0][1].device
    v, (fh, fw) = cases[0][1].shape[0], hw
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
        bound = fusion_bound(pix, c, m if mapped else 0,
                             feats.element_size())
        result = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                      bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                      phase_a_ms=a_ms, phase_b_ms=b_ms, library_ms=None)
        line = (f"[kernel] fused_mean_cov {name}: V={v} map={fh}x{fw} C={c} "
                f"N={pix.shape[1]} M={m if mapped else 0}; "
                f"{bound['n_valid']} valid pairs "
                f"({bound['n_valid'] / pix.numel():.4f}), {bound['rows']} "
                f"referenced rows: count, s1, s2 bitwise equal, max_abs_err="
                f"{abs_err:.3e} s2m max_rel_err={rel_err:.3e} (tol: s2m rel "
                f"1e-5) ms={ms:.4f} (phase A {a_ms:.4f}, phase B "
                f"{b_ms:.4f}) plain_ms={plain_ms:.4f} {bound_text(bound)}")
        if mapped:
            a_bound, a_by, a_fp32 = mapped_rows_bound(feats, m)
            line += f"; phase A bound_ms={a_bound:.4f} ({a_by})"
            if a_fp32 is not None:
                line += f", at the fp32 rate {a_fp32:.4f}"
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


def fusion_backward_bound(pix, hw, c, m, with_g2, elt=4):
    """Least time of K1's backward on these inputs. Bytes: each referenced
    pixel row of the maps (``elt`` bytes an element; only where the s2
    cotangent or the mapped stream needs x: d features from g1 alone never
    read them) and of phase A's mapped rows read once, the whole
    d-features map written once (``elt`` again), the rows of g1 (g2) of
    the voxels with a valid pair (the pixel buckets never reach the
    others), the indices read once, and with the mapped stream gm,
    counts, W, b read once and dW, db written once.
    Operations: per valid (voxel, view)
    pair, C adds for G1 (2C with g2) and M for GM; per referenced row, 2M
    for dY, 2CM for dY @ W^T, C for the sum (3C more with g2), 2CM for
    dW and M for db; 2M per voxel for the unseen views' bias term. On
    bfloat16 maps (``elt`` 2) each pair rounds its own cotangent, so dY @
    W^T (2CM) and the sum (C) run per valid pair, not per row. Also
    returns the referenced rows."""
    import torch

    v, n = pix.shape
    valid = pix >= 0
    rows = sum(int(torch.unique(p[k]).numel()) for p, k in zip(pix, valid))
    n_valid = int(valid.sum())
    n_seen = int(valid.any(0).sum())
    g = 2 if with_g2 else 1
    reads_x = bool(m) or with_g2
    nbytes = (4 * (rows * m + g * n_seen * c + pix.numel()
                   + (n * m + n + 2 * (c * m + m) if m else 0))
              + elt * (rows * c * reads_x + v * hw * c))
    per_pair = elt == 2
    ops = (n_valid * (g * c + m + (2 * c * m + c if per_pair else 0))
           + rows * (2 * m + (2 if per_pair else 4) * c * m
                     + (0 if per_pair else c) + m
                     + (3 * c if with_g2 else 0))
           + 2 * n * m)
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops, rows)


def bf16_ulps(got, want):
    """max |got - want| in bfloat16 ulps of max |want| (2^-7 of the power
    of two at or below it), and the share of elements that differ."""
    import math

    top = float(want.float().abs().max())
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 1.0
    return (float((got.float() - want.float()).abs().max()) / ulp,
            float((got != want).float().mean()))


def check_fusion_backward(voxel, pix, hw, gen, label, dtype=None,
                          with_g2=False, c=256, m=32, rel_tol=1e-5):
    """K1's backward kernel vs ``fusion_carry_backward_plain`` at the main
    path's form (C = 256, M = 32, cotangents of s1 and s2m, none of s2;
    ``with_g2`` adds one of s2, the form a ``cov`` volume trains, kG2;
    ``m`` = 0 is the plain-mean volume's form, the s1 cotangent alone;
    ``c`` off ``voxel.K1_CHANNELS`` runs padded): two runs bitwise equal;
    on float32 maps d features within ``rel_tol`` x max, on bfloat16 maps
    (``dtype``) within 2 bfloat16 ulps of the largest at under 1% of the
    elements (each pair's product with W^T sums its M terms in another
    order; without the mapped stream bitwise); dW and db within 1e-4 x
    max. Times the kernel (back to back, and from a full queue:
    ``device_ms``), its passes (the index preparation, also from a full
    queue, pass 1, 2 and 3, each on the last one's outputs; at K1's own
    widths), the plain
    version and the yardstick: ``torch.mm`` on the two products it
    contains (dY @ W^T and x^T dY over the referenced rows) or, without
    the mapped stream, ``index_add_`` of the valid pairs' g1 rows into
    the flat maps (the whole function in one call)."""
    import torch

    dev = pix.device
    v, n = pix.shape
    dtype = dtype or torch.float32
    feats = torch.randn((v,) + hw + (c,), generator=gen,
                        device=dev).to(dtype)
    g1 = torch.randn((n, c), generator=gen, device=dev)
    w = b = gm = rows_p = None
    if m:
        w = torch.randn((c, m), generator=gen, device=dev) / c ** 0.5
        b = torch.randn((m,), generator=gen, device=dev)
        gm = torch.randn((n, m), generator=gen, device=dev)
    g2 = torch.randn((n, c), generator=gen, device=dev) if with_g2 else None
    count = (pix >= 0).float().sum(0)
    if m:
        rows_p = voxel.mapped_rows_plain(feats, w, b)
    args = (feats, pix, count, g1, g2, gm, w, b, rows_p)
    got = voxel.fusion_carry_backward(*args)
    again = voxel.fusion_carry_backward(*args)
    want = voxel.fusion_carry_backward_plain(*args)
    torch.cuda.synchronize()
    if not all((x is None and y is None) or torch.equal(x, y)
               for x, y in zip(got, again)):
        raise SystemExit("K1 backward: two runs differ")
    pairs = [(x, y) for x, y in zip(got, want) if y is not None]
    errs = [float((x.float() - y.float()).abs().max()) for x, y in pairs]
    rels = [e / max(float(y.float().abs().max()), 1e-30)
            for e, (_, y) in zip(errs, pairs)] + [0.0, 0.0]
    bf16 = dtype == torch.bfloat16
    ulps, share = bf16_ulps(got[0], want[0]) if bf16 else (0.0, 0.0)
    ms = cuda_time_ms(lambda: voxel.fusion_carry_backward(*args), 20)
    # from a full queue: at one view the wrapper's host work outlasts it
    device_ms = queued_time_ms(lambda: voxel.fusion_carry_backward(*args))
    n_pix = hw[0] * hw[1]
    passes = {"index_ms": cuda_time_ms(lambda: voxel.pixel_order(pix, n_pix),
                                       20),
              "index_device_ms": queued_time_ms(
                  lambda: voxel.pixel_order(pix, n_pix))}
    if c in voxel.K1_CHANNELS:
        order, off, rows, n_rows = voxel.pixel_order(pix, n_pix)
        _, dy = voxel._pixel_sums(feats, order, off, g1, g2, gm, rows_p, w)
        passes["pass1_ms"] = cuda_time_ms(lambda: voxel._pixel_sums(
            feats, order, off, g1, g2, gm, rows_p, w), 20)
        if m:
            parts = voxel._weight_parts(feats, dy, rows, n_rows, gm, count)
            passes["pass2_ms"] = cuda_time_ms(lambda: voxel._weight_parts(
                feats, dy, rows, n_rows, gm, count), 20)
            passes["pass3_ms"] = cuda_time_ms(
                lambda: voxel._weight_reduce(*parts, b), 20)
    plain_ms = cuda_time_ms(lambda: voxel.fusion_carry_backward_plain(*args),
                            3, warmup=1)
    keys = torch.where(pix >= 0, pix.long() + torch.arange(
        v, device=dev)[:, None] * n_pix, -1).flatten()
    if m:  # the yardstick: the two products over the referenced rows
        ref = torch.unique(keys[keys >= 0])
        x_r = feats.reshape(-1, c)[ref].float()
        dy_r = torch.randn((ref.numel(), m), generator=gen, device=dev)
        wt = w.t().contiguous()
        library_ms = cuda_time_ms(
            lambda: (torch.mm(dy_r, wt), torch.mm(x_r.t(), dy_r)), 20)
        what = "torch.mm: dY @ W^T and x^T dY over the referenced rows"
    else:  # the scatter of every valid pair's g1 row to its pixel
        kept = keys >= 0
        dst, rows_g = keys[kept], g1.repeat(v, 1)[kept]
        flat = torch.zeros((v * n_pix, c), device=dev)
        library_ms = cuda_time_ms(lambda: flat.index_add_(0, dst, rows_g),
                                  20)
        what = "index_add_ of the valid pairs' g1 rows into the flat maps"
    bound_ms, bound_by, nbytes, ops, n_ref = fusion_backward_bound(
        pix, n_pix, c, m, with_g2, feats.element_size())
    tol = (f"{ulps:.2f} bfloat16 ulps at {share:.4f} of the elements, tol 2 "
           f"at under 0.01" if bf16 else f"tol {rel_tol:g}")
    g2_form = "with the s2 cotangent (kG2)" if with_g2 else "no s2 cotangent"
    form = (f"mapped, {g2_form}" if m else f"plain mean, {g2_form}"
            if with_g2 else "plain mean (g1 only)")
    log(f"[kernel] fused_mean_cov_backward {str(dtype)[6:]} {form}, "
        f"{label}: V={v} map={hw[0]}x{hw[1]} C={c} N={n} M={m}; {n_ref} "
        f"referenced rows: two runs bitwise equal; max_abs_err "
        + ", ".join(f"{k} {e:.3e} (rel {r:.3e})" for k, e, r in zip(
            ("d features", "dW", "db"), errs, rels))
        + f" ({tol}; dW, db tol 1e-4) ms={ms:.4f} device_ms="
        f"{device_ms:.4f} ("
        + ", ".join(f"{k[:-3]} {t:.4f}" for k, t in passes.items())
        + f") plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} ({what}) "
        f"bound_ms={bound_ms:.4f} ({bound_by}; {nbytes} B, {ops} FLOP)")
    if ((ulps > 2 or share >= 0.01 or (not m and ulps > 0)) if bf16
            else rels[0] > rel_tol) or rels[1] > 1e-4 or rels[2] > 1e-4:
        raise SystemExit("K1 backward disagrees with its plain version")
    return dict(max_abs_err=max(errs), ms=ms, device_ms=device_ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms, **passes)


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
    nbytes = ((pts.numel() + v * 16 + n * 2 * c) * 4 + n
              + images.numel() * images.element_size()
              + feats.numel() * feats.element_size())
    ops = n * v * (20 + 2 * 14 + 12 * c + 1) + n * (10 * c + 2)
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def check_k2(render, cases, img_hw):
    """The fused K2 vs its plain version (the carry, then the epilogue)
    on the card: pixel_mask, the unseen count and globalfeat bit for bit
    (the errors are printed). The unseen count is read from each side's
    own output: a point no view counts has s1m = 0, so every mean is
    exactly 0.
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
        bitwise = all(torch.equal(g, p) for g, p in zip(got, want))
        unseen = [int((g[0][..., :cs] == 0).all(-1).sum()) for g in
                  (got, want)]
        if not torch.equal(got[1], want[1]) or unseen[0] != unseen[1]:
            raise SystemExit(f"K2 {name}: pixel_mask or the unseen count "
                             f"differs from the plain version")
        abs_err = float((got[0] - want[0]).abs().max())
        rel_err = abs_err / max(float(want[0].abs().max()), 1e-30)
        n_pts = got[1].numel()
        line = (f"[kernel] streaming_sample_mean_var {name}: "
                f"V={images.shape[0]} N={n_pts} C={cs} "
                f"{str(feats.dtype)[6:]}: pixel_mask and "
                f"unseen count equal (pixel_mask share "
                f"{float(got[1].float().mean()):.4f}, unseen "
                f"{unseen[0]} of {n_pts}); globalfeat max_abs_err="
                f"{abs_err:.3e} max_rel_err={rel_err:.3e} (tol: bitwise); "
                f"bitwise equal {bitwise}")
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
                          bound_by=bound_by, library_ms=None)
        log(line)
        if not bitwise:
            raise SystemExit(f"K2 {name}: not bitwise equal to the plain "
                             f"version (rel {rel_err:.3e})")
        results[name] = result
    return results


def k2_train_bound(pts, feats, n_host):
    """Least time of K2's training form: bytes (points, feature maps,
    projections and the ``n_host`` floats a point of host sums and count
    read once, globalfeat and the mask written once) over HBM rate against
    the operations of ``ray_bound`` without the rgb taps and the count."""
    n = pts.numel() // 3
    v, c = feats.shape[0], feats.shape[-1]
    nbytes = ((pts.numel() + v * 16 + n * n_host + n * 2 * (3 + c)) * 4 + n
              + feats.numel() * feats.element_size())
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
    nbytes = ((2 * n * 2 * c + n * c + n + 3 * n + 16 * v) * 4 + 8 * pairs
              + 8 * kept + 2 * v * fh * fw * c * feats.element_size())
    ops = kept * (20 * c + 40) + 15 * n * c
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def check_k2_training(render, pts, proj, img_hw, feats, host, gen,
                      images=None):
    """K2's training form (host rgb sums; with ``host`` None and
    ``images`` its eval form, under grad as the fast_cov family trains)
    against its plain version at the training path's shape (pixel_mask
    and globalfeat bit for bit), then K2's backward against
    ``streaming_sample_mean_var_backward_plain`` on a random cotangent
    (within 1e-5 x max, two runs bitwise equal), with times, bounds and
    ``index_add_`` of the weighted tap rows into the flat feature map as
    the backward's yardstick (it does the scatter alone)."""
    import torch

    args = (pts, images, proj, img_hw, feats, host)
    form = "training form (host rgb)" if host is not None else (
        "eval form under grad (the device rgb stream)")
    got = render.streaming_sample_mean_var(*args)
    want = render.streaming_sample_mean_var_plain(*args)
    torch.cuda.synchronize()
    fwd_err = float((got[0] - want[0]).abs().max())
    fwd_rel = fwd_err / max(float(want[0].abs().max()), 1e-30)
    bf16 = feats.dtype == torch.bfloat16
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise SystemExit(f"K2's {form} is not bitwise equal to its plain "
                         f"version (rel {fwd_rel:.3e})")
    ms = cuda_time_ms(lambda: render.streaming_sample_mean_var(*args), 10)
    plain_ms = cuda_time_ms(
        lambda: render.streaming_sample_mean_var_plain(*args), 2, warmup=1)
    bound_ms, bound_by, nbytes, ops = (
        k2_train_bound(pts, feats, 10) if host is not None
        else ray_bound(pts, images, feats))
    n_pts = got[1].numel()
    log(f"[kernel] streaming_sample_mean_var {form}: "
        f"V={feats.shape[0]} N={n_pts} C={feats.shape[-1]} "
        f"{str(feats.dtype)[6:]}: pixel_mask "
        f"equal (share {float(got[1].float().mean()):.4f}); globalfeat "
        f"max_abs_err={fwd_err:.3e} max_rel_err={fwd_rel:.3e} (tol: "
        f"bitwise); bitwise equal True ms={ms:.4f} "
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
    err = float((d.float() - want.float()).abs().max())
    rel = err / max(float(want.float().abs().max()), 1e-30)
    if bf16 and err > 0:
        raise SystemExit("K2 backward on bfloat16 maps is not bitwise equal "
                         "to its plain version")
    b_ms = cuda_time_ms(
        lambda: render.streaming_sample_mean_var_backward(*bargs), 10)
    b_plain_ms = cuda_time_ms(
        lambda: render.streaming_sample_mean_var_backward_plain(*bargs), 2,
        warmup=1)
    # its passes, each on the last one's outputs: pass 0 (keys and, on
    # float32 maps, cotangents), the index preparation (the counting sort;
    # on bfloat16 maps each kept pair's slot), on float32 maps pass 1 (the
    # windows' sums), on bfloat16 maps pass 1a (each kept pair's df at its
    # slot) and pass 1b (the windows' sums), pass 2 (the unpack)
    keys, coef = render._backward_keys(*bargs)
    n_win = feats.shape[1] * feats.shape[2]
    passes = {"pass0_ms": cuda_time_ms(lambda: render._backward_keys(*bargs),
                                       10)}
    if bf16:
        rank, off = render._window_rank_launch(keys, n_win)
        df, wts = render._pair_df(*bargs, rank)
        packed = render._window_sums_bf16(df, wts, off, feats)
        passes["index_ms"] = cuda_time_ms(
            lambda: render._window_rank_launch(keys, n_win), 10)
        passes["pass1a_ms"] = cuda_time_ms(
            lambda: render._pair_df(*bargs, rank), 10)
        passes["pass1b_ms"] = cuda_time_ms(
            lambda: render._window_sums_bf16(df, wts, off, feats), 10)
        del rank, df, wts
    else:
        order, off = render._window_order_launch(keys, n_win)
        packed = render._window_sums(pts, proj, img_hw, feats, coef, order,
                                     off)
        passes["index_ms"] = cuda_time_ms(
            lambda: render._window_order_launch(keys, n_win), 10)
        passes["pass1_ms"] = cuda_time_ms(lambda: render._window_sums(
            pts, proj, img_hw, feats, coef, order, off), 10)
        del order
    passes["pass2_ms"] = cuda_time_ms(lambda: render._unpack(packed, off,
                                                              feats), 10)
    held = int(((off[1:] - off[:-1]) > 0).sum())
    longest = int((off[1:] - off[:-1]).max())
    del keys, coef, off, packed
    idx, rows, kept = k2_scatter_rows(render, *bargs)
    flat = torch.zeros((feats.numel() // feats.shape[-1], feats.shape[-1]),
                       dtype=feats.dtype, device=feats.device)
    rows = rows.to(feats.dtype)
    library_ms = cuda_time_ms(lambda: flat.index_add_(0, idx, rows), 5)
    n_rows = idx.numel()
    del idx, rows, flat
    b_bound, b_by, b_bytes, b_ops = k2_backward_bound(pts, feats, kept)
    pairs = n_pts * feats.shape[0]
    unseen = int((cnt == 0).sum())
    log(f"[kernel] streaming_sample_mean_var_backward {str(feats.dtype)[6:]}"
        f": V={feats.shape[0]} "
        f"N={n_pts} C={feats.shape[-1]}; {pairs} (point, view) pairs, "
        f"{kept} with a non-zero tap weight ({kept / pairs:.4f}), {unseen} "
        f"points seen by no view: two runs bitwise equal; d featmaps "
        f"max_abs_err={err:.3e} (rel {rel:.3e} of max "
        f"{float(want.float().abs().max()):.3e}, tol "
        f"{'0: bitwise' if bf16 else '1e-5'}); {held} of "
        f"{feats.numel() // feats.shape[-1]} windows hold a pair, the "
        f"longest {longest} ms={b_ms:.4f} ("
        + ", ".join(f"{'index preparation' if k == 'index_ms' else 'pass '}"
                    f"{'' if k == 'index_ms' else k[4:-3]} {v:.4f}"
                    for k, v in passes.items()) + ") "
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


def timed_steps(tr, batch, counters, iters=5, warmup=2):
    """``warmup`` steps of ``tr``, then ``iters`` timed on the host clock
    with every count of ``counters`` set to 0 just before. Returns the
    metrics of each timed step, the seconds a step, the counts and the
    peak memory."""
    import torch

    for _ in range(warmup):
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


def step_stage_times(tr, batch, iters=3, **loss_kw):
    """CUDA-event times (ms, mean of ``iters``) of one train step's
    stages: the forward and loss (``loss_kw`` to ``scene_loss_terms``),
    the backward, the optimizer."""
    import torch

    from nerfdet_tpu_torch.train.step import (reduce_loss_terms,
                                              scene_loss_terms)

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    stage = {"forward + loss": 0.0, "backward": 0.0, "optimizer": 0.0}
    for _ in range(iters):
        tr.optimizer.zero_grad()
        ev[0].record()
        loss, _ = reduce_loss_terms([scene_loss_terms(tr.model, b,
                                                      **loss_kw)
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
    """``prepare_rays`` at the model's N_rand, near/far, samples and
    compute dtype from a seeded RandomState, and its host-clock
    seconds."""
    import numpy as np

    t0 = time.perf_counter()
    out = ray_stats.prepare_rays(
        scene, np.random.RandomState(SEED), model.n_rand,
        model.near_far_range, model.n_samples, model.meta.ori_shape,
        model.meta.img_shape, model.compute_dtype)
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


def counted_trainers(api, counters, per_step, kept=None):
    """Wrap ``api.init_trainer`` so every ``Trainer.step`` appends the
    launches of ``counters`` it made to ``per_step``; a dict ``kept``
    gets the last Trainer (``trainer``, its uncounted ``step``) and the
    batch it last stepped on (``batch``). Returns the original, to put
    back."""
    original = api.init_trainer

    def init_trainer(*args, **kwargs):
        tr = original(*args, **kwargs)
        step = tr.step
        if kept is not None:
            kept.update(trainer=tr, step=step)

        def counted(batch):
            before = [fn.launches for fn in counters]
            out = step(batch)
            per_step.append([fn.launches - b
                             for fn, b in zip(counters, before)])
            if kept is not None:
                kept["batch"] = batch
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


def runtime_path(api, voxel, pointnet, render, card, tmp):
    """Phase 9: the flagship trained and evaluated from a ScanNet-layout
    dataset on disk (written under ``tmp``, which phase 11 reads again)
    through the port's CLIs, in process. Returns the kernels' launches in
    the first training run and the ``--options`` that point the config at
    the dataset."""
    import math

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
    return totals, opts


# phase 10: NeRF-Det-R101* (depth_sp): the depth gate and the rgb stream
DEPTH_CONFIG = "configs/nerfdet/nerfdet_res101_2x_low_res_depth_sp.py"
ORIGIN_RES_CONFIG = "configs/nerfdet/nerfdet_res101_2x_orign_res_depth_sp.py"
DEPTH_VIEWS = 100  # the test pipeline's source views
DEPTH_TRAIN_VIEWS = 48  # the config's train_pipeline_overrides
DEPTH_CLI_STEPS = 3


def depth_scene(model, seed, n_views):
    """A seeded 4-box scene with depth maps, every ray of its target view
    and the intrinsic scaled to ``ori_shape`` (without the scale the
    voxels' camera depths and the sensed depth disagree)."""
    import numpy as np

    from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene

    meta = model.meta
    h, w = meta.img_shape
    scene = make_synthetic_scene(seed=seed, n_views=n_views, n_targets=1,
                                 hw=(h, w), pad_hw=meta.pad_shape,
                                 n_rand=(h - 2 * MARGIN) * (w - 2 * MARGIN),
                                 n_boxes=4, max_gt=8, margin=MARGIN,
                                 with_depth=True)
    scene["intrinsic"] = scene["intrinsic"].copy()
    scene["intrinsic"][:2] *= np.float32(meta.ori_shape[0] / h)
    return scene


def gated_streams(voxel, model, scene, dev):
    """Both streams' pixel indices as ``build_volume`` computes them for a
    scene with depth: the features' at the stride-4 maps, the rgb
    stream's at the images, each gated by the depth map. Returns {name:
    (pix, the share of (voxel, view) pairs in the image, the share the
    gate keeps, the inputs of its ``depth_gate``)}."""
    import torch

    meta = model.meta
    h, w = meta.img_shape
    stride = 4
    points = voxel.get_points(model.n_voxels, model.voxel_size,
                              scene["origin"], dev).reshape(-1, 3)
    depth = torch.as_tensor(scene["depth"], device=dev)
    out = {}
    for name, ratio, (bh, bw), width in (
            ("features", meta.ori_shape[0] / (h / stride),
             (h // stride, w // stride), meta.pad_shape[1] // stride),
            ("rgb", meta.ori_shape[0] / h, (h, w), meta.pad_shape[1])):
        proj = voxel.compute_projection(scene["intrinsic"],
                                        scene["extrinsics"], ratio, dev)
        x, y, z, valid = voxel.project_points(points, proj, bh, bw)
        args = (z, x, y, valid, depth, bh, bw, model.voxel_size[-1])
        kept = voxel.depth_gate(*args)
        out[name] = (voxel.pixel_index(x, y, kept, width).contiguous(),
                     float(valid.float().mean()), float(kept.float().mean()),
                     args)
    return out


def check_rgb(voxel, images, pix, label):
    """The rgb stream's kernel (the uncounted launch) against its plain
    version, bitwise; its time (``ms``: the wrapper back to back), its
    device time beside it (``device_ms``, from ``queued_time_ms``: the
    kernel is shorter than its wrapper's host work), the plain version's
    time and the bound: the
    indices read once, a kept pair's pixel (12 bytes, 6 in bfloat16) and
    the two (N, 3) outputs written once over the HBM rate, against 9
    operations a kept pair over the fp32 rate."""
    import torch

    got = voxel._rgb_launch(images, pix)
    want = voxel.rgb_carry_plain(images, pix)
    torch.cuda.synchronize()
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise SystemExit(f"the rgb stream ({label}) differs from its plain "
                         f"version")
    ms = cuda_time_ms(lambda: voxel._rgb_launch(images, pix), 50)
    device_ms = queued_time_ms(lambda: voxel._rgb_launch(images, pix))
    plain_ms = cuda_time_ms(lambda: voxel.rgb_carry_plain(images, pix), 3,
                            warmup=1)
    kept = int((pix >= 0).sum())
    nbytes = (4 * pix.numel() + 3 * images.element_size() * kept
              + 24 * pix.shape[1])
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, 9 * kept / FP32_PEAK * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    v, hh, ww, _ = images.shape
    log(f"[kernel] fused_mean_cov_rgb {label}: V={v} images {hh}x{ww}x3 "
        f"{str(images.dtype)[6:]} "
        f"N={pix.shape[1]}; {kept} kept pairs ({kept / pix.numel():.4f}): "
        f"s1e, s2e bitwise equal to the plain version, max_abs_err=0 "
        f"ms={ms:.4f} (the wrapper back to back; device_ms={device_ms:.4f}, "
        f"from a full queue) plain_ms={plain_ms:.4f} bound_ms={bound_ms:.5f} "
        f"({bound_by}; {nbytes} B, {9 * kept} FLOP) library_ms=n/a (no "
        f"one PyTorch call gathers and sums the views' pixels)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                kept_pairs=kept, device_ms=device_ms)


def depth_path(api, voxel, pointnet, render, card):
    """Phase 10: NeRF-Det-R101* (``nerfdet_res101_2x_low_res_depth_sp``)
    at full width: the kernels at the depth-gated indices, inference at
    100 views, joint training with ``loss_depth`` at 48 views, the train
    and test CLIs from files with depth maps, and one ``eval_step`` of
    the original-resolution config. Returns the record's numbers."""
    import math
    import tempfile

    import numpy as np
    import torch

    from nerfdet_tpu_torch.config import Config
    from nerfdet_tpu_torch.data import dataset as dataset_mod
    from nerfdet_tpu_torch.data import pipeline as pipeline_mod
    from nerfdet_tpu_torch.data import ray_stats
    from nerfdet_tpu_torch.data.dataset import build_dataset
    from nerfdet_tpu_torch.data.synthetic import write_synthetic_scannet
    from nerfdet_tpu_torch.nn.heads import get_candidate_bboxes
    from nerfdet_tpu_torch.tools import test as test_cli
    from nerfdet_tpu_torch.tools import train as train_cli

    t_phase = time.perf_counter()
    dev = api.resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    names = ("fused_mean_cov", "fused_mean_cov_backward", "fused_mean_cov_rgb",
             "streaming_sample_mean_var",
             "streaming_sample_mean_var_backward", "furthest_point_sample")
    counters = (voxel.fusion_carry, voxel.fusion_carry_backward,
                voxel.rgb_carry, render.streaming_sample_mean_var,
                render.streaming_sample_mean_var_backward,
                pointnet.furthest_point_sample)

    def zero():
        for fn in counters:
            fn.launches = 0

    def counts():
        return [fn.launches for fn in counters]

    # ---- the model and the scenes ----
    t0 = time.perf_counter()
    cfg = Config.fromfile(DEPTH_CONFIG)
    model = api.init_detector(cfg, device="cuda", seed=SEED)
    meta = model.meta
    scene = depth_scene(model, SEED + 2, DEPTH_VIEWS)
    # the training scene: 48 of the 100 views, the same target view
    keep = slice(0, 2 * DEPTH_TRAIN_VIEWS, 2)
    scene48 = dict(scene, **{k: scene[k][keep] for k in (
        "imgs", "denorm_images", "extrinsics", "depth")})
    log(f"[depth] {DEPTH_CONFIG}: {len(model.backbone.layer3)} blocks in "
        f"layer3 (ResNet-101), {sum(p.numel() for p in model.parameters())}"
        f" parameters, depth_supervise {cfg.model['depth_supervise']}, "
        f"use_depth {cfg.input_modality['use_depth']}; scene {DEPTH_VIEWS} "
        f"views {meta.img_shape} padded {meta.pad_shape} with depth maps, "
        f"the training scene {DEPTH_TRAIN_VIEWS} of them: "
        f"{time.perf_counter() - t0:.1f} s")
    if len(model.backbone.layer3) != 23:
        raise SystemExit("the depth_sp R101 config did not build ResNet-101")

    # ---- 10.1 the kernels at the depth-gated indices ----
    rgb = {}
    streams = {}
    for label, sc in ((f"{DEPTH_TRAIN_VIEWS} views", scene48),
                      (f"{DEPTH_VIEWS} views", scene)):
        st = gated_streams(voxel, model, sc, dev)
        streams[label] = st
        for name, (_, seen, kept, _) in st.items():
            log(f"[depth] gate, {label}, {name} stream: {seen:.4f} of the "
                f"(voxel, view) pairs in the image, {kept:.4f} kept "
                f"within +-{model.voxel_size[-1]} m of the sensed depth")
        images = torch.as_tensor(sc["denorm_images"], device=dev)
        rgb[label] = check_rgb(voxel, images, st["rgb"][0], label)
        del images
    pix48 = streams[f"{DEPTH_TRAIN_VIEWS} views"]["features"][0]
    hw = (meta.pad_shape[0] // 4, meta.pad_shape[1] // 4)
    k1 = check_fusion(voxel, [(f"float32 mapped, depth-gated, "
                               f"{DEPTH_TRAIN_VIEWS} views", pix48,
                               torch.float32, True)], hw, gen)
    k1 = next(iter(k1.values()))
    k1_bwd = check_fusion_backward(voxel, pix48, hw, gen,
                                   f"phase 10's depth-gated pix, "
                                   f"{DEPTH_TRAIN_VIEWS} views")

    # ---- 10.2 inference at 100 views ----
    nms_pre, iou_thr = cfg.test_cfg["nms_pre"], cfg.test_cfg["iou_thr"]
    batch = api.device_batch(model, scene)
    if "rgb_s1" in batch or "depth" not in batch:
        raise SystemExit("a scene with depth must take the in-scan stream")
    zero()
    out = api.eval_step(model, batch, nms_pre)
    det = api.detections_from_candidates(
        out["boxes"].cpu().numpy(), out["scores"].cpu().numpy(), SCORE_THR,
        iou_thr)
    launches = counts()
    log(f"[depth] eval_step at {DEPTH_VIEWS} views -> "
        f"{tuple(out['boxes'].shape)} candidates, NMS kept "
        f"{len(det['labels_3d'])}; launches "
        + ", ".join(f"{n} {c}" for n, c in zip(names, launches)))
    if launches != [1, 0, 1, 0, 0, 0]:
        raise SystemExit(f"the R101* inference path launched {launches}: "
                         f"expected K1 and the rgb stream once")
    path_launches = launches[2]
    if not (torch.isfinite(out["boxes"]).all()
            and torch.isfinite(out["scores"]).all()):
        raise SystemExit("non-finite candidates")
    with torch.inference_mode():
        head_k, valid_k, _ = model(batch)
        saved = voxel.fusion_carry, voxel.rgb_carry
        voxel.fusion_carry = voxel.fusion_carry_plain
        voxel.rgb_carry = voxel.rgb_carry_plain
        try:
            head_p, valid_p, _ = model(batch)
        finally:
            voxel.fusion_carry, voxel.rgb_carry = saved
    torch.cuda.synchronize()
    diff = max(float((a - b).abs().max()) for hk, hp in zip(head_k, head_p)
               for a, b in zip(hk, hp))
    scale = max(float(b.abs().max()) for hp in head_p for b in hp)
    observed = float((valid_k > 0).float().mean())
    log(f"[depth] kernels vs plain (K1 and the rgb stream) through the whole "
        f"graph: view counts equal {torch.equal(valid_k, valid_p)}, head "
        f"outputs max |diff| {diff:.3e} (max |out| {scale:.3e}, tol 1e-4 "
        f"relative); {observed:.4f} of the voxels observed")
    if not torch.equal(valid_k, valid_p) or diff > 1e-4 * max(scale, 1.0):
        raise SystemExit("kernel and plain R101* graphs disagree")
    with torch.inference_mode():
        feats = model.extract_2d(batch["imgs"])
        vol_args = (feats, batch["intrinsic"], batch["extrinsics"],
                    batch["origin"])
        vol_kw = dict(denorm_images=batch["denorm_images"],
                      depth=batch["depth"])
        vol = model.build_volume(*vol_args, **vol_kw)
        heads = model.detect(vol["det_volume"])
        mlvl = model.mlvl_points(batch["origin"])
        st = streams[f"{DEPTH_VIEWS} views"]
        stages = {
            "extract_2d (ResNet-101 + FPN)": lambda: model.extract_2d(
                batch["imgs"]),
            "build_volume (projection, gate, K1, rgb stream, density)":
                lambda: model.build_volume(*vol_args, **vol_kw),
            "  of it the depth gate (both streams)": lambda: [
                voxel.depth_gate(*st[k][3]) for k in ("features", "rgb")],
            "  of it the rgb stream kernel": lambda: voxel._rgb_launch(
                batch["denorm_images"], st["rgb"][0]),
            "detect (3D neck + head)": lambda: model.detect(
                vol["det_volume"]),
            "get_candidate_bboxes": lambda: get_candidate_bboxes(
                heads, vol["valid"], mlvl, nms_pre, model.n_classes),
        }
        for name, fn in stages.items():
            log(f"[stage] R101* {DEPTH_VIEWS} views {name}: "
                f"{cuda_time_ms(fn, 3, warmup=1):.3f} ms")
    del feats, vol, heads
    iters = 5
    for _ in range(2):
        api.eval_step(model, batch, nms_pre)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = api.eval_step(model, batch, nms_pre)
        det = api.detections_from_candidates(
            out["boxes"].cpu().numpy(), out["scores"].cpu().numpy(),
            cfg.test_cfg["score_thr"], iou_thr)
    dt = (time.perf_counter() - t0) / iters
    log(f"[depth] inference: {1 / dt:.3f} scenes/s ({dt * 1e3:.2f} ms a "
        f"scene: eval_step + host NMS at {DEPTH_VIEWS} views with depth), "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"measured on {card}")
    del model, batch, out
    torch.cuda.empty_cache()

    # ---- 10.3 joint training with loss_depth at 48 views ----
    t0 = time.perf_counter()
    tr = api.init_trainer(cfg, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    prepared = ray_stats.prepare_rays(
        scene48, np.random.RandomState(SEED), tr.model.n_rand,
        tr.model.near_far_range, tr.model.n_samples, meta.ori_shape,
        meta.img_shape)
    tbatch = api.train_batch(tr.model, [prepared])
    log(f"[depth] init_trainer + the host ray stream ({tr.model.n_rand} "
        f"rays with depths): {time.perf_counter() - t0:.1f} s")
    hist, dt, launches, peak = timed_steps(tr, tbatch, counters)
    last = {k: float(v) for k, v in hist[-1].items()}
    log(f"[depth] train, 5 steps: launches "
        + ", ".join(f"{n} {c}" for n, c in zip(names, launches))
        + "; last step " + ", ".join(f"{k} {v:.6g}" for k, v in
                                     last.items()))
    if launches != [5, 5, 5, 5, 5, 0]:
        raise SystemExit(f"the R101* training path launched {launches}")
    for m in hist:
        if not all(math.isfinite(float(v)) for v in m.values()):
            raise SystemExit(f"non-finite train metrics {m}")
    if not (last.get("loss_depth", 0.0) > 0 and last["n_pos"] > 0):
        raise SystemExit("no depth loss or no positive voxels")
    for k, ms in step_stage_times(tr, tbatch, depth_supervise=True).items():
        log(f"[stage] R101* train {k}: {ms:.3f} ms")
    log(f"[depth] train: {1 / dt:.3f} steps/s ({dt * 1e3:.2f} ms a step: "
        f"Trainer.step, one scene of {DEPTH_TRAIN_VIEWS} views and "
        f"{tr.model.n_rand} rays, loss_depth on, host clock after 2 "
        f"warm-up steps), peak memory {peak / 2**30:.2f} GiB; measured on "
        f"{card}")
    del tr, tbatch, prepared
    torch.cuda.empty_cache()

    # ---- 10.4 the CLIs from files; 10.5 the original resolution ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_depth_") as tmp:
        t0 = time.perf_counter()
        train_root = write_synthetic_scannet(
            os.path.join(tmp, "train"), n_scenes=1,
            n_images=RUNTIME_TRAIN_VIEWS, hw=RUNTIME_HW, seed=SEED + 3,
            splits=("train",), workers=8, with_depth=True)
        val_root = write_synthetic_scannet(
            os.path.join(tmp, "val"), n_scenes=1, n_images=RUNTIME_VAL_VIEWS,
            hw=RUNTIME_HW, seed=SEED + 4, splits=("val",), workers=8,
            with_depth=True)
        opts = runtime_options(cfg, train_root, val_root)
        log(f"[depth] wrote a ScanNet-layout dataset with depth maps (.npy) "
            f"at {RUNTIME_HW[0]}x{RUNTIME_HW[1]}: {RUNTIME_TRAIN_VIEWS} + "
            f"{RUNTIME_VAL_VIEWS} views in 8 processes: "
            f"{time.perf_counter() - t0:.1f} s")
        clock = HostClock()
        clock.wrap(pipeline_mod, "load_depth", "depth")
        clock.wrap(dataset_mod.ScanNetMultiViewDataset, "__getitem__",
                   "scene")
        per_step = []
        original_init = counted_trainers(api, counters, per_step)
        try:
            zero()
            t0 = time.perf_counter()
            result = train_cli.main([
                DEPTH_CONFIG, "--work-dir", os.path.join(tmp, "work"),
                "--max-steps", str(DEPTH_CLI_STEPS), "--no-validate",
                "--options", *opts])
            train_s = time.perf_counter() - t0
            cli_launches = counts()
        finally:
            api.init_trainer = original_init
            clock.restore()
        hist = result["history"]
        for h, n in zip(hist, per_step):
            log(f"[depth] tools/train step {h['step']}: waited "
                f"{h['data_s']:.3f} s on the loader, step {h['step_s']:.3f}"
                f" s; launches {n}; loss {h['loss']:.5g}, loss_nvs "
                f"{h.get('loss_nvs', float('nan')):.5g}, loss_depth "
                f"{h.get('loss_depth', float('nan')):.5g}")
            if not (h.get("loss_depth", 0.0) > 0 and all(
                    math.isfinite(h[k]) for k in h if k.startswith("loss"))):
                raise SystemExit(f"tools/train step without a finite depth "
                                 f"loss: {h}")
        if per_step != [[1, 1, 1, 1, 1, 0]] * DEPTH_CLI_STEPS:
            raise SystemExit(f"tools/train launches a step {per_step}")
        n_scenes, split = clock.take()
        timed = hist[1:]
        rate = len(timed) / sum(h["data_s"] + h["step_s"] for h in timed)
        log(f"[depth] tools/train from files ({cfg.data['workers_per_gpu']} "
            f"loader thread): {rate:.3f} steps/s over steps 2-"
            f"{DEPTH_CLI_STEPS} (loader wait + step); a scene in the loader "
            f"{split.get('scene', 0.0):.3f} s, of it the depth maps' load + "
            f"resize {split.get('depth', 0.0):.3f} s ({n_scenes} scenes); "
            f"the run {train_s:.1f} s; measured on {card}")

        ckpt = result["checkpoints"][0]
        zero()
        t0 = time.perf_counter()
        metrics = test_cli.main([DEPTH_CONFIG, ckpt, "--eval", "mAP", "nvs",
                                 "--options", *opts])
        test_s = time.perf_counter() - t0
        launches = counts()
        pipe = cfg.data["test"]["pipeline"][0]
        pad = [t for t in pipe["transforms"] if t["type"] == "Pad"][0]["size"]
        chunks = -(-((pad[0] - 2 * pipe["margin"])
                     * (pad[1] - 2 * pipe["margin"])) // cfg.model["N_rand"])
        log(f"[depth] tools/test --eval mAP nvs on one val scene: "
            f"{test_s:.1f} s; launches "
            + ", ".join(f"{n} {c}" for n, c in zip(names, launches))
            + "; " + ", ".join(f"{k} {metrics[k]:.4f}" for k in (
                "mAP_0.25", "mAR_0.25", "psnr", "ssim", "rmse")))
        if launches != [1, 0, 1, chunks * pipe["nerf_target_views"], 0, 0]:
            raise SystemExit(f"the test CLI launched {launches}")
        if not all(math.isfinite(v) for k, v in metrics.items()
                   if k.startswith(("mAP", "mAR", "psnr", "ssim", "rmse"))):
            raise SystemExit(f"non-finite test metrics {metrics}")

        # 10.5: one eval_step of the original-resolution config
        cfg_o = Config.fromfile(ORIGIN_RES_CONFIG)
        cfg_o.merge_from_options(opts)
        model = api.init_detector(cfg_o, device="cuda", seed=SEED)
        t0 = time.perf_counter()
        scene_o = build_dataset(cfg_o.data["test"], test_mode=True,
                                use_depth=True)[0]
        load_s = time.perf_counter() - t0
        batch = api.device_batch(model, scene_o)
        st = gated_streams(voxel, model, scene_o, dev)
        zero()
        out = api.eval_step(model, batch, cfg_o.test_cfg["nms_pre"])
        torch.cuda.synchronize()
        launches = counts()
        if launches != [1, 0, 1, 0, 0, 0] or not (
                torch.isfinite(out["boxes"]).all()
                and torch.isfinite(out["scores"]).all()):
            raise SystemExit(f"the original-resolution eval_step launched "
                             f"{launches} or gave non-finite candidates")
        eval_ms = cuda_time_ms(lambda: api.eval_step(
            model, batch, cfg_o.test_cfg["nms_pre"]), 3, warmup=1)
        v_o = batch["imgs"].shape[0]
        log(f"[depth] {ORIGIN_RES_CONFIG}: a val scene of {v_o} views at "
            f"{model.meta.img_shape} padded {model.meta.pad_shape} loaded "
            f"from files in {load_s:.3f} s; eval_step -> "
            f"{tuple(out['boxes'].shape)} candidates, launches "
            + ", ".join(f"{n} {c}" for n, c in zip(names, launches))
            + f"; gate keeps {st['features'][2]:.4f} (features, maps "
            f"{batch['imgs'].shape[1] // 4}x{batch['imgs'].shape[2] // 4})"
            f" / {st['rgb'][2]:.4f} (rgb) of the pairs; eval_step "
            f"{eval_ms:.2f} ms; measured on {card}")
        rgb_o = check_rgb(voxel, batch["denorm_images"], st["rgb"][0],
                          f"original resolution, {v_o} views")
        del model, batch, out
        torch.cuda.empty_cache()
    log(f"[depth] phase 10 in {time.perf_counter() - t_phase:.1f} s")
    return dict(rgb=rgb, rgb_orig=rgb_o, k1=k1, k1_bwd=k1_bwd,
                launches=path_launches, runtime_launches=cli_launches[2],
                kept={label: {k: v[2] for k, v in st_.items()}
                      for label, st_ in streams.items()})


# phase 11: bfloat16 compute (the JAX package's --bf16 path)
BF16_DEPTH_VIEWS = 50  # R101*'s bf16 inference: half phase 10's 100 views
BF16_CLI_STEPS = 2


def check_fusion_grad(voxel, pix, hw, gen):
    """K1's forward on bfloat16 maps that need a gradient (the training
    path's form: phase A's rows saved for the backward) against its plain
    version: count, s1 and s2 bitwise, s2m within 1e-5 relative; its time
    with autograd recording and its phases' apart (the uncounted launches
    ``_mapped_rows_launch`` on the tensor cores and ``_carry_launch``),
    the plain version's, the bound (the product at the bf16 tensor-core
    rate, and every operation at the fp32 rate beside it) and, beside
    phase A, two one-call yardsticks of its work: ``torch.addmm`` on the
    widened rows, and a cuBLAS bf16 GEMM of the rows by W's three pieces
    side by side (C x 3M, bf16 out)."""
    import torch

    dev = pix.device
    v, (fh, fw), c, m = pix.shape[0], hw, 256, 32
    feats = torch.randn((v, fh, fw, c), generator=gen,
                        device=dev).bfloat16().requires_grad_()
    w = (torch.randn((c, m), generator=gen, device=dev)
         / c ** 0.5).requires_grad_()
    b = torch.randn((m,), generator=gen, device=dev).requires_grad_()
    got = voxel.fusion_carry(feats, pix, w, b)
    with torch.no_grad():
        want = voxel.fusion_carry_plain(feats, pix, w, b)
        rows_want = voxel.mapped_rows_plain(feats, w, b)
    torch.cuda.synchronize()
    if not got[0].requires_grad or not all(
            torch.equal(g, p) for g, p in zip(got[:3], want[:3])):
        raise SystemExit("K1 under grad on bfloat16 maps: no graph, or "
                         "count, s1 or s2 differs from the plain version")
    err = float((got[3].detach() - want[3]).abs().max())
    rel = err / max(float(want[3].abs().max()), 1e-30)
    ms = cuda_time_ms(lambda: voxel.fusion_carry(feats, pix, w, b), 20)
    with torch.no_grad():
        plain_ms = cuda_time_ms(
            lambda: voxel.fusion_carry_plain(feats, pix, w, b), 5)
        fd, wd, bd = feats.detach(), w.detach(), b.detach()
        rows_p = voxel._mapped_rows_launch(fd, wd, bd)
        rows_rel = float((rows_p - rows_want).abs().max()) / max(
            float(rows_want.abs().max()), 1e-30)
        a_ms = cuda_time_ms(lambda: voxel._mapped_rows_launch(fd, wd, bd),
                            20)
        b_ms = cuda_time_ms(lambda: voxel._carry_launch(fd, pix, rows_p, bd),
                            20)
        del rows_p, rows_want
        # phase A's work in one call: the rows widened (exactly, outside
        # the timing) @ W + b; and the bf16 GEMM on W's pieces
        flat, x16 = fd.float().reshape(-1, c), fd.reshape(-1, c)
        library_ms = cuda_time_ms(lambda: torch.addmm(bd, flat, wd), 20)
        del flat
        pieces = torch.cat(voxel.split_bf16x3_plain(wd), dim=1)
        gemm_ms = cuda_time_ms(lambda: torch.mm(x16, pieces), 20)
    bound = fusion_bound(pix, c, m, 2)
    a_bound, a_by, a_fp32 = mapped_rows_bound(feats, m)
    log(f"[kernel] fused_mean_cov bfloat16 mapped, under grad: V={v} "
        f"map={fh}x{fw} C={c} N={pix.shape[1]} M={m}; {bound['n_valid']} "
        f"valid pairs, {bound['rows']} referenced rows: count, s1, s2 "
        f"bitwise equal, s2m max_rel_err={rel:.3e}, phase A's rows "
        f"max_rel_err={rows_rel:.3e} (tol 1e-5) ms={ms:.4f} (phase A "
        f"{a_ms:.4f} on the tensor cores, bound_ms={a_bound:.4f} ({a_by}), "
        f"at the fp32 rate {a_fp32:.4f}; phase B {b_ms:.4f}) plain_ms="
        f"{plain_ms:.4f} library_ms={library_ms:.4f} (torch.addmm on the "
        f"widened rows: phase A's work), bf16 GEMM {gemm_ms:.4f} (torch.mm "
        f"of the bf16 rows by W's three pieces, C x {3 * m}, bf16 out) "
        f"{bound_text(bound)}")
    if rel > 1e-5 or rows_rel > 1e-5:
        raise SystemExit(f"K1 under grad disagrees: s2m rel {rel:.3e}, "
                         f"rows rel {rows_rel:.3e}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
                library_ms=library_ms, phase_a_ms=a_ms, phase_b_ms=b_ms,
                bf16_gemm_ms=gemm_ms,
                bounds={"phase_a_ms": a_bound,
                        "fp32_rate_ms": bound["fp32_bound_ms"]})


def check_fusion_backward_exact(voxel, pix, hw, gen):
    """K1's backward on bfloat16 maps at the main path's form, on small
    integer maps, W, mapped rows and cotangents, whose pair products and
    sums are exact in float32 in any order: d features bit for bit equal
    to the plain version (on random inputs the kernel's fma chain and the
    plain version's matmul may round a pair's product apart), dW and db
    within 1e-4 x max."""
    import torch

    dev = pix.device
    v, n = pix.shape
    c, m = 256, 32

    def ints(shape, lo, hi):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).float()

    feats = ints((v,) + hw + (c,), -4, 5).bfloat16()
    w, b = ints((c, m), -4, 5), ints((m,), -4, 5)
    g1, gm = ints((n, c), -8, 9), ints((n, m), -8, 9)
    mapped = ints((v, hw[0] * hw[1], m), -8, 9)
    count = (pix >= 0).float().sum(0)
    args = (feats, pix, count, g1, None, gm, w, b, mapped)
    got = voxel.fusion_carry_backward(*args)
    want = voxel.fusion_carry_backward_plain(*args)
    torch.cuda.synchronize()
    rels = [float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
            for x, y in zip(got[1:], want[1:])]
    same = torch.equal(got[0], want[0])
    log(f"[kernel] fused_mean_cov_backward bfloat16 mapped, exact integer "
        f"inputs, phase 8's pix: V={v} C={c} N={n} M={m}: d features "
        f"bitwise equal {same} (tol: bitwise), dW rel {rels[0]:.3e}, db rel "
        f"{rels[1]:.3e} (tol 1e-4)")
    if not same or max(rels) > 1e-4:
        raise SystemExit("K1 backward on bfloat16 maps is not bitwise equal "
                         "to its plain version on exact inputs")


def bf16_path(api, voxel, pointnet, render, card, pix_scaled, nvs,
              runtime_opts, f32_detection):
    """Phase 11: the bfloat16 compute path (``compute_dtype=bfloat16``,
    the JAX package's ``--bf16``): the bf16 kernel forms against their
    plain versions at the path's shapes, then NeRF-Det-R50 detection, the
    render of one view and the joint train step at full width,
    NeRF-Det-R101* (depth_sp) inference and one train step through the
    rgb stream on bfloat16 images, and ``tools/train --bf16`` then
    ``tools/test`` on phase 9's files. Returns the record's numbers."""
    import math

    import numpy as np
    import torch

    from nerfdet_tpu_torch.config import Config
    from nerfdet_tpu_torch.data import ray_stats
    from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfdet_tpu_torch.nn.heads import get_candidate_bboxes
    from nerfdet_tpu_torch.tools import test as test_cli
    from nerfdet_tpu_torch.tools import train as train_cli

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    dev = api.resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    names = ("fused_mean_cov", "fused_mean_cov_backward",
             "fused_mean_cov_rgb", "streaming_sample_mean_var",
             "streaming_sample_mean_var_backward", "furthest_point_sample")
    counters = (voxel.fusion_carry, voxel.fusion_carry_backward,
                voxel.rgb_carry, render.streaming_sample_mean_var,
                render.streaming_sample_mean_var_backward,
                pointnet.furthest_point_sample)
    launches = {n: 0 for n in names}  # this phase's paths, summed

    def zero():
        for fn in counters:
            fn.launches = 0

    def read(label):
        got = [fn.launches for fn in counters]
        for n, k in zip(names, got):
            launches[n] += k
        log(f"[bf16] {label}: launches "
            + ", ".join(f"{n} {k}" for n, k in zip(names, got)))
        return got

    # ---- 11.1 the bf16 kernel forms against their plain versions ----
    t0 = time.perf_counter()
    model = api.init_detector(CONFIG, device="cuda", seed=SEED,
                              compute_dtype=bf16)
    meta = model.meta
    h, w = meta.img_shape
    hw = (meta.pad_shape[0] // 4, meta.pad_shape[1] // 4)
    log(f"[bf16] init_detector({CONFIG}, compute_dtype=bfloat16): "
        f"{time.perf_counter() - t0:.1f} s")
    k1 = check_fusion_grad(voxel, pix_scaled, hw, gen)
    k1_bwd = check_fusion_backward(
        voxel, pix_scaled, hw, gen,
        "phase 8's pix (intrinsic scaled to ori_shape)", bf16)
    check_fusion_backward_exact(voxel, pix_scaled, hw, gen)
    item = nvs[0]
    rbatch = api.render_batch(model, item)
    with torch.inference_mode():
        fmaps = model.render_featmaps(model.extract_2d(rbatch["imgs"]))
    rays = render.sample_along_camera_ray(
        rbatch["ray_o"].reshape(-1, 3)[:CHUNK],
        rbatch["ray_d"].reshape(-1, 3)[:CHUNK], *model.near_far_range,
        model.n_samples)[0]
    proj = model.render_projection(item["intrinsic"], item["extrinsics"],
                                   dev)
    images = rbatch["denorm_images"].to(bf16)
    k2 = check_k2(render, [("render chunk, bfloat16", rays.contiguous(),
                            images, fmaps.contiguous(), proj, True)],
                  (h, w))["render chunk, bfloat16"]
    del fmaps, rays, images
    tscene, _ = host_ray_stream(ray_stats, model,
                                train_scene(model, SEED + 1))
    with torch.no_grad():
        tfeats = model.render_featmaps(model.extract_2d(
            torch.as_tensor(tscene["imgs"], device=dev))).contiguous()
    ray_t = {k: torch.as_tensor(tscene[k], device=dev) for k in (
        "ray_o", "ray_d") + ray_stats.RAY_STREAM_KEYS}
    k2_train, k2_bwd = check_k2_training(
        render, render.points_at(ray_t["ray_o"], ray_t["ray_d"],
                                 ray_t["z_vals"]),
        model.render_projection(tscene["intrinsic"], tscene["extrinsics"],
                                dev), (h, w), tfeats,
        tuple(ray_t[k] for k in ray_stats.RAY_STREAM_KEYS[1:]), gen)
    del tscene, tfeats, ray_t
    log(f"[bf16] 11.1 kernels in {time.perf_counter() - t0:.1f} s")

    # ---- 11.2 R50 detection at bf16 ----
    scene = make_synthetic_scene(seed=SEED, n_views=N_VIEWS, n_targets=1,
                                 hw=(h, w), pad_hw=meta.pad_shape,
                                 n_rand=(h - 2 * MARGIN) * (w - 2 * MARGIN),
                                 n_boxes=4, max_gt=8, margin=MARGIN)
    batch = api.device_batch(model, scene)
    test_cfg = Config.fromfile(CONFIG).test_cfg
    nms_pre, iou_thr = test_cfg["nms_pre"], test_cfg["iou_thr"]
    zero()
    out = api.eval_step(model, batch, nms_pre)
    det = api.detections_from_candidates(
        out["boxes"].float().cpu().numpy(), out["scores"].float().cpu()
        .numpy(), SCORE_THR, iou_thr)
    got = read(f"eval_step at bfloat16 -> {tuple(out['boxes'].shape)} "
               f"candidates ({str(out['scores'].dtype)[6:]} scores), NMS "
               f"kept {len(det['labels_3d'])}")
    if got != [1, 0, 0, 0, 0, 0]:
        raise SystemExit(f"the bf16 detection path launched {got}")
    if not (torch.isfinite(out["boxes"]).all()
            and torch.isfinite(out["scores"]).all()):
        raise SystemExit("non-finite bf16 candidates")
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
            ms = cuda_time_ms(fn, 3, warmup=1)
            log(f"[stage] bf16 {name}: {ms:.3f} ms (float32, phase 4: "
                f"{f32_detection[name]:.3f} ms)")
    del feats, vol, heads
    iters = 5
    for _ in range(2):
        api.eval_step(model, batch, nms_pre)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(iters):
        out = api.eval_step(model, batch, nms_pre)
        det = api.detections_from_candidates(
            out["boxes"].float().cpu().numpy(),
            out["scores"].float().cpu().numpy(), test_cfg["score_thr"],
            iou_thr)
    dt = (time.perf_counter() - t0) / iters
    log(f"[bf16] detection: {1 / dt:.3f} scenes/s ({dt * 1e3:.2f} ms a "
        f"scene: eval_step + host NMS; float32, phase 4: "
        f"{f32_detection['scenes/s']:.3f} scenes/s), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; measured on "
        f"{card}")
    del batch, out

    # ---- 11.3 the render of one view at bf16 ----
    n_rays = item["ray_o"].shape[1]
    expect = math.ceil(n_rays / CHUNK)
    zero()
    metrics = api.run_nvs_eval(model, nvs, chunk=CHUNK, progress=False)
    got = read(f"run_nvs_eval at bfloat16, one view of {n_rays} rays: psnr "
               f"{metrics['psnr']:.4f} ssim {metrics['ssim']:.4f}")
    if got != [0, 0, 0, expect, 0, 0]:
        raise SystemExit(f"the bf16 render launched {got}, expected K2 "
                         f"{expect} times")
    if not all(np.isfinite(v) for v in metrics.values()):
        raise SystemExit(f"non-finite bf16 NVS metrics {metrics}")
    with torch.inference_mode():
        rgb_out, depth_out = model.render_full(rbatch, CHUNK)
    near, far = model.near_far_range
    if not (torch.isfinite(rgb_out).all() and torch.isfinite(depth_out).all()
            and float(rgb_out.min()) >= 0 and float(rgb_out.max()) <= 1
            and near <= float(depth_out.min())
            and float(depth_out.max()) <= far):
        raise SystemExit("bf16 render_full outputs non-finite or out of "
                         "range")
    stages, _, _ = render_stage_times(model, render, rbatch, n_rays)
    mlp_flop = 2 * expect * CHUNK * model.n_samples * sum(
        m.in_features * m.out_features for m in model.nerf_mlp.modules()
        if isinstance(m, torch.nn.Linear))
    for label, ms in stages.items():
        extra = ""
        if label == "NeRF MLP":
            extra = (f" ({mlp_flop / 1e9:.1f} GFLOP bf16, "
                     f"{mlp_flop / ms / 1e9:.2f} TFLOP/s)")
        log(f"[stage] bf16 render {label}: {ms:.3f} ms{extra}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        for _ in range(3):
            model.render_full(rbatch, CHUNK)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / 3
    log(f"[bf16] render: {1 / dt:.3f} views/s ({dt * 1e3:.2f} ms a view: "
        f"render_full, {n_rays} rays); measured on {card}")
    del model, rbatch, rgb_out, depth_out
    torch.cuda.empty_cache()

    # ---- 11.4 the joint train step at bf16 ----
    t0 = time.perf_counter()
    tr = api.init_trainer(CONFIG, device="cuda", seed=SEED,
                          steps_per_epoch=1000, compute_dtype=bf16)
    prepared, host_s = host_ray_stream(ray_stats, tr.model,
                                       train_scene(tr.model, SEED + 1))
    tbatch = api.train_batch(tr.model, [prepared])
    log(f"[bf16] init_trainer(compute_dtype=bfloat16) + the bfloat16 host "
        f"ray stream ({host_s:.2f} s on the host): "
        f"{time.perf_counter() - t0:.1f} s")
    hist, dt, got, peak = timed_steps(tr, tbatch, counters)
    last = {k: float(v) for k, v in hist[-1].items()}
    for n, k in zip(names, got):
        launches[n] += k
    log(f"[bf16] joint train, 5 steps: launches "
        + ", ".join(f"{n} {k}" for n, k in zip(names, got))
        + "; last step " + ", ".join(f"{k} {v:.6g}" for k, v in
                                     last.items()))
    if got != [5, 5, 0, 5, 5, 0]:
        raise SystemExit(f"the bf16 joint training path launched {got}")
    for m in hist:
        if not all(math.isfinite(float(v)) for v in m.values()):
            raise SystemExit(f"non-finite bf16 train metrics {m}")
    if not (last["n_pos"] > 0 and "loss_nvs" in last):
        raise SystemExit("no positive voxels or no NVS loss at bf16")
    if any(p.dtype != torch.float32 for p in tr.model.parameters()):
        raise SystemExit("a parameter left float32")
    for k, ms in step_stage_times(tr, tbatch).items():
        log(f"[stage] bf16 joint train {k}: {ms:.3f} ms")
    log(f"[bf16] joint train: {1 / dt:.3f} steps/s ({dt * 1e3:.2f} ms a "
        f"step: Trainer.step, one scene of {N_VIEWS} views and "
        f"{tr.model.n_rand} rays, host clock after 2 warm-up steps), peak "
        f"memory {peak / 2**30:.2f} GiB; measured on {card}")
    del tr, tbatch, prepared
    torch.cuda.empty_cache()

    # ---- 11.5 R101* (depth_sp) at bf16: the rgb stream on bf16 images ----
    t0 = time.perf_counter()
    cfg = Config.fromfile(DEPTH_CONFIG)
    model = api.init_detector(cfg, device="cuda", seed=SEED,
                              compute_dtype=bf16)
    scene = depth_scene(model, SEED + 2, BF16_DEPTH_VIEWS)
    streams = gated_streams(voxel, model, scene, dev)
    rgb_check = check_rgb(
        voxel, torch.as_tensor(scene["denorm_images"], device=dev).to(bf16),
        streams["rgb"][0], f"{BF16_DEPTH_VIEWS} views, bfloat16 images")
    batch = api.device_batch(model, scene)
    zero()
    out = api.eval_step(model, batch, cfg.test_cfg["nms_pre"])
    got = read(f"R101* eval_step at bfloat16, {BF16_DEPTH_VIEWS} views "
               f"with depth -> {tuple(out['boxes'].shape)} candidates")
    if got != [1, 0, 1, 0, 0, 0]:
        raise SystemExit(f"the bf16 R101* inference launched {got}")
    if not (torch.isfinite(out["boxes"]).all()
            and torch.isfinite(out["scores"]).all()):
        raise SystemExit("non-finite bf16 R101* candidates")
    del model, batch, out
    torch.cuda.empty_cache()
    tr = api.init_trainer(cfg, device="cuda", seed=SEED,
                          steps_per_epoch=1000, compute_dtype=bf16)
    scene48 = depth_scene(tr.model, SEED + 3, DEPTH_TRAIN_VIEWS)
    prepared, _ = host_ray_stream(ray_stats, tr.model, scene48)
    tbatch = api.train_batch(tr.model, [prepared])
    zero()
    m = {k: float(v) for k, v in tr.step(tbatch).items()}
    torch.cuda.synchronize()
    got = read(f"R101* train step at bfloat16, {DEPTH_TRAIN_VIEWS} views, "
               f"loss_depth on: " + ", ".join(f"{k} {v:.6g}"
                                              for k, v in m.items()))
    if got != [1, 1, 1, 1, 1, 0]:
        raise SystemExit(f"the bf16 R101* train step launched {got}")
    if not (all(math.isfinite(v) for v in m.values())
            and m.get("loss_depth", 0.0) > 0):
        raise SystemExit(f"bf16 R101* train step: {m}")
    log(f"[bf16] 11.5 R101* in {time.perf_counter() - t0:.1f} s")
    del tr, tbatch, prepared, scene48
    torch.cuda.empty_cache()

    # ---- 11.6 tools/train --bf16, then tools/test, on phase 9's files ----
    t0 = time.perf_counter()
    work = os.path.join(os.path.dirname(runtime_opts[0].split("=", 1)[1]
                                        .rstrip("/")), "work_bf16")
    zero()
    result = train_cli.main([CONFIG, "--bf16", "--work-dir", work,
                             "--max-steps", str(BF16_CLI_STEPS), "--options",
                             *runtime_opts])
    got = read(f"tools/train --bf16, {BF16_CLI_STEPS} steps and a "
               f"validation")
    hist = result["history"]
    for hs in hist:
        log(f"[bf16] tools/train --bf16 step {hs['step']}: loss "
            f"{hs['loss']:.5g} loss_nvs {hs.get('loss_nvs', float('nan')):.5g}"
            f" grad_norm {hs['grad_norm']:.5g}, step {hs['step_s']:.3f} s")
    if (len(hist) != BF16_CLI_STEPS or not result["checkpoints"]
            or got[1] != BF16_CLI_STEPS or got[4] != BF16_CLI_STEPS
            or not all(math.isfinite(hs[k]) for hs in hist for k in hs
                       if k.startswith(("loss", "grad")))):
        raise SystemExit(f"tools/train --bf16: {len(hist)} steps, "
                         f"launches {got}")
    ckpt = result["checkpoints"][-1]
    saved = torch.load(ckpt, map_location="cpu", weights_only=False)
    if any(v.is_floating_point() and v.dtype != torch.float32
           for v in saved["model"].values()):
        raise SystemExit("a bf16 run saved a non-float32 weight")
    zero()
    metrics = test_cli.main([CONFIG, ckpt, "--eval", "mAP", "--options",
                             *runtime_opts])
    got = read(f"tools/test on {os.path.basename(ckpt)} (float32, as the "
               f"JAX tool): " + ", ".join(f"{k} {v:.4g}" for k, v in
                                          metrics.items()))
    if got[0] < 1 or not all(math.isfinite(v) for v in metrics.values()):
        raise SystemExit(f"tools/test after --bf16: {metrics}, {got}")
    log(f"[bf16] 11.6 CLIs in {time.perf_counter() - t0:.1f} s")
    log(f"[bf16] phase 11 in {time.perf_counter() - t_phase:.1f} s")
    return dict(k1=k1, k1_bwd=k1_bwd, k2=k2, k2_train=k2_train,
                k2_bwd=k2_bwd, rgb=rgb_check, launches=launches)




# phase 12: JPEG views read by the port's own decoder
JPEG_FIXTURES = os.path.join("tests", "data", "torch_jpeg")
JPEG_REPEATS = 5  # decodes of each view for its host time


def jpeg_scene(meta, root):
    """Lay the fixtures' 484x648 scene out in ScanNet's layout under
    ``root``: ``posed_images/scene0000_00/#####.jpg`` and the infos (the
    JAX writer's schema) as both splits. Returns ``root``."""
    import pickle
    import shutil

    import numpy as np

    scene = meta["scene"]
    sdir = os.path.join(root, "posed_images", "scene0000_00")
    os.makedirs(sdir, exist_ok=True)
    paths, poses = [], []
    for i, view in enumerate(scene["views"]):
        rel = os.path.join("posed_images", "scene0000_00", f"{i:05d}.jpg")
        shutil.copy(os.path.join(JPEG_FIXTURES, view["file"]),
                    os.path.join(root, rel))
        paths.append(rel)
        poses.append(np.asarray(view["extrinsic"], np.float32))
    boxes = np.asarray(scene["gt_boxes_upright_depth"], np.float32)
    info = dict(img_paths=paths, extrinsics=poses,
                intrinsics=np.asarray(scene["intrinsic"], np.float32),
                annos=dict(gt_num=len(boxes), gt_boxes_upright_depth=boxes,
                           axis_align_matrix=np.eye(4, dtype=np.float32),
                           **{"class": np.asarray(scene["labels"],
                                                  np.int64)}))
    for split in ("train", "val"):
        with open(os.path.join(root, f"scannet_infos_{split}.pkl"),
                  "wb") as f:
            pickle.dump([info], f)
    return root


def jpeg_path(api, voxel, pointnet, render, card, ckpt, tmp):
    """Phase 12: the JAX writer's JPEG views (``tests/data/torch_jpeg``)
    decoded by the port (no cv2: the card's machine has none) to the
    SHA-256 of ``cv2.imread``'s output recorded beside them, the host
    time a view at 484x648 and 968x1296, then ``tools/test --eval mAP``
    from phase 9's checkpoint ``ckpt`` on a val scene laid out from them
    (``run_eval`` through the loader, K1 once). Returns the decoder's
    record."""
    import hashlib
    import math
    import statistics

    from nerfdet_tpu_torch.config import Config
    from nerfdet_tpu_torch.data import jpeg, pipeline
    from nerfdet_tpu_torch.tools import test as test_cli

    t_phase = time.perf_counter()
    if not os.path.exists(ckpt):
        raise SystemExit(f"phase 9 left no checkpoint {ckpt}")
    with open(os.path.join(JPEG_FIXTURES, "meta.json")) as f:
        meta = json.load(f)
    record = {"name": "jpeg_decode", "route": "host C++ (entropy) + numpy",
              "source": "nerfdet_tpu_torch/data/jpeg.py, "
                        "nerfdet_tpu_torch/csrc/jpeg_entropy.cpp",
              "replaces": "cv2.imread in nerfdet_tpu/data/pipeline.py:36"}
    for tag, part in meta.items():
        times = []
        for view in part["views"]:
            path = os.path.join(JPEG_FIXTURES, view["file"])
            rgb = pipeline.imread(path)
            digest = hashlib.sha256(rgb.tobytes()).hexdigest()
            if (rgb.shape != tuple(part["hw"]) + (3,)
                    or digest != view["sha256"]):
                raise SystemExit(f"{view['file']} decodes to {rgb.shape}, "
                                 f"sha256 {digest}, not cv2.imread's "
                                 f"{view['sha256']}")
            with open(path, "rb") as f:
                data = f.read()
            for _ in range(JPEG_REPEATS):
                t0 = time.perf_counter()
                jpeg.decode(data)
                times.append((time.perf_counter() - t0) * 1e3)
        hw = "x".join(map(str, part["hw"]))
        record[f"host_ms_{hw}"] = statistics.median(times)
        log(f"[jpeg] {len(part['views'])} views at {hw}: decoded to "
            f"cv2.imread's SHA-256 (bitwise); host ms a view: median "
            f"{statistics.median(times):.2f}, min {min(times):.2f}, max "
            f"{max(times):.2f} ({JPEG_REPEATS} decodes each, one thread)")

    cfg = Config.fromfile(CONFIG)
    root = jpeg_scene(meta, os.path.join(tmp, "jpeg_scene"))
    every = (voxel.fusion_carry, voxel.fusion_carry_backward,
             render.streaming_sample_mean_var,
             render.streaming_sample_mean_var_backward,
             pointnet.furthest_point_sample)
    decoded = []
    decode = jpeg.decode

    def counted(data):
        decoded.append(len(data))
        return decode(data)

    jpeg.decode = counted
    for fn in every:
        fn.launches = 0
    t0 = time.perf_counter()
    try:
        metrics = test_cli.main([CONFIG, ckpt, "--eval", "mAP",
                                 "--options",
                                 *runtime_options(cfg, root, root)])
    finally:
        jpeg.decode = decode
    wall = time.perf_counter() - t0
    launches = [fn.launches for fn in every]
    pipe = cfg.data["test"]["pipeline"][0]
    n_views = len(meta["scene"]["views"])
    log(f"[jpeg] tools/test --eval mAP from {os.path.basename(ckpt)} on "
        f"the fixtures' val scene ({n_views} JPEG views at 484x648; the "
        f"pipeline draws {pipe['n_images']} and keeps the distinct ones): "
        f"{len(decoded)} JPEG decodes, launches fused_mean_cov "
        f"{launches[0]}, backward "
        f"kernels {launches[1]} / {launches[3]}, streaming_sample_mean_var "
        f"{launches[2]}, furthest_point_sample {launches[4]}; "
        f"{wall:.2f} s; measured on {card}")
    if launches != [1, 0, 0, 0, 0] or len(decoded) != n_views:
        raise SystemExit(f"tools/test on JPEG views launched {launches} "
                         f"after {len(decoded)} JPEG decodes")
    keys = sorted(k for k in metrics if k.startswith(("mAP", "mAR")))
    if not keys or not all(math.isfinite(metrics[k]) for k in keys):
        raise SystemExit(f"non-finite or missing metrics {metrics}")
    log("[jpeg] mAP/mAR: " + ", ".join(f"{k} {metrics[k]:.4f}"
                                       for k in keys))
    record.update(views=sum(len(p["views"]) for p in meta.values()),
                  test_launches_k1=launches[0], test_s=wall)
    log(f"[jpeg] phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return record


# phase 13: multi-card training and evaluation, one process a card
DDP_STEPS = 2  # 13.1's steps through the train CLI (3 before)
DDP_TIMED = 1  # 13.2's timed steps after the compared one (3 before)
DDP_TIMEOUT = 300  # seconds a child run of phase 13 may take
LAUNCHER = """\
# a child run of chip_smoke.py phase 13: python3 <this> MODE OUT [ARGS]
import sys

import torch

torch.backends.cudnn.deterministic = True
sys.path.insert(0, {root!r})
import chip_smoke  # noqa: E402

chip_smoke.ddp_child(sys.argv[1:])
"""


def ddp_child(argv):
    """A child process of phase 13, started through its launcher file:
    ``MODE OUT [ARGS]``. ``train`` and ``test`` call the CLI's ``main``
    with ARGS; ``step`` takes one joint train step of phase 8's model on
    its rank's scene (``SEED + 1 + rank``) and times ``DDP_TIMED`` more.
    ``--gloo-on-one-card`` in ARGS first joins the process group over
    gloo, every rank on ``cuda:0`` (NCCL refuses two ranks on one card).
    Every train step's kernel launches and every reduction over the
    group (CUDA events around it) are recorded; rank 0 writes the record
    to OUT (JSON; ``step`` writes OUT.rank<r>.pt on every rank)."""
    import torch
    import torch.distributed as dist

    from nerfdet_tpu_torch import api
    from nerfdet_tpu_torch.data import ray_stats
    from nerfdet_tpu_torch.ops import render, voxel
    from nerfdet_tpu_torch.parallel import dist as pdist
    from nerfdet_tpu_torch.tools import test as test_cli
    from nerfdet_tpu_torch.tools import train as train_cli

    mode, out, args = argv[0], argv[1], list(argv[2:])
    own_group = "--gloo-on-one-card" in args
    if own_group:
        args.remove("--gloo-on-one-card")
        os.environ["LOCAL_RANK"] = "0"
        dist.init_process_group("gloo", init_method="env://")
    counters = (voxel.fusion_carry, voxel.fusion_carry_backward,
                render.streaming_sample_mean_var,
                render.streaming_sample_mean_var_backward)
    if mode in ("step2d", "eval2d"):  # phase 14: and K2's sums form
        counters += (render.streaming_sample_sums, voxel.rgb_carry)
    per_step, reduces = [], []
    original_init = counted_trainers(api, counters, per_step)
    originals = {name: getattr(pdist, name) for name in (
        "all_reduce_mean_", "all_reduce_sum_")}

    def timed_reduce(name, original):
        def reduce(tensors, group=None):
            if group is None:
                return original(tensors, group)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            original(tensors, group)
            ev[1].record()
            reduces.append((len(per_step), len(tensors), sum(
                t.numel() * t.element_size() for t in tensors), ev, name))
        return reduce

    for name, fn in originals.items():
        setattr(pdist, name, timed_reduce(name, fn))
    record = {"mode": mode}

    def counted():
        torch.cuda.synchronize()
        record["per_step"] = per_step
        for key, kind in (("reduces", "all_reduce_mean_"),
                          ("sum_reduces", "all_reduce_sum_")):
            record[key] = [(s, n, b, ev[0].elapsed_time(ev[1]))
                           for s, n, b, ev, k in reduces if k == kind]
        return record
    try:
        if mode == "train":
            result = train_cli.main(args)
            record["history"] = result["history"]
        elif mode == "test":
            for fn in counters:
                fn.launches = 0
            record["metrics"] = test_cli.main(args)
            record["launches"] = [fn.launches for fn in counters]
        elif mode in ("step2d", "eval2d"):
            mesh_child(mode, out, api, counters, per_step, counted)
        else:
            with pdist.process_group("cuda") as (dev, group):
                tr = api.init_trainer(CONFIG, device=dev, seed=SEED,
                                      steps_per_epoch=1000,
                                      process_group=group)
                rank = pdist.rank(group)
                scene, _ = host_ray_stream(
                    ray_stats, tr.model, train_scene(tr.model,
                                                     SEED + 1 + rank))
                batch = api.train_batch(tr.model, [scene])
                metrics = tr.step(batch)
                state = {k: v.to("cpu", copy=True) for k, v in
                         tr.model.state_dict().items()}
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(DDP_TIMED):
                    tr.step(batch)
                torch.cuda.synchronize()
                record.update(
                    metrics={k: float(v) for k, v in metrics.items()},
                    step_s=(time.perf_counter() - t0) / DDP_TIMED,
                    device=str(dev), backend=dist.get_backend(group),
                    world=pdist.world(group))
                torch.save(dict(counted(), state=state),
                           f"{out}.rank{rank}.pt")
        rank = dist.get_rank() if dist.is_initialized() else 0
        if mode in ("train", "test") and rank == 0:
            with open(out, "w") as f:
                json.dump(counted(), f)
    finally:
        api.init_trainer = original_init
        for name, fn in originals.items():
            setattr(pdist, name, fn)
        if own_group:
            dist.destroy_process_group()


def start_children(commands, logs):
    """Start ``commands``, (argv, extra environment) pairs, each in a
    session of its own, its output to a file under ``logs``."""
    started = []
    for c, extra in commands:
        path = os.path.join(logs, f"child_{time.monotonic_ns()}.log")
        with open(path, "w") as f:
            started.append((c, path, subprocess.Popen(
                c, env=dict(os.environ, **extra), stdout=f,
                stderr=subprocess.STDOUT, start_new_session=True)))
    return started


def wait_children(started):
    """Wait for ``start_children``'s processes; kill every one and fail
    after ``DDP_TIMEOUT``; fail if one exits non-zero."""
    deadline = time.monotonic() + DDP_TIMEOUT
    try:
        for _, _, p in started:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for _, _, p in started:
            if p.poll() is None:
                os.killpg(p.pid, 9)
                p.wait()
    for c, path, p in started:
        if p.returncode != 0:
            with open(path) as f:
                log(f.read()[-4000:])
            raise SystemExit(f"phase 13: {c[:6]} exited {p.returncode}")


def run_children(commands, logs):
    """``start_children``, then ``wait_children``."""
    wait_children(start_children(commands, logs))


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def reduce_ms(record):
    """(ms of the step's reductions, ms and bytes of its gradients'
    reduction) a step, over the steps after the first."""
    steps = {}
    for s, n, b, ms in record["reduces"]:
        steps.setdefault(s, []).append((n, b, ms))
    later = [v for s, v in sorted(steps.items()) if s > 0] or list(
        steps.values())
    total = sum(sum(ms for _, _, ms in v) for v in later) / len(later)
    grads = [max(v, key=lambda r: r[1]) for v in later]
    return (total, sum(g[2] for g in grads) / len(grads), grads[0][0],
            grads[0][1])


def ddp_path(api, ray_stats, card, tmp, runtime_opts):
    """Phase 13: data-parallel training and evaluation, one process a
    card. 13.1: ``tools/train --distributed`` under torchrun at world 1
    (NCCL) against the same run without ``--distributed``, on phase 9's
    files; 13.2: the R50 joint step over two ranks on this card (gloo,
    CUDA tensors), one scene a rank, against one process stepping both
    (and over NCCL, a card a rank, where the machine has two); 13.3:
    ``tools/test --distributed`` at world 2 (gloo, this card) against
    world 1 on phase 9's val scene, twice, and ``ckpt_2``. Returns the
    numbers of the record."""
    import pickle

    import torch

    from nerfdet_tpu_torch.tools import test as test_cli

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    launcher = os.path.join(tmp, "ddp_launcher.py")
    with open(launcher, "w") as f:
        f.write(LAUNCHER.format(root=root))
    py, torchrun = sys.executable, [sys.executable, "-m",
                                    "torch.distributed.run",
                                    "--standalone"]
    names = ("fused_mean_cov", "fused_mean_cov_backward",
             "streaming_sample_mean_var",
             "streaming_sample_mean_var_backward")
    out = {}

    # ---- 13.1 the train CLI at world 1: NCCL against no group ----
    runs = {}
    for tag, cmd in (
            ("--distributed (torchrun, NCCL, world 1)",
             torchrun + ["--nproc_per_node", "1", launcher]),
            ("without --distributed", [py, launcher])):
        path = os.path.join(tmp, f"ddp_train_{len(runs)}.json")
        args = [CONFIG, "--work-dir", os.path.join(tmp, f"ddp_{len(runs)}"),
                "--max-steps", str(DDP_STEPS), "--no-validate", "--options",
                *runtime_opts]
        if not runs:
            args.insert(1, "--distributed")
        t0 = time.perf_counter()
        run_children([(cmd + ["train", path] + args, {})], tmp)
        with open(path) as f:
            runs[tag] = json.load(f)
        runs[tag]["wall_s"] = time.perf_counter() - t0
    for i in range(len(runs)):  # their checkpoints: 1.26 GB each
        shutil.rmtree(os.path.join(tmp, f"ddp_{i}"))
    (dtag, d), (ptag, p) = runs.items()
    worst = 0.0
    for hd, hp in zip(d["history"], p["history"]):
        for k in ("loss", "loss_cls", "loss_bbox", "loss_centerness",
                  "loss_nvs", "n_pos", "grad_norm"):
            worst = max(worst, abs(hd[k] - hp[k]) / max(abs(hp[k]), 1e-30))
    for tag, r in runs.items():
        h = r["history"]
        log(f"[ddp] 13.1 tools/train {tag}: {len(h)} steps, launches a step "
            f"{r['per_step']} ({', '.join(names)}); losses "
            + "; ".join(f"{x['loss']:.6f}/{x['grad_norm']:.6f}" for x in h)
            + f" (loss/grad_norm); child wall {r['wall_s']:.1f} s")
        if r["per_step"] != [[1, 1, 1, 1]] * DDP_STEPS:
            raise SystemExit(f"13.1 {tag}: launches {r['per_step']}, "
                             f"expected each kernel once a step")
    step_rate = {tag: (len(r["history"]) - 1) / sum(
        x["step_s"] for x in r["history"][1:]) for tag, r in runs.items()}
    file_rate = {tag: (len(r["history"]) - 1) / sum(
        x["step_s"] + x["data_s"] for x in r["history"][1:])
        for tag, r in runs.items()}
    total_ms, grad_ms, n_grads, grad_bytes = reduce_ms(d)
    log(f"[ddp] 13.1 per-step loss terms and grad_norm: max rel diff "
        f"{worst:.3e} (tol 1e-6; bitwise {worst == 0.0})")
    if worst > 1e-6:
        raise SystemExit("13.1: --distributed at world 1 and the run "
                         "without it disagree")
    log(f"[ddp] 13.1 steps/s (steps 2-{DDP_STEPS}, Trainer.step with "
        f"train_batch on the host clock): {step_rate[dtag]:.3f} "
        f"--distributed, {step_rate[ptag]:.3f} without; from files (loader "
        f"wait included) {file_rate[dtag]:.3f} / {file_rate[ptag]:.3f}; "
        f"all-reduces {total_ms:.3f} ms a step, of them the gradients' "
        f"{grad_ms:.3f} ms ({n_grads} tensors, {grad_bytes} bytes float32, "
        f"one flat buffer); CUDA events; measured on {card}")
    out.update(world1_steps_s=step_rate[dtag], plain_steps_s=step_rate[ptag],
               world1_files_steps_s=file_rate[dtag],
               plain_files_steps_s=file_rate[ptag],
               allreduce_ms=total_ms, grad_allreduce_ms=grad_ms,
               grad_tensors=n_grads, grad_bytes=grad_bytes,
               world1_max_rel=worst,
               launches=dict(zip(names, map(sum, zip(*d["per_step"])))))

    # ---- 13.3 tools/test --distributed at world 2 against world 1: its
    # two ranks run beside 13.2's one-process step ----
    val_root = [o.split("=", 1)[1] for o in runtime_opts
                if o.startswith("data.test.data_root=")][0].rstrip("/")
    with open(os.path.join(val_root, "scannet_infos_val.pkl"), "rb") as f:
        infos = pickle.load(f)
    twice = os.path.join(val_root, "scannet_infos_val_twice.pkl")
    with open(twice, "wb") as f:
        pickle.dump(infos * 2, f)  # a scene for each rank
    opts = [o for o in runtime_opts if not o.startswith(
        "data.test.ann_file=")] + [f"data.test.ann_file={twice}"]
    ckpt = os.path.join(tmp, "work", "ckpts", "ckpt_2.pth")
    args = [CONFIG, ckpt, "--eval", "mAP", "--options", *opts]
    path = os.path.join(tmp, "ddp_test.json")
    t3 = time.perf_counter()
    test_children = start_children(
        [(torchrun + ["--nproc_per_node", "2", launcher, "test", path,
                      "--gloo-on-one-card", args[0], args[1],
                      "--distributed"] + args[2:], {})], tmp)

    # ---- 13.2 the joint step over two ranks against one process ----
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    try:
        tr = api.init_trainer(CONFIG, device="cuda", seed=SEED,
                              steps_per_epoch=1000)
        scenes = [host_ray_stream(ray_stats, tr.model,
                                  train_scene(tr.model, SEED + 1 + r))[0]
                  for r in (0, 1)]
        n_params = sum(1 for _ in tr.model.parameters())
        one = {k: float(v) for k, v in tr.step(api.train_batch(
            tr.model, scenes)).items()}
        want = {k: v.to("cpu", copy=True)
                for k, v in tr.model.state_dict().items()}
        # the gradients the update read, and each parameter's rate
        grads = {n: p.grad.to("cpu", copy=True)
                 for n, p in tr.model.named_parameters()}
        rate = {n: tr.optimizer.schedule(0) * (
            tr.optimizer.lr_mult if n.startswith("backbone.") else 1.0)
            for n in grads}
        del tr, scenes
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    log(f"[ddp] 13.2 one process, two scenes of {N_VIEWS} views and 2048 "
        f"rays: " + ", ".join(f"{k} {v:.6g}" for k, v in one.items())
        + f"; {n_params} parameter tensors")
    wait_children(test_children)
    wall = time.perf_counter() - t3
    with open(path) as f:
        two = json.load(f)
    t0 = time.perf_counter()
    world1 = json.loads(json.dumps(test_cli.main(args)))
    wall1 = time.perf_counter() - t0
    keys = sorted(k for k in world1 if k.startswith(("mAP", "mAR")))
    log(f"[ddp] 13.3 tools/test --distributed, two ranks on this card over "
        f"gloo, {len(infos) * 2} val scenes: rank 0's launches "
        f"{two['launches']} (K1 once a scene of its share); "
        + ", ".join(f"{k} {two['metrics'][k]:.6f}" for k in keys)
        + f"; equal to world 1's dict: {two['metrics'] == world1} (child "
        f"wall {wall:.1f} s, world 1 in process {wall1:.1f} s)")
    out["test_metrics_equal"] = two["metrics"] == world1
    out["_test_args"], out["_world1"] = args, world1  # phase 14.3's
    if two["metrics"] != world1 or two["launches"] != [len(infos), 0, 0,
                                                       0]:
        raise SystemExit("13.3: the sharded test CLI's metrics are not "
                         "world 1's")

    # ---- 13.2 the step over ranks ----
    backends = [("gloo", "two ranks on this card over gloo (CUDA tensors)")]
    if torch.cuda.device_count() > 1:
        backends.append(("nccl", "two ranks over NCCL, a card a rank"))
    for backend, what in backends:
        port = free_port()
        base = os.path.join(tmp, f"ddp_step_{backend}")
        extra = ["--gloo-on-one-card"] if backend == "gloo" else []
        t0 = time.perf_counter()
        run_children([([py, launcher, "step", base] + extra, dict(
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
            MASTER_ADDR="localhost", MASTER_PORT=str(port)))
            for r in (0, 1)], tmp)
        wall = time.perf_counter() - t0
        ranks = [torch.load(f"{base}.rank{r}.pt") for r in (0, 1)]
        loss_rel = max(abs(r["metrics"][k] - v) / max(abs(v), 1e-30)
                       for r in ranks for k, v in one.items())
        stats = [k for k in want if k.endswith(("running_mean",
                                                "running_var"))]
        s_err = max(float((r["state"][k] - want[k]).abs().max()) / max(
            float(want[k].abs().max()), 1e-30) for r in ranks for k in stats)
        # the parameters: within 1e-6 of the tensor's max where the
        # gradient is signal (|g| >= 1e-3 of its tensor's max); elsewhere
        # within 2 lr mult + 1e-6, AdamW's first step being ~lr sign(g),
        # and the sign of a gradient at its rounding noise noise
        p_err, p_noise, beyond = 0.0, 0.0, 0
        for r in ranks:
            for n, g in grads.items():
                d = (r["state"][n].double() - want[n].double()).abs()
                top = max(float(want[n].abs().max()), 1e-30)
                strong = g.abs() >= 1e-3 * float(g.abs().max())
                if bool(strong.any()):
                    p_err = max(p_err, float(d[strong].max()) / top)
                p_noise = max(p_noise, (float(d.max()) - 1e-6)
                              / (2 * rate[n]))
                beyond += int((d > 1e-6 * top).sum())
        n_elems = sum(g.numel() for g in grads.values())
        same = all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k])
                   for k in want)
        total_ms, grad_ms, n_grads, grad_bytes = reduce_ms(ranks[0])
        log(f"[ddp] 13.2 {what} ({ranks[0]['backend']}, "
            f"{[r['device'] for r in ranks]}), one scene a rank: loss terms "
            f"and grad_norm max rel diff {loss_rel:.3e} (tol 1e-5); "
            f"parameters where the gradient is signal: max diff / tensor "
            f"max {p_err:.3e} (tol 1e-6), elsewhere max diff {p_noise:.3e} "
            f"x 2 lr mult (+1e-6; tol 1); {beyond} of 2 x {n_elems} "
            f"elements beyond 1e-6 of their tensor's max; running "
            f"statistics {s_err:.3e} (tol 1e-6); the ranks' parameters "
            f"bitwise equal: {same}; launches a step "
            f"{ranks[0]['per_step']}")
        log(f"[ddp] 13.2 {what}: {ranks[0]['step_s'] * 1e3:.2f} ms a step "
            f"(mean of {DDP_TIMED} after the compared one, host clock), "
            f"all-reduces {total_ms:.3f} ms a step, the gradients' "
            f"{grad_ms:.3f} ms ({n_grads} tensors, {grad_bytes} bytes); "
            f"child wall {wall:.1f} s; measured on {card}")
        if (loss_rel > 1e-5 or p_err > 1e-6 or p_noise > 1 or s_err > 1e-6
                or not same or ranks[0]["per_step"][0] != [1, 1, 1, 1]):
            raise SystemExit(f"13.2 {what}: the step over ranks is not "
                             f"the one-process step")
        out[f"{backend}_step_ms"] = ranks[0]["step_s"] * 1e3
        out[f"{backend}_allreduce_ms"] = total_ms
        out[f"{backend}_grad_allreduce_ms"] = grad_ms
        out[f"{backend}_max_rel"] = max(loss_rel, p_err, s_err)
        out[f"{backend}_elements_beyond_1e-6"] = beyond
    if torch.cuda.device_count() < 2:
        log(f"[ddp] NCCL at world > 1 was not run on this machine "
            f"({torch.cuda.device_count()} card)")

    log(f"[ddp] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 14: the 2-D data x views sharding, two gloo ranks on this card
MESH_VIEWS = 2  # ranks a scene (--mesh-views)
MESH_TIMED = 1  # 14.1's and 14.2's timed calls after the compared one
MESH_EVAL_VIEWS = 50  # 14.2's R101* views, 25 a rank (100 before)


def mesh_child(mode, out, api, counters, per_step, counted):
    """A rank of phase 14 (``ddp_child``'s process group of two gloo
    ranks on this card, one views group): ``step2d`` takes phase 8's joint
    step at ``--mesh-views 2`` on the scene in OUT.scene.npz (host ray
    stream included) and times ``MESH_TIMED`` more; ``eval2d`` runs R101*'s
    ``eval_step`` with the views of the scene in OUT.scene.npz sharded, and
    times ``MESH_TIMED`` more. Each rank writes OUT.rank<r>.pt: the
    metrics or the candidates, the launches of ``counters`` (a step's, or
    the first eval's), the reductions, the seconds a call and, after the
    steps, the SHA-256 of its parameters."""
    import hashlib

    import numpy as np
    import torch

    from nerfdet_tpu_torch.config import Config
    from nerfdet_tpu_torch.parallel import dist as pdist

    with np.load(f"{out}.scene.npz") as f:
        scene = {k: f[k] for k in f}
    with pdist.process_group("cuda") as (dev, group):
        rank = pdist.rank(group)
        if mode == "step2d":
            tr = api.init_trainer(CONFIG, device=dev, seed=SEED,
                                  steps_per_epoch=1000, process_group=group,
                                  mesh_views=MESH_VIEWS)
            batch = api.train_batch(tr.model, [scene],
                                    view_group=tr.view_group)
            first = tr.step(batch)
            call = lambda: tr.step(batch)  # noqa: E731
            rec = dict(metrics={k: float(v) for k, v in first.items()})
        else:
            views, _ = pdist.mesh_groups(MESH_VIEWS, group)
            model = api.init_detector(DEPTH_CONFIG, device=dev, seed=SEED)
            nms_pre = Config.fromfile(DEPTH_CONFIG).test_cfg["nms_pre"]
            for fn in counters:
                fn.launches = 0
            batch = api.device_batch(model, scene, view_group=views)
            got = api.eval_step(model, batch, nms_pre, view_group=views)
            per_step.append([fn.launches for fn in counters])
            call = lambda: api.eval_step(  # noqa: E731
                model, batch, nms_pre, view_group=views)
            with torch.inference_mode():
                heads, valid, _ = model(batch, view_group=views)
            rec = dict(scores=got["scores"].cpu(), valid=valid.cpu(),
                       heads=[t.cpu() for level in heads for t in level])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(MESH_TIMED):
            call()
        torch.cuda.synchronize()
        rec["call_s"] = (time.perf_counter() - t0) / MESH_TIMED
        if mode == "step2d":
            h = hashlib.sha256()
            for v in tr.model.state_dict().values():
                h.update(v.cpu().numpy().tobytes())
            rec["state_sha256"] = h.hexdigest()
        rec.update(device=str(dev), world=pdist.world(group))
        torch.save(dict(counted(), **rec), f"{out}.rank{rank}.pt")


def k2_sums_bound(pts, feats, images=None):
    """Least time of K2's sums form: bytes (points, projections, feature
    maps and, in the eval form, the images read once; the three sums of
    3 + C channels and the count, or of the C feature channels, written
    once) over HBM rate against the operations of ``ray_bound``'s (eval
    form) or ``k2_train_bound``'s (training form) carry, without the
    epilogue."""
    n = pts.numel() // 3
    v, c = feats.shape[0], feats.shape[-1]
    cso = c + (3 if images is not None else 0)
    nbytes = ((pts.numel() + v * 16 + n * 3 * cso
               + (n if images is not None else 0)) * 4
              + feats.numel() * feats.element_size()
              + (images.numel() * images.element_size()
                 if images is not None else 0))
    per_pair = (20 + 2 * 14 + 12 * cso + 1 if images is not None
                else 20 + 14 + 12 * c)
    ops = n * v * per_pair
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations", nbytes, ops)


def check_k2_sums(render, pts, images, proj, img_hw, feats):
    """K2's sums form (a rank's views of a sharded scene) against its plain
    version in both forms, bit for bit, with its time, the plain version's
    and its bound. Returns {form: record}."""
    import torch

    out = {}
    for form, host in (("training", True), ("eval", False)):
        args = (pts, images, proj, img_hw, feats, host)
        got = render.streaming_sample_sums(*args)
        want = render.streaming_sample_sums_plain(*args)
        torch.cuda.synchronize()
        pairs = [(a, b) for a, b in zip(got, want) if b is not None]
        err = max(float((a - b).abs().max()) for a, b in pairs)
        bitwise = all(torch.equal(a, b) for a, b in pairs)
        ms = cuda_time_ms(lambda: render.streaming_sample_sums(*args), 10)
        plain_ms = cuda_time_ms(
            lambda: render.streaming_sample_sums_plain(*args), 2, warmup=1)
        bound_ms, bound_by, nbytes, ops = k2_sums_bound(
            pts, feats, None if host else images)
        log(f"[kernel] streaming_sample_mean_var sums form, {form}: "
            f"V={feats.shape[0]} (this rank's half) N={pts.numel() // 3} "
            f"C={feats.shape[-1]} {str(feats.dtype)[6:]}: s1u, s2u, s1m"
            f"{', cnt' if not host else ''} max_abs_err={err:.3e} (tol: "
            f"bitwise); bitwise equal {bitwise} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}; "
            f"{nbytes} B, {ops} FLOP)")
        if not bitwise:
            raise SystemExit(f"K2's sums form ({form}) is not bitwise equal "
                             f"to its plain version")
        out[form] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=None)
    return out


def mesh_path(api, render, ray_stats, card, tmp, ddp):
    """Phase 14: the 2-D data x views sharding (``--mesh-views 2``) on two
    gloo ranks of this card (NCCL refuses two ranks on one device), one
    views group. 14.0: K2's sums form at the rank's half of phase 8's
    batch, against its plain version; 14.1: phase 8's joint step at
    ``--mesh-views 2`` against one process (loss terms 1e-4 relative,
    grad_norm 1e-3, the ranks' parameters bitwise equal; K1, K1's
    backward, K2's sums form and K2's backward once a step on each rank;
    the step's ms and the all-reduces'); 14.2: R101*'s ``eval_step`` at
    ``MESH_EVAL_VIEWS`` views with the views sharded (the depth gate and the rgb stream
    on each rank's half) against one process (head outputs and the
    candidates' sorted scores 1e-4 of their max, view counts exact);
    14.3: ``tools/test --distributed --mesh-views 2`` on phase 13.3's
    files against its world 1 metrics. Returns the numbers of the
    record."""
    import numpy as np
    import torch

    from nerfdet_tpu_torch.config import Config

    t_phase = time.perf_counter()
    launcher = os.path.join(tmp, "ddp_launcher.py")
    py = sys.executable
    out = {}
    names = ("fused_mean_cov", "fused_mean_cov_backward",
             "streaming_sample_mean_var",
             "streaming_sample_mean_var_backward",
             "streaming_sample_mean_var_sums", "fused_mean_cov_rgb")

    def ranks_of(mode, base):
        port = free_port()
        t0 = time.perf_counter()
        run_children([([py, launcher, mode, base, "--gloo-on-one-card"],
                       dict(RANK=str(r), LOCAL_RANK=str(r),
                            WORLD_SIZE=str(MESH_VIEWS),
                            MASTER_ADDR="localhost", MASTER_PORT=str(port)))
                      for r in range(MESH_VIEWS)], tmp)
        wall = time.perf_counter() - t0
        return [torch.load(f"{base}.rank{r}.pt") for r in range(
            MESH_VIEWS)], wall

    # ---- 14.0 K2's sums form at a rank's half of phase 8's batch ----
    torch.cuda.empty_cache()
    model = api.init_detector(CONFIG, device="cuda", seed=SEED)
    scene, _ = host_ray_stream(ray_stats, model, train_scene(model,
                                                             SEED + 1))
    half = N_VIEWS // MESH_VIEWS
    h, w = model.meta.img_shape
    with torch.no_grad():
        feats = model.render_featmaps(model.extract_2d(torch.as_tensor(
            scene["imgs"][:half], device="cuda")))
    ray = {k: torch.as_tensor(scene[k], device="cuda")
           for k in ("ray_o", "ray_d", "z_vals")}
    pts = render.points_at(ray["ray_o"], ray["ray_d"], ray["z_vals"])
    proj = model.render_projection(scene["intrinsic"],
                                   scene["extrinsics"][:half], "cuda")
    images = torch.as_tensor(scene["denorm_images"][:half], device="cuda")
    out["sums"] = check_k2_sums(render, pts, images, proj, (h, w), feats)
    del model, feats, pts, proj, images, ray
    torch.cuda.empty_cache()

    # ---- 14.1 the joint step at --mesh-views 2 against one process ----
    base = os.path.join(tmp, "mesh_step")
    np.savez(f"{base}.scene.npz", **scene)
    torch.backends.cudnn.deterministic = True
    try:
        tr = api.init_trainer(CONFIG, device="cuda", seed=SEED,
                              steps_per_epoch=1000)
        one = {k: float(v) for k, v in tr.step(api.train_batch(
            tr.model, [scene])).items()}
        del tr
    finally:
        torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()
    ranks, wall = ranks_of("step2d", base)
    rels = {k: max(abs(r["metrics"][k] - v) / max(abs(v), 1e-30)
                   for r in ranks) for k, v in one.items()}
    rel = max(v for k, v in rels.items() if k != "grad_norm")
    same = len({r["state_sha256"] for r in ranks}) == 1
    means_ms, _, _, _ = reduce_ms(ranks[0])
    sums_ms = sum(ms for s_, _, _, ms in ranks[0]["sum_reduces"]
                  if s_ > 0) / MESH_TIMED  # the steps after the first
    total_ms = means_ms + sums_ms
    per_step = ranks[0]["per_step"]
    log(f"[mesh] 14.1 the joint step at --mesh-views {MESH_VIEWS}, two ranks "
        f"on this card over gloo (CUDA tensors), {half} of {N_VIEWS} views "
        f"and 1024 of 2048 rays a rank, against one process: rel diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
        + f" (tol: the loss terms 1e-4, grad_norm 1e-3); the ranks' "
        f"parameters bitwise equal: {same}; launches a step {per_step} "
        f"({', '.join(names)})")
    log(f"[mesh] 14.1 {ranks[0]['call_s'] * 1e3:.2f} ms a step (mean of "
        f"{MESH_TIMED} after the compared one, host clock), all-reduces "
        f"{total_ms:.3f} ms a step, of them the view sums' (forward and "
        f"backward: K1's, K2's, the NVS loss's) {sums_ms:.3f} ms; "
        f"child wall {wall:.1f} s; measured on {card}")
    if (rel > 1e-4 or rels["grad_norm"] > 1e-3 or not same
            or per_step != [[1, 1, 0, 1, 1, 0]] * (1 + MESH_TIMED)):
        raise SystemExit("14.1: the step at --mesh-views 2 is not the "
                         "one-process step")
    out.update(step_ms=ranks[0]["call_s"] * 1e3, allreduce_ms=total_ms,
               view_sums_ms=sums_ms, step_max_rel=rel,
               grad_norm_rel=rels["grad_norm"],
               launches=dict(zip(names, map(sum, zip(*per_step)))))

    # ---- 14.2 R101*'s eval_step at 100 views, the views sharded ----
    model = api.init_detector(DEPTH_CONFIG, device="cuda", seed=SEED)
    dscene = depth_scene(model, SEED + 3, MESH_EVAL_VIEWS)
    base = os.path.join(tmp, "mesh_eval")
    np.savez(f"{base}.scene.npz", **dscene)
    nms_pre = Config.fromfile(DEPTH_CONFIG).test_cfg["nms_pre"]
    batch = api.device_batch(model, dscene)
    want = api.eval_step(model, batch, nms_pre)
    with torch.inference_mode():
        heads, valid, _ = model(batch)
    want_heads = [t.cpu() for level in heads for t in level]
    del model, batch, heads
    torch.cuda.empty_cache()
    ranks, wall = ranks_of("eval2d", base)

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    # the head's outputs (as phase 4 compares them) and the candidates'
    # scores in descending order: the random weights' near-equal scores
    # take their top-k in an order a rounding can swap
    head_err = max(rel(a, b) for r in ranks
                   for a, b in zip(r["heads"], want_heads))
    score_err = max(rel(r["scores"].max(-1).values.sort().values,
                        want["scores"].cpu().max(-1).values.sort().values)
                    for r in ranks)
    same_valid = all(torch.equal(r["valid"], valid.cpu()) for r in ranks)
    err = max(head_err, score_err)
    log(f"[mesh] 14.2 R101* eval_step at {MESH_EVAL_VIEWS} views (depth "
        f"gate, rgb stream on the card), {MESH_EVAL_VIEWS // MESH_VIEWS} a "
        f"rank, "
        f"against one process: head outputs max diff {head_err:.3e} of "
        f"their max, candidates' sorted scores {score_err:.3e} (tol 1e-4); "
        f"view counts equal {same_valid}; rank 0's launches "
        f"{ranks[0]['per_step'][0]}; {ranks[0]['call_s'] * 1e3:.2f} ms a "
        f"scene (mean of {MESH_TIMED}, host clock); child wall {wall:.1f} "
        f"s; measured on {card}")
    if (err > 1e-4 or not same_valid
            or ranks[0]["per_step"][0] != [1, 0, 0, 0, 0, 1]):
        raise SystemExit("14.2: the views-sharded eval is not one "
                         "process's")
    out.update(eval_ms=ranks[0]["call_s"] * 1e3, eval_max_rel=err)

    # ---- 14.3 tools/test --mesh-views 2 against world 1 ----
    path = os.path.join(tmp, "mesh_test.json")
    args = ddp["_test_args"]
    torchrun = [py, "-m", "torch.distributed.run", "--standalone"]
    t0 = time.perf_counter()
    run_children([(torchrun + ["--nproc_per_node", str(MESH_VIEWS),
                               launcher, "test", path, "--gloo-on-one-card",
                               args[0], args[1], "--distributed",
                               "--mesh-views", str(MESH_VIEWS)] + args[2:],
                   {})], tmp)
    wall = time.perf_counter() - t0
    with open(path) as f:
        two = json.load(f)
    world1 = ddp["_world1"]
    keys = sorted(k for k in world1 if k.startswith(("mAP", "mAR")))
    diff = max(abs(two["metrics"][k] - world1[k]) for k in keys)
    log(f"[mesh] 14.3 tools/test --distributed --mesh-views {MESH_VIEWS}, two "
        f"ranks on this card over gloo, phase 13.3's two val scenes at 100 "
        f"source views: rank 0's launches {two['launches']} (K1 once a "
        f"scene); " + ", ".join(f"{k} {two['metrics'][k]:.6f}" for k in keys)
        + f"; against world 1: max diff {diff:.3e} (tol 1e-6), equal "
        f"{two['metrics'] == world1}; child wall {wall:.1f} s")
    if diff > 1e-6 or two["launches"][0] != 2:
        raise SystemExit("14.3: tools/test --mesh-views is not world 1")
    out["test_metrics_max_diff"] = diff
    log(f"[mesh] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 15: tools/benchmark on the R50 flagship
BENCH_RUNS = (("detection f32", ["--f32"]), ("detection bf16", []),
              ("nvs bf16", ["--nvs"]), ("train bf16", ["--train"]))


def bench_path(card):
    """Phase 15: ``python -m nerfdet_tpu_torch.tools.benchmark`` (its
    ``main``) on the flagship at its defaults (50 views, 5 warm-up and 30
    timed iterations): detection in float32 and bfloat16, ``--nvs``
    (16,384 rays), ``--train`` (bfloat16); then detection
    again with the synthetic intrinsic scaled from the view to
    ``ori_shape`` (ROADMAP §3's open question), with the tool's own
    functions. Returns the numbers."""
    import torch

    from nerfdet_tpu_torch import api
    from nerfdet_tpu_torch.config import Config
    from nerfdet_tpu_torch.tools import benchmark

    t_phase = time.perf_counter()
    out = {}
    for tag, extra in BENCH_RUNS:
        torch.cuda.empty_cache()
        out[tag] = benchmark.main([CONFIG] + extra)
        log(f"[bench] {tag}: {json.dumps(out[tag])}")
    cfg = Config.fromfile(CONFIG)
    meta = api.scene_meta_from_config(cfg)
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        model = api.init_detector(cfg, device=dev, seed=0,
                                  compute_dtype=dtype)
        scene = benchmark.synthetic_scene(meta, 50, 64)
        scene["intrinsic"] = scene["intrinsic"].copy()
        scene["intrinsic"][:2] *= meta.ori_shape[0] / meta.img_shape[0]
        batch = benchmark.detection_batch(model, scene)
        fn = benchmark.detection_fn(model, cfg.test_cfg["nms_pre"])
        batches = [dict(batch, origin=o)
                   for o in benchmark.moved_origins(scene["origin"], 35)]
        benchmark.time_calls(fn, [batch] + batches[:5], dev)
        dt = benchmark.time_calls(fn, batches[5:], dev)
        short = "f32" if dtype == torch.float32 else "bf16"
        tag = f"detection {short} intrinsic scaled"
        out[tag] = dict(scenes_per_s=30 / dt, ms_per_scene=dt / 30 * 1e3)
        log(f"[bench] {tag}: {30 / dt:.3f} scenes/sec ({dt / 30 * 1e3:.1f} "
            f"ms/scene, V=50; the tool's scene, unscaled, "
            f"{out['detection ' + short]['scenes_per_s']:.3f}) measured on "
            f"{card}")
        del model
    log(f"[bench] phase 15 in {time.perf_counter() - t_phase:.1f} s")
    return out


# phase 16: the fast_cov family (NeRF-Det configs typed ImVoxelNet)
FC = "configs/imvoxelnet/imvoxelnet_scannet_fast_cov_w_mean_volume"
FC_EXEMPLAR = FC + "_renderrgb_image_mode_1028_rgb_depthtest.py"
FC_SQUEEZE8 = FC + "_renderrgb_image.py"
FC_NO_DEPTH = FC + "_renderrgb_image_mode_114_resnet50_onlyrgb.py"
FC_SWIN = (FC + "_renderrgb_image_mode_1028_rgb_depthtest_swin_2xlonger_"
           "largervoxel.py")
FC_LARGEST = FC + "_1.py"
FC_VOLUME = FC + "_renderrgb_volume_mode.py"
FC_VIEWS = 51  # the family's test views
FC_NVS_CHUNK = 2048
FC_CLI_STEPS = 2
FC_CLI_VIEWS = 60  # views of each written scene (train: 30 + 10 targets)
FC_NAMES = ("fused_mean_cov", "fused_mean_cov_backward", "fused_mean_cov_rgb",
            "streaming_sample_mean_var", "streaming_sample_mean_var_backward")


def family_config(path, options=None):
    """A family config, with ``options`` merged (the config's own keys
    otherwise)."""
    from nerfdet_tpu_torch.config import Config

    cfg = Config.fromfile(path)
    if options:
        cfg.merge_from_options(options)
    return cfg


def family_views(cfg, which):
    """The MultiViewPipeline's ``n_images`` of the config's ``which``
    split."""
    node = cfg.data[which]
    while "dataset" in node:
        node = node["dataset"]
    return [t for t in node["pipeline"]
            if t["type"] == "MultiViewPipeline"][0]["n_images"]


def first_views(scene, n, depth=True):
    """The scene's first ``n`` source views (the same target rays), with
    or without its depth maps."""
    out = dict(scene, **{k: scene[k][:n] for k in (
        "imgs", "denorm_images", "extrinsics", "depth") if k in scene})
    if not depth:
        out.pop("depth", None)
    return out


def family_pix(voxel, model, scene, dev, gated):
    """K1's and the rgb stream's pixel indices as ``build_volume``
    computes them for ``scene``: the features' at the stride-4 maps, the
    rgb stream's at the images, gated by the scene's depth where
    ``gated``."""
    import torch

    meta = model.meta
    h, w = meta.img_shape
    points = voxel.get_points(model.n_voxels, model.voxel_size,
                              scene["origin"], dev).reshape(-1, 3)
    out = {}
    for name, ratio, (bh, bw), width in (
            ("features", meta.ori_shape[0] / (h / 4), (h // 4, w // 4),
             meta.pad_shape[1] // 4),
            ("rgb", meta.ori_shape[0] / h, (h, w), meta.pad_shape[1])):
        proj = voxel.compute_projection(scene["intrinsic"],
                                        scene["extrinsics"], ratio, dev)
        x, y, z, valid = voxel.project_points(points, proj, bh, bw)
        if gated:
            valid = voxel.depth_gate(
                z, x, y, valid, torch.as_tensor(scene["depth"], device=dev),
                bh, bw, model.voxel_size[-1])
        out[name] = voxel.pixel_index(x, y, valid, width).contiguous()
    return out


def family_scene(model, seed, n_views):
    """``depth_scene`` of the model's geometry, and its target view as an
    ``nvs_dataset`` (the intrinsic taken back to the rendered size)."""
    import numpy as np

    scene = depth_scene(model, seed, n_views)
    h, w = model.meta.img_shape
    k_img = scene["intrinsic"].copy()
    k_img[:2] /= np.float32(model.meta.ori_shape[0] / h)
    return scene, nvs_dataset(scene, k_img, (h, w))


def family_step_grads(voxel, render, model, batch, start, plain):
    """Loss and gradients of one train-step forward + backward (no
    update) of ``batch`` from the state ``start``, the depths jittered
    from a generator seeded the same each call; with ``plain`` through
    the plain versions of K1, the rgb stream and K2 (autograd through
    them)."""
    import torch

    from nerfdet_tpu_torch.train.step import (reduce_loss_terms,
                                              scene_loss_terms)

    saved = voxel.fusion_carry, voxel.rgb_carry, \
        render.streaming_sample_mean_var
    if plain:
        voxel.fusion_carry = voxel.fusion_carry_plain
        voxel.rgb_carry = voxel.rgb_carry_plain
        render.streaming_sample_mean_var = \
            render.streaming_sample_mean_var_plain
    fpn_out = []

    def keep(module, args, out):
        out[0].retain_grad()
        fpn_out.append(out[0])

    hook = model.neck.register_forward_hook(keep)
    try:
        model.load_state_dict(start)
        model.zero_grad()
        gen = torch.Generator(next(model.parameters()).device)
        gen.manual_seed(SEED)
        loss, metrics = reduce_loss_terms([scene_loss_terms(
            model, b, depth_supervise=True, generator=gen) for b in batch])
        loss.backward()
    finally:
        hook.remove()
        voxel.fusion_carry, voxel.rgb_carry, \
            render.streaming_sample_mean_var = saved
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(loss.detach()), metrics, grads, fpn_out[0].grad.clone()


def fast_cov_path(api, voxel, render, card):
    """Phase 16: the fast_cov family (``configs/imvoxelnet/*fast_cov*``,
    NeRF-Det typed ImVoxelNet, its data path without host streams) at full
    width, 480x640 scenes with depth maps, random weights from ``SEED``.
    16.0 the kernels at the family's shapes against their plain versions;
    16.1 the exemplar (R50, cov_w_mean, density, depth): eval_step at 51
    views, the joint Trainer.step at 30 views, one step kernels vs plain;
    16.2 squeeze 8 (M = 16); 16.3 no depth (the ungated rgb stream); 16.4
    Swin-T; 16.5 the 64x64x12 volume; 16.6 volume mode (nerf_density
    off); 16.7 tools/train then tools/test on files. Returns the record's
    numbers."""
    import math
    import tempfile

    import numpy as np
    import torch

    from nerfdet_tpu_torch.data import ray_stats
    from nerfdet_tpu_torch.data.synthetic import write_synthetic_scannet
    from nerfdet_tpu_torch.nn.heads import get_candidate_bboxes
    from nerfdet_tpu_torch.tools import test as test_cli
    from nerfdet_tpu_torch.tools import train as train_cli

    t_phase = time.perf_counter()
    dev = api.resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    f32, bf16 = torch.float32, torch.bfloat16
    counters = (voxel.fusion_carry, voxel.fusion_carry_backward,
                voxel.rgb_carry, render.streaming_sample_mean_var,
                render.streaming_sample_mean_var_backward)

    def zero():
        for fn in counters:
            fn.launches = 0

    def counts():
        return [fn.launches for fn in counters]

    def named(launches):
        return ", ".join(f"{n} {c}" for n, c in zip(FC_NAMES, launches))

    def expect(launches, want, what):
        if launches != want:
            raise SystemExit(f"phase 16 {what} launched {named(launches)}; "
                             f"expected {named(want)}")

    def finite_candidates(res, what):
        if not (torch.isfinite(res["boxes"]).all()
                and torch.isfinite(res["scores"]).all()):
            raise SystemExit(f"phase 16 {what}: non-finite candidates")

    def finite_metrics(metrics, what, need=("loss_nvs",)):
        m = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in m.values()) or not all(
                m.get(k, 0.0) > 0 for k in need):
            raise SystemExit(f"phase 16 {what}: metrics {m}")
        return m

    # ---- the exemplar and the family's scene ----
    t0 = time.perf_counter()
    cfg = family_config(FC_EXEMPLAR)
    model = api.init_detector(cfg, device="cuda", seed=SEED)
    meta = model.meta
    h, w = meta.img_shape
    scene, nvs = family_scene(model, SEED + 16, FC_VIEWS)
    n_train = family_views(cfg, "train")
    log(f"[fast_cov] {FC_EXEMPLAR}: type {cfg.model['type']} -> NeRF-Det, "
        f"volume_type {model.volume_type}, nerf_density "
        f"{model.nerf_density}, host streams {model.host_streams}, volume "
        f"{model.n_voxels} at {model.voxel_size}, "
        f"{sum(p.numel() for p in model.parameters())} parameters; scene "
        f"{FC_VIEWS} views {meta.img_shape} padded {meta.pad_shape} with "
        f"depth maps, train {n_train} of them: "
        f"{time.perf_counter() - t0:.1f} s")
    if model.host_streams or model.volume_type != "cov_w_mean" \
            or not model.nerf_density:
        raise SystemExit("the exemplar did not build as the family's graph")

    # ---- 16.0 the kernels at the family's shapes ----
    hw = (meta.pad_shape[0] // 4, meta.pad_shape[1] // 4)
    gated = family_pix(voxel, model, scene, dev, True)
    ungated = family_pix(voxel, model, scene, dev, False)
    size = f"{FC_VIEWS} views of {meta.pad_shape[0]}x{meta.pad_shape[1]}"
    k1 = check_fusion(voxel, [
        (f"float32 mapped, {size}, depth-gated", gated["features"], f32,
         True),
        (f"bfloat16 mapped, {size}, depth-gated", gated["features"], bf16,
         True)], hw, gen)
    k1_m16 = check_fusion(voxel, [
        (f"float32 mapped M=16, {size}, ungated", ungated["features"], f32,
         True),
        (f"bfloat16 mapped M=16, {size}, ungated", ungated["features"],
         bf16, True)], hw, gen, m=16)
    images = torch.as_tensor(scene["denorm_images"], device=dev)
    rgb = check_rgb(voxel, images, ungated["rgb"], f"ungated, {size}")
    rgb_gated = check_rgb(voxel, images, gated["rgb"],
                          f"depth-gated, {size}")
    del images, gated, ungated
    pix_train = family_pix(voxel, model, first_views(scene, n_train), dev,
                           True)["features"]
    k1_bwd = check_fusion_backward(
        voxel, pix_train, hw, gen,
        f"the exemplar's training pix ({n_train} views, depth-gated)",
        with_g2=True)
    del pix_train
    # K2's eval form under grad at C = 16: squeeze 8's views and rays
    cfg8 = family_config(FC_SQUEEZE8)
    n8, r8 = family_views(cfg8, "train"), cfg8.model["N_rand"]
    c8 = (cfg8.model["neck"]["out_channels"]
          // cfg8.model["squeeze_scale"] // 2)
    sc8 = first_views(scene, n8)
    drawn = ray_stats.draw_rays(sc8, np.random.RandomState(SEED), r8)
    ro, rd = (torch.as_tensor(drawn[k], device=dev)
              for k in ("ray_o", "ray_d"))
    pts, _ = render.sample_along_camera_ray(
        ro, rd, *cfg8.model["near_far_range"], cfg8.model["N_samples"],
        det=False, generator=gen)
    feats8 = torch.randn((n8, h // 4, w // 4, c8), generator=gen,
                         device=dev)
    k2, k2_bwd = check_k2_training(
        render, pts, model.render_projection(sc8["intrinsic"],
                                             sc8["extrinsics"], dev),
        (h, w), feats8, None, gen,
        images=torch.as_tensor(sc8["denorm_images"], device=dev))
    del pts, feats8, ro, rd, drawn

    # ---- 16.1 the exemplar: eval_step at 51 views ----
    nms_pre, iou_thr = cfg.test_cfg["nms_pre"], cfg.test_cfg["iou_thr"]
    batch = api.device_batch(model, scene)
    if "rgb_s1" in batch or "denorm_images" not in batch:
        raise SystemExit("the family must sum its rgb stream on the device")
    zero()
    res = api.eval_step(model, batch, nms_pre)
    det = api.detections_from_candidates(
        res["boxes"].float().cpu().numpy(),
        res["scores"].float().cpu().numpy(), SCORE_THR, iou_thr)
    eval_launches = counts()
    log(f"[fast_cov] 16.1 eval_step at {FC_VIEWS} views -> "
        f"{tuple(res['boxes'].shape)} candidates, NMS kept "
        f"{len(det['labels_3d'])}; launches {named(eval_launches)}")
    expect(eval_launches, [1, 0, 1, 0, 0], "16.1 eval_step")
    finite_candidates(res, "16.1 eval_step")
    with torch.inference_mode():
        head_k, valid_k, _ = model(batch)
        saved = voxel.fusion_carry, voxel.rgb_carry
        voxel.fusion_carry = voxel.fusion_carry_plain
        voxel.rgb_carry = voxel.rgb_carry_plain
        try:
            head_p, valid_p, _ = model(batch)
        finally:
            voxel.fusion_carry, voxel.rgb_carry = saved
    diff = max(float((a - b).abs().max()) for hk, hp in zip(head_k, head_p)
               for a, b in zip(hk, hp))
    scale = max(float(b.abs().max()) for hp in head_p for b in hp)
    log(f"[fast_cov] 16.1 kernels vs plain (K1, the rgb stream) through the "
        f"whole graph: view counts equal {torch.equal(valid_k, valid_p)}, "
        f"head outputs max |diff| {diff:.3e} (max |out| {scale:.3e}, tol "
        f"1e-4 relative); third scale {tuple(head_k[-1][0].shape[:3])}")
    if not torch.equal(valid_k, valid_p) or diff > 1e-4 * max(scale, 1.0):
        raise SystemExit("kernel and plain family graphs disagree")
    del head_k, head_p
    with torch.inference_mode():
        feats = model.extract_2d(batch["imgs"])
        vol_args = (feats, batch["intrinsic"], batch["extrinsics"],
                    batch["origin"])
        vol_kw = dict(denorm_images=batch["denorm_images"],
                      depth=batch["depth"])
        vol = model.build_volume(*vol_args, **vol_kw)
        heads = model.detect(vol["det_volume"])
        mlvl = model.mlvl_points(batch["origin"])
        stages = {}
        for name, fn in {
                "extract_2d (ResNet-50 + FPN)": lambda: model.extract_2d(
                    batch["imgs"]),
                "build_volume (gate, K1, rgb stream, density, cov_w_mean)":
                    lambda: model.build_volume(*vol_args, **vol_kw),
                "detect (3D neck + head)": lambda: model.detect(
                    vol["det_volume"]),
                "get_candidate_bboxes": lambda: get_candidate_bboxes(
                    heads, vol["valid"], mlvl, nms_pre, model.n_classes),
        }.items():
            stages[name] = cuda_time_ms(fn, 3, warmup=1)
            log(f"[stage] fast_cov exemplar {FC_VIEWS} views {name}: "
                f"{stages[name]:.3f} ms")
    del feats, vol, heads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        res = api.eval_step(model, batch, nms_pre)
        api.detections_from_candidates(
            res["boxes"].float().cpu().numpy(),
            res["scores"].float().cpu().numpy(), cfg.test_cfg["score_thr"],
            iou_thr)
    dt = (time.perf_counter() - t0) / iters
    eval_rate = 1 / dt
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[fast_cov] 16.1 inference: {eval_rate:.3f} scenes/s "
        f"({dt * 1e3:.2f} ms a scene: eval_step + host NMS at {FC_VIEWS} "
        f"views with depth), peak memory {eval_peak:.2f} GiB; measured on "
        f"{card}")
    del model, batch, res
    torch.cuda.empty_cache()

    # ---- 16.1 the exemplar: the joint train step at 30 views ----
    t0 = time.perf_counter()
    tr = api.init_trainer(cfg, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    tbatch = api.train_batch(tr.model, [first_views(scene, n_train)],
                             rng=np.random.RandomState(SEED))
    if any(k in tbatch[0] for k in ("rgb_s1", "ray_s1u", "z_vals")):
        raise SystemExit("the family's train batch carries host streams")
    log(f"[fast_cov] 16.1 init_trainer, {n_train} views and "
        f"{tr.model.n_rand} rays drawn (no host stream: depths jittered "
        f"on the device): {time.perf_counter() - t0:.1f} s")
    start = {k: v.clone() for k, v in tr.model.state_dict().items()}
    loss_k, _, grads_k, fpn_k = family_step_grads(
        voxel, render, tr.model, tbatch, start, False)
    loss_p, _, grads_p, fpn_p = family_step_grads(
        voxel, render, tr.model, tbatch, start, True)
    tr.model.load_state_dict(start)
    tr.optimizer.zero_grad()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = {n: float((grads_k[n] - grads_p[n]).norm())
                / max(float(grads_p[n].norm()), 1e-30) for n in (
                    "mapping.0.weight", "mapping.0.bias",
                    "nerf_mlp.mlp.rgb_layer.output_layer.weight",
                    "neck.lateral_convs.0.conv.weight")}
    fpn_rel = float((fpn_k - fpn_p).norm() / fpn_p.norm())
    log(f"[fast_cov] 16.1 kernels vs plain (K1 and its backward, the rgb "
        f"stream, K2's eval form and its backward) for one step: loss "
        f"{loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}, tol 1e-5); "
        f"gradients rel norm " + ", ".join(f"{n} {v:.3e}" for n, v in
                                           grad_rel.items())
        + f"; FPN output {fpn_rel:.3e} (tol 1e-4)")
    if loss_rel > 1e-5 or fpn_rel > 1e-4 or max(grad_rel.values()) > 1e-4:
        raise SystemExit("kernel and plain family train steps disagree")
    del grads_k, grads_p, fpn_k, fpn_p, start
    hist, dt, train_launches, peak = timed_steps(tr, tbatch, counters)
    last = finite_metrics(hist[-1], "16.1 train",
                          ("loss_nvs", "loss_depth"))
    log(f"[fast_cov] 16.1 train, 5 steps: launches {named(train_launches)}; "
        f"last step " + ", ".join(f"{k} {v:.6g}" for k, v in last.items()))
    expect(train_launches, [5] * 5, "16.1 training (5 steps)")
    train_stages = step_stage_times(tr, tbatch, depth_supervise=True)
    for k, ms in train_stages.items():
        log(f"[stage] fast_cov exemplar train {k}: {ms:.3f} ms")
    train_rate = 1 / dt
    log(f"[fast_cov] 16.1 train: {train_rate:.3f} steps/s ({dt * 1e3:.2f} "
        f"ms a step: Trainer.step, one scene of {n_train} views at "
        f"{meta.pad_shape[0]}x{meta.pad_shape[1]} and {tr.model.n_rand} "
        f"rays, loss_depth on, host clock after 2 warm-up steps), peak "
        f"memory {peak / 2**30:.2f} GiB; measured on {card}")
    del tr, tbatch
    torch.cuda.empty_cache()

    # ---- 16.2 squeeze 8: M = 16, 40 views, 4096 rays ----
    tr = api.init_trainer(cfg8, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    if tr.model.mapping[0].out_features != c8:
        raise SystemExit(f"squeeze 8 built M={tr.model.mapping[0]}")
    b8 = api.train_batch(tr.model, [sc8], rng=np.random.RandomState(SEED))
    zero()
    m8 = finite_metrics(tr.step(b8), "16.2 train")
    launches8 = counts()
    log(f"[fast_cov] 16.2 {FC_SQUEEZE8}: M={c8}, one step at {n8} views "
        f"and {r8} rays: launches {named(launches8)}; loss {m8['loss']:.6g}"
        f", loss_nvs {m8['loss_nvs']:.6g}")
    expect(launches8, [1] * 5, "16.2 training")
    model = tr.model.eval()
    del tr, b8
    torch.cuda.empty_cache()
    zero()
    t0 = time.perf_counter()
    nvs_metrics = api.run_nvs_eval(model, nvs, chunk=FC_NVS_CHUNK,
                                   progress=False)
    nvs_s = time.perf_counter() - t0
    nvs_launches = counts()
    n_rays = (h - 2 * MARGIN) * (w - 2 * MARGIN)
    chunks = -(-n_rays // FC_NVS_CHUNK)
    log(f"[fast_cov] 16.2 run_nvs_eval, one {h - 2 * MARGIN}x"
        f"{w - 2 * MARGIN} view from {FC_VIEWS} views at chunk "
        f"{FC_NVS_CHUNK}: {nvs_s:.2f} s; launches {named(nvs_launches)}; "
        + ", ".join(f"{k} {v:.4f}" for k, v in nvs_metrics.items()))
    expect(nvs_launches, [0, 0, 0, chunks, 0], "16.2 run_nvs_eval")
    del model
    torch.cuda.empty_cache()

    # ---- 16.3 no depth: the ungated rgb stream ----
    cfg3 = family_config(FC_NO_DEPTH)
    if cfg3.model["depth_supervise"] or cfg3.input_modality["use_depth"]:
        raise SystemExit(f"{FC_NO_DEPTH} asks for depth")
    model = api.init_detector(cfg3, device="cuda", seed=SEED)
    nodepth = first_views(scene, FC_VIEWS, depth=False)
    batch = api.device_batch(model, nodepth)
    zero()
    res = api.eval_step(model, batch, nms_pre)
    torch.cuda.synchronize()
    launches3 = counts()
    finite_candidates(res, "16.3 eval_step")
    expect(launches3, [1, 0, 1, 0, 0], "16.3 eval_step")
    del model, batch, res
    tr = api.init_trainer(cfg3, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    n3 = family_views(cfg3, "train")
    b3 = api.train_batch(tr.model, [first_views(scene, n3, depth=False)],
                         rng=np.random.RandomState(SEED))
    zero()
    m3 = finite_metrics(tr.step(b3), "16.3 train")
    train3 = counts()
    log(f"[fast_cov] 16.3 {FC_NO_DEPTH}: eval_step at {FC_VIEWS} views "
        f"without depth, launches {named(launches3)}; one step at {n3} "
        f"views, launches {named(train3)}; loss {m3['loss']:.6g}, loss_nvs "
        f"{m3['loss_nvs']:.6g}, no loss_depth {'loss_depth' not in m3}")
    expect(train3, [1] * 5, "16.3 training")
    del tr, b3
    torch.cuda.empty_cache()

    # ---- 16.4 Swin-T ----
    cfg4 = family_config(FC_SWIN)
    model = api.init_detector(cfg4, device="cuda", seed=SEED)
    if type(model.backbone).__name__ != "SwinTransformer":
        raise SystemExit("the Swin config did not build the Swin backbone")
    batch = api.device_batch(model, scene)
    zero()
    res = api.eval_step(model, batch, nms_pre)
    torch.cuda.synchronize()
    launches4 = counts()
    finite_candidates(res, "16.4 eval_step")
    expect(launches4, [1, 0, 1, 0, 0], "16.4 eval_step")
    with torch.inference_mode():
        swin_ms = cuda_time_ms(lambda: model.backbone(batch["imgs"]), 3,
                               warmup=1)
        extract_ms = cuda_time_ms(lambda: model.extract_2d(batch["imgs"]),
                                  3, warmup=1)
    eval4_ms = cuda_time_ms(lambda: api.eval_step(model, batch, nms_pre), 3,
                            warmup=1)
    del model, batch, res
    torch.cuda.empty_cache()
    tr = api.init_trainer(cfg4, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    n4 = family_views(cfg4, "train")
    b4 = api.train_batch(tr.model, [first_views(scene, n4)],
                         rng=np.random.RandomState(SEED))
    zero()
    t0 = time.perf_counter()
    m4 = finite_metrics(tr.step(b4), "16.4 train", ("loss_nvs",
                                                    "loss_depth"))
    torch.cuda.synchronize()
    step4_s = time.perf_counter() - t0
    train4 = counts()
    log(f"[fast_cov] 16.4 {FC_SWIN}: Swin-T, volume "
        f"{tr.model.n_voxels}; eval_step at {FC_VIEWS} views "
        f"{eval4_ms:.2f} ms (of it the backbone {swin_ms:.2f} ms, backbone "
        f"+ FPN {extract_ms:.2f} ms), launches {named(launches4)}; one step "
        f"at {n4} views and {tr.model.n_rand} rays ({step4_s:.2f} s, the "
        f"first), launches {named(train4)}; loss {m4['loss']:.6g}; "
        f"measured on {card}")
    expect(train4, [1] * 5, "16.4 training")
    del tr, b4
    torch.cuda.empty_cache()

    # ---- 16.5 the largest volume: 64x64x12 ----
    cfg5 = family_config(FC_LARGEST)
    model = api.init_detector(cfg5, device="cuda", seed=SEED)
    n5 = family_views(cfg5, "test")
    batch = api.device_batch(model, first_views(
        scene, n5, depth=cfg5.input_modality["use_depth"]))
    zero()
    res = api.eval_step(model, batch, nms_pre)
    torch.cuda.synchronize()
    launches5 = counts()
    finite_candidates(res, "16.5 eval_step")
    expect(launches5, [1, 0, 1, 0, 0], "16.5 eval_step")
    with torch.inference_mode():
        heads5, _, _ = model(batch)
    scales5 = [tuple(t[0].shape[:3]) for t in heads5]
    eval5_ms = cuda_time_ms(lambda: api.eval_step(model, batch, nms_pre), 3,
                            warmup=1)
    log(f"[fast_cov] 16.5 {FC_LARGEST}: volume {model.n_voxels} at "
        f"{model.voxel_size}, the head's scales {scales5}; eval_step at {n5} "
        f"views {eval5_ms:.2f} ms, launches {named(launches5)}; measured on "
        f"{card}")
    if scales5[-1] != tuple(n // 4 for n in model.n_voxels):
        raise SystemExit(f"the third scale is {scales5[-1]}")
    del model, batch, res, heads5
    torch.cuda.empty_cache()

    # ---- 16.6 volume mode (nerf_density off) ----
    cfg6 = family_config(FC_VOLUME, {"model.nerf_density": False})
    model = api.init_detector(cfg6, device="cuda", seed=SEED)
    if model.nerf_mode != "volume" or hasattr(model, "mapping"):
        raise SystemExit("the volume-mode config did not build volume mode")
    batch = api.device_batch(model, first_views(scene, FC_VIEWS,
                                                depth=False))
    zero()
    res = api.eval_step(model, batch, nms_pre)
    torch.cuda.synchronize()
    launches6 = counts()
    finite_candidates(res, "16.6 eval_step")
    expect(launches6, [1, 0, 0, 0, 0], "16.6 eval_step")
    zero()
    t0 = time.perf_counter()
    vrgb, vdepth = model.render_full(api.render_batch(
        model, first_views(nvs[0], FC_VIEWS, depth=False)), FC_NVS_CHUNK)
    torch.cuda.synchronize()
    render6_s = time.perf_counter() - t0
    render6 = counts()
    if not (torch.isfinite(vrgb).all() and torch.isfinite(vdepth).all()):
        raise SystemExit("16.6 render_full: non-finite rgb or depth")
    expect(render6, [1, 0, 0, 0, 0], "16.6 render_full")
    del model, batch, res, vrgb, vdepth
    torch.cuda.empty_cache()
    tr = api.init_trainer(cfg6, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    n6 = family_views(cfg6, "train")
    b6 = api.train_batch(tr.model, [first_views(scene, n6)],
                         rng=np.random.RandomState(SEED))
    zero()
    m6 = finite_metrics(tr.step(b6), "16.6 train",
                        ("loss_nvs", "loss_depth"))
    train6 = counts()
    map_grad = float(tr.model.mean_mapping[0].weight.grad.abs().max())
    log(f"[fast_cov] 16.6 {FC_VOLUME} with nerf_density=False: eval_step "
        f"launches {named(launches6)}; render_full of one "
        f"{h - 2 * MARGIN}x{w - 2 * MARGIN} view {render6_s:.2f} s, "
        f"launches {named(render6)}; one step at {n6} views and "
        f"{tr.model.n_rand} rays, launches {named(train6)}; loss "
        f"{m6['loss']:.6g}, loss_nvs {m6['loss_nvs']:.6g}, max |d "
        f"mean_mapping| {map_grad:.3e}")
    expect(train6, [1, 1, 0, 0, 0], "16.6 training")
    if not map_grad > 0:
        raise SystemExit("16.6: no gradient reached mean_mapping")
    del tr, b6
    torch.cuda.empty_cache()

    # ---- 16.7 the CLIs from files ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_fast_cov_") as tmp:
        t0 = time.perf_counter()
        roots = [write_synthetic_scannet(
            os.path.join(tmp, split), n_scenes=1, n_images=FC_CLI_VIEWS,
            hw=RUNTIME_HW, seed=SEED + 17 + i, splits=(split,), workers=8,
            with_depth=True) for i, split in enumerate(("train", "val"))]
        opts = runtime_options(cfg, *roots)
        log(f"[fast_cov] 16.7 wrote 2 scenes of {FC_CLI_VIEWS} views at "
            f"{RUNTIME_HW[0]}x{RUNTIME_HW[1]} with .npy depth: "
            f"{time.perf_counter() - t0:.1f} s")
        per_step = []
        original_init = counted_trainers(api, counters, per_step)
        try:
            t0 = time.perf_counter()
            result = train_cli.main([
                FC_EXEMPLAR, "--work-dir", os.path.join(tmp, "work"),
                "--max-steps", str(FC_CLI_STEPS), "--no-validate",
                "--options", *opts])
            cli_train_s = time.perf_counter() - t0
        finally:
            api.init_trainer = original_init
        for hh, n in zip(result["history"], per_step):
            log(f"[fast_cov] 16.7 tools/train step {hh['step']}: launches "
                f"{named(n)}; loss {hh['loss']:.5g}, loss_nvs "
                f"{hh.get('loss_nvs', float('nan')):.5g}, loss_depth "
                f"{hh.get('loss_depth', float('nan')):.5g}")
            finite_metrics(hh, "16.7 tools/train", ("loss_nvs",
                                                    "loss_depth"))
        if per_step != [[1] * 5] * FC_CLI_STEPS:
            raise SystemExit(f"16.7 tools/train launches a step {per_step}")
        zero()
        t0 = time.perf_counter()
        metrics = test_cli.main([FC_EXEMPLAR, result["checkpoints"][0],
                                 "--eval", "mAP", "nvs", "--options",
                                 *opts])
        cli_test_s = time.perf_counter() - t0
        cli_launches = counts()
        pipe = cfg.data["test"]["pipeline"][0]
        pad = [t for t in pipe["transforms"] if t["type"] == "Pad"][0]["size"]
        cli_chunks = -(-((pad[0] - 2 * pipe["margin"])
                         * (pad[1] - 2 * pipe["margin"]))
                       // cfg.model["N_rand"])
        log(f"[fast_cov] 16.7 tools/train {FC_CLI_STEPS} steps "
            f"{cli_train_s:.1f} s; tools/test --eval mAP nvs "
            f"{cli_test_s:.1f} s, launches {named(cli_launches)}; "
            + ", ".join(f"{k} {metrics[k]:.4f}" for k in (
                "mAP_0.25", "mAR_0.25", "psnr", "ssim", "rmse")))
        expect(cli_launches, [1, 0, 1, cli_chunks
                              * pipe["nerf_target_views"], 0],
               "16.7 tools/test")
        if not all(math.isfinite(v) for k, v in metrics.items()
                   if k.startswith(("mAP", "mAR", "psnr", "ssim", "rmse"))):
            raise SystemExit(f"non-finite test metrics {metrics}")
    wall = time.perf_counter() - t_phase
    log(f"[fast_cov] phase 16 in {wall:.1f} s")
    return dict(k1=k1, k1_m16=k1_m16, rgb=rgb, rgb_gated=rgb_gated,
                k1_bwd=k1_bwd, k2=k2, k2_bwd=k2_bwd,
                launches=dict(zip(FC_NAMES, train_launches)),
                eval_launches=dict(zip(FC_NAMES, eval_launches)),
                eval_rate=eval_rate, eval_peak_gib=eval_peak,
                train_rate=train_rate, train_peak_gib=peak / 2**30,
                stages=stages, train_stages=train_stages, wall_s=wall)


# phase 17: the indoor ImVoxelNet on ScanNet (ImVoxelNet configs without
# NeRF keys, and the lowercase imvoxelnet type)
IV = "configs/imvoxelnet/imvoxelnet_scannet"
IV_ATLAS = IV + ".py"
IV_FAST = IV + "_fast.py"
IV_FAST_DEPTH = IV + "_fast_depth.py"
IV_SWIN = IV + "_swin_t.py"
IV_CLI_STEPS = 2
IV_CLI_VIEWS = 60  # views of each written scene (train 20, test 50)
IV_NARROW = (1, 8, 16)  # K1 off its widths: the smoke config's FPN 8


def indoor_path(api, voxel, render, card):
    """Phase 17: the indoor ImVoxelNet on ScanNet at full width, random
    weights from ``SEED``, synthetic 478x640 scenes (phase 16's scene
    maker) at the intrinsic scaled to ``ori_shape``. 17.0 K1 at this
    slice's shapes against its plain version (the plain-mean form into the
    80x80x32 volume and its g1-only backward, C = 256 depth-gated at
    40x40x16, C = 1, 8, 16 run padded); 17.1 ``imvoxelnet_scannet.py``
    (the Atlas neck, the V1 head): eval_step at 50 views with stage
    times, the Trainer.step at 20 views (2 + 5 steps), one step kernels vs
    plain; 17.2 the fast and fast_depth configs; 17.3 the lowercase
    imvoxelnet (Swin-T, the NeRF-Det graph without the density); 17.4
    bfloat16; 17.5 tools/train then tools/test on files. Returns the
    record's numbers."""
    import math
    import tempfile

    import numpy as np
    import torch

    from nerfdet_tpu_torch.data.synthetic import write_synthetic_scannet
    from nerfdet_tpu_torch.nn.heads import get_candidate_bboxes
    from nerfdet_tpu_torch.parallel.train2d import pipeline_views
    from nerfdet_tpu_torch.tools import test as test_cli
    from nerfdet_tpu_torch.tools import train as train_cli

    t_phase = time.perf_counter()
    dev = api.resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    f32, bf16 = torch.float32, torch.bfloat16
    counters = (voxel.fusion_carry, voxel.fusion_carry_backward,
                voxel.rgb_carry, render.streaming_sample_mean_var,
                render.streaming_sample_mean_var_backward)

    def zero():
        for fn in counters:
            fn.launches = 0

    def counts():
        return [fn.launches for fn in counters]

    def named(launches):
        return ", ".join(f"{n} {c}" for n, c in zip(FC_NAMES, launches))

    def expect(launches, want, what):
        if launches != want:
            raise SystemExit(f"phase 17 {what} launched {named(launches)}; "
                             f"expected {named(want)}")

    def finite_candidates(res, what):
        if not (torch.isfinite(res["boxes"]).all()
                and torch.isfinite(res["scores"]).all()):
            raise SystemExit(f"phase 17 {what}: non-finite candidates")

    def finite_metrics(metrics, what, need=("n_pos",)):
        m = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in m.values()) or not all(
                m.get(k, 0.0) > 0 for k in need):
            raise SystemExit(f"phase 17 {what}: metrics {m}")
        return m

    # ---- imvoxelnet_scannet.py and its scene ----
    t0 = time.perf_counter()
    cfg = family_config(IV_ATLAS)
    model = api.init_detector(cfg, device="cuda", seed=SEED)
    meta = model.meta
    n_test, n_train = family_views(cfg, "test"), family_views(cfg, "train")
    scene = depth_scene(model, SEED + 17, n_test)
    c = model.neck.fpn_convs[0].conv.out_channels
    log(f"[indoor] {IV_ATLAS}: {type(model).__name__}, 3D neck "
        f"{type(model.neck_3d).__name__}, head {model.head_type} (V1 "
        f"{model.uses_v1_head}), volume {model.n_voxels} at "
        f"{model.voxel_size}, FPN {c}, "
        f"{sum(p.numel() for p in model.parameters())} parameters; scene "
        f"{n_test} views {meta.img_shape} padded {meta.pad_shape}, train "
        f"{n_train}: {time.perf_counter() - t0:.1f} s")
    if not model.uses_v1_head or type(model).__name__ != "IndoorImVoxelNet":
        raise SystemExit(f"{IV_ATLAS} did not build the indoor ImVoxelNet")

    # ---- 17.0 K1 at this slice's shapes ----
    hw = (meta.pad_shape[0] // 4, meta.pad_shape[1] // 4)
    vol = "x".join(str(n) for n in model.n_voxels)
    pix_test = family_pix(voxel, model, scene, dev, False)["features"]
    k1 = check_fusion(voxel, [
        (f"float32 plain mean, {n_test} views into {vol}", pix_test, f32,
         False),
        (f"bfloat16 plain mean, {n_test} views into {vol}", pix_test, bf16,
         False)], hw, gen, c=c)
    del pix_test
    pix_train = family_pix(voxel, model, first_views(scene, n_train), dev,
                           False)["features"]
    train_label = f"the training pix ({n_train} views into {vol})"
    k1_bwd = check_fusion_backward(voxel, pix_train, hw, gen, train_label,
                                   c=c, m=0)
    k1_bwd_bf16 = check_fusion_backward(voxel, pix_train, hw, gen,
                                        train_label, dtype=bf16, c=c, m=0)
    narrow, narrow_bwd = {}, {}
    for cn in IV_NARROW:
        narrow[cn] = check_fusion(voxel, [
            (f"float32 plain mean C={cn} (run at "
             f"{voxel.k1_width(cn)}), {train_label}", pix_train, f32,
             False)], hw, gen, c=cn)
        narrow_bwd[cn] = check_fusion_backward(
            voxel, pix_train, hw, gen, f"C={cn}, {train_label}", c=cn, m=0)
    del pix_train
    cfg_fd = family_config(IV_FAST_DEPTH)
    fd_model = api.init_detector(cfg_fd, device="cuda", seed=SEED)
    pix_fd = family_pix(voxel, fd_model, scene, dev, True)["features"]
    kept_fd = float((pix_fd >= 0).float().mean())
    c_fd = fd_model.neck.fpn_convs[0].conv.out_channels
    k1_fd = check_fusion(voxel, [
        (f"float32 plain mean C={c_fd}, {n_test} views depth-gated into "
         f"{fd_model.n_voxels}", pix_fd, f32, False)], hw, gen, c=c_fd)
    log(f"[indoor] 17.0 the depth gate keeps {kept_fd:.4f} of the (voxel, "
        f"view) pairs at {fd_model.n_voxels} ({IV_FAST_DEPTH})")
    del pix_fd, fd_model

    # ---- 17.1 eval_step at 50 views ----
    nms_pre, iou_thr = cfg.test_cfg["nms_pre"], cfg.test_cfg["iou_thr"]
    nodepth = first_views(scene, n_test, depth=False)
    batch = api.device_batch(model, nodepth)
    if set(batch) != {"imgs", "intrinsic", "extrinsics", "origin"}:
        raise SystemExit(f"the indoor batch holds {sorted(batch)}")
    zero()
    res = api.eval_step(model, batch, nms_pre)
    det = api.detections_from_candidates(
        res["boxes"].float().cpu().numpy(),
        res["scores"].float().cpu().numpy(), SCORE_THR, iou_thr)
    eval_launches = counts()
    log(f"[indoor] 17.1 eval_step at {n_test} views -> "
        f"{tuple(res['boxes'].shape)} candidates, NMS kept "
        f"{len(det['labels_3d'])}; launches {named(eval_launches)}")
    expect(eval_launches, [1, 0, 0, 0, 0], "17.1 eval_step")
    finite_candidates(res, "17.1 eval_step")
    with torch.inference_mode():
        head_k, valid_k, _ = model(batch)
        saved = voxel.fusion_carry
        voxel.fusion_carry = voxel.fusion_carry_plain
        try:
            head_p, valid_p, _ = model(batch)
        finally:
            voxel.fusion_carry = saved
    diff = max(float((a - b).abs().max()) for hk, hp in zip(head_k, head_p)
               for a, b in zip(hk, hp))
    scale = max(float(b.abs().max()) for hp in head_p for b in hp)
    shapes = [tuple(t[0].shape[:3]) for t in head_k]
    log(f"[indoor] 17.1 kernels vs plain (K1) through the whole graph: view "
        f"counts equal {torch.equal(valid_k, valid_p)}, head outputs max "
        f"|diff| {diff:.3e} (max |out| {scale:.3e}, tol 1e-4 relative); "
        f"scales {shapes}")
    if not torch.equal(valid_k, valid_p) or diff > 1e-4 * max(scale, 1.0):
        raise SystemExit("kernel and plain indoor graphs disagree")
    if shapes != [tuple(n >> i for n in model.n_voxels) for i in range(3)]:
        raise SystemExit(f"the Atlas neck's scales are {shapes}")
    del head_k, head_p
    with torch.inference_mode():
        feats, _ = model.extract_2d(batch["imgs"])
        geo = (batch["intrinsic"], batch["extrinsics"], batch["origin"])
        volume, valid = model.build_volume(feats, *geo)
        x = volume.permute(3, 0, 1, 2)[None]
        scales = model.neck_3d(x)
        heads = model.detect(volume)
        mlvl = model.mlvl_points(batch["origin"])
        stages = {}
        for name, fn in {
                "extract_2d (ResNet-50 + FPN)": lambda: model.extract_2d(
                    batch["imgs"]),
                "build_volume (projection + K1)": lambda: model.build_volume(
                    feats, *geo),
                "Atlas neck": lambda: model.neck_3d(x),
                "V1 head": lambda: model.bbox_head(scales),
                "get_candidate_bboxes": lambda: get_candidate_bboxes(
                    heads, valid, mlvl, nms_pre, model.n_classes),
        }.items():
            stages[name] = cuda_time_ms(fn, 3, warmup=1)
            log(f"[stage] indoor {n_test} views {name}: "
                f"{stages[name]:.3f} ms")
    del feats, volume, x, scales, heads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    iters = 3
    t0 = time.perf_counter()
    for _ in range(iters):
        res = api.eval_step(model, batch, nms_pre)
        api.detections_from_candidates(
            res["boxes"].float().cpu().numpy(),
            res["scores"].float().cpu().numpy(), cfg.test_cfg["score_thr"],
            iou_thr)
    dt = (time.perf_counter() - t0) / iters
    eval_rate = 1 / dt
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    eval_ms = cuda_time_ms(lambda: api.eval_step(model, batch, nms_pre), 3,
                           warmup=1)
    log(f"[indoor] 17.1 inference: {eval_rate:.3f} scenes/s ({dt * 1e3:.2f} "
        f"ms a scene: eval_step + host NMS at {n_test} views), peak memory "
        f"{eval_peak:.2f} GiB; the Atlas neck {stages['Atlas neck']:.3f} ms "
        f"of it; measured on {card}")
    del model, batch, res
    torch.cuda.empty_cache()

    # ---- 17.1 the Trainer.step at 20 views ----
    t0 = time.perf_counter()
    tr = api.init_trainer(cfg, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    tbatch = api.train_batch(tr.model, [first_views(scene, n_train,
                                                    depth=False)],
                             rng=np.random.RandomState(SEED))
    log(f"[indoor] 17.1 init_trainer, {n_train} views: "
        f"{time.perf_counter() - t0:.1f} s")
    start = {k: v.clone() for k, v in tr.model.state_dict().items()}
    loss_k, _, grads_k, _ = family_step_grads(voxel, render, tr.model,
                                              tbatch, start, False)
    loss_p, _, grads_p, _ = family_step_grads(voxel, render, tr.model,
                                              tbatch, start, True)
    tr.model.load_state_dict(start)
    tr.optimizer.zero_grad()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    grad_rel = {n: float((grads_k[n] - grads_p[n]).norm())
                / max(float(grads_p[n].norm()), 1e-30) for n in (
                    "neck.lateral_convs.0.conv.weight",
                    "neck_3d.model.down_0_0.conv1.weight",
                    "bbox_head.cls_conv.weight")}
    log(f"[indoor] 17.1 kernels vs plain (K1 and its backward) for one step:"
        f" loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_rel:.3e}, tol "
        f"1e-5); gradients rel norm " + ", ".join(
            f"{n} {v:.3e}" for n, v in grad_rel.items()) + " (tol 1e-4)")
    if loss_rel > 1e-5 or max(grad_rel.values()) > 1e-4:
        raise SystemExit("kernel and plain indoor train steps disagree")
    del grads_k, grads_p, start
    hist, dt, train_launches, peak = timed_steps(tr, tbatch, counters)
    last = finite_metrics(hist[-1], "17.1 train")
    log(f"[indoor] 17.1 train, 5 steps: launches {named(train_launches)}; "
        f"last step " + ", ".join(f"{k} {v:.6g}" for k, v in last.items()))
    expect(train_launches, [5, 5, 0, 0, 0], "17.1 training (5 steps)")
    train_stages = step_stage_times(tr, tbatch)
    for k, ms in train_stages.items():
        log(f"[stage] indoor train {k}: {ms:.3f} ms")
    train_rate = 1 / dt
    log(f"[indoor] 17.1 train: {train_rate:.3f} steps/s ({dt * 1e3:.2f} ms "
        f"a step: Trainer.step, one scene of {n_train} views at "
        f"{meta.pad_shape[0]}x{meta.pad_shape[1]}, host clock after 2 "
        f"warm-up steps), peak memory {peak / 2**30:.2f} GiB; measured on "
        f"{card}")
    del tr, tbatch
    torch.cuda.empty_cache()

    # ---- 17.2 the fast neck and the V2 head, with and without depth ----
    fast = {}
    for path in (IV_FAST, IV_FAST_DEPTH):
        cfg2 = family_config(path)
        depth = bool(cfg2.input_modality["use_depth"])
        model = api.init_detector(cfg2, device="cuda", seed=SEED)
        if model.uses_v1_head or type(model.neck_3d).__name__ != \
                "FastIndoorImVoxelNeck":
            raise SystemExit(f"{path} did not build the fast neck and V2 "
                             f"head")
        batch = api.device_batch(model, first_views(scene, n_test, depth))
        zero()
        res = api.eval_step(model, batch, cfg2.test_cfg["nms_pre"])
        torch.cuda.synchronize()
        ev = counts()
        finite_candidates(res, f"17.2 {path} eval_step")
        expect(ev, [1, 0, 0, 0, 0], f"17.2 {path} eval_step")
        ms = cuda_time_ms(lambda: api.eval_step(
            model, batch, cfg2.test_cfg["nms_pre"]), 3, warmup=1)
        del model, batch, res
        tr = api.init_trainer(cfg2, device="cuda", seed=SEED,
                              steps_per_epoch=1000)
        n2 = family_views(cfg2, "train")
        b2 = api.train_batch(tr.model, [first_views(scene, n2, depth)],
                             rng=np.random.RandomState(SEED))
        zero()
        m2 = finite_metrics(tr.step(b2), f"17.2 {path} train")
        tl = counts()
        log(f"[indoor] 17.2 {path} (depth {depth}): eval_step at {n_test} "
            f"views {ms:.2f} ms, launches {named(ev)}; one step at {n2} "
            f"views, launches {named(tl)}; loss {m2['loss']:.6g}, n_pos "
            f"{m2['n_pos']:.0f}; measured on {card}")
        expect(tl, [1, 1, 0, 0, 0], f"17.2 {path} training")
        fast[os.path.basename(path)] = dict(eval_ms=ms, loss=m2["loss"])
        del tr, b2
        torch.cuda.empty_cache()

    # ---- 17.3 the lowercase imvoxelnet: Swin-T, NeRF-Det without density
    cfg3 = family_config(IV_SWIN)
    model = api.init_detector(cfg3, device="cuda", seed=SEED)
    if (type(model.backbone).__name__ != "SwinTransformer"
            or model.nerf_density or model.host_streams):
        raise SystemExit(f"{IV_SWIN} did not build NeRF-Det with Swin-T, "
                         f"no density, no host streams")
    sw_scene = train_scene(model, SEED + 173)
    batch = api.device_batch(model, sw_scene)
    zero()
    res = api.eval_step(model, batch, cfg3.test_cfg["nms_pre"])
    torch.cuda.synchronize()
    launches3 = counts()
    finite_candidates(res, "17.3 eval_step")
    expect(launches3, [1, 0, 0, 0, 0], "17.3 eval_step")
    del model, batch, res
    tr = api.init_trainer(cfg3, device="cuda", seed=SEED,
                          steps_per_epoch=1000)
    n3 = pipeline_views(cfg3.data["train"])  # less the target views
    b3 = api.train_batch(tr.model, [first_views(sw_scene, n3)],
                         rng=np.random.RandomState(SEED))
    zero()
    m3 = finite_metrics(tr.step(b3), "17.3 train", ("n_pos", "loss_nvs"))
    train3 = counts()
    log(f"[indoor] 17.3 {IV_SWIN}: eval_step at {N_VIEWS} views of "
        f"{tr.model.meta.pad_shape}, launches {named(launches3)}; one step "
        f"at {n3} views and {tr.model.n_rand} rays, launches "
        f"{named(train3)}; loss {m3['loss']:.6g}, loss_nvs "
        f"{m3['loss_nvs']:.6g}")
    expect(train3, [1, 1, 0, 1, 1], "17.3 training")
    del tr, b3, sw_scene
    torch.cuda.empty_cache()

    # ---- 17.4 bfloat16 ----
    model = api.init_detector(cfg, device="cuda", seed=SEED,
                              compute_dtype=bf16)
    batch = api.device_batch(model, nodepth)
    zero()
    res = api.eval_step(model, batch, nms_pre)
    torch.cuda.synchronize()
    launches4 = counts()
    finite_candidates(res, "17.4 bf16 eval_step")
    expect(launches4, [1, 0, 0, 0, 0], "17.4 bf16 eval_step")
    bf16_ms = cuda_time_ms(lambda: api.eval_step(model, batch, nms_pre), 3,
                           warmup=1)
    del model, batch, res
    tr = api.init_trainer(cfg, device="cuda", seed=SEED,
                          steps_per_epoch=1000, compute_dtype=bf16)
    b4 = api.train_batch(tr.model, [first_views(scene, n_train,
                                                depth=False)],
                         rng=np.random.RandomState(SEED))
    zero()
    t0 = time.perf_counter()
    m4 = finite_metrics(tr.step(b4), "17.4 bf16 train")
    torch.cuda.synchronize()
    step4_s = time.perf_counter() - t0
    train4 = counts()
    log(f"[indoor] 17.4 bfloat16 {IV_ATLAS}: eval_step at {n_test} views "
        f"{bf16_ms:.2f} ms (float32 {eval_ms:.2f}), "
        f"launches {named(launches4)}; one step at {n_train} views "
        f"({step4_s:.2f} s, the first), launches {named(train4)}; loss "
        f"{m4['loss']:.6g}; measured on {card}")
    expect(train4, [1, 1, 0, 0, 0], "17.4 bf16 training")
    del tr, b4
    torch.cuda.empty_cache()

    # ---- 17.5 the CLIs from files ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_indoor_") as tmp:
        t0 = time.perf_counter()
        roots = [write_synthetic_scannet(
            os.path.join(tmp, split), n_scenes=1, n_images=IV_CLI_VIEWS,
            hw=RUNTIME_HW, seed=SEED + 170 + i, splits=(split,), workers=8)
            for i, split in enumerate(("train", "val"))]
        opts = runtime_options(cfg, *roots)
        log(f"[indoor] 17.5 wrote 2 scenes of {IV_CLI_VIEWS} views at "
            f"{RUNTIME_HW[0]}x{RUNTIME_HW[1]}: "
            f"{time.perf_counter() - t0:.1f} s")
        per_step = []
        original_init = counted_trainers(api, counters, per_step)
        try:
            t0 = time.perf_counter()
            result = train_cli.main([
                IV_ATLAS, "--work-dir", os.path.join(tmp, "work"),
                "--max-steps", str(IV_CLI_STEPS), "--no-validate",
                "--options", *opts])
            cli_train_s = time.perf_counter() - t0
        finally:
            api.init_trainer = original_init
        for hh, n in zip(result["history"], per_step):
            log(f"[indoor] 17.5 tools/train step {hh['step']}: launches "
                f"{named(n)}; loss {hh['loss']:.5g}, n_pos {hh['n_pos']:.0f}")
            # the files' scenes, their origin shifted at random, may hold
            # no positive in a step: finite is the check here (17.1 has
            # the positives)
            finite_metrics(hh, "17.5 tools/train", ())
        if per_step != [[1, 1, 0, 0, 0]] * IV_CLI_STEPS:
            raise SystemExit(f"17.5 tools/train launches a step {per_step}")
        zero()
        t0 = time.perf_counter()
        metrics = test_cli.main([IV_ATLAS, result["checkpoints"][0],
                                 "--eval", "mAP", "--options", *opts])
        cli_test_s = time.perf_counter() - t0
        cli_launches = counts()
        log(f"[indoor] 17.5 tools/train {IV_CLI_STEPS} steps "
            f"{cli_train_s:.1f} s; tools/test --eval mAP {cli_test_s:.1f} s, "
            f"launches {named(cli_launches)}; " + ", ".join(
                f"{k} {metrics[k]:.4f}" for k in ("mAP_0.25", "mAR_0.25")))
        expect(cli_launches, [1, 0, 0, 0, 0], "17.5 tools/test")
        if not all(math.isfinite(v) for k, v in metrics.items()
                   if k.startswith(("mAP", "mAR"))):
            raise SystemExit(f"non-finite test metrics {metrics}")
    wall = time.perf_counter() - t_phase
    log(f"[indoor] phase 17 in {wall:.1f} s")
    return dict(k1=k1, k1_bwd=k1_bwd, k1_bwd_bf16=k1_bwd_bf16,
                k1_fast_depth=k1_fd, kept_fast_depth=kept_fd,
                narrow={str(k): v for k, v in narrow.items()},
                narrow_bwd={str(k): v for k, v in narrow_bwd.items()},
                launches=dict(zip(FC_NAMES, train_launches)),
                eval_launches=dict(zip(FC_NAMES, eval_launches)),
                eval_rate=eval_rate, eval_peak_gib=eval_peak,
                train_rate=train_rate, train_peak_gib=peak / 2**30,
                stages=stages, train_stages=train_stages, fast=fast,
                eval_ms=eval_ms, bf16_eval_ms=bf16_ms, wall_s=wall)


# ---------------------------------------------------------------------
# phase 18: the SUN RGB-D ImVoxelNet (monocular: one view a scene,
# yawed heads, rotated NMS, rotated mAP), inference and evaluation
SR = "configs/imvoxelnet/imvoxelnet_sunrgbd"
SR_V1 = SR + ".py"
SR_FAST = SR + "_fast.py"
SR_PERSP = "configs/imvoxelnet/imvoxelnet_perspective_sunrgbd.py"
SR_HW = (530, 730)  # the configs' nominal ori_shape
SR_SCENES = 3  # the fixture's val scenes
SR_ITERS = 5  # timed eval_step + host NMS calls
SR_BATCH = 4  # the configs' samples_per_gpu: scenes a train step
SR_TRAIN_SCENES = 4  # the train split's scenes (x2: RepeatDataset)
SR_CLI_STEPS = 2


def rotated_iou_ms(model, batch, iters=3):
    """CUDA-event ms of the yawed heads' rotated 3D IoU loss alone: for
    each scene of ``batch``, the forward and backward of
    ``nn/heads.yawed_iou_loss`` over every point of every level against
    the step's targets, summed over the scenes; and the points a
    scene."""
    import torch

    from nerfdet_tpu_torch.nn.heads import get_targets, yawed_iou_loss
    from nerfdet_tpu_torch.nn.heads_v1 import get_targets_v1

    total = 0.0
    for scene in batch:
        with torch.no_grad():
            head_outs, _, _ = model(scene)
            mlvl = model.mlvl_points(scene["origin"])
            points = torch.cat(mlvl)
            ids = torch.cat([torch.full((p.shape[0],), i, dtype=torch.int32,
                                        device=p.device)
                             for i, p in enumerate(mlvl)])
            gt = (scene["gt_boxes"], scene["gt_labels"], scene["gt_mask"])
            if model.uses_v1_head:
                _, box_t, _ = get_targets_v1(
                    points, ids, model.regress_ranges, *gt, model.n_classes,
                    model.head_centerness_topk, yaw=True)
            else:
                _, box_t, _ = get_targets(
                    points, ids, *gt, model.n_scales, model.head_limit,
                    model.head_centerness_topk, yaw=True)
        pred = torch.cat([b.reshape(-1, b.shape[-1])
                          for _, b, _ in head_outs]).detach()
        pred.requires_grad_()

        def run():
            (1.0 - yawed_iou_loss(points, pred, box_t)).sum().backward()

        total += cuda_time_ms(run, iters, warmup=1)
    return total, int(points.shape[0])


def sunrgbd_fixture(root, n_scenes, n_classes, seed, split="val"):
    """A SUN RGB-D split on disk, as JAX's ETL lays it out: PNG views
    of ``SR_HW`` under ``sunrgbd_trainval/image`` and an info pkl of its
    schema (``image``, ``calib`` with ``K`` column-major and ``Rt``,
    ``annos`` with gravity-centered yawed ``gt_boxes_upright_depth``).
    The camera sits at the origin looking along +y, a few degrees of
    pitch apart; the GT boxes lie in the volume's 6.4 x 6.4 x 2.56 m
    around (0, 3, -1). Returns the pkl's path."""
    import pickle

    import numpy as np

    from nerfdet_tpu_torch.data.pipeline import imwrite_png

    rng = np.random.RandomState(seed)
    image_dir = os.path.join(root, "sunrgbd_trainval", "image")
    os.makedirs(image_dir, exist_ok=True)
    h, w = SR_HW
    k = np.array([[529.5, 0, w / 2], [0, 529.5, h / 2], [0, 0, 1]])
    infos = []
    for i in range(n_scenes):
        coarse = rng.randint(0, 256, (h // 10 + 1, w // 10 + 1, 3))
        img = np.kron(coarse, np.ones((10, 10, 1)))[:h, :w].astype(np.uint8)
        rel = os.path.join("sunrgbd_trainval", "image", f"{i + 1:06d}.png")
        imwrite_png(os.path.join(root, rel), img)
        a = rng.uniform(-0.08, 0.08)  # pitch, radians
        rt = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)],
                       [0, np.sin(a), np.cos(a)]])
        n = rng.randint(2, 6)
        boxes = np.concatenate([
            rng.uniform(-2, 2, (n, 1)), rng.uniform(1.5, 5, (n, 1)),
            rng.uniform(-1.8, -0.4, (n, 1)), rng.uniform(0.4, 2.0, (n, 3)),
            rng.uniform(-np.pi, np.pi, (n, 1))], 1)
        labels = rng.randint(0, n_classes, n)
        infos.append(dict(
            point_cloud=dict(num_features=6, lidar_idx=i + 1),
            pts_path=os.path.join("points", f"{i + 1:06d}.bin"),
            image=dict(image_idx=i + 1, image_shape=np.array(SR_HW, np.int32),
                       image_path=rel),
            calib=dict(K=k.T.flatten(), Rt=rt),
            annos=dict(gt_num=n, name=np.array([f"class{c}" for c in labels]),
                       bbox=rng.uniform(0, 500, (n, 4)),
                       location=boxes[:, :3], dimensions=boxes[:, 3:6],
                       rotation_y=boxes[:, 6],
                       index=np.arange(n, dtype=np.int32),
                       **{"class": labels}, gt_boxes_upright_depth=boxes)))
    path = os.path.join(root, f"sunrgbd_c{n_classes}_infos_{split}.pkl")
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path


def sunrgbd_path(api, voxel, render, card):
    """Phase 18: the SUN RGB-D ImVoxelNet at full width, random weights
    from ``SEED``, on a fixture this phase writes (``sunrgbd_fixture``:
    530x730 PNG views read through the port's dataset, so each scene is
    the test pipeline's: 465x640 padded to 480x640, origin (0, 3, -1)).
    18.0 K1's plain-mean form at one view against its plain version
    (``imvoxelnet_sunrgbd.py``'s (1, 120, 160, 64) maps into 80x80x32 f32
    and bf16, ``_fast``'s C = 256 into 40x40x16); 18.1
    ``imvoxelnet_sunrgbd.py``: eval_step + host rotated NMS, K1 once a
    scene, kernels vs plain through the graph, stage times, scenes/s;
    18.2 ``_fast`` (the yawed V2 head), 18.3 the perspective split (30
    classes), 18.4 bfloat16, one scene each; 18.5 ``tools/test --eval
    mAP`` from the files (f32, the perspective split, ``--bf16``); 18.6
    K1's s1-only backward at one view; 18.7 training through the CLIs
    and a timed ``Trainer.step``. Returns the record's numbers."""
    import math
    import tempfile

    import torch

    from nerfdet_tpu_torch.data.dataset import build_dataset
    from nerfdet_tpu_torch.nn.heads import get_candidate_bboxes
    from nerfdet_tpu_torch.tools import test as test_cli
    from nerfdet_tpu_torch.tools import train as train_cli
    from nerfdet_tpu_torch.utils.checkpoint import save_checkpoint

    t_phase = time.perf_counter()
    dev = api.resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    f32, bf16 = torch.float32, torch.bfloat16
    counters = (voxel.fusion_carry, voxel.fusion_carry_backward,
                voxel.rgb_carry, render.streaming_sample_mean_var,
                render.streaming_sample_mean_var_backward)

    def zero():
        for fn in counters:
            fn.launches = 0

    def counts():
        return [fn.launches for fn in counters]

    def named(launches):
        return ", ".join(f"{n} {c}" for n, c in zip(FC_NAMES, launches))

    def expect(launches, want, what):
        if launches != want:
            raise SystemExit(f"phase 18 {what} launched {named(launches)}; "
                             f"expected {named(want)}")

    def candidates(model, batch, what):
        zero()
        res = api.eval_step(model, batch, 1000)
        torch.cuda.synchronize()
        launches = counts()
        expect(launches, [1, 0, 0, 0, 0], what)
        if not (res["boxes"].shape[-1] == 7
                and torch.isfinite(res["boxes"]).all()
                and torch.isfinite(res["scores"]).all()):
            raise SystemExit(f"phase 18 {what}: candidates "
                             f"{tuple(res['boxes'].shape)} not yawed and "
                             f"finite")
        return res, launches

    def host_nms(res, cfg, score_thr=None, iters=3):
        """The host tail (score threshold, rotated NMS a class): its ms
        on the host clock (the mean of ``iters`` calls after one) and the
        boxes kept."""
        boxes = res["boxes"].float().cpu().numpy()
        scores = res["scores"].float().cpu().numpy()
        thr = cfg.test_cfg["score_thr"] if score_thr is None else score_thr
        for i in range(iters + 1):
            if i == 1:
                t0 = time.perf_counter()
            det = api.detections_from_candidates(boxes, scores, thr,
                                                 cfg.test_cfg["iou_thr"])
        return ((time.perf_counter() - t0) * 1e3 / iters,
                len(det["labels_3d"]))

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_sunrgbd_")
    root = tmp.name + "/"
    t0 = time.perf_counter()
    ann10 = sunrgbd_fixture(root, SR_SCENES, 10, SEED + 180)
    ann30 = sunrgbd_fixture(root, SR_SCENES, 30, SEED + 181)
    # the perspective configs' data dicts keep their base's 10 class names
    # (a fault of the config files, JAX's too: ROADMAP §3); name the 30
    persp_names = tuple(family_config(SR_PERSP).class_names)
    files = {10: [f"data.test.data_root={root}", f"data.test.ann_file={ann10}"],
             30: [f"data.test.data_root={root}", f"data.test.ann_file={ann30}",
                  f"data.test.classes={persp_names!r}"]}
    cfg = family_config(SR_V1, files[10])
    dataset = build_dataset(cfg.data["test"], test_mode=True)
    scene = dataset[0]
    model = api.init_detector(cfg, device="cuda", seed=SEED)
    meta = model.meta
    c = model.neck.fpn_convs[0].conv.out_channels
    log(f"[sunrgbd] {SR_V1}: {type(model).__name__}, head {model.head_type} "
        f"(yaw {model.yaw}), volume {model.n_voxels} at {model.voxel_size}, "
        f"FPN {c}, {sum(p.numel() for p in model.parameters())} "
        f"parameters; {type(dataset).__name__} of {len(dataset)} scenes: "
        f"one view {meta.ori_shape} -> {meta.img_shape} padded "
        f"{meta.pad_shape}, imgs {scene['imgs'].shape}, origin "
        f"{scene['origin'].tolist()}; {time.perf_counter() - t0:.1f} s")
    if not model.yaw or not model.uses_v1_head or scene["imgs"].shape[0] != 1:
        raise SystemExit(f"{SR_V1} did not build the yawed V1 head on one "
                         f"view")

    # ---- 18.0 K1 at one view ----
    hw = (meta.pad_shape[0] // 4, meta.pad_shape[1] // 4)
    vol = "x".join(str(n) for n in model.n_voxels)
    pix = family_pix(voxel, model, scene, dev, False)["features"]
    k1 = check_fusion(voxel, [
        (f"float32 plain mean, one view into {vol}", pix, f32, False),
        (f"bfloat16 plain mean, one view into {vol}", pix, bf16, False)],
        hw, gen, c=c)
    fast_cfg = family_config(SR_FAST, files[10])
    fast = api.init_detector(fast_cfg, device="cuda", seed=SEED)
    c_fast = fast.neck.fpn_convs[0].conv.out_channels
    pix_fast = family_pix(voxel, fast, scene, dev, False)["features"]
    k1.update(check_fusion(voxel, [
        (f"float32 plain mean C={c_fast}, one view into "
         f"{'x'.join(str(n) for n in fast.n_voxels)} ({SR_FAST})", pix_fast,
         f32, False)], hw, gen, c=c_fast))

    # ---- 18.6 K1's s1-only backward at one view (the training form) ----
    k1_bwd = {}
    for tag, p_, c_ in ((f"{SR_V1} C={c}", pix, c),
                        (f"{SR_FAST} C={c_fast}", pix_fast, c_fast)):
        for dt in (f32, bf16):
            k1_bwd[f"{str(dt)[6:]} {tag}"] = check_fusion_backward(
                voxel, p_, hw, gen, f"18.6 one view ({tag}; "
                f"{int((p_ >= 0).sum())} valid pairs)", dtype=dt, c=c_,
                m=0, rel_tol=1e-6)
    del pix, pix_fast

    # ---- 18.1 imvoxelnet_sunrgbd.py: eval_step + host rotated NMS ----
    batch = api.device_batch(model, scene)
    res, eval_launches = candidates(model, batch, "18.1 eval_step")
    nms_ms, kept = host_nms(res, cfg)
    nms_all_ms, kept_all = host_nms(res, cfg, 0.0)
    log(f"[sunrgbd] 18.1 eval_step -> {tuple(res['boxes'].shape)} yawed "
        f"candidates; launches {named(eval_launches)}; host rotated NMS at "
        f"score_thr {cfg.test_cfg['score_thr']}: {nms_ms:.2f} ms, kept "
        f"{kept}; at 0 (every candidate): {nms_all_ms:.2f} ms, kept "
        f"{kept_all}")
    with torch.inference_mode():
        head_k, valid_k, _ = model(batch)
        saved = voxel.fusion_carry
        voxel.fusion_carry = voxel.fusion_carry_plain
        try:
            head_p, valid_p, _ = model(batch)
        finally:
            voxel.fusion_carry = saved
    diff = max(float((a - b).abs().max()) for hk, hp in zip(head_k, head_p)
               for a, b in zip(hk, hp))
    scale = max(float(b.abs().max()) for hp in head_p for b in hp)
    seen = float((valid_k > 0).float().mean())
    log(f"[sunrgbd] 18.1 kernels vs plain (K1) through the whole graph: "
        f"view counts equal {torch.equal(valid_k, valid_p)} ({seen:.4f} of "
        f"the voxels seen), head outputs max |diff| {diff:.3e} (max |out| "
        f"{scale:.3e}, tol 1e-4 relative)")
    if not torch.equal(valid_k, valid_p) or diff > 1e-4 * max(scale, 1.0):
        raise SystemExit("kernel and plain SUN RGB-D graphs disagree")
    del head_k, head_p
    with torch.inference_mode():
        feats, _ = model.extract_2d(batch["imgs"])
        geo = (batch["intrinsic"], batch["extrinsics"], batch["origin"])
        volume, valid = model.build_volume(feats, *geo)
        x = volume.permute(3, 0, 1, 2)[None]
        scales = model.neck_3d(x)
        heads = model.detect(volume)
        mlvl = model.mlvl_points(batch["origin"])
        stages = {}
        for name, fn in {
                "extract_2d (ResNet-50 + FPN)": lambda: model.extract_2d(
                    batch["imgs"]),
                "build_volume (projection + K1)": lambda: model.build_volume(
                    feats, *geo),
                "Atlas neck": lambda: model.neck_3d(x),
                "V1 head (yawed)": lambda: model.bbox_head(scales),
                "get_candidate_bboxes (yawed)": lambda: get_candidate_bboxes(
                    heads, valid, mlvl, 1000, model.n_classes, yaw=True),
        }.items():
            stages[name] = cuda_time_ms(fn, 3, warmup=1)
            log(f"[stage] sunrgbd one view {name}: {stages[name]:.3f} ms")
    stages["rotated NMS (host)"] = nms_ms
    stages["rotated NMS, every candidate (host)"] = nms_all_ms
    del feats, volume, x, scales, heads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(SR_ITERS):
        res = api.eval_step(model, batch, 1000)
        api.detections_from_candidates(
            res["boxes"].float().cpu().numpy(),
            res["scores"].float().cpu().numpy(), cfg.test_cfg["score_thr"],
            cfg.test_cfg["iou_thr"])
    dt = (time.perf_counter() - t0) / SR_ITERS
    eval_rate = 1 / dt
    eval_peak = torch.cuda.max_memory_allocated() / 2**30
    eval_ms = cuda_time_ms(lambda: api.eval_step(model, batch, 1000), 3,
                           warmup=1)
    log(f"[sunrgbd] 18.1 inference: {eval_rate:.3f} scenes/s ({dt * 1e3:.2f} "
        f"ms a scene: eval_step + host rotated NMS, one view), eval_step "
        f"{eval_ms:.3f} ms, peak memory {eval_peak:.2f} GiB; measured on "
        f"{card}")
    ckpt10 = save_checkpoint(os.path.join(root, "ckpt10"), 0, {
        "model": model.state_dict(), "optimizer": {}})
    del model, batch, res
    torch.cuda.empty_cache()

    # ---- 18.2 _fast, 18.3 the perspective split, 18.4 bfloat16 ----
    others = {}
    persp_cfg = family_config(SR_PERSP, files[30])
    persp = api.init_detector(persp_cfg, device="cuda", seed=SEED)
    ckpt30 = save_checkpoint(os.path.join(root, "ckpt30"), 0, {
        "model": persp.state_dict(), "optimizer": {}})
    low = api.init_detector(cfg, ckpt10, device="cuda",
                            compute_dtype=bf16)
    for tag, path, m, c_ in (("18.2", SR_FAST, fast, fast_cfg),
                             ("18.3", SR_PERSP, persp, persp_cfg),
                             ("18.4 bf16", SR_V1, low, cfg)):
        b = api.device_batch(m, build_dataset(c_.data["test"],
                                              test_mode=True)[0])
        r, launches = candidates(m, b, f"{tag} eval_step")
        ms = cuda_time_ms(lambda: api.eval_step(m, b, 1000), 3, warmup=1)
        n_ms, n_kept = host_nms(r, c_)
        others[tag] = dict(eval_ms=ms, nms_ms=n_ms, kept=n_kept)
        log(f"[sunrgbd] {tag} {path}: {m.head_type} (V1 {m.uses_v1_head}), "
            f"{m.n_classes} classes, volume {m.n_voxels}, "
            f"{str(m.compute_dtype).split('.')[-1]}: eval_step {ms:.3f} ms, "
            f"launches {named(launches)}; host rotated NMS at score_thr "
            f"{c_.test_cfg['score_thr']}: {n_ms:.2f} ms, kept {n_kept}; "
            f"measured on {card}")
    del fast, persp, low
    torch.cuda.empty_cache()

    # ---- 18.5 tools/test --eval mAP from the files ----
    cli = {}
    for tag, path, ckpt, extra, ious in (
            ("f32", SR_V1, ckpt10, [], (0.25, 0.5)),
            ("perspective", SR_PERSP, ckpt30, [], (0.15,)),
            ("bf16", SR_V1, ckpt10, ["--bf16"], (0.25, 0.5))):
        zero()
        t0 = time.perf_counter()
        metrics = test_cli.main([path, ckpt, "--eval", "mAP", *extra,
                                 "--options", *files[30 if tag ==
                                                     "perspective" else 10]])
        wall = time.perf_counter() - t0
        launches = counts()
        keys = [f"mAP_{t:.2f}" for t in ious] + [f"mAR_{t:.2f}" for t in ious]
        log(f"[sunrgbd] 18.5 tools/test --eval mAP {tag} ({path}, "
            f"{SR_SCENES} scenes of one view from PNG): {wall:.1f} s, "
            f"launches {named(launches)}; " + ", ".join(
                f"{k} {metrics.get(k, float('nan')):.4f}" for k in keys))
        expect(launches, [SR_SCENES, 0, 0, 0, 0], f"18.5 tools/test {tag}")
        if not all(math.isfinite(metrics.get(k, float("nan")))
                   for k in keys):
            raise SystemExit(f"18.5 tools/test {tag}: metrics {metrics}")
        cli[tag] = dict(wall_s=wall, **{k: metrics[k] for k in keys})

    # ---- 18.7 training: tools/train, tools/test, a timed Trainer.step ----
    train_root = os.path.join(root, "train") + "/"
    ann_train = sunrgbd_fixture(train_root, SR_TRAIN_SCENES, 10, SEED + 182,
                                split="train")
    train_opts = [f"data.train.dataset.data_root={train_root}",
                  f"data.train.dataset.ann_file={ann_train}", *files[10]]
    train_runs, train_launches = {}, None
    for tag, path, extra in (("f32", SR_V1, []), ("fast f32", SR_FAST, []),
                             ("bf16", SR_V1, ["--bf16"])):
        per_step, kept = [], {}
        original_init = counted_trainers(api, counters, per_step, kept)
        t0 = time.perf_counter()
        try:
            result = train_cli.main([
                path, "--work-dir", os.path.join(root, "work", tag),
                "--max-steps", str(SR_CLI_STEPS), "--batch-size",
                str(SR_BATCH), "--no-validate", *extra,
                "--options", *train_opts])
        finally:
            api.init_trainer = original_init
        train_s = time.perf_counter() - t0
        names = ("loss", "loss_cls", "loss_centerness", "loss_bbox",
                 "grad_norm")
        for hh, n in zip(result["history"], per_step):
            log(f"[sunrgbd] 18.7 tools/train {tag} ({path}) step "
                f"{hh['step']}: launches {named(n)}; " + ", ".join(
                    f"{k} {hh[k]:.5g}" for k in names + ("n_pos",)))
            if not all(math.isfinite(float(hh[k])) for k in names):
                raise SystemExit(f"18.7 tools/train {tag}: step {hh}")
        if per_step != [[SR_BATCH, SR_BATCH, 0, 0, 0]] * SR_CLI_STEPS:
            raise SystemExit(f"18.7 tools/train {tag} launches a step "
                             f"{per_step}")
        train_launches = train_launches or per_step[0]
        zero()
        t0 = time.perf_counter()
        metrics = test_cli.main([path, result["checkpoints"][-1], "--eval",
                                 "mAP", *extra, "--options", *files[10]])
        test_s = time.perf_counter() - t0
        expect(counts(), [SR_SCENES, 0, 0, 0, 0], f"18.7 tools/test {tag}")
        maps = {k: v for k, v in metrics.items()
                if k.startswith(("mAP", "mAR"))}
        if not maps or not all(math.isfinite(v) for v in maps.values()):
            raise SystemExit(f"18.7 tools/test {tag}: metrics {metrics}")

        # the CLI's own Trainer, timed on the last batch it stepped on
        tr, tbatch = kept["trainer"], kept["batch"]
        tr.step = kept["step"]
        hist, dt, launches, peak = timed_steps(tr, tbatch, counters, iters=3,
                                               warmup=1)
        expect(launches, [3 * SR_BATCH, 3 * SR_BATCH, 0, 0, 0],
               f"18.7 Trainer.step {tag} (3 steps)")
        step_stages = step_stage_times(tr, tbatch, iters=2)
        iou_ms, n_points = rotated_iou_ms(tr.model, tbatch)
        step_ms = sum(step_stages.values())
        train_runs[tag] = dict(
            cli_train_s=train_s, cli_test_s=test_s, steps_per_s=1 / dt,
            step_ms=dt * 1e3, peak_gib=peak / 2**30, stages=step_stages,
            rotated_iou_ms=iou_ms, rotated_iou_share=iou_ms / step_ms,
            points=n_points, loss=float(hist[-1]["loss"]),
            grad_norm=float(hist[-1]["grad_norm"]), **maps)
        log(f"[sunrgbd] 18.7 {tag} ({path}): tools/train {SR_CLI_STEPS} "
            f"steps of {SR_BATCH} scenes {train_s:.1f} s, tools/test "
            f"--eval mAP {test_s:.1f} s (" + ", ".join(
                f"{k} {v:.4f}" for k, v in maps.items()) + f"); "
            f"its Trainer.step {dt * 1e3:.2f} ms ({1 / dt:.3f} steps/s, "
            f"host clock after a warm-up step), peak memory "
            f"{peak / 2**30:.2f} GiB; stages " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in step_stages.items())
            + f"; the rotated 3D IoU loss alone {iou_ms:.3f} ms over "
            f"{SR_BATCH} x {n_points} points ({iou_ms / step_ms:.4f} of "
            f"the stages' sum); measured on {card}")
        del tr, tbatch, kept
        torch.cuda.empty_cache()
    tmp.cleanup()
    wall = time.perf_counter() - t_phase
    log(f"[sunrgbd] phase 18 in {wall:.1f} s")
    return dict(k1=k1, k1_bwd=k1_bwd,
                launches=dict(zip(FC_NAMES, eval_launches)),
                train_launches=dict(zip(FC_NAMES, train_launches)),
                eval_rate=eval_rate, eval_ms=eval_ms, eval_peak_gib=eval_peak,
                stages=stages, others=others, cli=cli, train=train_runs,
                wall_s=wall)


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
    from nerfdet_tpu_torch.data import jpeg, ray_stats
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
    cuda_build.build(cuda_build.KERNELS + (jpeg.LIBRARY,))
    log(f"[build] {len(cuda_build.KERNELS)} CUDA sources and the JPEG "
        f"decoder's host source in {time.perf_counter() - t0:.1f} s")
    for name, (secs, msgs) in cuda_build.BUILD_LOG.items():
        log(f"[build] {os.path.basename(cuda_build._source(name))}: "
            f"{secs:.1f} s")
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
    f32_detection = {}  # phase 4's times, beside phase 11's
    fusion_bwd = check_fusion_backward(voxel, pix, (fh, fw), gen,
                                       "phase 4/7's pix")
    pix_scaled = pixel_indices(intrinsic)
    fusion_bwd_scaled = check_fusion_backward(
        voxel, pix_scaled, (fh, fw), gen,
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
            f32_detection[name] = cuda_time_ms(fn, 3, warmup=1)
            log(f"[stage] {name}: {f32_detection[name]:.3f} ms")

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
    f32_detection["scenes/s"] = iters / dt
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
    files = tempfile.TemporaryDirectory(prefix="chip_smoke_runtime_")
    runtime, runtime_opts = runtime_path(api, voxel, pointnet, render, card,
                                         files.name)
    log(f"[done] phases 1-9 in {time.perf_counter() - t_start:.1f} s")

    # ---- 10. NeRF-Det-R101* (depth_sp): the depth gate, the rgb stream --
    torch.cuda.empty_cache()
    depth = depth_path(api, voxel, pointnet, render, card)
    log(f"[done] phases 1-10 in {time.perf_counter() - t_start:.1f} s")

    # ---- 11. bfloat16 compute (the JAX --bf16 path) ----------------------
    torch.cuda.empty_cache()
    low = bf16_path(api, voxel, pointnet, render, card, pix_scaled, nvs,
                    runtime_opts, f32_detection)
    log(f"[done] phases 1-11 in {time.perf_counter() - t_start:.1f} s")

    # ---- 12. JPEG views read by the port's own decoder --------------------
    torch.cuda.empty_cache()
    decoder = jpeg_path(api, voxel, pointnet, render, card,
                        os.path.join(files.name, "work", "ckpts",
                                     "ckpt_2.pth"), files.name)
    log(f"[done] phases 1-12 in {time.perf_counter() - t_start:.1f} s")

    # ---- 13. data parallel: one process a card, NCCL / gloo -------------
    torch.cuda.empty_cache()
    ddp = ddp_path(api, ray_stats, card, files.name, runtime_opts)
    log(f"[done] phases 1-13 in {time.perf_counter() - t_start:.1f} s")

    # ---- 14. the 2-D data x views sharding: two ranks on this card -------
    torch.cuda.empty_cache()
    mesh = mesh_path(api, render, ray_stats, card, files.name, ddp)
    files.cleanup()
    log(f"[done] phases 1-14 in {time.perf_counter() - t_start:.1f} s")

    # ---- 15. tools/benchmark on the flagship -----------------------------
    torch.cuda.empty_cache()
    bench = bench_path(card)

    # ---- 16. the fast_cov family (NeRF-Det configs typed ImVoxelNet) -----
    torch.cuda.empty_cache()
    family = fast_cov_path(api, voxel, render, card)

    # ---- 17. the indoor ImVoxelNet on ScanNet -----------------------------
    torch.cuda.empty_cache()
    indoor = indoor_path(api, voxel, render, card)

    # ---- 18. the SUN RGB-D ImVoxelNet: one view, yawed, rotated NMS ----
    torch.cuda.empty_cache()
    sunrgbd = sunrgbd_path(api, voxel, render, card)

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
    gated = f"{DEPTH_TRAIN_VIEWS} views"
    rgb_main = depth["rgb"][f"{DEPTH_VIEWS} views"]
    record["kernels"][0]["depth_gated"] = {k: depth["k1"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "phase_a_ms", "phase_b_ms")}
    record["kernels"][3]["depth_gated"] = {k: depth["k1_bwd"][k] for k in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms", "index_ms", "pass1_ms", "pass2_ms", "pass3_ms")}
    record["kernels"].append({
        "name": "fused_mean_cov_rgb",
        "route": "cuda",
        "source": "nerfdet_tpu_torch/csrc/fused_mean_cov.cu",
        "replaces": "nerfdet_tpu/ops/voxel.py:383",
        "launches": depth["launches"],
        "max_abs_err": max(r["max_abs_err"] for r in list(
            depth["rgb"].values()) + [depth["rgb_orig"]]),
        "ms": rgb_main["ms"],
        "device_ms": rgb_main["device_ms"],
        "plain_ms": rgb_main["plain_ms"],
        "bound_ms": rgb_main["bound_ms"],
        "bound_by": rgb_main["bound_by"],
        "library_ms": None,
        "library_of": "none: no one PyTorch call gathers the views' pixels "
                      "and sums them",
        "at_48_views": {k: depth["rgb"][gated][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "kept_pairs")},
        "original_resolution": {k: depth["rgb_orig"][k] for k in (
            "ms", "device_ms", "plain_ms", "bound_ms", "kept_pairs")},
        "kept_share": depth["kept"],
        "runtime_launches": depth["runtime_launches"],  # phase 10's CLI run
    })
    for name, form, source, replaces in (
            ("fused_mean_cov_bf16", low["k1"], "fused_mean_cov.cu",
             "nerfdet_tpu/ops/voxel.py:370"),
            ("fused_mean_cov_backward_bf16", low["k1_bwd"],
             "fused_mean_cov_backward.cu", "nerfdet_tpu/ops/voxel.py:370"),
            ("fused_mean_cov_rgb_bf16", low["rgb"], "fused_mean_cov.cu",
             "nerfdet_tpu/ops/voxel.py:383"),
            ("streaming_sample_mean_var_bf16", low["k2"],
             "streaming_sample_mean_var.cu", "nerfdet_tpu/ops/render.py:162"),
            ("streaming_sample_mean_var_backward_bf16", low["k2_bwd"],
             "streaming_sample_mean_var_backward.cu",
             "nerfdet_tpu/ops/render.py:162")):
        record["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"nerfdet_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": low["launches"][name[:-len("_bf16")]],
            **{k: form[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by",
                                    "library_ms")}})
    record["kernels"][-5]["library_of"] = (
        "phase A: torch.addmm(b, features.float().reshape(-1, C), W) on "
        "the widened rows")
    record["kernels"][-5].update({k: low["k1"][k] for k in (
        "phase_a_ms", "phase_b_ms", "bf16_gemm_ms", "bounds")})
    record["kernels"][-4]["library_of"] = (
        "torch.mm on dY @ W^T and x^T dY over the referenced rows")
    record["kernels"][-4].update({k: low["k1_bwd"][k] for k in (
        "index_ms", "pass1_ms", "pass2_ms", "pass3_ms")})
    record["kernels"][-3]["device_ms"] = low["rgb"]["device_ms"]
    record["kernels"][-2]["training_form"] = low["k2_train"]
    record["kernels"][-1]["library_of"] = (
        "index_add_ of the weighted tap rows (bfloat16) into the flat "
        "feature map: the scatter alone")
    record["kernels"][-1].update({k: v for k, v in low["k2_bwd"].items()
                                  if k.startswith(("pass", "index"))})
    sums = mesh["sums"]["training"]
    record["kernels"].append({
        "name": "streaming_sample_mean_var_sums",
        "route": "cuda",
        "source": "nerfdet_tpu_torch/csrc/streaming_sample_mean_var.cu",
        "replaces": "nerfdet_tpu/ops/render.py:260",
        "launches": mesh["launches"]["streaming_sample_mean_var_sums"],
        "max_abs_err": max(r["max_abs_err"] for r in mesh["sums"].values()),
        **{k: sums[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "eval_form": mesh["sums"]["eval"],
        "library_of": "none: no one PyTorch call samples the views and sums "
                      "them",
    })
    for entry in record["kernels"]:  # phase 13.1's run with --distributed
        entry["ddp_launches"] = ddp["launches"].get(entry["name"], 0)
        # phase 14.1's rank 0, its steps at --mesh-views 2
        entry["mesh_launches"] = mesh["launches"].get(entry["name"], 0)
        # phase 16.1's exemplar: 5 joint train steps
        entry["fast_cov_launches"] = family["launches"].get(entry["name"], 0)
    # phase 16.0: the kernels at the fast_cov family's shapes
    by_name = {e["name"]: e for e in record["kernels"]}
    by_name["fused_mean_cov"]["fast_cov"] = dict(
        family["k1"], **family["k1_m16"])
    by_name["fused_mean_cov_backward"]["fast_cov_kG2"] = family["k1_bwd"]
    by_name["fused_mean_cov_rgb"]["fast_cov"] = {
        "ungated": family["rgb"], "depth_gated": family["rgb_gated"]}
    by_name["streaming_sample_mean_var"]["fast_cov_eval_form_c16"] = \
        family["k2"]
    by_name["streaming_sample_mean_var_backward"]["fast_cov_c16"] = \
        family["k2_bwd"]
    shown = ("eval_launches", "eval_rate", "eval_peak_gib", "train_rate",
             "train_peak_gib", "stages", "train_stages", "wall_s")
    log(f"[fast_cov] {json.dumps({k: family[k] for k in shown})}")
    for entry in record["kernels"]:  # phase 17.1: 5 indoor train steps
        entry["indoor_launches"] = indoor["launches"].get(entry["name"], 0)
    # phase 17.0: K1 at the indoor ImVoxelNet's shapes
    by_name["fused_mean_cov"]["indoor_plain_mean"] = dict(
        indoor["k1"], **indoor["k1_fast_depth"],
        **{f"C={k} padded": v for k, r in indoor["narrow"].items()
           for v in r.values()})
    by_name["fused_mean_cov_backward"]["indoor_g1"] = {
        "float32": indoor["k1_bwd"], "bfloat16": indoor["k1_bwd_bf16"],
        **{f"C={k} padded": v for k, v in indoor["narrow_bwd"].items()}}
    shown += ("fast", "eval_ms", "bf16_eval_ms", "kept_fast_depth")
    log(f"[indoor] {json.dumps({k: indoor[k] for k in shown})}")
    for entry in record["kernels"]:  # phase 18.1: one SUN RGB-D scene
        entry["sunrgbd_launches"] = sunrgbd["launches"].get(entry["name"], 0)
        # phase 18.7: a tools/train step of 4 SUN RGB-D scenes
        entry["sunrgbd_train_launches"] = sunrgbd["train_launches"].get(
            entry["name"], 0)
    # phase 18.0: K1 at one view (imvoxelnet_sunrgbd.py, _fast)
    by_name["fused_mean_cov"]["sunrgbd_one_view"] = sunrgbd["k1"]
    # phase 18.6: its s1-only backward at one view
    by_name["fused_mean_cov_backward"]["sunrgbd_one_view_g1"] = \
        sunrgbd["k1_bwd"]
    shown = ("eval_rate", "eval_ms", "eval_peak_gib", "stages", "others",
             "cli", "train", "wall_s")
    log(f"[sunrgbd] {json.dumps({k: sunrgbd[k] for k in shown})}")
    log(f"[done] phases 1-18 in {time.perf_counter() - t_start:.1f} s")
    shown = {k: v for k, v in ddp.items() if k != "launches" and k[0] != "_"}
    log(f"[ddp] {json.dumps(shown)}")
    log(f"[mesh] {json.dumps({k: v for k, v in mesh.items() if k != 'sums'})}")
    log(f"[bench] {json.dumps(bench)}")
    log(f"[jpeg] {json.dumps(decoder)}")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
