"""Time K2's forward, K2's backward and K1's backward of one checkout on
the card, the backwards pass by pass, for comparing two designs of them
in one call.

    python3 kernel_ab.py [CHECKOUT] [--save OUT.pt] [--profile] [--forward]
    python3 kernel_ab.py [CHECKOUT] --fusion [--save OUT.pt]
    python3 kernel_ab.py [CHECKOUT] --sort [--save OUT.pt] [--profile]
    python3 kernel_ab.py --compare A.pt B.pt
    python3 kernel_ab.py --ablate
    python3 kernel_ab.py --ablate-backward
    python3 kernel_ab.py --ablate-fusion

Imports ``nerfdet_tpu_torch`` from CHECKOUT (default: this file's
directory), building its kernels there, and makes the inputs of
``chip_smoke.py`` (this directory's) from their seeds: NeRF-Det-R50 at
full width with random weights, phase 4's pixel indices (the intrinsic as
the synthetic scene gives it) and phase 8's (scaled to ``ori_shape``),
and phase 8's training batch (2048 rays x 64 samples over 50 views of
59x80x32 mapped maps). With CUDA events it times K2's forward in both
forms and both dtypes (``_k2_launch``: the eval form at phase 6's first
render chunk, the training form with the host rgb sums at phase 8's
batch under grad, each on float32 maps and on the same maps in
bfloat16), K2's backward on float32 maps and on the same maps in
bfloat16 (whole; pass 0, the index preparation and each later pass: on
float32 maps passes 1 and 2; on bfloat16 maps passes 1 and 2 in the
window-walk design, passes 1a, 1b and 2 in the slot design) and K1's
backward at both pixel indices on float32 maps and on the same maps in
bfloat16 (whole; the index preparation, passes 1, 2 and 3), C = 256, M =
32 and no s2 cotangent as on the training path. A design without a pass's own
entry point reports what the whole leaves after the passes it has
("rest"). With ``--save`` it writes the backwards' outputs in both
dtypes, which ``--compare`` holds bit for bit against another
checkout's (phase A's rows and s2m within 1e-5 relative: their C-long dot
products may run in another order; it exits 1 where a key misses). With ``--profile`` it also prints each backward's device
time by kernel (``torch.profiler``, 5 calls). With ``--forward`` it
times K2's forward alone. With ``--fusion`` it times K1's forward and
the rgb stream instead: K1 on bfloat16 maps in the training path's form
(maps, W and b requiring a gradient) at phase 8's indices and without a
gradient at phase 4's, and on float32 maps at phase 4's (phase 3's form),
each whole, phase A (``_mapped_rows_launch``) and phase B
(``_carry_launch``) apart; the rgb stream (``_rgb_launch``) at phase 10's
depth-gated indices, 100 views of float32 images and 50 of bfloat16
(R101*'s scenes), its device time from a full queue
(``chip_smoke.queued_time_ms``: the kernel is shorter than its wrapper's
host work) beside the wrapper's back to back; ``--save`` then writes
count, s1, s2, s2m, phase A's rows, s1e and s2e. With ``--sort`` it
times the backwards' counting sort (``csrc/counting_sort.cuh``) alone,
back to back and from a full queue: K1's ``pixel_order`` at SUN RGB-D's
one view (``SORT_CASES``: 204,800 and 25,600 voxels into 120x160
pixels) and at the indoor ImVoxelNet's 20 views, and K1's g1-only
backward there (C = 64); K2's ``_window_order_launch`` and its rank form
at phase 8's 50 views (131,072 points, 4,720 windows a view). The keys
are random from a seed at each case's share of valid pairs, not a
scene's; ``--save`` writes the sorts' outputs (the entries the sort
leaves unspecified dropped), ``--profile`` each sort's kernels. ``--ablate-fusion``
times phase A, phase B and the rgb stream with each of FUSION_VARIANTS
(text edits of ``csrc/fused_mean_cov.cu``: ring stages, group depths,
loads) built into a library of its own. Prints one line of times and the card.
``--ablate`` builds this checkout's K2 four more times with its gathers
replaced by values made from the address (no feature-map loads; no
image loads; neither) or without the integer widening of its bfloat16
texels, each computing garbage with the same floating-point arithmetic,
and times K2's forward with each: what the gathers and the widening
cost. ``--ablate-backward`` prints the skew of the bfloat16 backwards'
work (pairs a K1 row and batch of rows, pairs a K2 window) and times
K1's pass 1 and K2's passes 1a and 1b on bfloat16 maps with a cost
removed in turn by a text edit of the source (``BWD_VARIANTS``: K1's
batches of adjacent rows, loads, copies, the bfloat16 roundings). Run
two checkouts in turns (A B B A) in one call: calls may land on cards of
other power limits.
"""

import importlib.util
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def timed(fn, iters=20):
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k2_times(render, bargs, out, tag=""):
    """K2's backward, pass by pass where the design has them (``tag``
    "_bf16" on bfloat16 maps)."""
    hw_img, feats = bargs[2], bargs[3]
    n_win = feats.shape[1] * feats.shape[2]
    t = {f"k2{tag}_bwd": timed(
        lambda: render.streaming_sample_mean_var_backward(*bargs), 10)}
    out[f"k2{tag}_bwd"] = render.streaming_sample_mean_var_backward(*bargs)
    keys, coef = render._backward_keys(*bargs)
    t[f"k2{tag}_pass0"] = timed(lambda: render._backward_keys(*bargs), 10)
    if tag and hasattr(render, "_pair_df"):  # the slot design's passes
        rank, off = render._window_rank_launch(keys, n_win)
        t[f"k2{tag}_index"] = timed(
            lambda: render._window_rank_launch(keys, n_win), 10)
        t[f"k2{tag}_pass1a"] = timed(
            lambda: render._pair_df(*bargs, rank), 10)
        df, wts = render._pair_df(*bargs, rank)
        t[f"k2{tag}_pass1b"] = timed(
            lambda: render._window_sums_bf16(df, wts, off, feats), 10)
        packed = render._window_sums_bf16(df, wts, off, feats)
        t[f"k2{tag}_pass2"] = timed(lambda: render._unpack(packed, off,
                                                           feats), 10)
    elif hasattr(render, "_window_sums"):
        order, off = render._window_order_launch(keys, n_win)
        t[f"k2{tag}_index"] = timed(
            lambda: render._window_order_launch(keys, n_win), 10)
        pts, proj = bargs[0], bargs[1]
        t[f"k2{tag}_pass1"] = timed(lambda: render._window_sums(
            pts, proj, hw_img, feats, coef, order, off), 10)
        packed = render._window_sums(pts, proj, hw_img, feats, coef, order,
                                     off)
        t[f"k2{tag}_pass2"] = timed(lambda: render._unpack(packed, off,
                                                           feats), 10)
    else:
        keys2 = keys.reshape(-1)
        t[f"k2{tag}_index"] = timed(lambda: render.window_order(
            keys2, feats.shape[0] * n_win), 10)
        t[f"k2{tag}_rest"] = (t[f"k2{tag}_bwd"] - t[f"k2{tag}_pass0"]
                              - t[f"k2{tag}_index"])
    return t


def k2_forward_times(render, eval_args, train_args, out):
    """K2's forward: the eval form and the training form (host rgb sums,
    s1u written for the backward), on float32 maps and in bfloat16."""
    import torch

    t = {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        pts, images, proj, hw, feats = eval_args
        args = (pts, images.to(dtype), proj, hw, feats.to(dtype))
        t[f"k2_eval_{tag}"] = timed(lambda: render._k2_launch(*args))
        out[f"k2_eval_{tag}"] = list(render._k2_launch(*args)[:2])
        pts, proj, hw, feats, host = train_args
        args = (pts, None, proj, hw, feats.to(dtype), host)
        t[f"k2_train_{tag}"] = timed(lambda: render._k2_launch(
            *args, for_grad=True))
        out[f"k2_train_{tag}"] = list(render._k2_launch(
            *args, for_grad=True)[:3])
    torch.cuda.synchronize()
    return t


# K2's gathers and what --ablate puts in their place (the same arithmetic
# on a value made from the address, no memory read), and the widening of
# bfloat16 texels (integer instructions) and what replaces it (the raw
# word, negated for the low channel: a modifier of the floating-point
# instruction that reads it, so no instruction, and no two channels equal)
K2_GATHERS = {
    "features": (
        "const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));",
        "const uint4 q = make_uint4((uint32_t)(uintptr_t)p, 0x3f803f80u, "
        "0x3f803f80u, (uint32_t)(uintptr_t)p >> 3);"),
    "images": (
        "return widen(__ldg(reinterpret_cast<const unsigned short*>(p)));",
        "return __uint_as_float(((uint32_t)(uintptr_t)p & 0xffffu) << 16);"),
    "widening": (
        "return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u\n"
        "                                 : w[e >> 1] << 16);",
        "return e & 1 ? __uint_as_float(w[e >> 1])\n"
        "             : -__uint_as_float(w[e >> 1]);"),
}


def build_variants(flag, variants, real, entries):
    """Build each of ``variants`` ((label, source, [(old, new), ...]):
    exact-text edits of ``csrc/<source>.cu``) into a library of its own,
    every nvcc started at once, and type each function of ``entries``
    that the real library ``real[source]`` has as the real one is typed.
    Returns [(label, source, library)] in the order given."""
    import ctypes

    from nerfdet_tpu_torch.ops import cuda_build

    out_dir = os.path.join(cuda_build.BUILD_DIR, flag.lstrip("-"))
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for i, (label, source, edits) in enumerate(variants):
        with open(os.path.join(cuda_build.CSRC, f"{source}.cu")) as f:
            src = f.read()
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"kernel_ab {flag}: {label}: the code is "
                                 f"not in the source")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = path[:-3] + ".so"
        jobs.append((label, source, so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC, "-o", so, path],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)))
    built = []
    for label, source, so, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"kernel_ab {flag}: {label} did not build")
        lib = ctypes.CDLL(so)
        for name in entries:
            try:
                ref = getattr(real[source], name)
            except AttributeError:
                continue
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = ref.argtypes, ref.restype
        built.append((label, source, lib))
    return built


def ablate():
    """K2's forward on bfloat16 maps (the 16-byte lane form) with its
    feature gathers, its image gathers, both, or its texel widening
    replaced (K2_GATHERS),
    each built from this checkout's source into its own library and
    timed in place of the real one; the real one first and last."""
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    (render, _), _, _, (eval_args, train_args) = inputs(HERE)
    variants = {"without feature loads": ["features"],
                "without image loads": ["images"],
                "without either": ["features", "images"],
                "without the widening": ["widening"]}
    source = "streaming_sample_mean_var"
    libs = {"real": render._lib()}
    libs.update((label, lib) for label, _, lib in build_variants(
        "--ablate", [(label, source, [K2_GATHERS[g] for g in gathers])
                     for label, gathers in variants.items()],
        {source: libs["real"]}, [source]))
    real_lib = render._lib
    pts, images, proj, hw, feats = eval_args
    bf = torch.bfloat16
    eval_bf = (pts, images.to(bf), proj, hw, feats.to(bf))
    pts, proj, hw, feats, host = train_args
    train_bf = (pts, None, proj, hw, feats.to(bf), host)
    try:
        for name in list(libs) + ["real"]:
            render._lib = lambda lib=libs[name]: lib
            e = timed(lambda: render._k2_launch(*eval_bf))
            t = timed(lambda: render._k2_launch(*train_bf, for_grad=True))
            print(f"[kernel_ab] ablate K2 bf16 {name}: eval form {e:.4f} ms, "
                  f"training form {t:.4f} ms", flush=True)
    finally:
        render._lib = real_lib
    return 0


# The bfloat16 backwards' costs, each removed by a text edit of this
# checkout's source (the same floating-point work on values made from the
# address where a load goes, or no rounding): (library, variant, [(old,
# new), ...]). The first K1 variant restores the batches of 32 adjacent
# pixel rows the interleaved batches replaced.
BWD_VARIANTS = [
    ("fused_mean_cov_backward", "pass 1 on batches of adjacent rows", [
        ("    const long long r = bt + lane * batches;",
         "    const long long r = bt * 32 + lane;"),
        ("      uint16_t* out = dfeat + (size_t)(bt + k * batches) * kC + "
         "lane * kW;",
         "      uint16_t* out = dfeat + (size_t)(bt * 32 + k) * kC + "
         "lane * kW;"),
        ("        ring_r[k] = (int)(bt + i * batches);",
         "        ring_r[k] = (int)(bt * 32 + i);")]),
    ("fused_mean_cov_backward", "pass 1 without bf16 roundings", [
        ("  return __bfloat162float(__float2bfloat16_rn(x));",
         "  return x;"),
        ("  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);\n"
         "  const unsigned u = *reinterpret_cast<const unsigned*>(&h);\n"
         "  a = __uint_as_float(u << 16);  // a in the low half\n"
         "  b = __uint_as_float(u & 0xffff0000u);", "")]),
    ("streaming_sample_mean_var_backward", "pass 1a without its tap loads", [
        ("      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));",
         "      const uint4 q = make_uint4((unsigned)(size_t)p, 0x3f803f80u, "
         "0x3f803f80u, (unsigned)(size_t)p >> 3);")]),
    ("streaming_sample_mean_var_backward", "pass 1b without its df copies", [
        ("          cp_async16(dst + (b - lo), src + b);",
         "          if (b < 0) cp_async16(dst + (b - lo), src + b);")]),
    ("streaming_sample_mean_var_backward", "passes 1a, 1b without bf16 "
     "roundings", [
        ("  return __bfloat162float(__float2bfloat16_rn(x));",
         "  return x;"),
        ("  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);\n"
         "  const unsigned u = *reinterpret_cast<const unsigned*>(&h);\n"
         "  a = __uint_as_float(u << 16);  // a in the low half\n"
         "  b = __uint_as_float(u & 0xffff0000u);", ""),
        ("      const __nv_bfloat162 h = __floats2bfloat162_rn(x[e], "
         "x[e + 1]);\n      x[e] = __low2float(h);\n"
         "      x[e + 1] = __high2float(h);", "")]),
]


def ablate_backward():
    """The skew of the bfloat16 backwards' work at the A/B's inputs (K1:
    pairs a pixel row and a batch of 32 rows, adjacent or interleaved;
    K2: pairs a window), then K1's pass 1 and K2's passes 1a and 1b with
    each of BWD_VARIANTS built from this checkout's source into its own
    library and timed in place of the real one (the real one first and
    last)."""
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    (render, voxel), k1, k2, _ = inputs(HERE)
    feats = k1["feats"].bfloat16()
    mapped = voxel.mapped_rows_plain(feats, k1["w"], k1["b"])
    hw = feats.shape[1] * feats.shape[2]
    k1_args = {}
    for tag, pix in k1["pix"].items():
        order, off, _, _ = voxel.pixel_order(pix, hw)
        cnt = (off[:, 1:] - off[:, :-1]).flatten()
        k1_args[tag] = (feats, order, off, k1["g1"], None, k1["gm"], mapped,
                        k1["w"])
        pad = torch.nn.functional.pad(cnt, (0, -cnt.numel() % 32))
        adjacent = pad.reshape(-1, 32).sum(1)
        inter = pad.reshape(32, -1).sum(0)
        print(f"[kernel_ab] K1 {tag}: {int(cnt.sum())} pairs, "
              f"{int((cnt > 0).sum())} referenced rows, at most "
              f"{int(cnt.max())} pairs a row; a batch of 32 rows: mean "
              f"{float(adjacent.float().mean()):.1f} pairs, at most "
              f"{int(adjacent.max())} adjacent, {int(inter.max())} "
              f"interleaved", flush=True)
    bargs = k2["_bf16"]
    v, fh, fw, _ = bargs[3].shape
    keys, _ = render._backward_keys(*bargs)
    rank, off = render._window_rank_launch(keys, fh * fw)
    df, wts = render._pair_df(*bargs, rank)
    length = (off[1:] - off[:-1]).float()
    held = length[length > 0]
    print(f"[kernel_ab] K2: {int(off[-1])} kept pairs in {held.numel()} of "
          f"{length.numel()} windows: mean {float(held.mean()):.1f}, p99 "
          f"{float(held.quantile(0.99)):.0f}, at most {int(length.max())} "
          f"a window", flush=True)
    real = {"fused_mean_cov_backward": voxel._backward_lib(),
            "streaming_sample_mean_var_backward": render._backward_lib()}
    runs = [(name, "real", real[name]) for name in real]
    runs += [(name, label, lib) for label, name, lib in build_variants(
        "--ablate-backward", [(label, name, subs)
                              for name, label, subs in BWD_VARIANTS],
        real, [f"{name}_{attr}" for name in real for attr in (
            "pixels", "parts", "tile", "order", "weights", "reduce", "keys",
            "rank", "windows", "pairs", "windows_bf16", "unpack")])]
    runs += [(name, "real", real[name]) for name in real]
    modules = {"fused_mean_cov_backward": voxel,
               "streaming_sample_mean_var_backward": render}
    for name, label, lib in runs:
        module = modules[name]
        keep = module._backward_lib
        module._backward_lib = lambda lib=lib: lib
        try:
            if module is voxel:
                times = ", ".join(
                    f"{tag} {timed(lambda: voxel._pixel_sums(*a)):.4f}"
                    for tag, a in k1_args.items())
                print(f"[kernel_ab] ablate K1 bf16 pass 1, {label}: "
                      f"{times} ms", flush=True)
            else:
                t1a = timed(lambda: render._pair_df(*bargs, rank), 10)
                t1b = timed(lambda: render._window_sums_bf16(
                    df, wts, off, bargs[3]), 10)
                print(f"[kernel_ab] ablate K2 bf16, {label}: pass 1a "
                      f"{t1a:.4f} ms, pass 1b {t1b:.4f} ms", flush=True)
        finally:
            module._backward_lib = keep
    return 0


# K1's forward and the rgb stream with one design choice changed by a
# text edit of this checkout's source: (label, [(old, new), ...]).
FUSION_VARIANTS = [
    ("phase A ring of 6 stages", [
        ("constexpr int kStagesTc = 4;", "constexpr int kStagesTc = 6;")]),
    ("phase A without its mma", [
        ("          mma_bf16(acc[mi][0], a[ks][mi], bq[0], bq[1]);\n"
         "          mma_bf16(acc[mi][1], a[ks][mi], bq[2], bq[3]);", "")]),
    ("phase A without its stores", [
        ("              *reinterpret_cast<float2*>(o) = make_float2(y0, y1);",
         "              if (y0 == 12345.f)\n"
         "                *reinterpret_cast<float2*>(o) = make_float2(y0, y1);"
         )]),
    ("phase B bf16 groups of 8 views", [
        ("return sizeof(T) == 4 ? 1 : 32 / (cpl > 8 ? cpl : 8);",
         "return sizeof(T) == 4 ? 1 : 64 / (cpl > 8 ? cpl : 8);")]),
    ("phase B bf16 groups of 16 views", [
        ("return sizeof(T) == 4 ? 1 : 32 / (cpl > 8 ? cpl : 8);",
         "return sizeof(T) == 4 ? 1 : 128 / (cpl > 8 ? cpl : 8);")]),
    ("phase B f32 groups of 4 views", [
        ("return sizeof(T) == 4 ? 1 : 32 / (cpl > 8 ? cpl : 8);",
         "return 32 / (cpl > 8 ? cpl : 8);")]),
    ("rgb with the next pass's indices in flight", [
        ("  float acc = 0.f;\n"
         "  for (int v0 = 0; v0 < n_views; v0 += kViewsRgb) {",
         "  float acc = 0.f;\n  int p[kAheadRgb], q[kAheadRgb];\n"
         "  for (int k = 0; k < kAheadRgb; ++k) {\n"
         "    const int v = warp + kWarpsRgb * k;\n"
         "    q[k] = v < n_views && n < n_vox\n"
         "               ? __ldg(pix + static_cast<size_t>(v) * n_vox + n)\n"
         "               : -1;\n  }\n"
         "  for (int v0 = 0; v0 < n_views; v0 += kViewsRgb) {"),
        ("    int p[kAheadRgb];\n#pragma unroll\n"
         "    for (int k = 0; k < kAheadRgb; ++k) {\n"
         "      const int v = v0 + warp + kWarpsRgb * k;\n"
         "      p[k] = v < n_views",
         "#pragma unroll\n    for (int k = 0; k < kAheadRgb; ++k) "
         "p[k] = q[k];\n#pragma unroll\n"
         "    for (int k = 0; k < kAheadRgb; ++k) {\n"
         "      const int v = v0 + kViewsRgb + warp + kWarpsRgb * k;\n"
         "      q[k] = v < n_views")]),
    ("phase B without mapped loads", [
        ("              y[i][k] = __ldg(mapped + ((size_t)v * hw + p[i][k]) "
         "* n_map +\n                              lane);",
         "              y[i][k] = __int_as_float(p[i][k] | lane);")]),
]


def ablate_fusion():
    """Phase A on bfloat16 maps, phase B (bfloat16 at phase 8's and phase
    4's indices, float32 at phase 4's) and the rgb stream (device time,
    100 views f32, 50 bf16) with each of FUSION_VARIANTS built from this
    checkout's source into its own library and timed in place of the
    real one (the real one first and last)."""
    import torch

    from nerfdet_tpu_torch import api
    from nerfdet_tpu_torch.ops import cuda_build, voxel

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    dev = torch.device("cuda")
    _build(cuda_build, ["fused_mean_cov"])
    _, _, _, k1, _ = k1_inputs(smoke, api, voxel, dev)
    depth = api.init_detector(smoke.DEPTH_CONFIG, device="cuda",
                              seed=smoke.SEED)
    rgb = {}
    for tag, views, dtype in (("f32_100", smoke.DEPTH_VIEWS, torch.float32),
                              ("bf16_50", smoke.BF16_DEPTH_VIEWS,
                               torch.bfloat16)):
        scene = smoke.depth_scene(depth, smoke.SEED + 2, views)
        rgb[tag] = (torch.as_tensor(scene["denorm_images"],
                                    device=dev).to(dtype),
                    smoke.gated_streams(voxel, depth, scene, dev)["rgb"][0])
    real = voxel._lib()
    runs = [("real", real)]
    runs += [(label, lib) for label, _, lib in build_variants(
        "--ablate-fusion", [(label, "fused_mean_cov", edits)
                            for label, edits in FUSION_VARIANTS],
        {"fused_mean_cov": real}, [f"fused_mean_cov_{name}" for name in (
            "mapped_rows", "mapped_rows_smem", "carry", "rgb")])]
    runs.append(("real", real))
    w, b = k1["w"], k1["b"]
    bf = k1["feats"].bfloat16()
    keep_lib = voxel._lib
    for label, lib in runs:
        voxel._lib = lambda lib=lib: lib
        try:
            t = {"A bf16": timed(lambda: voxel._mapped_rows_launch(bf, w, b))}
            for dtag, feats in (("bf16", bf), ("f32", k1["feats"])):
                rows = voxel._mapped_rows_launch(feats, w, b)
                for where, pix in k1["pix"].items():
                    if dtag == "f32" and where == "phase8":
                        continue
                    t[f"B {dtag} {where}"] = timed(
                        lambda: voxel._carry_launch(feats, pix, rows, b))
                del rows
            for tag, (images, pix) in rgb.items():
                t[f"rgb {tag}"] = smoke.queued_time_ms(
                    lambda: voxel._rgb_launch(images, pix))
        finally:
            voxel._lib = keep_lib
        print(f"[kernel_ab] ablate fusion, {label}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in t.items()) + " ms", flush=True)
    print(f"[kernel_ab] ablate fusion on {_card()}", flush=True)
    return 0


def k1_times(voxel, tag, feats, pix, w, b, g1, gm, out):
    """K1's backward, pass by pass where the design has them (``tag``
    ends in "_bf16" on bfloat16 maps)."""
    import torch

    count = (pix >= 0).float().sum(0)
    mapped = voxel.mapped_rows_plain(feats, w, b)
    args = (feats, pix, count, g1, None, gm, w, b, mapped)
    hw = feats.shape[1] * feats.shape[2]
    t = {f"k1_bwd_{tag}": timed(lambda: voxel.fusion_carry_backward(*args))}
    out[f"k1_bwd_{tag}"] = voxel.fusion_carry_backward(*args)
    t[f"k1_index_{tag}"] = timed(lambda: voxel.pixel_order(pix, hw))
    if hasattr(voxel, "_pixel_sums"):
        order, off, rows, n_rows = voxel._pixel_order_launch(pix, hw)
        t[f"k1_pass1_{tag}"] = timed(lambda: voxel._pixel_sums(
            feats, order, off, g1, None, gm, mapped, w))
        _, dy = voxel._pixel_sums(feats, order, off, g1, None, gm, mapped, w)
        t[f"k1_pass2_{tag}"] = timed(lambda: voxel._weight_parts(
            feats, dy, rows, n_rows, gm, count))
        parts = voxel._weight_parts(feats, dy, rows, n_rows, gm, count)
        t[f"k1_pass3_{tag}"] = timed(lambda: voxel._weight_reduce(*parts, b))
    else:
        t[f"k1_rest_{tag}"] = t[f"k1_bwd_{tag}"] - t[f"k1_index_{tag}"]
    torch.cuda.synchronize()
    return t


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _build(cuda_build, names):
    cuda_build.build(names)
    for name, (_, log) in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"[ptxas] {name}: {line.strip()}")


def k1_inputs(smoke, api, voxel, dev):
    """The R50 model, phase 4's scene, its intrinsic scaled to
    ``ori_shape``, K1's inputs from their seeds (the maps, W, b and
    cotangents with each intrinsic's ``pix``) and the generator, which
    the caller draws on."""
    import numpy as np
    import torch

    from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene

    model = api.init_detector(smoke.CONFIG, device="cuda", seed=smoke.SEED)
    meta = model.meta
    h, w = meta.img_shape
    stride = 4
    fh, fw = meta.pad_shape[0] // stride, meta.pad_shape[1] // stride
    scene = make_synthetic_scene(
        seed=smoke.SEED, n_views=smoke.N_VIEWS, n_targets=1, hw=(h, w),
        pad_hw=meta.pad_shape,
        n_rand=(h - 2 * smoke.MARGIN) * (w - 2 * smoke.MARGIN), n_boxes=4,
        max_gt=8, margin=smoke.MARGIN)
    points = voxel.get_points(model.n_voxels, model.voxel_size,
                              scene["origin"], dev).reshape(-1, 3)
    scaled = scene["intrinsic"].copy()
    scaled[:2] *= np.float32(meta.ori_shape[0] / h)

    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    c, m = 256, 32
    n_vox = points.shape[0]
    k1 = dict(feats=torch.randn((smoke.N_VIEWS, fh, fw, c), generator=gen,
                                device=dev),
              w=torch.randn((c, m), generator=gen, device=dev) / c ** 0.5,
              b=torch.randn((m,), generator=gen, device=dev),
              g1=torch.randn((n_vox, c), generator=gen, device=dev),
              gm=torch.randn((n_vox, m), generator=gen, device=dev), pix={})
    for tag, k in (("phase4", scene["intrinsic"]), ("phase8", scaled)):
        proj = voxel.compute_projection(k, scene["extrinsics"],
                                        meta.ori_shape[0] / (h / stride), dev)
        x, y, _, valid = voxel.project_points(points, proj, h // stride,
                                              w // stride)
        k1["pix"][tag] = voxel.pixel_index(x, y, valid, fw).contiguous()
    return model, scene, scaled, k1, gen


def inputs(root):
    """The checkout's modules and the A/B's inputs, from their seeds: for
    K1 the maps, W, b and cotangents with each intrinsic's ``pix``; for
    K2 its backward's arguments at phase 8's training batch on float32
    maps and on the same maps in bfloat16 (keys "" and "_bf16"), and its
    forward's in both forms."""
    sys.path.insert(0, root)
    import torch

    from nerfdet_tpu_torch import api
    from nerfdet_tpu_torch.data import ray_stats
    from nerfdet_tpu_torch.ops import cuda_build, render, voxel

    smoke = _smoke()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build(cuda_build, [k for k in cuda_build.KERNELS if "mean" in k])
    model, scene, scaled, k1, gen = k1_inputs(smoke, api, voxel, dev)
    meta = model.meta
    h, w = meta.img_shape

    tscene, _ = smoke.host_ray_stream(ray_stats, model,
                                      smoke.train_scene(model,
                                                        smoke.SEED + 1))
    with torch.no_grad():
        tfeats = model.render_featmaps(model.extract_2d(
            torch.as_tensor(tscene["imgs"], device=dev)))
    ray = {k: torch.as_tensor(tscene[k], device=dev) for k in (
        "ray_o", "ray_d") + ray_stats.RAY_STREAM_KEYS}
    pts = render.points_at(ray["ray_o"], ray["ray_d"], ray["z_vals"])
    proj = model.render_projection(tscene["intrinsic"],
                                   tscene["extrinsics"], dev)
    host = tuple(ray[k] for k in ray_stats.RAY_STREAM_KEYS[1:])
    gf, _, s1u, cnt = render._k2_launch(pts, None, proj, (h, w), tfeats,
                                        host, for_grad=True)
    g = torch.randn(gf.shape, generator=gen, device=dev)
    k2 = {"": (pts, proj, (h, w), tfeats, g, gf, s1u, cnt)}
    bfeats = tfeats.bfloat16()
    gf, _, s1u, cnt = render._k2_launch(pts, None, proj, (h, w), bfeats,
                                        host, for_grad=True)
    k2["_bf16"] = (pts, proj, (h, w), bfeats, g, gf, s1u, cnt)
    nvs = smoke.nvs_dataset(dict(scene, intrinsic=scaled),
                            scene["intrinsic"], (h, w))
    _, epts, eimgs, efeats, eproj, _ = smoke.ray_cases(
        model, nvs[0], api.render_batch(model, nvs[0]), (h, w))[0]
    k2_fwd = ((epts, eimgs, eproj, (h, w), efeats),
              (pts, proj, (h, w), tfeats, host))
    return (render, voxel), k1, k2, k2_fwd


def fusion(root, save):
    """K1's forward and the rgb stream of one checkout (``--fusion``)."""
    sys.path.insert(0, root)
    import torch

    from nerfdet_tpu_torch import api
    from nerfdet_tpu_torch.ops import cuda_build, voxel

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    _build(cuda_build, ["fused_mean_cov"])
    _, _, _, k1, _ = k1_inputs(smoke, api, voxel, dev)
    out, t = {}, {}
    w, b = k1["w"], k1["b"]
    forms = (("k1_bf16_grad_phase8", torch.bfloat16, "phase8", True),
             ("k1_bf16_phase4", torch.bfloat16, "phase4", False),
             ("k1_f32_phase4", torch.float32, "phase4", False))
    for tag, dtype, where, grad in forms:
        feats, pix = k1["feats"].to(dtype), k1["pix"][where]
        args = ((feats.requires_grad_(), pix, w.clone().requires_grad_(),
                 b.clone().requires_grad_()) if grad else (feats, pix, w, b))
        with torch.set_grad_enabled(grad):
            t[tag] = timed(lambda: voxel.fusion_carry(*args))
        with torch.no_grad():
            got = voxel.fusion_carry(*args)
            fd = feats.detach()
            rows = voxel._mapped_rows_launch(fd, w, b)
            t[f"{tag}_A"] = timed(lambda: voxel._mapped_rows_launch(fd, w, b))
            t[f"{tag}_B"] = timed(lambda: voxel._carry_launch(fd, pix, rows,
                                                             b))
        for name, x in zip(("s1", "s2", "count", "s2m", "rows"),
                           list(got) + [rows]):
            out[f"{tag}_{name}"] = x.detach()
        del feats, args, got, rows
    del k1
    torch.cuda.empty_cache()
    depth = api.init_detector(smoke.DEPTH_CONFIG, device="cuda",
                              seed=smoke.SEED)
    for tag, views, dtype in (("rgb_f32_100", smoke.DEPTH_VIEWS,
                               torch.float32),
                              ("rgb_bf16_50", smoke.BF16_DEPTH_VIEWS,
                               torch.bfloat16)):
        scene = smoke.depth_scene(depth, smoke.SEED + 2, views)
        pix = smoke.gated_streams(voxel, depth, scene, dev)["rgb"][0]
        images = torch.as_tensor(scene["denorm_images"], device=dev).to(dtype)
        t[tag] = smoke.queued_time_ms(lambda: voxel._rgb_launch(images, pix))
        t[f"{tag}_wrapper"] = timed(lambda: voxel._rgb_launch(images, pix),
                                    50)
        out[f"{tag}_s1e"], out[f"{tag}_s2e"] = voxel._rgb_launch(images, pix)
        print(f"[kernel_ab] {tag}: {int((pix >= 0).sum())} kept pairs of "
              f"{pix.numel()}", flush=True)
    torch.cuda.synchronize()
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        torch.save(out, save)
    print(f"[kernel_ab] {root} --fusion: " + " ".join(
        f"{k}={v:.4f}" for k, v in t.items())
        + f" ({time.strftime('%H:%M:%S')}; {_card()})", flush=True)
    return 0


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def profile(name, fn, iters=5):
    """Device microseconds a call of ``fn``, by kernel."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
        if e.device_time_total > 0:
            print(f"[kernel_ab] profile {name}: "
                  f"{e.device_time_total / iters:.1f} us x{e.count // iters} "
                  f"{e.key[:100]}", flush=True)


def run(root, save, with_profile, forward_only):
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    (render, voxel), k1, k2, k2_fwd = inputs(root)
    out, t = {}, {}
    t.update(k2_forward_times(render, *k2_fwd, out))
    for dtag, feats in (("", k1["feats"]), ("_bf16", k1["feats"].bfloat16())):
        for tag, pix in ({} if forward_only else k1["pix"]).items():
            t.update(k1_times(voxel, tag + dtag, feats, pix, k1["w"],
                              k1["b"], k1["g1"], k1["gm"], out))
            if with_profile:
                count = (pix >= 0).float().sum(0)
                args = (feats, pix, count, k1["g1"], None, k1["gm"],
                        k1["w"], k1["b"], voxel.mapped_rows_plain(
                            feats, k1["w"], k1["b"]))
                profile(f"K1 backward {tag}{dtag}",
                        lambda: voxel.fusion_carry_backward(*args))
    del k1
    for dtag, bargs in ({} if forward_only else k2).items():
        t.update(k2_times(render, bargs, out, dtag))
        if with_profile:
            profile(f"K2 backward{dtag}",
                    lambda: render.streaming_sample_mean_var_backward(
                        *bargs))
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        torch.save({k: v if isinstance(v, torch.Tensor) else list(v)
                    for k, v in out.items()}, save)
    print(f"[kernel_ab] {root}: " + " ".join(f"{k}={v:.4f}"
                                             for k, v in t.items())
          + f" ({time.strftime('%H:%M:%S')}; {_card()})", flush=True)
    return 0


# --sort: (views, items, bins, share of valid pairs); K1 at SUN RGB-D's
# one view into 80x80x32 and 40x40x16 and at 20 views into 80x80x32, K2
# at phase 8's 50 views
SORT_CASES = {"k1_one_view": (1, 204800, 19200, 0.518),
              "k1_one_view_fast": (1, 25600, 19200, 0.507),
              "k1_20_views": (20, 204800, 19200, 0.578),
              "k2_50_views": (50, 131072, 4720, 0.642)}


def sort_ab(root, save, with_profile):
    """The backwards' counting sort of one checkout (``--sort``)."""
    sys.path.insert(0, root)
    import torch

    from nerfdet_tpu_torch.ops import cuda_build, render, voxel

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    smoke = _smoke()
    _build(cuda_build, ["fused_mean_cov_backward",
                        "streaming_sample_mean_var_backward"])
    gen = torch.Generator(device="cuda").manual_seed(smoke.SEED)
    out, t = {}, {}
    for tag, (v, n, hw, share) in SORT_CASES.items():
        keys = torch.randint(0, hw, (v, n), device="cuda", generator=gen,
                             dtype=torch.int32)
        drop = torch.rand((v, n), device="cuda", generator=gen) > share
        if tag.startswith("k1"):
            pix = keys.masked_fill(drop, -1)
            calls = {tag: lambda: voxel.pixel_order(pix, hw)}
            out[tag] = list(calls[tag]())
            g1 = torch.randn((n, 64), device="cuda", generator=gen)
            feats = torch.zeros((v, 120, 160, 64), device="cuda")
            count = (pix >= 0).float().sum(0)
            bwd = (lambda: voxel.fusion_carry_backward(
                feats, pix, count, g1=g1))
            t[f"{tag}_bwd"] = timed(bwd)
            t[f"{tag}_bwd_device"] = smoke.queued_time_ms(bwd)
        else:  # K2's keys: the view's windows after the views before
            keys = (keys + torch.arange(v, device="cuda", dtype=torch.int32)
                    [:, None] * hw).masked_fill(drop, -1)
            kept = keys.reshape(-1) >= 0
            calls = {tag: lambda: render._window_order_launch(keys, hw),
                     f"{tag}_rank": lambda: render._window_order_launch(
                         keys, hw, rank=True)}
            order, off = calls[tag]()
            rank, off_r = calls[f"{tag}_rank"]()
            out[tag] = [order[:int(off[-1])], off]
            out[f"{tag}_rank"] = [rank.reshape(-1)[kept], off_r]
        for name, fn in calls.items():
            t[name] = timed(fn)
            t[f"{name}_device"] = smoke.queued_time_ms(fn)
            if with_profile:
                profile(f"sort {name}", fn)
    torch.cuda.synchronize()
    if save:
        os.makedirs(os.path.dirname(os.path.abspath(save)), exist_ok=True)
        torch.save(out, save)
    print(f"[kernel_ab] {root} --sort: " + " ".join(
        f"{k}={v:.4f}" for k, v in t.items())
        + f" ({time.strftime('%H:%M:%S')}; {_card()})", flush=True)
    return 0


# outputs held within 1e-5 relative, not bit for bit: phase A's rows and
# s2m (their C-long dot products may run in another order)
CLOSE = ("_rows", "_s2m")


def compare(a, b):
    import torch

    x, y = torch.load(a), torch.load(b)
    missed = []
    for k in sorted(x):
        xs = x[k] if isinstance(x[k], list) else [x[k]]
        ys = y[k] if isinstance(y[k], list) else [y[k]]
        same = [torch.equal(p, q) for p, q in zip(xs, ys)]
        diff = [float((p.float() - q.float()).abs().max()
                      / q.float().abs().max().clamp_min(1e-30))
                for p, q in zip(xs, ys)]
        ok = max(diff) <= 1e-5 if k.endswith(CLOSE) else all(same)
        if not ok:
            missed.append(k)
        print(f"[kernel_ab] {k}: bitwise equal {same}, max rel diff "
              f"{['%.3e' % d for d in diff]}"
              f"{'' if ok else ' MISSES its bar'}", flush=True)
    print(f"[kernel_ab] compare: {len(x) - len(missed)} of {len(x)} keys "
          f"within their bars (bitwise; {', '.join(CLOSE)} 1e-5 relative)",
          flush=True)
    return 1 if missed else 0


def main(argv):
    if argv[:1] == ["--compare"]:
        return compare(argv[1], argv[2])
    if argv[:1] == ["--ablate"]:
        return ablate()
    if argv[:1] == ["--ablate-backward"]:
        return ablate_backward()
    if argv[:1] == ["--ablate-fusion"]:
        return ablate_fusion()
    save = None
    if "--save" in argv:
        i = argv.index("--save")
        save = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    with_profile = "--profile" in argv
    forward_only = "--forward" in argv
    with_fusion = "--fusion" in argv
    with_sort = "--sort" in argv
    argv = [a for a in argv if a not in ("--profile", "--forward",
                                         "--fusion", "--sort")]
    if with_fusion:
        return fusion(os.path.abspath(argv[0] if argv else HERE), save)
    if with_sort:
        return sort_ab(os.path.abspath(argv[0] if argv else HERE), save,
                       with_profile)
    return run(os.path.abspath(argv[0] if argv else HERE), save,
               with_profile, forward_only)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
