"""Time K2's forward, K2's backward and K1's backward of one checkout on
the card, the backwards pass by pass, for comparing two designs of them
in one call.

    python3 kernel_ab.py [CHECKOUT] [--save OUT.pt] [--profile] [--forward]
    python3 kernel_ab.py --compare A.pt B.pt
    python3 kernel_ab.py --ablate
    python3 kernel_ab.py --ablate-backward

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
checkout's. With ``--profile`` it also prints each backward's device
time by kernel (``torch.profiler``, 5 calls). With ``--forward`` it
times K2's forward alone. Prints one line of times and the card.
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


def ablate():
    """K2's forward on bfloat16 maps (the 16-byte lane form) with its
    feature gathers, its image gathers, both, or its texel widening
    replaced (K2_GATHERS),
    each built from this checkout's source into its own library and
    timed in place of the real one; the real one first and last."""
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    (render, _), _, _, (eval_args, train_args) = inputs(HERE)
    from nerfdet_tpu_torch.ops import cuda_build

    with open(os.path.join(cuda_build.CSRC,
                           "streaming_sample_mean_var.cu")) as f:
        source = f.read()
    variants = {"without feature loads": ["features"],
                "without image loads": ["images"],
                "without either": ["features", "images"],
                "without the widening": ["widening"]}
    out_dir = os.path.join(cuda_build.BUILD_DIR, "ablate")
    os.makedirs(out_dir, exist_ok=True)
    libs, jobs = {"real": render._lib()}, {}
    for i, (name, gathers) in enumerate(variants.items()):
        src = source
        for g in gathers:
            old, new = K2_GATHERS[g]
            if old not in src:
                raise SystemExit(f"kernel_ab --ablate: the {g} code is "
                                 f"not in the source")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"k2_{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        jobs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
             path[:-3] + ".so", path], stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT), path[:-3] + ".so")
    for name, (proc, so) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"kernel_ab --ablate: {name} did not build")
        lib = ctypes.CDLL(so)
        lib.streaming_sample_mean_var.argtypes = (
            libs["real"].streaming_sample_mean_var.argtypes)
        lib.streaming_sample_mean_var.restype = ctypes.c_int
        libs[name] = lib
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
    import ctypes

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    (render, voxel), k1, k2, _ = inputs(HERE)
    from nerfdet_tpu_torch.ops import cuda_build

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
    out_dir = os.path.join(cuda_build.BUILD_DIR, "ablate_backward")
    os.makedirs(out_dir, exist_ok=True)
    jobs = []
    for i, (name, label, subs) in enumerate(BWD_VARIANTS):
        with open(os.path.join(cuda_build.CSRC, f"{name}.cu")) as f:
            src = f.read()
        for old, new in subs:
            if old not in src:
                raise SystemExit(f"kernel_ab --ablate-backward: {label}: "
                                 f"the code is not in the source")
            src = src.replace(old, new)
        path = os.path.join(out_dir, f"{i}.cu")
        with open(path, "w") as f:
            f.write(src)
        so = path[:-3] + ".so"
        jobs.append((name, label, so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
             cuda_build.CSRC, "-o", so, path],
            stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)))
    real = {"fused_mean_cov_backward": voxel._backward_lib(),
            "streaming_sample_mean_var_backward": render._backward_lib()}
    runs = [(name, "real", real[name]) for name in real]
    for name, label, so, proc in jobs:
        if proc.wait() != 0:
            raise SystemExit(f"kernel_ab --ablate-backward: {label} did not "
                             f"build")
        lib = ctypes.CDLL(so)
        for attr in ("pixels", "parts", "tile", "order", "weights", "reduce",
                     "keys", "rank", "windows", "pairs", "windows_bf16",
                     "unpack"):
            fname = f"{name}_{attr}"
            try:
                ref = getattr(real[name], fname)
            except AttributeError:
                continue
            getattr(lib, fname).argtypes = ref.argtypes
            getattr(lib, fname).restype = ref.restype
        runs.append((name, label, lib))
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


def inputs(root):
    """The checkout's modules and the A/B's inputs, from their seeds: for
    K1 the maps, W, b and cotangents with each intrinsic's ``pix``; for
    K2 its backward's arguments at phase 8's training batch on float32
    maps and on the same maps in bfloat16 (keys "" and "_bf16"), and its
    forward's in both forms."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from nerfdet_tpu_torch import api
    from nerfdet_tpu_torch.data import ray_stats
    from nerfdet_tpu_torch.data.synthetic import make_synthetic_scene
    from nerfdet_tpu_torch.ops import cuda_build, render, voxel

    spec = importlib.util.spec_from_file_location(
        "smoke", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build([k for k in cuda_build.KERNELS if "mean" in k])
    for name, (_, log) in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                print(f"[ptxas] {name}: {line.strip()}")

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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[kernel_ab] {root}: " + " ".join(f"{k}={v:.4f}"
                                             for k, v in t.items())
          + f" ({time.strftime('%H:%M:%S')}; {card})", flush=True)
    return 0


def compare(a, b):
    import torch

    x, y = torch.load(a), torch.load(b)
    for k in sorted(x):
        xs = x[k] if isinstance(x[k], list) else [x[k]]
        ys = y[k] if isinstance(y[k], list) else [y[k]]
        same = [torch.equal(p, q) for p, q in zip(xs, ys)]
        diff = [float((p.float() - q.float()).abs().max()
                      / q.float().abs().max().clamp_min(1e-30))
                for p, q in zip(xs, ys)]
        print(f"[kernel_ab] {k}: bitwise equal {same}, max rel diff "
              f"{['%.3e' % d for d in diff]}", flush=True)
    return 0


def main(argv):
    if argv[:1] == ["--compare"]:
        return compare(argv[1], argv[2])
    if argv[:1] == ["--ablate"]:
        return ablate()
    if argv[:1] == ["--ablate-backward"]:
        return ablate_backward()
    save = None
    if "--save" in argv:
        i = argv.index("--save")
        save = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    with_profile = "--profile" in argv
    forward_only = "--forward" in argv
    argv = [a for a in argv if a not in ("--profile", "--forward")]
    return run(os.path.abspath(argv[0] if argv else HERE), save,
               with_profile, forward_only)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
