"""Time K2 (``streaming_sample_mean_var``) of one checkout on the card, for
comparing two versions of the kernel in one call.

    python3 k2_ab.py [CHECKOUT]    # default: this file's directory

Imports ``nerfdet_tpu_torch`` from CHECKOUT (building its kernels there),
times the eval form (in-kernel rgb) at one render chunk (2048 rays x 64
samples, 50 views, 240x320 images, 59x80x32 feature maps, seeded points
over a room) with CUDA events, and, where the checkout has them, the
training form (host rgb sums) and K2's backward at the same shape.
Prints the kernel's ptxas report, one line of times, and the card. Run
two checkouts in turns (A B B A) in one call: calls may land on cards
of other power limits.
"""

import os
import subprocess
import sys
import time


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1
                           else os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from nerfdet_tpu_torch.ops import cuda_build, render

    if not torch.cuda.is_available():
        print("k2_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cuda_build.build(["streaming_sample_mean_var"])
    for line in cuda_build.BUILD_LOG.get("streaming_sample_mean_var",
                                         (0, ""))[1].splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print(f"[ptxas] {line.strip()}")

    rng = np.random.RandomState(0)
    v, r, s, c = 50, 2048, 64, 32
    intrinsic = np.array([[288.0, 0, 160.0], [0, 288.0, 120.0], [0, 0, 1]],
                         np.float32)
    extr = []
    for i in range(v):
        a = 2 * np.pi * i / v
        pos = np.array([3.5 * np.cos(a), 3.5 * np.sin(a), 1.5])
        fwd = -pos / np.linalg.norm(pos)
        right = np.cross(fwd, [0, 0, 1.0])
        right /= np.linalg.norm(right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1] = right, np.cross(fwd, right)
        c2w[:3, 2], c2w[:3, 3] = fwd, pos
        extr.append(np.linalg.inv(c2w))
    proj = render.view_projection(intrinsic, np.asarray(extr, np.float32),
                                  1.0, dev)
    pts, images, feats = [torch.from_numpy(x.astype(np.float32)).to(dev)
                          for x in (rng.uniform([-3, -3, -0.5], [3, 3, 3],
                                                (r, s, 3)),
                                    rng.uniform(0, 1, (v, 240, 320, 3)),
                                    rng.randn(v, 59, 80, c))]
    hw = (239, 320)

    def timed(fn, iters=20):
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

    out = {"eval_ms": timed(lambda: render.streaming_sample_mean_var(
        pts, images, proj, hw, feats))}
    if hasattr(render, "streaming_sample_mean_var_backward"):
        carry = render.ray_view_carry_plain(pts, images, feats, proj, hw)
        host = tuple(t[..., :3].contiguous() for t in carry[:3]) + (
            carry[3],)
        out["training_ms"] = timed(lambda: render.streaming_sample_mean_var(
            pts, None, proj, hw, feats, host))
        gf, _, s1u, cnt = render._k2_launch(pts, None, proj, hw, feats, host,
                                            for_grad=True)
        g = torch.randn(gf.shape, device=dev)
        out["backward_ms"] = timed(
            lambda: render.streaming_sample_mean_var_backward(
                pts, proj, hw, feats, g, gf, s1u, cnt), 10)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"[k2_ab] {root}: " + " ".join(f"{k}={v:.4f}"
                                         for k, v in out.items())
          + f" ({time.strftime('%H:%M:%S')}; {card})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
