"""Throughput of the port's device path on synthetic data.

    python -m nerfdet_tpu_torch.tools.benchmark <config> [--views 50] \
        [--warmup 5] [--iters 30] [--f32] [--nvs [--rays 16384]] \
        [--train] [--device cuda|cpu]

The port of ``tools/benchmark.py`` of the JAX package, with its flags
and defaults (``--bf16`` is on unless ``--f32`` is given), on the card
unless ``--device cpu``. A seeded synthetic scene of ``--views`` views at
the config's image size and the model's random weights (seed 0); data
loading is not timed. Three modes, each the JAX tool's:

* detection (default): scenes/s of ``api.eval_step`` (the forward with
  its density path's rgb stream on the device, then
  ``get_candidate_bboxes``), the origin moved by i x 1e-4 at iteration i
  so each iteration does the work JAX's does;
* ``--nvs``: rays/s of ``render_full`` over ``--rays`` rays from one
  origin in chunks of ``N_rand``. The directions are drawn from a
  ``torch.Generator`` seeded 1: not JAX's ``PRNGKey(1)`` stream, and
  used for timing only;
* ``--train``: ms/step of the joint detection + NVS step (AdamW, lr
  2e-4, weight decay 1e-4, gradient clip 35) on one scene with
  ``N_rand`` rays and the host streams the production loader makes (the
  rgb sums, ``host_sample_z`` on ``RandomState(0)``, the ray stream).

The card is synchronized around the timed loop. It prints the JAX tool's
lines, the card's name where JAX names its platform, and the warm-up's
seconds where JAX prints its compile time. ``main`` returns the numbers.
The timed function of each mode is a plain function of its batch
(``detection_fn``, ``nvs_fn``, ``train_fn``).
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import api
from ..config import Config
from ..data.dataset import (ray_stats_spec_from_config,
                            rgb_stats_spec_from_config)
from ..data.ray_stats import host_ray_rgb_stats, host_sample_z
from ..data.rgb_stats import host_rgb_stats
from ..data.synthetic import make_synthetic_scene
from ..device import resolve_device
from ..train.optim import build_optimizer
from ..train.step import make_train_step

OPTIMIZER = dict(type="AdamW", lr=2e-4, weight_decay=1e-4)
GRAD_CLIP = dict(max_norm=35.0)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("config")
    p.add_argument("--views", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--nvs", action="store_true",
                   help="benchmark NeRF rendering rays/sec instead of "
                        "detection scenes/sec")
    p.add_argument("--rays", type=int, default=16384,
                   help="rays per NVS iteration")
    p.add_argument("--train", action="store_true",
                   help="benchmark the full train step (fwd+bwd+AdamW, "
                        "joint det+NVS losses) in ms/step")
    p.add_argument("--f32", action="store_true",
                   help="force float32 compute (overrides --bf16)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def synthetic_scene(meta, views: int, n_rand: int) -> Dict:
    """The JAX tool's scene: seed 0, one target view, 4 boxes."""
    return make_synthetic_scene(
        seed=0, n_views=views, n_targets=1, hw=meta.img_shape,
        pad_hw=meta.pad_shape, n_rand=n_rand, n_boxes=4, max_gt=8,
        margin=10)


def detection_batch(model, scene: Dict) -> Dict:
    """The detection inputs: images and denormalized images on the
    model's device (its density path samples the rgb on the device), the
    geometry on the host."""
    dev = next(model.parameters()).device
    batch = {k: scene[k] for k in ("intrinsic", "extrinsics", "origin")}
    for k in ("imgs", "denorm_images"):
        batch[k] = torch.as_tensor(scene[k], device=dev)
    return batch


def moved_origins(origin, n: int) -> List[np.ndarray]:
    """The origin moved by i x 1e-4 (float32) for i < n."""
    return [np.asarray(origin, np.float32)
            + np.float32(i) * np.float32(1e-4) for i in range(n)]


def detection_fn(model, nms_pre: int) -> Callable[[Dict], Dict]:
    """The timed detection function: ``api.eval_step`` (the forward, then
    the top ``nms_pre`` candidates) of a ``detection_batch``."""
    return lambda batch: api.eval_step(model, batch, nms_pre)


def nvs_batch(model, scene: Dict, rays: int, seed: int = 1) -> Dict:
    """``render_full``'s inputs: ``rays`` rays from the scene's first ray
    origin, their directions unit normals drawn from a generator seeded
    ``seed``."""
    dev = next(model.parameters()).device
    dirs = torch.randn((rays, 3), generator=torch.Generator().manual_seed(
        seed))
    batch = {k: scene[k] for k in ("intrinsic", "extrinsics")}
    for k in ("imgs", "denorm_images"):
        batch[k] = torch.as_tensor(scene[k], device=dev)
    batch["ray_o"] = torch.as_tensor(scene["ray_o"][:1], device=dev).expand(
        rays, 3).contiguous()
    batch["ray_d"] = (dirs / torch.linalg.norm(dirs, dim=-1,
                                               keepdim=True)).to(dev)
    return batch


def nvs_fn(model, chunk: int) -> Callable[[Dict], tuple]:
    """The timed rendering function: ``render_full`` in chunks."""
    return lambda batch: model.render_full(batch, chunk)


def train_scene(cfg, meta, views: int, bf16: bool) -> Dict:
    """The JAX tool's train scene: ``N_rand`` rays and the host streams of
    the production loader (the rgb sums, ``host_sample_z`` on
    ``RandomState(0)`` and the ray stream) at the compute dtype."""
    n_rand = cfg.model.get("N_rand", 2048)
    scene = synthetic_scene(meta, views, n_rand)
    vspec = rgb_stats_spec_from_config(cfg, bf16=bf16)
    if vspec is not None:
        scene["rgb_s1"], scene["rgb_s2"] = host_rgb_stats(
            scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
            scene["origin"], vspec[0], vspec[1], meta.ori_shape,
            meta.img_shape, compute_dtype=vspec[2])
    rspec = ray_stats_spec_from_config(cfg, bf16=bf16)
    if rspec is not None:
        z = host_sample_z(np.random.RandomState(0), n_rand, rspec[0][0],
                          rspec[0][1], rspec[1])
        (scene["ray_s1u"], scene["ray_s2u"], scene["ray_s1m"],
         scene["ray_cnt"]) = host_ray_rgb_stats(
            scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
            scene["ray_o"], scene["ray_d"], z, meta.ori_shape,
            meta.img_shape, compute_dtype=rspec[2])
        scene["z_vals"] = z
    return scene


def train_fn(model) -> Callable[[List[Dict]], Dict]:
    """The timed train step: the JAX step's defaults (joint losses), AdamW
    at lr 2e-4 and weight decay 1e-4, the gradients clipped to 35; it
    takes ``api.train_batch`` of the scenes. The model goes to train
    mode."""
    model.train()
    return make_train_step(model, build_optimizer(model, OPTIMIZER,
                                                  grad_clip=GRAD_CLIP))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_calls(fn, batches, dev) -> float:
    """Seconds of ``fn`` over ``batches``, the card synchronized before
    and after."""
    _sync(dev)
    t0 = time.perf_counter()
    for b in batches:
        fn(b)
    _sync(dev)
    return time.perf_counter() - t0


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    meta = api.scene_meta_from_config(cfg)
    use_bf16 = args.bf16 and not args.f32
    model = api.init_detector(
        cfg, device=dev, seed=0,
        compute_dtype=torch.bfloat16 if use_bf16 else torch.float32)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    n_rand = cfg.model.get("N_rand", 2048)
    dtype = "bf16" if use_bf16 else "f32"

    if args.train:
        scene = train_scene(cfg, meta, args.views, use_bf16)
        tbatch = api.train_batch(model, [scene])
        step = train_fn(model)
        warm = time_calls(step, [tbatch] * (1 + args.warmup), dev)
        print(f"warm-up (1st step + {args.warmup}): {warm:.1f}s")
        dt = time_calls(step, [tbatch] * args.iters, dev)
        print(f"train: {dt / args.iters * 1e3:.1f} ms/step "
              f"({args.iters / dt:.2f} scenes/sec/chip, V={args.views}, "
              f"N_rand={n_rand}, {dtype}, {name})")
        return dict(mode="train", ms_per_step=dt / args.iters * 1e3,
                    warmup_s=warm, views=args.views, dtype=dtype,
                    device=name)

    scene = synthetic_scene(meta, args.views, 64)
    n = args.warmup + args.iters
    if args.nvs:  # render_full reads no origin
        batch = nvs_batch(model, scene, args.rays)
        fn = nvs_fn(model, n_rand)
        batches = [batch] * n
    else:
        batch = detection_batch(model, scene)
        fn = detection_fn(model, cfg.test_cfg["nms_pre"])
        batches = [dict(batch, origin=o)
                   for o in moved_origins(scene["origin"], n)]
    warm = time_calls(fn, [batch] + batches[:args.warmup], dev)
    print(f"warm-up: {warm:.1f}s")
    dt = time_calls(fn, batches[args.warmup:], dev)
    if args.nvs:
        rate = args.iters * args.rays / dt
        print(f"{rate:,.0f} rays/sec ({dt / args.iters * 1e3:.1f} ms per "
              f"{args.rays} rays, V={args.views}, {name})")
        return dict(mode="nvs", rays_per_s=rate,
                    ms_per_iter=dt / args.iters * 1e3, warmup_s=warm,
                    views=args.views, dtype=dtype, device=name)
    print(f"{args.iters / dt:.3f} scenes/sec ({dt / args.iters * 1e3:.1f} "
          f"ms/scene, V={args.views}, {name})")
    return dict(mode="detection", scenes_per_s=args.iters / dt,
                ms_per_scene=dt / args.iters * 1e3, warmup_s=warm,
                views=args.views, dtype=dtype, device=name)


if __name__ == "__main__":
    main()
