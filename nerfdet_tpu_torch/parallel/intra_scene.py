"""Intra-scene sharding at inference: a scene's views, or its rays, over
a group of ranks.

Port of ``nerfdet_tpu/parallel/intra_scene.py``. The fusion keeps only
streaming sums, so sharding the views is an all-reduce of them
(``ops/voxel.fused_mean_cov`` with ``view_group``); rays are independent,
so sharding them is a slice a rank and a gather.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from . import dist as pdist
from .train2d import view_shard


def make_view_sharded_volume(model, view_group) -> Callable:
    """``fn(batch)`` -> (det_volume, valid) of the scene ``batch`` (imgs,
    denorm_images, intrinsic, extrinsics, origin: every view) with its
    views sharded over ``view_group``: each rank runs the backbone and K1
    on its contiguous slice of the views, the sums are all-reduced, and
    every rank gets the global volume (the density path's rgb stream from
    the images on the card, as JAX's helper builds it)."""

    @torch.inference_mode()
    def fn(batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        mine = view_shard(batch, pdist.rank(view_group),
                          pdist.world(view_group))
        feats = model.extract_2d(mine["imgs"])
        vol = model.build_volume(feats, mine["intrinsic"],
                                 mine["extrinsics"], mine["origin"],
                                 denorm_images=mine["denorm_images"],
                                 view_group=view_group)
        return vol["det_volume"], vol["valid"]

    return fn


def make_ray_sharded_render(model, group, chunk: int = 2048) -> Callable:
    """``fn(batch)`` -> (rgb, depth) of every ray of ``batch`` (``ray_o``
    / ``ray_d`` flat (R, 3), R divisible by the group's size; every view
    on every rank): each rank renders its contiguous R / n rays with
    ``render_full`` in chunks of ``chunk``, and the slices are gathered
    in rank order on every rank (the dual of view sharding)."""

    @torch.inference_mode()
    def fn(batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        n, r = pdist.world(group), batch["ray_o"].shape[0]
        if r % n:
            raise ValueError(f"{r} rays do not split over {n} ranks")
        lo = pdist.rank(group) * (r // n)
        mine = dict(batch, ray_o=batch["ray_o"][lo:lo + r // n],
                    ray_d=batch["ray_d"][lo:lo + r // n])
        rgb, depth = model.render_full(mine, chunk)
        return (pdist.all_gather_cat(rgb, group),
                pdist.all_gather_cat(depth, group))

    return fn
