"""The 2-D data x views grid: scenes over the data groups, each scene's
source views (and, after the view statistics, its rays) over a views
group.

Port of ``nerfdet_tpu/parallel/train2d.py``. JAX lays its devices out as
a (data, views) mesh and runs the step under ``shard_map``; here one
process a rank, rank r at (r // n_views, r % n_views)
(``parallel/dist.mesh_groups``), and the psums over the views axis are
all-reduces over the views group whose backward sums the cotangents
(``dist.all_reduce_sum``), as the transpose of psum is psum. Every rank
of a views group then computes the scene's global loss; the gradients'
mean over every rank is the global batch's gradient for the sharded and
the replicated parameters alike (``train/step.py``), as JAX's pmean over
(data, views).

A views group must hold the same scenes bit for bit: its first rank
loads them and sends them to the others (``shared_batches``,
``shared_scene``); each rank keeps its contiguous slice of the view-led
keys (``view_shard``) after the host streams (rgb sums, ray stream) were
computed over every view (``api.train_batch`` / ``api.device_batch``
with the group).
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List

import torch

from ..train.step import make_train_step
from . import dist as pdist

# scene-dict keys whose leading axis is the source-view axis V
VIEW_LED_KEYS = ("imgs", "denorm_images", "extrinsics", "depth")


def view_shard(scene: Dict, index: int, n: int) -> Dict:
    """``scene`` with each view-led key cut to shard ``index`` of ``n``:
    its contiguous V / n views (JAX's ``shard_batch_2d`` over the views
    axis). Raises where n does not divide V."""
    if n == 1:
        return scene
    out = dict(scene)
    for k in VIEW_LED_KEYS:
        if k in scene:
            v = scene[k].shape[0]
            if v % n:
                raise ValueError(f"{v} views of {k!r} do not split over "
                                 f"--mesh-views {n}")
            out[k] = scene[k][index * (v // n):(index + 1) * (v // n)]
    return out


def pipeline_views(data_cfg: Dict) -> int:
    """The source views a scene of the dataset config ``data_cfg`` holds
    (through a ``RepeatDataset``): its ``MultiViewPipeline``'s
    ``n_images`` (50 where unset), less the ``nerf_target_views`` (10
    where unset) that random loading draws from them."""
    if data_cfg.get("type") == "RepeatDataset":
        data_cfg = data_cfg["dataset"]
    for step in data_cfg.get("pipeline", []):
        if step.get("type") == "MultiViewPipeline":
            n = int(step.get("n_images", 50))
            if step.get("loading", "random") == "random":
                n -= int(step.get("nerf_target_views", 10))
            return n
    return 40


def check_mesh_views(n_views: int, world, scene_views: Dict[str, int],
                     n_rand=None) -> None:
    """Raise, naming the numbers, where ``--mesh-views n_views`` cannot
    lay out the grid: without a process group (``world`` None: no
    ``--distributed``), or where it does not divide the world, a split's
    views a scene (``scene_views``: split name -> views) or ``N_rand``."""
    if n_views <= 1:
        return
    if world is None:
        raise ValueError(f"--mesh-views {n_views} shards over processes: it "
                         f"needs --distributed")
    if world % n_views:
        raise ValueError(f"--mesh-views {n_views} does not divide the world "
                         f"of {world} processes")
    for split, v in scene_views.items():
        if v % n_views:
            raise ValueError(f"--mesh-views {n_views} does not divide the "
                             f"{v} views a {split} scene")
    if n_rand is not None and n_rand % n_views:
        raise ValueError(f"--mesh-views {n_views} does not divide N_rand "
                         f"{n_rand}")


def _first_rank(view_group) -> int:
    """The global rank of the views group's first rank."""
    return torch.distributed.get_global_rank(view_group, 0)


def shared_scene(load: Callable[[], Dict], view_group):
    """``load()`` on the views group's first rank, sent to every rank of
    the group (``load`` itself without a group)."""
    if view_group is None:
        return load()
    mine = load() if pdist.rank(view_group) == 0 else None
    return pdist.broadcast_object(mine, _first_rank(view_group), view_group)


def shared_batches(loader, view_group) -> Iterator[List[Dict]]:
    """The batches of ``loader`` (a ``BatchLoader`` over the data groups)
    as its views group's first rank loads them, on every rank of the
    group: the other ranks never run their loader, so the group holds the
    same scenes whatever the loader's thread count."""
    if view_group is None:
        yield from loader
        return
    src = _first_rank(view_group)
    if pdist.rank(view_group) == 0:
        for batch in loader:
            yield pdist.broadcast_object(batch, src, view_group)
    else:
        for _ in range(len(loader)):
            yield pdist.broadcast_object(None, src, view_group)


def make_train_step_2d(model, optimizer, n_views: int, process_group,
                       depth_supervise: bool = False,
                       use_nerf_mask: bool = True,
                       rgb_supervision: bool = True):
    """The 2-D train step (JAX's ``make_train_step_2d``): the grid's
    groups of ``process_group`` (the world) at ``n_views`` ranks a scene,
    and ``train/step.make_train_step`` over them. Returns (step,
    view_group, data_group); ``step`` takes ``api.train_batch(model,
    scenes, view_group=view_group)`` of the views group's scenes."""
    views, data = pdist.mesh_groups(n_views, process_group)
    step = make_train_step(model, optimizer, depth_supervise, use_nerf_mask,
                           rgb_supervision, process_group=process_group,
                           view_group=views, data_group=data)
    return step, views, data


def make_eval_step_sharded(model, view_group, nms_pre: int = 1000
                           ) -> Callable[[Dict], Dict]:
    """Single-scene inference with the views sharded over ``view_group``
    (JAX's ``make_eval_step_sharded``): ``fn(batch)`` with ``batch`` =
    ``api.device_batch(model, scene, view_group=view_group)`` gives the
    candidates of ``api.eval_step``, the same on every rank of the group.
    The density modulation stays on, as in the port's ``eval_step`` (the
    JAX step passes ``with_rays=False``, which drops it: ROADMAP §3)."""
    from .. import api

    def fn(batch: Dict) -> Dict:
        return api.eval_step(model, batch, nms_pre, view_group=view_group)

    return fn
