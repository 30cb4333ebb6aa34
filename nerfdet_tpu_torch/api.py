"""Entry points: detection and novel-view rendering, their evaluation,
and detection training.

Port of ``nerfdet_tpu/api.py`` (``init_detector``,
``scene_meta_from_config``, ``single_scene_test``,
``detections_from_candidates``, ``inference_detector``, ``run_eval``,
``run_nvs_eval``) and of the eval step of
``nerfdet_tpu/train/step.py:make_eval_step``. The port's eval step runs
the graph the parity tests and the benchmark run: the nerf_density
modulation is on, as in the original NeRF-Det's ``simple_test`` (the JAX
``make_eval_step`` defaults to ``with_rays=False``, which skips it, and
the JAX ``tools/test.py`` keeps that default).

For VoteNet, ``points_eval_step`` and ``single_cloud_test`` are the
per-scene forward + decode and host tail of
``nerfdet_tpu/train/points_step.py:run_indoor_points_eval``.

``init_trainer`` and ``train_batch`` set up what ``tools/train.py`` of
the JAX package sets up for one joint detection + NVS train step: the
model in train mode, the optimizer, the schedule and the loss switches
(``rgb_supervision``, ``depth_supervise``, ``use_nerf_mask``) from the
config, and the scenes with their host ray stream on the device.

With a views group (the 2-D data x views sharding, ``parallel/train2d``)
``device_batch`` and ``train_batch`` send a rank only its slice of a
scene's views, after the host streams were computed over all of them;
``eval_step``, ``run_eval`` and the ``Trainer`` then sum the views'
statistics over the group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .config import Config
from .core.nms import aligned_3d_nms, nms_bev_rotated
from .core.nvs_metrics import aggregate_nvs, evaluate_rendering
from .data.dataset import build_dataset
from .data.ray_stats import RAY_STREAM_KEYS, draw_rays, prepare_rays
from .data.rgb_stats import host_rgb_stats
from .device import resolve_device
from .models.builder import build_model, unported_refusal
from .models.imvoxelnet_indoor import IndoorImVoxelNet
from .models.nerfdet import VOLUME_MESH_VIEWS, NerfDet, SceneMeta
from .models.votenet import VoteNet, votenet_nms
from .nn.heads import get_candidate_bboxes
from .nn.vote_head import vote_head_get_bboxes
from .parallel import dist as pdist
from .parallel.train2d import make_train_step_2d, shared_scene, view_shard
from .train.optim import (Optimizer, build_lr_schedule_from_config,
                          build_optimizer)
from .train.step import make_train_step
from .utils.checkpoint import load_checkpoint
from .utils.weight_convert import load_reference_state_dict


def scene_meta_from_config(config) -> SceneMeta:
    """SceneMeta from the test pipeline's Resize/Pad transforms."""
    img_scale, pad = (320, 240), (240, 320)
    for step in config.get("test_pipeline") or []:
        if step.get("type") == "MultiViewPipeline":
            for t in step.get("transforms", []):
                if t["type"] == "Resize":
                    img_scale = tuple(t["img_scale"])
                if t["type"] == "Pad":
                    pad = tuple(t["size"])
    # ScanNet sensor resolution unless the config overrides it
    ori = tuple(config.get("ori_shape", (968, 1296)))
    scale = min(img_scale[0] / ori[1], img_scale[1] / ori[0])
    img_shape = (int(ori[0] * scale + 0.5), int(ori[1] * scale + 0.5))
    return SceneMeta(ori_shape=ori, img_shape=img_shape, pad_shape=pad)


def init_detector(config, checkpoint: Optional[str] = None,
                  device="cuda", seed: int = 0,
                  compute_dtype=None) -> torch.nn.Module:
    """Build the detector (NeRF-Det, the indoor ImVoxelNet or VoteNet)
    from a config file or object, in eval mode on ``device``. Weights are
    random from ``seed`` unless ``checkpoint`` names a ``.pth``: one the
    port's train CLI wrote (``utils/checkpoint.save_checkpoint``, the
    model's state_dict under ``"model"``), or ``tools/publish_model``
    published, or for NeRF-Det a reference state_dict. NeRF-Det and the
    indoor ImVoxelNet
    compute in ``compute_dtype`` (float32 where None; bfloat16 is the
    JAX package's ``--bf16`` path), its parameters float32 either way.
    Raises if ``device`` is CUDA and there is none."""
    dev = resolve_device(device)
    if isinstance(config, str):
        config = Config.fromfile(config)
    model = build_model(config.model, meta=scene_meta_from_config(config),
                        compute_dtype=compute_dtype or torch.float32)
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint is not None:
        if isinstance(model, VoteNet):
            raise NotImplementedError(
                f"reference checkpoints of {type(model).__name__} are not "
                f"ported yet")
        obj = load_checkpoint(checkpoint)
        if "model" in obj:  # the port's own (published: no optimizer)
            model.load_state_dict(obj["model"], strict=True)
        elif isinstance(model, IndoorImVoxelNet):
            # the JAX package converts no reference ImVoxelNet either
            raise NotImplementedError(
                "reference checkpoints of IndoorImVoxelNet are not "
                "converted (the JAX package loads its own only); the "
                "port's own checkpoints load")
        else:
            load_reference_state_dict(model, obj.get("state_dict", obj))
    return model.to(dev).eval()


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _to_device(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def render_batch(model: NerfDet, scene: Dict) -> Dict:
    """``render_full``'s inputs for one scene: images, denormalized
    images and the rays on the model's device, the geometry on the host
    (the projection is computed there); in volume mode also the origin
    and, where the scene has them, the depth maps (``render_full`` fuses
    the volume first)."""
    dev = _device_of(model)
    batch = {k: scene[k] for k in ("intrinsic", "extrinsics")}
    for k in ("imgs", "denorm_images", "ray_o", "ray_d"):
        batch[k] = _to_device(scene[k], dev)
    if model.nerf_mode == "volume":
        batch["origin"] = scene["origin"]
        if "depth" in scene:
            batch["depth"] = _to_device(scene["depth"], dev)
    return batch


def device_batch(model: NerfDet, scene: Dict, view_group=None) -> Dict:
    """The eval step's detection inputs for one scene: images and, where
    the scene has them, its depth maps on the model's device; the small
    geometry arrays stay on the host (the projection is computed there).
    The density path's rgb stream: for a scene with depth maps, or a
    model whose data path ships no host streams (``host_streams``: the
    ImVoxelNet-typed configs, as in the JAX package), the denormalized
    images go to the device (the stream is summed there, gated by the
    depth where the scene has it), else the host rgb sums, computed here
    (at the model's compute dtype) when the scene does not carry them.
    Merged with ``render_batch``, the forward also renders the scene's
    rays. With a ``view_group`` the
    view-led keys are this rank's slice of the views (``view_shard``),
    taken after the host rgb sums."""
    dev = _device_of(model)
    host_rgb = (model.nerf_density and model.host_streams
                and "depth" not in scene)
    if host_rgb and "rgb_s1" not in scene:
        scene = dict(scene, **dict(zip(("rgb_s1", "rgb_s2"), host_rgb_stats(
            scene["denorm_images"], scene["intrinsic"], scene["extrinsics"],
            scene["origin"], model.n_voxels, model.voxel_size,
            model.meta.ori_shape, model.meta.img_shape,
            compute_dtype=model.compute_dtype))))
    scene = view_shard(scene, pdist.rank(view_group), pdist.world(view_group))
    batch = {k: scene[k] for k in ("intrinsic", "extrinsics", "origin")}
    batch["imgs"] = _to_device(scene["imgs"], dev)
    if "depth" in scene:
        batch["depth"] = _to_device(scene["depth"], dev)
    if host_rgb:
        batch["rgb_s1"] = _to_device(scene["rgb_s1"], dev)
        batch["rgb_s2"] = _to_device(scene["rgb_s2"], dev)
    # the images feed the density's rgb stream without host sums, and an
    # image-mode render without the host ray stream
    if (model.nerf_density and not host_rgb) or (
            not model.host_streams and model.nerf_mode == "image"):
        batch["denorm_images"] = _to_device(scene["denorm_images"], dev)
    return batch


def train_batch(model: NerfDet, scenes: List[Dict],
                rng: Optional[np.random.RandomState] = None,
                view_group=None) -> List[Dict]:
    """The train step's inputs for a list of numpy scenes: each scene's
    ``device_batch`` (images and host rgb sums on the model's device)
    with its padded ground truth: gt_boxes (G, 7) float32, gt_labels
    (G,) int64 and gt_mask (G,) bool. A scene with rays (ray_o, ray_d,
    gt_rgb, optionally gt_depth) also brings them and their host ray
    stream (``data/ray_stats.prepare_rays`` at the model's N_rand,
    near/far, samples and compute dtype, drawn from ``rng``, a fresh unseeded
    ``RandomState`` if None, where the scene carries no stream yet). With
    a ``view_group`` the images are this rank's slice of the views
    (``device_batch``); the rays and their stream hold every view.

    A model without host streams (``NerfDet.host_streams``) gets the
    drawn rays alone (``data/ray_stats.draw_rays``): its render jitters
    the depths on the device and samples the denormalized images there
    (image mode; ``device_batch`` sends them)."""
    dev = _device_of(model)
    out = []
    for scene in scenes:
        rays = "ray_o" in scene and isinstance(model, NerfDet)
        if rays and not model.host_streams:
            scene = draw_rays(scene, rng if rng is not None else
                              np.random.RandomState(), model.n_rand)
        elif rays and "z_vals" not in scene:
            scene = prepare_rays(
                scene, rng if rng is not None else
                np.random.RandomState(), model.n_rand,
                model.near_far_range, model.n_samples,
                model.meta.ori_shape, model.meta.img_shape,
                model.compute_dtype)
        batch = device_batch(model, scene, view_group)
        batch["gt_boxes"] = _to_device(scene["gt_boxes"], dev)
        batch["gt_labels"] = torch.as_tensor(
            np.asarray(scene["gt_labels"], np.int64), device=dev)
        batch["gt_mask"] = torch.as_tensor(
            np.asarray(scene["gt_mask"], bool), device=dev)
        if rays:
            keys = ("ray_o", "ray_d", "gt_rgb") + (
                RAY_STREAM_KEYS if model.host_streams else ()) + (
                ("gt_depth",) if "gt_depth" in scene else ())
            batch.update((k, _to_device(scene[k], dev)) for k in keys)
        out.append(batch)
    return out


@dataclasses.dataclass
class Trainer:
    """What ``init_trainer`` builds: the model (train mode), its
    optimizer (``optimizer.schedule(k)`` is the rate of update k) and the
    train step (``step(train_batch(model, scenes, view_group=
    trainer.view_group))`` -> metrics); on the 2-D grid its views and
    data groups (None otherwise)."""

    model: NerfDet
    optimizer: Optimizer
    step: Callable[[List[Dict]], Dict[str, torch.Tensor]]
    view_group: Any = None
    data_group: Any = None


def init_trainer(config, checkpoint: Optional[str] = None, device="cuda",
                 seed: int = 0, steps_per_epoch: int = 1,
                 compute_dtype=None, process_group=None,
                 mesh_views: int = 1) -> Trainer:
    """Joint detection + NVS training from a NeRF-Det config, as
    ``tools/train.py`` of the JAX package trains it: the model as
    ``init_detector`` builds it, in train mode; AdamW, gradient clipping
    and the lr schedule from the config's ``optimizer``,
    ``optimizer_config`` and ``lr_config`` (``total_epochs`` epochs of
    ``steps_per_epoch`` steps); the step's losses from ``config.model``:
    ``rgb_supervision`` (default True: the NVS loss on the batch's rays),
    ``depth_supervise`` (default False) and ``use_nerf_mask`` (default
    True). The model computes in ``compute_dtype`` (``init_detector``);
    the gradients, the optimizer state and the parameters stay float32.
    Runs on the card unless ``device="cpu"``. With a ``process_group``
    (``parallel/dist.py``) the step is data parallel over its ranks
    (``train/step.py``): every rank builds the same model from the same
    ``seed`` and ``checkpoint`` and steps its own scenes. ``mesh_views``
    > 1 lays the group out as the 2-D data x views grid, ``mesh_views``
    ranks a scene (``parallel/train2d.make_train_step_2d``; not in volume
    mode)."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    refusal = unported_refusal(config.model)
    if refusal is not None:
        raise NotImplementedError(refusal)
    model = init_detector(config, checkpoint, device, seed, compute_dtype)
    if not isinstance(model, (NerfDet, IndoorImVoxelNet)):
        raise NotImplementedError(
            f"training {type(model).__name__} is not ported yet")
    model.train()
    schedule = build_lr_schedule_from_config(
        config.optimizer["lr"], config.get("lr_config", dict(step=(8, 11))),
        steps_per_epoch, config.get("total_epochs", 12))
    optimizer = build_optimizer(
        model, dict(config.optimizer),
        grad_clip=config.get("optimizer_config", {}).get("grad_clip"),
        lr_schedule=schedule)
    losses = dict(
        depth_supervise=config.model.get("depth_supervise", False),
        use_nerf_mask=config.model.get("use_nerf_mask", True),
        rgb_supervision=config.model.get("rgb_supervision", True))
    if mesh_views > 1:
        if getattr(model, "nerf_mode", None) == "volume":
            raise NotImplementedError(VOLUME_MESH_VIEWS)
        step, views, data = make_train_step_2d(
            model, optimizer, mesh_views, process_group, **losses)
        return Trainer(model, optimizer, step, views, data)
    step = make_train_step(model, optimizer, process_group=process_group,
                           **losses)
    return Trainer(model, optimizer, step)


@torch.inference_mode()
def eval_step(model: NerfDet, batch: Dict, nms_pre: int = 1000,
              view_group=None) -> Dict:
    """Single-scene inference on the device: candidate boxes (M, 6), or
    (M, 7) gravity-centered yawed boxes for a yawed head (SUN RGB-D), and
    scores (M, n_classes), density modulation on; with a ray bundle in
    ``batch`` also its render_rgb (R, 3) and render_depth (R,). The
    scores and render_rgb are in the model's compute dtype. With a
    ``view_group`` the batch holds this rank's views (``device_batch``)
    and the outputs are the scene's, on every rank of the group."""
    head_outs, valid, render_out = model(batch, view_group=view_group)
    boxes, scores = get_candidate_bboxes(
        head_outs, valid, model.mlvl_points(batch["origin"]), nms_pre,
        model.n_classes, yaw=getattr(model, "yaw", False))
    out = dict(boxes=boxes, scores=scores)
    if render_out is not None:
        out["render_rgb"] = render_out["rgb"]
        out["render_depth"] = render_out["depth"]
    return out


def detections_from_candidates(boxes, scores, score_thr: float = 0.01,
                               iou_thr: float = 0.25) -> Dict:
    """Candidates -> final detections on the host: score threshold, then
    for (M, 6) corner boxes class-aware axis-aligned NMS, corners -> (cx,
    cy, z_bottom, dx, dy, dz, yaw=0); for (M, 7) gravity-centered yawed
    boxes (SUN RGB-D) rotated BEV NMS class by class on (cx, cy, dx, dy,
    yaw), the kept boxes in descending score order (a stable sort of the
    classes' picks in ascending class order), each gravity center moved
    to the bottom. Returns numpy boxes_3d (n, 7), scores_3d, labels_3d."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    labels = scores.argmax(axis=1)
    max_scores = scores.max(axis=1)
    keep = max_scores > score_thr
    boxes, max_scores, labels = boxes[keep], max_scores[keep], labels[keep]
    if boxes.shape[-1] == 7:
        pick = []
        for cls in np.unique(labels):
            sel = np.flatnonzero(labels == cls)
            ids = nms_bev_rotated(boxes[sel][:, [0, 1, 3, 4, 6]],
                                  max_scores[sel], iou_thr)
            pick.extend(sel[ids])
        pick = np.asarray(sorted(pick, key=lambda i: -max_scores[i]),
                          np.int64)
        out = boxes[pick].copy()
        out[:, 2] -= out[:, 5] / 2.0  # gravity center -> bottom
        return dict(boxes_3d=out, scores_3d=max_scores[pick],
                    labels_3d=labels[pick])
    ids = aligned_3d_nms(boxes, max_scores, labels, iou_thr)
    boxes = boxes[ids]
    out = np.zeros((len(boxes), 7), np.float32)
    out[:, 0] = (boxes[:, 0] + boxes[:, 3]) / 2.0
    out[:, 1] = (boxes[:, 1] + boxes[:, 4]) / 2.0
    out[:, 2] = boxes[:, 2]
    out[:, 3] = boxes[:, 3] - boxes[:, 0]
    out[:, 4] = boxes[:, 4] - boxes[:, 1]
    out[:, 5] = boxes[:, 5] - boxes[:, 2]
    return dict(boxes_3d=out, scores_3d=max_scores[ids],
                labels_3d=labels[ids])


def single_scene_test(model: NerfDet, scene: Dict, score_thr: float = 0.01,
                      iou_thr: float = 0.25, nms_pre: int = 1000,
                      view_group=None) -> Dict:
    """Device path + host NMS for one scene (numpy scene dict), its views
    sharded over ``view_group`` where given."""
    out = eval_step(model, device_batch(model, scene, view_group), nms_pre,
                    view_group)
    return detections_from_candidates(out["boxes"].float().cpu().numpy(),
                                      out["scores"].float().cpu().numpy(),
                                      score_thr, iou_thr)


@torch.inference_mode()
def points_eval_step(model: VoteNet, points):
    """One cloud through VoteNet and the decode, on the model's device:
    (N, 3 + extra) points (numpy or tensor) -> ((P, 7) gravity-centered
    boxes, (P,) objectness, (P, num_classes) semantic probabilities)."""
    pts = torch.as_tensor(points, dtype=torch.float32,
                          device=_device_of(model))
    return vote_head_get_bboxes(model(pts), model.bbox_coder)


def single_cloud_test(model: VoteNet, points, nms_thr: float = 0.25,
                      score_thr: float = 0.05,
                      per_class_proposal: bool = True) -> Dict:
    """Device path + host ``votenet_nms`` for one (N, 3 + extra) numpy
    cloud: boxes_3d (bottom-centered), scores_3d, labels_3d."""
    boxes, obj, sem = points_eval_step(model, points)
    return votenet_nms(boxes.cpu().numpy(), obj.cpu().numpy(),
                       sem.cpu().numpy(), np.asarray(points)[:, :3],
                       nms_thr=nms_thr, score_thr=score_thr,
                       per_class_proposal=per_class_proposal)


@torch.inference_mode()
def run_nvs_eval(model: NerfDet, dataset, chunk: int = 2048,
                 out_dir: Optional[str] = None, progress: bool = True,
                 logger=None) -> Dict:
    """Novel-view-synthesis evaluation: render every target view of
    every scene with ``render_full``, score PSNR / SSIM / RMSE, and
    optionally dump comparison PNGs under ``out_dir``.

    ``dataset`` needs ``len``, ``dataset[i]`` (a numpy scene with
    ``ray_o``/``ray_d`` (T, R, 3) or (R, 3), ``gt_rgb`` and optionally
    ``gt_depth``) and ``dataset.pipeline.pad_size`` / ``.margin``, which
    give the target views' (h, w); the port's test-mode
    ``ScanNetMultiViewDataset`` is one. Returns the metrics averaged over
    scenes (also to ``logger`` where given)."""
    h = dataset.pipeline.pad_size[0] - 2 * dataset.pipeline.margin
    w = dataset.pipeline.pad_size[1] - 2 * dataset.pipeline.margin
    per_scene = {}
    for i in range(len(dataset)):
        scene = dataset[i]
        rgb, depth = model.render_full(render_batch(model, scene), chunk)
        t = scene["ray_o"].shape[0] if scene["ray_o"].ndim == 3 else 1
        rgb = rgb.float().cpu().numpy().reshape(t, h, w, 3)
        depth = depth.float().cpu().numpy().reshape(t, h, w)
        gt_rgb = np.asarray(scene["gt_rgb"]).reshape(t, h, w, 3)
        gt_depth = (np.asarray(scene["gt_depth"]).reshape(t, h, w)
                    if "gt_depth" in scene else None)
        per_scene[f"scene_{i}"] = evaluate_rendering(
            rgb, gt_rgb, depth=depth, gt_depth=gt_depth, out_dir=out_dir,
            scene=f"scene_{i}")
        if progress:
            m = per_scene[f"scene_{i}"]
            print(f"[nvs] scene {i}: psnr={m['psnr']:.2f} "
                  f"ssim={m['ssim']:.3f}", flush=True)
    agg = aggregate_nvs(per_scene)
    if logger is not None:
        logger.info("NVS: " + " ".join(
            f"{k}: {v:.4f}" for k, v in agg.items()))
    return agg


def inference_detector(model: NerfDet, info: Dict, config,
                       use_depth: bool = False) -> Dict:
    """Detection on ONE raw scene described by ``info`` (``img_paths``,
    ``extrinsics`` world->cam, ``c2w``, ``intrinsic`` at the images'
    size), replaying the config's test pipeline with ``RandomState(0)``
    (with ``use_depth`` reading each view's depth map); the origin is
    (0, 0, 0.5) and the NMS threshold the test_cfg's ``iou_thr`` (0.25
    where it has none), as the JAX function sets them for every config:
    a SUN RGB-D dataset's origin (0, 3, -1) and its ``nms_thr`` (0.15)
    are not read here (``run_eval`` reads both; ROADMAP §3). Returns
    ``single_scene_test``'s dict."""
    if isinstance(config, str):
        config = Config.fromfile(config)
    ds = build_dataset(dict(config.data["test"]), test_mode=True,
                       use_depth=use_depth)
    scene = ds.pipeline(info, np.random.RandomState(0))
    scene["origin"] = np.array([0.0, 0.0, 0.5], np.float32)
    test_cfg = config.test_cfg
    return single_scene_test(model, scene,
                             score_thr=test_cfg.get("score_thr", 0.01),
                             iou_thr=test_cfg.get("iou_thr", 0.25),
                             nms_pre=test_cfg.get("nms_pre", 1000))


def run_eval(model: NerfDet, dataset, test_cfg: Dict, logger=None,
             progress: bool = True, process_group=None, view_group=None,
             data_group=None) -> Dict:
    """The detection eval loop: every scene of ``dataset`` through
    ``single_scene_test`` (the eval step with the density modulation on,
    as the original's ``simple_test``; the JAX ``run_eval`` defaults to
    an eval step without it), then ``dataset.evaluate`` (mAP / mAR). A
    dataset built with ``use_depth`` gives each scene its depth maps,
    which gate the fusion, as in the JAX loop.

    With a ``process_group`` of W ranks, rank r evaluates scenes
    ``r::W``; rank 0 gathers every rank's detections through the group,
    scores them in scene order and returns the metrics, the others {}.

    On the 2-D grid (``view_group`` and ``data_group`` of
    ``parallel/dist.mesh_groups``; ``process_group`` unused) the scenes
    are split so over the data groups, and each scene's views over its
    views group: the group's first rank loads it and sends it to the
    others (``parallel/train2d.shared_scene``)."""
    if view_group is not None:
        process_group = data_group
    rank, world = pdist.rank(process_group), pdist.world(process_group)
    n = len(dataset)
    local: List = []
    for i in range(rank, n, world):
        scene = shared_scene(lambda: dataset[i], view_group)
        local.append((i, single_scene_test(
            model, scene, score_thr=test_cfg.get("score_thr", 0.01),
            iou_thr=test_cfg.get("iou_thr", test_cfg.get("nms_thr", 0.25)),
            nms_pre=test_cfg.get("nms_pre", 1000), view_group=view_group)))
        if progress and len(local) % 10 == 0:
            print(f"[eval] rank {rank}: {len(local)}/"
                  f"{(n - rank + world - 1) // world}", flush=True)
    if view_group is not None and pdist.rank(view_group) != 0:
        return {}
    parts = pdist.gather_to_rank0(local, process_group)
    if parts is None:
        return {}
    merged = dict(r for part in parts for r in part)
    return dataset.evaluate([merged[i] for i in range(n)], logger=logger)
