"""ScanNet multi-view dataset (host side, numpy scenes).

Port of ``nerfdet_tpu/data/dataset.py``: ``ScanNetMultiViewDataset``
(per-scene info -> camera geometry, the pipeline, the empty-GT resample,
the indoor-protocol ``evaluate``), the host-statistics specs and the
multi-view branch of ``build_dataset`` with ``RepeatDataset``. A scene is
the original's, key for key and bit for bit: the host rgb sums of the
density volume (``data/rgb_stats.py``) and, in train mode, the N_rand
rays with their stratified depths and rgb sums (``data/ray_stats.py``),
all computed with the pipeline's own ``ori_shape`` / ``img_shape``.
``api.train_batch`` takes the scenes as they are and draws nothing more.

Only float32 host statistics are ported, and the other dataset types
(points, SUN RGB-D, the outdoor sets) are not.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.eval import indoor_eval
from .pipeline import (MultiViewPipeline, RandomShiftOrigin, pad_gt,
                       subsample_rays)
from .ray_stats import host_ray_rgb_stats, host_sample_z
from .rgb_stats import host_rgb_stats

SCANNET_CLASSES = (
    'cabinet', 'bed', 'chair', 'sofa', 'table', 'door', 'window',
    'bookshelf', 'picture', 'counter', 'desk', 'curtain', 'refrigerator',
    'showercurtrain', 'toilet', 'sink', 'bathtub', 'garbagebin',
)


class ScanNetMultiViewDataset:
    """Multi-view posed-RGB ScanNet dataset.

    Args:
        data_root: dataset root (contains ``posed_images/`` etc.).
        ann_file: ``scannet_infos_{train,val}.pkl``.
        pipeline: a :class:`MultiViewPipeline`.
        classes: class names (defaults to the 18 ScanNet classes).
        test_mode: disables GT filtering and augmentation; scene i draws
            from ``RandomState(i)``.
        use_ray: emit ray bundles for the NeRF branch.
        n_rand: training ray-subset size.
        max_gt: GT padding size.
        shift_origin_std: train-time origin jitter std (None disables).
        repeat_times: the ``RepeatDataset`` factor.
        seed: seed of the stream that gives each train-mode scene its
            own ``RandomState`` seed, one draw a ``__getitem__`` call.
        rgb_stats_spec: ``(n_voxels, voxel_size, "float32")``: ship the
            density volume's host rgb sums (``rgb_s1``, ``rgb_s2``).
        ray_stats_spec: ``(near_far, n_samples, "float32")``: in train
            mode, ship the rays' stratified depths and rgb sums
            (``z_vals``, ``ray_s1u``, ``ray_s2u``, ``ray_s1m``,
            ``ray_cnt``).
    """

    def __init__(self, data_root: str, ann_file: str,
                 pipeline: Optional[MultiViewPipeline] = None,
                 classes: Sequence[str] = SCANNET_CLASSES,
                 test_mode: bool = False,
                 use_ray: bool = True,
                 n_rand: int = 2048,
                 max_gt: int = 64,
                 shift_origin_std=(0.7, 0.7, 0.0),
                 filter_empty_gt: bool = True,
                 repeat_times: int = 1,
                 seed: int = 0,
                 rgb_stats_spec=None,
                 ray_stats_spec=None):
        self.data_root = data_root
        self.classes = tuple(classes)
        self.test_mode = test_mode
        self.use_ray = use_ray
        self.n_rand = n_rand
        self.max_gt = max_gt
        self.rgb_stats_spec = rgb_stats_spec
        self.ray_stats_spec = ray_stats_spec
        self.filter_empty_gt = filter_empty_gt and not test_mode
        self.repeat_times = repeat_times
        self.pipeline = pipeline or MultiViewPipeline()
        self.shift_origin = (
            RandomShiftOrigin(shift_origin_std)
            if (shift_origin_std is not None and not test_mode) else None
        )
        with open(ann_file, "rb") as f:
            self.data_infos = pickle.load(f)
        # shared by every caller: with more than one loader thread, which
        # scene gets which draw depends on the threads' timing (as in the
        # JAX package; ROADMAP §3)
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.data_infos) * self.repeat_times

    # ------------------------------------------------------------------

    def get_data_info(self, index: int) -> Optional[Dict]:
        """Scene geometry dict; None for a scene without GT where empty
        scenes are filtered."""
        info = self.data_infos[index % len(self.data_infos)]
        axis_align = np.asarray(
            info["annos"]["axis_align_matrix"], np.float32)
        img_paths = [os.path.join(self.data_root, p)
                     for p in info["img_paths"]]
        extrinsics, c2ws = [], []
        for pose in info["extrinsics"]:
            c2w = (axis_align @ np.asarray(pose, np.float32))
            c2ws.append(c2w.astype(np.float32))
            extrinsics.append(np.linalg.inv(c2w).astype(np.float32))
        out = dict(
            img_paths=img_paths,
            extrinsics=np.stack(extrinsics),
            c2w=np.stack(c2ws),
            intrinsic=np.asarray(info["intrinsics"], np.float32),
            origin=np.array([0.0, 0.0, 0.5], np.float32),
        )
        ann = self.get_ann_info(index)
        out.update(ann)
        if self.filter_empty_gt and len(ann["gt_labels_3d"]) == 0:
            return None
        return out

    def get_ann_info(self, index: int) -> Dict:
        """Bottom-centered (origin (.5, .5, 0)) GT boxes + labels."""
        info = self.data_infos[index % len(self.data_infos)]
        annos = info["annos"]
        if annos["gt_num"] != 0:
            boxes = np.asarray(
                annos["gt_boxes_upright_depth"], np.float32)
            labels = np.asarray(annos["class"], np.int64)
        else:
            boxes = np.zeros((0, 6), np.float32)
            labels = np.zeros((0,), np.int64)
        if boxes.shape[0]:
            if boxes.shape[-1] == 6:
                boxes = np.concatenate(
                    [boxes, np.zeros_like(boxes[:, :1])], axis=-1)
            boxes = boxes.copy()
            # gravity center -> bottom center
            boxes[:, 2] -= boxes[:, 5] / 2.0
        return dict(gt_bboxes_3d=boxes, gt_labels_3d=labels)

    # ------------------------------------------------------------------

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.RandomState(
            self._rng.randint(0, 2 ** 31 - 1) if not self.test_mode
            else index)
        info = self.get_data_info(index)
        while info is None:  # empty-GT resample
            index = rng.randint(0, len(self))
            info = self.get_data_info(index)

        sample = self.pipeline(info, rng)
        origin = info["origin"]
        if self.shift_origin is not None:
            origin = self.shift_origin(origin, rng)
        sample["origin"] = origin

        boxes, labels, mask = pad_gt(
            info["gt_bboxes_3d"], info["gt_labels_3d"], self.max_gt)
        sample["gt_boxes"] = boxes
        sample["gt_labels"] = labels
        sample["gt_mask"] = mask

        if self.use_ray and not self.test_mode and "raydirs" in sample:
            sample = subsample_rays(sample, self.n_rand, rng)
            if self.ray_stats_spec is not None:
                near_far, n_samples, cdtype = self.ray_stats_spec
                z_vals = host_sample_z(rng, sample["ray_o"].shape[0],
                                       near_far[0], near_far[1],
                                       n_samples)
                s1u, s2u, s1m, cnt = host_ray_rgb_stats(
                    sample["denorm_images"], sample["intrinsic"],
                    sample["extrinsics"], sample["ray_o"],
                    sample["ray_d"], z_vals, sample["ori_shape"],
                    sample["img_shape"], compute_dtype=cdtype)
                sample["z_vals"] = z_vals
                sample["ray_s1u"] = s1u
                sample["ray_s2u"] = s2u
                sample["ray_s1m"] = s1m
                sample["ray_cnt"] = cnt
        elif self.use_ray and "raydirs" in sample:
            # test: keep per-view ray images; rename for the model
            sample["ray_o"] = sample.pop("lightpos")
            sample["ray_d"] = sample.pop("raydirs")
            sample["gt_rgb"] = sample.pop("gt_images")
        if self.rgb_stats_spec is not None:
            n_vox, vsz, cdtype = self.rgb_stats_spec
            s1, s2 = host_rgb_stats(
                sample["denorm_images"], sample["intrinsic"],
                sample["extrinsics"], origin, n_vox, vsz,
                sample["ori_shape"], sample["img_shape"],
                compute_dtype=cdtype)
            sample["rgb_s1"] = s1
            sample["rgb_s2"] = s2
        # host-only metadata stays out of the scene
        for k in ("ori_shape", "img_shape", "depth_range", "nerf_size"):
            sample.pop(k, None)
        return sample

    # ------------------------------------------------------------------

    def ground_truth_annos(self) -> List[Dict]:
        """GT dicts for ``indoor_eval`` (gravity-centered boxes)."""
        out = []
        for info in self.data_infos:
            annos = info["annos"]
            out.append(dict(
                gt_num=annos["gt_num"],
                gt_boxes_upright_depth=np.asarray(
                    annos.get("gt_boxes_upright_depth",
                              np.zeros((0, 6))), np.float32),
                **{"class": np.asarray(annos.get("class", []), np.int64)},
            ))
        return out

    def evaluate(self, results: List[Dict], metric=(0.25, 0.5),
                 logger=None) -> Dict:
        """ScanNet-protocol mAP/mAR at the IoU thresholds ``metric``."""
        label2cat = {i: c for i, c in enumerate(self.classes)}
        return indoor_eval(
            self.ground_truth_annos(), results, list(metric), label2cat,
            logger=logger)


def _refuse_bf16(bf16: bool, what: str) -> None:
    if bf16:
        raise NotImplementedError(
            f"bfloat16 {what} are not ported yet: the compute_dtype item "
            f"of ROADMAP §1 item 2")


def rgb_stats_spec_from_config(cfg, use_depth: bool = False,
                               bf16: bool = False):
    """``(n_voxels, voxel_size, "float32")`` for a nerf_density NerfDet
    config whose fusion runs without a depth gate (the flagship path),
    else None."""
    _refuse_bf16(bf16, "host rgb sums")
    model = cfg.get("model", {}) if hasattr(cfg, "get") else {}
    if model.get("type") != "nerfdet":  # the config registry key
        return None
    if not model.get("nerf_density", False) or use_depth:
        return None
    return (tuple(model["n_voxels"]), tuple(model["voxel_size"]),
            "float32")


def ray_stats_spec_from_config(cfg, bf16: bool = False):
    """``(near_far, n_samples, "float32")`` for an image-mode NerfDet
    config (the per-sample source-view colors are parameter-free), else
    None."""
    _refuse_bf16(bf16, "host ray streams")
    model = cfg.get("model", {}) if hasattr(cfg, "get") else {}
    if model.get("type") != "nerfdet":
        return None
    if model.get("nerf_mode", "image") != "image":
        return None
    return (tuple(model.get("near_far_range", (0.2, 8.0))),
            int(model.get("N_samples", 64)), "float32")


def build_dataset(data_cfg: Dict, test_mode: bool = False,
                  use_depth: bool = False, n_rand: int = 2048,
                  rgb_stats_spec=None,
                  ray_stats_spec=None) -> ScanNetMultiViewDataset:
    """Build from a reference-style ``data['train'/'val'/'test']`` dict
    (a ``RepeatDataset`` wrapper repeats the scenes ``times`` times)."""
    repeat = 1
    if data_cfg.get("type") == "RepeatDataset":
        repeat = data_cfg["times"]
        data_cfg = data_cfg["dataset"]
    if data_cfg.get("type", "ScanNetMultiViewDataset") != \
            "ScanNetMultiViewDataset":
        raise NotImplementedError(
            f"dataset type {data_cfg.get('type')!r} is not ported yet "
            f"(the point-cloud, SUN RGB-D and outdoor datasets come with "
            f"their models: ROADMAP §1 item 3)")
    pcfg = {d["type"]: d for d in data_cfg["pipeline"]}
    mv = pcfg.get("MultiViewPipeline", {})
    transforms = {t["type"]: t for t in mv.get("transforms", [])}
    pipeline = MultiViewPipeline(
        n_images=mv.get("n_images", 50),
        img_scale=tuple(transforms.get("Resize", {}).get(
            "img_scale", (320, 240))),
        pad_size=tuple(transforms.get("Pad", {}).get("size", (240, 320))),
        mean=mv.get("mean", (123.675, 116.28, 103.53)),
        std=mv.get("std", (58.395, 57.12, 57.375)),
        margin=mv.get("margin", 10),
        depth_range=mv.get("depth_range", (0.5, 5.5)),
        loading=mv.get("loading", "random"),
        nerf_target_views=mv.get("nerf_target_views", 10),
        use_depth=use_depth,
    )
    shift = pcfg.get("RandomShiftOrigin", {}).get("std")
    return ScanNetMultiViewDataset(
        data_root=data_cfg["data_root"],
        ann_file=data_cfg["ann_file"],
        pipeline=pipeline,
        classes=data_cfg.get("classes", SCANNET_CLASSES),
        test_mode=test_mode or data_cfg.get("test_mode", False),
        use_ray=data_cfg.get("modality", {}).get("use_ray", True),
        n_rand=n_rand,
        shift_origin_std=shift,
        filter_empty_gt=data_cfg.get("filter_empty_gt", False),
        repeat_times=repeat,
        rgb_stats_spec=rgb_stats_spec,
        ray_stats_spec=ray_stats_spec,
    )
