"""SUN RGB-D monocular datasets for the indoor ImVoxelNet (host side,
numpy scenes).

Port of ``nerfdet_tpu/data/sunrgbd_multiview.py``
(``SunRgbdMultiViewDataset``, ``SunRgbdPerspectiveMultiViewDataset``):
each scene is one image whose camera is the info pkl's ``calib`` (``K``
nine values, read as a 3x3 and transposed; ``Rt`` a 3x3 whose y and z
columns are swapped, y negated and the result transposed into the
world -> camera extrinsic, ``c2w`` its inverse), the volume at the fixed
origin (0, 3, -1), the GT yawed Depth boxes moved from their gravity
center to the bottom. The scenes are ``ScanNetMultiViewDataset``'s
(``data/dataset.py``), without rays or an origin shift; ``evaluate``
runs the indoor protocol on the pkl's yawed GT at (0.25, 0.5), the
perspective split at (0.15,).

The info pkls are plain pickles in the schema of the JAX package's
``data/sunrgbd_etl.create_sunrgbd_infos`` (``image.image_path``,
``calib.K`` / ``calib.Rt``, ``annos`` with ``gt_num``, ``class`` and
``gt_boxes_upright_depth`` (K, 7)); the port reads them and does not
write them. The total-scene split (``SunRgbdTotalMultiViewDataset``, the
layout head's) is refused by name (``data/dataset.build_dataset``).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..core.eval import indoor_eval
from .dataset import ScanNetMultiViewDataset

# the 10 detection classes (a copy of ``nerfdet_tpu/data/
# sunrgbd_dataset.py``'s ``SUNRGBD_CLASSES``)
SUNRGBD_CLASSES = ("bed", "table", "sofa", "chair", "toilet", "desk",
                   "dresser", "night_stand", "bookshelf", "bathtub")


class SunRgbdMultiViewDataset(ScanNetMultiViewDataset):
    """Monocular SUN RGB-D scenes for the volume detector."""

    DEFAULT_CLASSES = SUNRGBD_CLASSES
    ORIGIN = (0.0, 3.0, -1.0)
    METRIC = (0.25, 0.5)

    def __init__(self, *args, **kwargs):
        if kwargs.get("classes") is None:
            kwargs["classes"] = self.DEFAULT_CLASSES
        kwargs.setdefault("use_ray", False)
        kwargs.setdefault("shift_origin_std", None)
        super().__init__(*args, **kwargs)

    def get_data_info(self, index: int) -> Optional[Dict]:
        info = self.data_infos[index % len(self.data_infos)]
        img_path = os.path.join(self.data_root,
                                info["image"]["image_path"])
        calib = info["calib"]
        intrinsic = np.eye(4, dtype=np.float32)
        intrinsic[:3, :3] = np.asarray(
            calib["K"], np.float32).reshape(3, 3).T
        rt = np.asarray(calib["Rt"], np.float32).copy()
        rt[:, [1, 2]] = rt[:, [2, 1]]
        rt[:, 1] = -rt[:, 1]
        extrinsic = np.eye(4, dtype=np.float32)
        extrinsic[:3, :3] = rt.T
        c2w = np.linalg.inv(extrinsic).astype(np.float32)

        out = dict(
            img_paths=[img_path],
            extrinsics=extrinsic[None],
            c2w=c2w[None],
            intrinsic=intrinsic,
            origin=np.asarray(self.ORIGIN, np.float32),
        )
        ann = self.get_ann_info(index)
        out.update(ann)
        if self.filter_empty_gt and len(ann["gt_labels_3d"]) == 0:
            return None
        return out

    def get_ann_info(self, index: int) -> Dict:
        """7-dof yawed Depth boxes, gravity -> bottom center."""
        info = self.data_infos[index % len(self.data_infos)]
        annos = info["annos"]
        if annos["gt_num"] != 0:
            boxes = np.asarray(
                annos["gt_boxes_upright_depth"], np.float32).copy()
            labels = np.asarray(annos["class"], np.int64)
            boxes[:, 2] -= boxes[:, 5] / 2.0
        else:
            boxes = np.zeros((0, 7), np.float32)
            labels = np.zeros((0,), np.int64)
        return dict(gt_bboxes_3d=boxes, gt_labels_3d=labels)

    def evaluate(self, results, metric=None, logger=None) -> Dict:
        """Indoor mAP / mAR at ``metric`` (the split's IoUs where None)
        against the pkl's yawed GT."""
        label2cat = {i: c for i, c in enumerate(self.classes)}
        gt_annos = [i["annos"] for i in self.data_infos]
        return indoor_eval(gt_annos, results,
                           list(self.METRIC if metric is None else metric),
                           label2cat, logger=logger)


class SunRgbdPerspectiveMultiViewDataset(SunRgbdMultiViewDataset):
    """The perspective-class split, evaluated at IoU 0.15."""

    METRIC = (0.15,)
