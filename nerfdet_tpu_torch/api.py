"""Detection inference entry points.

Port of ``nerfdet_tpu/api.py`` (``init_detector``,
``scene_meta_from_config``, ``single_scene_test``,
``detections_from_candidates``) and of the eval step of
``nerfdet_tpu/train/step.py:make_eval_step``. The port's eval step runs
the graph the parity tests and the benchmark run: the nerf_density
modulation is on (the JAX ``make_eval_step`` defaults to
``with_rays=False``, which skips it).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .config import Config
from .core.nms import aligned_3d_nms
from .data.rgb_stats import host_rgb_stats
from .device import resolve_device
from .models.builder import build_model
from .models.nerfdet import NerfDet, SceneMeta
from .nn.heads import get_candidate_bboxes
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
                  device="cuda", seed: int = 0) -> NerfDet:
    """Build the detector from a config file or object, in eval mode on
    ``device``. Weights are random from ``seed`` unless ``checkpoint``
    names a reference NeRF-Det ``.pth`` state_dict. Raises if
    ``device`` is CUDA and there is none."""
    dev = resolve_device(device)
    if isinstance(config, str):
        config = Config.fromfile(config)
    model = build_model(config.model, meta=scene_meta_from_config(config))
    model.init_weights(torch.Generator().manual_seed(seed))
    if checkpoint is not None:
        obj = torch.load(checkpoint, map_location="cpu", weights_only=True)
        load_reference_state_dict(model, obj.get("state_dict", obj))
    return model.to(dev).eval()


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def device_batch(model: NerfDet, scene: Dict) -> Dict:
    """The eval step's inputs for one scene: images on the model's
    device; the small geometry arrays stay on the host (the projection
    is computed there); the host rgb sums of the density path are
    computed here when the scene does not carry them."""
    dev = _device_of(model)
    batch = {k: scene[k] for k in ("intrinsic", "extrinsics", "origin")}
    batch["imgs"] = torch.as_tensor(np.asarray(scene["imgs"], np.float32),
                                    device=dev)
    if model.nerf_density:
        if "rgb_s1" in scene:
            s1, s2 = scene["rgb_s1"], scene["rgb_s2"]
        else:
            s1, s2 = host_rgb_stats(
                scene["denorm_images"], scene["intrinsic"],
                scene["extrinsics"], scene["origin"], model.n_voxels,
                model.voxel_size, model.meta.ori_shape, model.meta.img_shape)
        batch["rgb_s1"] = torch.as_tensor(np.asarray(s1, np.float32),
                                          device=dev)
        batch["rgb_s2"] = torch.as_tensor(np.asarray(s2, np.float32),
                                          device=dev)
    return batch


@torch.inference_mode()
def eval_step(model: NerfDet, batch: Dict, nms_pre: int = 1000) -> Dict:
    """Single-scene inference on the device: candidate boxes (M, 6) and
    scores (M, n_classes), density modulation on."""
    head_outs, valid = model(batch)
    boxes, scores = get_candidate_bboxes(
        head_outs, valid, model.mlvl_points(batch["origin"]), nms_pre,
        model.n_classes)
    return dict(boxes=boxes, scores=scores)


def detections_from_candidates(boxes, scores, score_thr: float = 0.01,
                               iou_thr: float = 0.25) -> Dict:
    """Candidates -> final detections on the host: score threshold,
    class-aware axis-aligned NMS, corners -> (cx, cy, z_bottom, dx, dy,
    dz, yaw=0). Returns numpy boxes_3d (n, 7), scores_3d, labels_3d."""
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    labels = scores.argmax(axis=1)
    max_scores = scores.max(axis=1)
    keep = max_scores > score_thr
    boxes, max_scores, labels = boxes[keep], max_scores[keep], labels[keep]
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
                      iou_thr: float = 0.25, nms_pre: int = 1000) -> Dict:
    """Device path + host NMS for one scene (numpy scene dict)."""
    out = eval_step(model, device_batch(model, scene), nms_pre)
    return detections_from_candidates(out["boxes"].cpu().numpy(),
                                      out["scores"].cpu().numpy(),
                                      score_thr, iou_thr)
