"""The joint detection + NVS train step: per-scene loss sums, their
reduction, and one optimizer update.

Port of ``nerfdet_tpu/train/step.py`` (``scene_loss_terms``,
``reduce_loss_terms``, ``make_train_step``): the loss is the head's
centerness + cls + bbox terms plus, for a scene with rays under
``rgb_supervision``, the masked photometric loss ``loss_nvs`` and under
``depth_supervise`` the masked depth loss ``loss_depth``, each a per-scene
term averaged over the scenes. As in the JAX step, which ``vmap``s the
scenes of a batch:

* every scene runs its own forward, its BatchNorms normalized by its own
  statistics and updated from the same running statistics; the running
  statistics are then the mean of the scenes' updates (running the
  scenes one after another through stock BatchNorm would chain them);
* the focal and centerness losses divide by the cross-scene mean of the
  positive counts (at least 1), the bbox loss by each scene's own
  positives' centerness sum;
* ``grad_norm`` is the global norm of every gradient, frozen parameters
  included.

The scenes' graphs are all kept until the one backward (the cross-scene
n_pos is known only after every forward); one scene a step, as the
configs' ``samples_per_gpu=1``, keeps one.

Over a process group (one process a card, ``parallel/dist.py``) the
step is the JAX step on the global batch of every rank's scenes: n_pos
is the mean over all of them (an all-reduce before the loss is formed),
each rank's backward takes its scenes' share of the loss, and the
gradients (missing ones as zeros), the running statistics and the
metrics are then averaged over the ranks, in one flat buffer each, before
the clip. A rank's scenes are as many as every other's.

On the 2-D data x views grid (``--mesh-views``, JAX's
``parallel/train2d.make_train_step_2d``) the ranks of a views group share
their scenes, each holding a slice of every scene's views and rendering
a slice of its rays; the views' and rays' sums are summed over the group
(``parallel/dist.all_reduce_sum``), so every rank of the group computes
the same global loss. The backward sums the cotangents of those sums over
the group, which gives a sharded part's gradient once for each rank of
the group and a replicated part's once on each rank; the mean of the
gradients over every rank is then the gradient of the global batch for
both, as JAX's pmean over (data, views). The running statistics are
averaged over every rank, n_pos and the metrics over the data group.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from ..models.nerfdet import NerfDet
from ..nn.heads import head_loss_sums
from ..parallel import dist as pdist
from .optim import Optimizer


def scene_loss_terms(model: NerfDet, scene: Dict,
                     depth_supervise: bool = False,
                     use_nerf_mask: bool = True,
                     rgb_supervision: bool = True, view_group=None,
                     n_ray_shards: int = 1) -> Dict[str, torch.Tensor]:
    """Loss sums of ONE scene through the train-mode forward (which
    updates the 3D neck's running statistics in place). With rays and
    ``rgb_supervision``: ``loss_nvs``, the squared rgb error summed over
    the rays' mask (the ray mask if ``use_nerf_mask``, else every ray)
    over the mask's sum + 1e-6, and with ``depth_supervise`` likewise
    ``loss_depth`` from the absolute depth error. ``view_group``: the
    scene's view-led inputs are this rank's views (``NerfDet.forward``);
    with ``n_ray_shards`` > 1 the rank renders its slice of the rays, and
    the masked sums and the mask's sum are summed over the group before
    the divide, so every term is the scene's on every rank."""
    head_outs, valid, render = model(scene, view_group=view_group,
                                     n_ray_shards=n_ray_shards)
    terms = head_loss_sums(
        head_outs, valid, model.mlvl_points(scene["origin"]),
        scene["gt_boxes"], scene["gt_labels"], scene["gt_mask"],
        model.n_scales, model.head_limit, model.head_centerness_topk,
        model.n_classes)
    if render is not None and rgb_supervision:
        gt_rgb, gt_depth = scene["gt_rgb"], scene.get("gt_depth")
        sharded = view_group is not None and n_ray_shards > 1
        if sharded:  # this rank's contiguous slice of the rays
            part = gt_rgb.shape[0] // n_ray_shards
            lo = pdist.rank(view_group) * part
            gt_rgb = gt_rgb[lo:lo + part]
            if gt_depth is not None:
                gt_depth = gt_depth[lo:lo + part]
        mask = (render["mask"].float() if use_nerf_mask
                else torch.ones_like(render["depth"]))
        sums = [mask.sum(), torch.sum(
            mask[..., None] * (render["rgb"] - gt_rgb) ** 2)]
        if depth_supervise:
            sums.append(torch.sum(
                mask * torch.abs(render["depth"] - gt_depth)))
        if sharded:
            sums = pdist.all_reduce_sum(*sums, group=view_group)
        den = sums[0] + 1e-6
        terms["loss_nvs"] = sums[1] / den
        if depth_supervise:
            terms["loss_depth"] = sums[2] / den
    return terms


def reduce_loss_terms(terms: Sequence[Dict[str, torch.Tensor]],
                      group=None):
    """The global loss and metrics from the per-scene sums. With a
    process ``group`` the positives are averaged over every rank's
    scenes, the loss returned is this rank's share (its scenes' mean,
    whose gradients the ranks then average) and the metrics are the
    global ones."""
    def mean(key):
        return torch.stack([t[key] for t in terms]).mean()

    n_pos_mean = mean("n_pos")
    if group is not None:
        n_pos_mean = n_pos_mean.detach().clone()
        pdist.all_reduce_mean_([n_pos_mean], group)
    n_pos = torch.clamp(n_pos_mean, min=1.0)
    loss_centerness = mean("centerness_sum") / n_pos
    loss_cls = mean("cls_sum") / n_pos
    loss_bbox = torch.stack([
        t["bbox_sum"] / torch.clamp(t["bbox_avg"], min=1e-6)
        for t in terms]).mean()
    loss = loss_centerness + loss_cls + loss_bbox
    metrics = dict(loss_centerness=loss_centerness, loss_cls=loss_cls,
                   loss_bbox=loss_bbox, n_pos=n_pos_mean)
    for key in ("loss_nvs", "loss_depth"):
        if key in terms[0]:
            metrics[key] = mean(key)
            loss = loss + metrics[key]
    metrics["loss"] = loss
    if group is not None:
        local = [k for k in metrics if k != "n_pos"]
        values = [metrics[k].detach().clone() for k in local]
        pdist.all_reduce_mean_(values, group)
        metrics.update(zip(local, values))
    return loss, metrics


def _running_stats(model) -> List[torch.Tensor]:
    return [b for name, b in model.named_buffers()
            if name.endswith(("running_mean", "running_var"))]


def make_train_step(model: NerfDet, optimizer: Optimizer,
                    depth_supervise: bool = False,
                    use_nerf_mask: bool = True,
                    rgb_supervision: bool = True,
                    process_group=None, view_group=None, data_group=None
                    ) -> Callable[[List[Dict]], Dict[str, torch.Tensor]]:
    """The train step: ``step(scenes)`` runs a forward per scene, one
    backward and one update of ``optimizer``, and returns the metrics
    (loss, loss_centerness, loss_cls, loss_bbox, n_pos, grad_norm, and
    loss_nvs / loss_depth where the scenes carry rays and
    ``rgb_supervision`` / ``depth_supervise`` ask for them) as 0-d
    tensors on the model's device. ``scenes`` are ``api.train_batch``
    dicts. The model is put in train mode. The defaults are the JAX
    step's. With a ``process_group`` every rank calls ``step`` on its own
    scenes, as many on each, and takes the step of the global batch
    (the module docstring); the model and the optimizer must start the
    same on every rank. With a ``view_group`` (``parallel/dist.mesh_groups``:
    ``process_group`` is then the world, ``data_group`` this rank's data
    group) the step is the 2-D data x views step: each rank's scenes are
    its slices of its views group's scenes (``parallel/train2d``), and
    each renders its slice of their rays."""
    n_ray_shards = pdist.world(view_group)
    loss_group = process_group if view_group is None else data_group

    def step(scenes: List[Dict]) -> Dict[str, torch.Tensor]:
        model.train()
        optimizer.zero_grad()
        stats = _running_stats(model)
        start = [s.clone() for s in stats]
        updated = [torch.zeros_like(s) for s in stats]
        terms = []
        for scene in scenes:
            with torch.no_grad():
                for s, s0 in zip(stats, start):
                    s.copy_(s0)
            terms.append(scene_loss_terms(model, scene, depth_supervise,
                                          use_nerf_mask, rgb_supervision,
                                          view_group, n_ray_shards))
            with torch.no_grad():
                for u, s in zip(updated, stats):
                    u += s
        with torch.no_grad():
            for s, u in zip(stats, updated):
                s.copy_(u / len(scenes))
        pdist.all_reduce_mean_(stats, process_group)
        loss, metrics = reduce_loss_terms(terms, loss_group)
        loss.backward()
        pdist.all_reduce_mean_(optimizer.grads(), process_group)
        metrics["grad_norm"] = optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step
