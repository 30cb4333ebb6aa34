"""Evaluate a NeRF-Det checkpoint with the PyTorch port (mAP / NVS).

    python -m nerfdet_tpu_torch.tools.test \
        configs/nerfdet/nerfdet_res50_2x_low_res.py W/ckpts/ckpt_12.pth \
        --eval mAP nvs [--out metrics.json] [--show-dir renders] \
        [--max-scenes N] [--device cuda|cpu] [--options key=value ...]
    torchrun --nproc_per_node 4 -m nerfdet_tpu_torch.tools.test \
        <config> <checkpoint> --eval mAP --distributed

The NeRF-Det branch of ``tools/test.py`` of the JAX package: the test
dataset with its host rgb sums, the checkpoint (the port's own or a
reference ``.pth``) through ``api.init_detector``, ``api.run_eval``
for ``mAP`` and ``api.run_nvs_eval`` (chunks of the config's N_rand
rays) for ``nvs``, and the same JSON printed last (the ``mAP*``,
``mAR*``, ``psnr``, ``ssim`` and ``rmse`` keys). Detection runs with the
density modulation on, as the original's ``simple_test`` (the JAX tool
runs its eval step's default, without it). It runs on the card unless
``--device cpu`` is given, and raises where there is no card.
The depth maps are read where ``input_modality.use_depth`` asks (the
depth_sp configs), as in the JAX tool. ``--distributed`` (the train
CLI's process group and flags) shards ``mAP`` over the ranks, rank 0
scoring every rank's detections; ``nvs`` runs on rank 0 alone, and rank
0 alone prints. ``--mesh-views N`` (with ``--distributed``) lays the
ranks out as the 2-D data x views grid (``parallel/train2d.py``): each
scene's views are sharded over a views group of N ranks (its first rank
loads the scene and sends it to the others), and the scenes over the
world / N data groups; the JAX tool shards the views alone. N must
divide the world and the test scenes' views.
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import Dict, List, Optional

from .. import api
from ..config import Config
from ..data.dataset import build_dataset, rgb_stats_spec_from_config
from ..device import resolve_device
from ..parallel import dist as pdist
from ..parallel.train2d import check_mesh_views, pipeline_views
from ..utils.logging import get_root_logger

PRINTED = ("mAP", "mAR", "psnr", "ssim", "rmse")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test a detector")
    p.add_argument("config")
    p.add_argument("checkpoint")
    p.add_argument("--eval", nargs="+", default=["mAP"],
                   help="metrics: mAP and/or nvs")
    p.add_argument("--out", default=None, help="dump results json")
    p.add_argument("--show-dir", default=None,
                   help="dump rendered view PNGs here (nvs eval)")
    p.add_argument("--max-scenes", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--mesh-views", type=int, default=1,
                   help="ranks a scene's views are sharded over (with "
                        "--distributed)")
    p.add_argument("--distributed", action="store_true",
                   help="shard mAP over processes, one a card (torchrun, "
                        "or the three flags below)")
    p.add_argument("--coordinator", default=None,
                   help="distributed: rank 0's host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_options(args.options)
    if cfg.model["type"] != "nerfdet":
        raise NotImplementedError(
            f"evaluating {cfg.model['type']} from the CLI is not ported "
            f"yet: ROADMAP §1 item 3")
    if not args.distributed:
        check_mesh_views(args.mesh_views, None, {})
        return evaluate(args, cfg, resolve_device(args.device), None)
    with pdist.process_group(args.device, args.coordinator,
                             args.num_processes, args.process_id) as (
                                 device, group):
        check_mesh_views(args.mesh_views, pdist.world(group),
                         {"test": pipeline_views(cfg.data["test"])})
        return evaluate(args, cfg, device, group)


def evaluate(args, cfg, device, group) -> Dict:
    """The run of ``main`` on ``device``, ``mAP`` sharded over ``group``
    where one is given (on the 2-D grid with ``--mesh-views``); the
    metrics on rank 0, {} on the others."""
    rank = pdist.rank(group)
    views, data = pdist.mesh_groups(args.mesh_views, group)
    logger = get_root_logger(
        log_level=logging.INFO if rank == 0 else logging.WARNING)

    use_depth = cfg.get("input_modality", {}).get("use_depth", False)
    dataset = build_dataset(cfg.data["test"], test_mode=True,
                            use_depth=use_depth,
                            rgb_stats_spec=rgb_stats_spec_from_config(
                                cfg, use_depth=use_depth))
    if args.max_scenes:
        dataset.data_infos = dataset.data_infos[: args.max_scenes]
    model = api.init_detector(cfg, args.checkpoint, device=device)

    metrics = {}
    if "mAP" in args.eval:
        metrics.update(api.run_eval(model, dataset, dict(cfg.test_cfg),
                                    logger=logger, process_group=group,
                                    view_group=views, data_group=data))
    if rank != 0:
        return metrics
    if "nvs" in args.eval:
        metrics.update(api.run_nvs_eval(
            model, dataset, chunk=cfg.model.get("N_rand", 2048),
            out_dir=args.show_dir, logger=logger))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2)
    print(json.dumps({k: v for k, v in metrics.items()
                      if k.startswith(PRINTED)}, indent=2), flush=True)
    return metrics


if __name__ == "__main__":
    main()
