"""Evaluate a NeRF-Det checkpoint with the PyTorch port (mAP / NVS).

    python -m nerfdet_tpu_torch.tools.test \
        configs/nerfdet/nerfdet_res50_2x_low_res.py W/ckpts/ckpt_12.pth \
        --eval mAP nvs [--out metrics.json] [--show-dir renders] \
        [--max-scenes N] [--device cuda|cpu] [--options key=value ...]

The NeRF-Det branch of ``tools/test.py`` of the JAX package: the test
dataset with its host rgb sums, the checkpoint (the port's own or a
reference ``.pth``) through ``api.init_detector``, ``api.run_eval``
for ``mAP`` and ``api.run_nvs_eval`` (chunks of the config's N_rand
rays) for ``nvs``, and the same JSON printed last (the ``mAP*``,
``mAR*``, ``psnr``, ``ssim`` and ``rmse`` keys). Detection runs with the
density modulation on, as the original's ``simple_test`` (the JAX tool
runs its eval step's default, without it). It runs on the card unless
``--device cpu`` is given, and raises where there is no card.
``--mesh-views`` > 1 and ``--distributed`` are not ported yet.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from .. import api
from ..config import Config
from ..data.dataset import build_dataset, rgb_stats_spec_from_config
from ..device import resolve_device
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
                   help="not ported yet beyond 1")
    p.add_argument("--distributed", action="store_true",
                   help="not ported yet")
    p.add_argument("--options", nargs="+", default=[])
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    if args.distributed or args.mesh_views > 1:
        raise NotImplementedError(
            "multi-card evaluation (--distributed) and the views-sharded "
            "eval (--mesh-views) are not ported yet: ROADMAP §1 item 1")
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_options(args.options)
    if cfg.model["type"] != "nerfdet":
        raise NotImplementedError(
            f"evaluating {cfg.model['type']} from the CLI is not ported "
            f"yet: ROADMAP §1 item 3")
    device = resolve_device(args.device)
    logger = get_root_logger()

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
                                    logger=logger))
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
