"""Train NeRF-Det with the PyTorch port, from a dataset on disk.

    python -m nerfdet_tpu_torch.tools.train \
        configs/nerfdet/nerfdet_res50_2x_low_res.py --work-dir W \
        [--resume-from W/ckpts/ckpt_1.pth] [--max-steps N] \
        [--device cuda|cpu] [--options key=value ...]
    torchrun --nproc_per_node 4 -m nerfdet_tpu_torch.tools.train \
        configs/nerfdet/nerfdet_res50_2x_low_res.py --distributed ...

The NeRF-Det branch of ``tools/train.py`` of the JAX package: the
config and its ``--options``, the train dataset with the host rgb sums
and ray stream (``data/dataset.py``), ``BatchLoader`` with
``workers_per_gpu`` threads, ``api.init_trainer``
with the loader's steps per epoch, ``--load-from`` (weights) and
``--resume-from`` (weights, optimizer state and step; training resumes
at epoch step // steps_per_epoch), a checkpoint every epoch
(``W/ckpts/ckpt_{epoch}.pth``, ``checkpoint_config.max_keep_ckpts``)
and validation through ``api.run_eval`` after it unless
``--no-validate``. The depth_sp configs' depth maps are read where
``model.depth_supervise`` or ``input_modality.use_depth`` asks for them
(the child configs set only these; the base's data dicts keep
``use_depth=False``, as in the JAX tool). ``--profile-steps N`` writes a ``torch.profiler``
trace of N steps from step 10 to ``W/trace/trace.json``. ``--bf16``
(or a config's ``bf16``, or any ``fp16``) computes in bfloat16, as the
JAX tool's: the model at ``compute_dtype=bfloat16`` and the host rgb
sums and ray stream rounded as its specs say; the parameters, the
optimizer state and the checkpoints stay float32. It runs on the card
unless ``--device cpu`` is given, and raises where there is no card.

``--distributed`` trains data parallel, one process a card
(``torchrun``'s environment, or ``--coordinator host:port
--num-processes N --process-id i`` as the JAX tool takes them; NCCL on
the cards, gloo with ``--device cpu``): ``--batch-size`` is the global
scenes a step (default one a rank), split evenly over the ranks, each
rank loading its share of every global batch with ``workers_per_gpu``
threads; the step is the JAX step on the global batch
(``train/step.py``). Every rank loads ``--load-from`` /
``--resume-from``; rank 0 alone logs, writes the checkpoints and the
trace, and the others wait for each checkpoint; validation is sharded
over the ranks (``api.run_eval``).

``--mesh-views N`` (with ``--distributed``) lays the ranks out as the
2-D data x views grid of the JAX tool (``parallel/train2d.py``): N ranks
share each scene, each holding its slice of the scene's views and
rendering its slice of the rays; ``--batch-size`` defaults to world / N
scenes, split over the world / N data groups. The first rank of each
views group loads the group's scenes and sends them to the others. N
must divide the world, the train scenes' views and ``N_rand``.
Validation is sharded over the scenes, as without it.

Not ported, refused with the ROADMAP item that brings them: the
point-cloud and ImVoxelNet models.

``main(argv)`` returns what the run did (work dir, checkpoints, every
step's metrics with its seconds waiting on the loader and in the step,
the validation metrics; on a rank other than 0 no checkpoints and no
validation metrics), for callers in the same process.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Dict, List, Optional

import torch

from .. import api
from ..config import Config
from ..data.dataset import (build_dataset, ray_stats_spec_from_config,
                            rgb_stats_spec_from_config)
from ..data.loader import BatchLoader
from ..device import resolve_device
from ..parallel import dist as pdist
from ..parallel.train2d import (check_mesh_views, pipeline_views,
                                shared_batches)
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import MetricsLogger, collect_env, get_root_logger

PROFILE_START = 10  # the first step of a --profile-steps trace


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a detector")
    p.add_argument("config", help="config file path")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None,
                   help="resume weights, optimizer state and step")
    p.add_argument("--load-from", default=None,
                   help="initialize the weights only from a checkpoint "
                        "(the port's or a reference .pth)")
    p.add_argument("--no-validate", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--total-epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="global scenes a step (default one a process)")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many steps in all")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="trace N steps from step 10 with torch.profiler "
                        "(written to work_dir/trace)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--distributed", action="store_true",
                   help="data parallel, one process a card (torchrun, "
                        "or the three flags below)")
    p.add_argument("--coordinator", default=None,
                   help="distributed: rank 0's host:port")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (parameters and optimizer stay "
                        "float32)")
    p.add_argument("--mesh-views", type=int, default=1,
                   help="ranks a scene on the 2-D data x views grid "
                        "(with --distributed)")
    p.add_argument("--options", nargs="+", default=[],
                   help="config overrides key=value")
    return p.parse_args(argv)


def refuse_unported(args, cfg) -> None:
    """Raise for what the port cannot train yet, naming its ROADMAP item."""
    if cfg.model["type"] != "nerfdet":
        raise NotImplementedError(
            f"training {cfg.model['type']} (the point-cloud and ImVoxelNet "
            f"models) is not ported yet: ROADMAP §1 item 3")


def _profiler(device) -> "object":
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=activities)


def main(argv: Optional[List[str]] = None) -> Dict:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.options:
        cfg.merge_from_options(args.options)
    refuse_unported(args, cfg)
    if not args.distributed:
        check_mesh_views(args.mesh_views, None, {})
        return train(args, cfg, resolve_device(args.device), None)
    with pdist.process_group(args.device, args.coordinator,
                             args.num_processes, args.process_id) as (
                                 device, group):
        check_mesh_views(
            args.mesh_views, pdist.world(group),
            {"train": pipeline_views(cfg.data["train"])},
            cfg.model.get("N_rand", 2048))
        return train(args, cfg, device, group)


def train(args, cfg, device, group) -> Dict:
    """The run of ``main`` on ``device``, data parallel over ``group``
    where one is given (on the 2-D grid with ``--mesh-views``)."""
    rank, world = pdist.rank(group), pdist.world(group)
    n_data = world // args.mesh_views  # scenes a global batch split over
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    if rank == 0:
        os.makedirs(work_dir, exist_ok=True)
        timestamp = time.strftime("%Y%m%d_%H%M%S")
        logger = get_root_logger(os.path.join(work_dir, f"{timestamp}.log"))
        logger.info("Environment:\n" + "\n".join(
            f"  {k}: {v}" for k, v in collect_env().items()))
        logger.info(f"Config: {args.config}")
    else:
        logger = get_root_logger(log_level=logging.WARNING)

    # ---- data ---------------------------------------------------------
    use_depth = cfg.model.get("depth_supervise", False) or cfg.get(
        "input_modality", {}).get("use_depth", False)
    # a config's fp16 = dict(loss_scale=...) maps to bfloat16 compute
    use_bf16 = bool(args.bf16 or cfg.get("bf16")
                    or cfg.get("fp16") is not None)
    stats_spec = rgb_stats_spec_from_config(cfg, use_depth=use_depth,
                                            bf16=use_bf16)
    ray_spec = ray_stats_spec_from_config(cfg, bf16=use_bf16)
    dataset = build_dataset(cfg.data["train"], use_depth=use_depth,
                            n_rand=cfg.model.get("N_rand", 2048),
                            rgb_stats_spec=stats_spec,
                            ray_stats_spec=ray_spec)
    batch_size = args.batch_size or n_data
    if batch_size % n_data:
        raise ValueError(f"--batch-size {batch_size} does not split over "
                         f"{n_data} data groups of {args.mesh_views} "
                         f"process(es)")
    loader = BatchLoader(
        dataset, batch_size=batch_size // n_data, shuffle=True,
        num_workers=cfg.data.get("workers_per_gpu", 1), seed=args.seed,
        rank=rank // args.mesh_views, world=n_data)
    steps_per_epoch = len(loader)
    total_epochs = args.total_epochs or cfg.get("total_epochs", 12)
    cfg.merge_from_options({"total_epochs": total_epochs})
    logger.info(
        f"{len(dataset)} samples, batch {batch_size} over {world} "
        f"process(es) ({n_data} data x {args.mesh_views} views), "
        f"{loader.num_workers} loader threads a process, "
        f"{steps_per_epoch} steps/epoch, {total_epochs} epochs, device "
        f"{device}, {'bfloat16' if use_bf16 else 'float32'} compute")

    # ---- model & optimizer -------------------------------------------
    load_from = args.load_from or cfg.get("load_from")
    tr = api.init_trainer(
        cfg, checkpoint=load_from, device=device, seed=args.seed,
        steps_per_epoch=steps_per_epoch,
        compute_dtype=torch.bfloat16 if use_bf16 else torch.float32,
        process_group=group, mesh_views=args.mesh_views)
    if load_from:
        logger.info(f"loaded weights from {load_from}")
    start_epoch = 0
    resume = args.resume_from or cfg.get("resume_from")
    if resume:
        ckpt = load_checkpoint(resume)
        tr.model.load_state_dict(ckpt["model"])
        tr.optimizer.load_state_dict(ckpt["optimizer"])
        start_epoch = int(ckpt["step"]) // steps_per_epoch
        logger.info(f"resumed from {resume} at epoch {start_epoch}, step "
                    f"{tr.optimizer.count}")

    mlog = MetricsLogger(work_dir, logger,
                         interval=cfg.get("log_config", {}).get(
                             "interval", 50)) if rank == 0 else None
    val_dataset = None
    if not args.no_validate:
        val_dataset = build_dataset(cfg.data["val"], test_mode=True,
                                    use_depth=use_depth,
                                    rgb_stats_spec=stats_spec)

    # ---- loop ---------------------------------------------------------
    result = dict(work_dir=work_dir, steps_per_epoch=steps_per_epoch,
                  start_epoch=start_epoch, checkpoints=[], history=[],
                  val=[])
    prof, done = None, False
    for epoch in range(start_epoch, total_epochs):
        t_ask = time.perf_counter()
        for it, scenes in enumerate(shared_batches(loader, tr.view_group)):
            t_got = time.perf_counter()
            gstep_pre = tr.optimizer.count
            if (args.profile_steps and gstep_pre == PROFILE_START
                    and rank == 0):
                prof = _profiler(device)
                prof.__enter__()
            metrics = tr.step(api.train_batch(tr.model, scenes,
                                              view_group=tr.view_group))
            gstep = epoch * steps_per_epoch + it
            values = {k: float(v) for k, v in metrics.items()}
            if prof is not None and (gstep_pre == PROFILE_START
                                     + args.profile_steps - 1):
                prof.__exit__(None, None, None)
                os.makedirs(os.path.join(work_dir, "trace"), exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(work_dir, "trace", "trace.json"))
                prof = None
                logger.info(f"profiler trace written to {work_dir}/trace")
            lr = float(tr.optimizer.schedule(gstep))
            if mlog is not None:
                mlog.update(gstep, epoch + 1, values, lr=lr)
            t_done = time.perf_counter()
            result["history"].append(dict(
                step=gstep + 1, epoch=epoch + 1, lr=lr,
                data_s=t_got - t_ask, step_s=t_done - t_got, **values))
            t_ask = time.perf_counter()
            if args.max_steps and gstep + 1 >= args.max_steps:
                done = True
                break

        if rank == 0:
            payload = dict(model=tr.model.state_dict(),
                           optimizer=tr.optimizer.state_dict(),
                           step=tr.optimizer.count, epoch=epoch + 1)
            path = save_checkpoint(
                os.path.join(work_dir, "ckpts"), epoch + 1, payload,
                meta=dict(epoch=epoch + 1, config=args.config),
                max_keep=cfg.get("checkpoint_config", {}).get(
                    "max_keep_ckpts", -1))
            result["checkpoints"].append(path)
            logger.info(f"saved checkpoint {path}")
        pdist.barrier(group)

        if val_dataset is not None:
            tr.model.eval()
            metrics = api.run_eval(tr.model, val_dataset,
                                   dict(cfg.test_cfg), logger=logger,
                                   process_group=group)
            tr.model.train()
            if mlog is not None:
                mlog.log_eval(tr.optimizer.count, metrics)
                result["val"].append(metrics)
        if done:
            break
    if prof is not None:  # the run ended inside the traced steps
        prof.__exit__(None, None, None)
    if mlog is not None:
        mlog.close()
    logger.info("training complete")
    return result


if __name__ == "__main__":
    main()
