"""Run logging: root logger, environment, interval-averaged metrics.

Port of ``nerfdet_tpu/utils/logging.py``: the work-dir logfile, the
environment dump (torch, CUDA, the card and ``nvcc`` in place of JAX's
devices) and ``MetricsLogger`` with the original's message format and
``metrics.jsonl`` records. TensorBoard scalars are written where
``torch.utils.tensorboard`` imports (the original writes them where
``tensorflow`` does).
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import subprocess
import time
from collections import defaultdict
from typing import Dict, Optional


def get_root_logger(log_file: Optional[str] = None,
                    log_level=logging.INFO) -> logging.Logger:
    """The port's logger, to stderr and, where given, to ``log_file``
    (a later file replaces an earlier one: runs in one process each log
    to their own work dir)."""
    logger = logging.getLogger("nerfdet_tpu_torch")
    if not logger.handlers:
        logger.setLevel(log_level)
        sh = logging.StreamHandler()
        sh.setFormatter(_FORMAT)
        logger.addHandler(sh)
    if log_file:
        for h in [h for h in logger.handlers
                  if isinstance(h, logging.FileHandler)]:
            logger.removeHandler(h)
            h.close()
        os.makedirs(os.path.dirname(os.path.abspath(log_file)),
                    exist_ok=True)
        fh = logging.FileHandler(log_file)
        fh.setFormatter(_FORMAT)
        logger.addHandler(fh)
    return logger


_FORMAT = logging.Formatter(
    "%(asctime)s - %(name)s - %(levelname)s - %(message)s")


def _run(cmd) -> Optional[str]:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip()


def collect_env() -> Dict[str, str]:
    """Python, platform, torch, its CUDA, the card (name and power limit
    from ``nvidia-smi``) and ``nvcc``'s release, where present."""
    import platform

    import torch

    env = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "torch": torch.__version__,
        "torch.version.cuda": str(torch.version.cuda),
        "cuda available": str(torch.cuda.is_available()),
    }
    if torch.cuda.is_available():
        env["device"] = torch.cuda.get_device_name(0)
        env["device count"] = str(torch.cuda.device_count())
    if shutil.which("nvidia-smi"):
        card = _run(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"])
        if card:
            env["nvidia-smi"] = card.splitlines()[0]
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(nvcc):
        release = _run([nvcc, "--version"])
        if release:
            env["nvcc"] = release.splitlines()[-1]
    return env


class MetricsLogger:
    """Interval-averaged metrics -> logger + JSON lines (+ TensorBoard).

    Every ``interval`` steps the averaged metrics go to the logger as
    ``Epoch [e] iter [i] time t lr r k: v ...`` and to
    ``work_dir/metrics.jsonl`` as one record (step, epoch, iter_time,
    the averages, lr)."""

    def __init__(self, work_dir: str, logger: logging.Logger,
                 interval: int = 50, use_tensorboard: bool = True):
        self.logger = logger
        self.interval = interval
        self.work_dir = work_dir
        os.makedirs(work_dir, exist_ok=True)
        self.json_path = os.path.join(work_dir, "metrics.jsonl")
        self._buf = defaultdict(list)
        self._t_last = time.perf_counter()
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(os.path.join(work_dir, "tb"))

    def update(self, step: int, epoch: int, metrics: Dict[str, float],
               lr: Optional[float] = None):
        for k, v in metrics.items():
            self._buf[k].append(float(v))
        if (step + 1) % self.interval:
            return
        now = time.perf_counter()
        iter_time = (now - self._t_last) / self.interval
        self._t_last = now
        avg = {k: sum(v) / len(v) for k, v in self._buf.items()}
        self._buf.clear()
        msg = (f"Epoch [{epoch}] iter [{step + 1}] "
               f"time {iter_time:.3f}s "
               + (f"lr {lr:.2e} " if lr is not None else "")
               + " ".join(f"{k}: {v:.4f}" for k, v in avg.items()))
        self.logger.info(msg)
        rec = dict(step=step + 1, epoch=epoch, iter_time=iter_time, **avg)
        if lr is not None:
            rec["lr"] = lr
        with open(self.json_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in avg.items():
                self._tb.add_scalar(f"train/{k}", v, step + 1)
            if lr is not None:
                self._tb.add_scalar("train/lr", lr, step + 1)
            self._tb.flush()

    def log_eval(self, step: int, metrics: Dict[str, float]):
        self.logger.info(
            "Eval: " + " ".join(f"{k}: {v:.4f}" for k, v in sorted(
                metrics.items()) if k.startswith(("mAP", "mAR"))))
        with open(self.json_path, "a") as f:
            f.write(json.dumps(dict(step=step, mode="val", **metrics))
                    + "\n")
        if self._tb is not None:
            for k, v in metrics.items():
                if k.startswith(("mAP", "mAR")):
                    self._tb.add_scalar(f"val/{k}", v, step)
            self._tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
            self._tb = None
