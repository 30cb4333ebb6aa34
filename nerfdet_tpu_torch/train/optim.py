"""Optimizer and learning-rate schedule from the reference config.

Port of ``nerfdet_tpu/train/optim.py``: AdamW (beta 0.9/0.999, eps 1e-8,
decoupled weight decay) with the backbone at ``lr_mult`` of the base
rate, frozen parameters left unchanged, global-norm gradient clipping,
and the mmcv step / cyclic / cosine schedules with optax's step counting
(update k, from 0, takes the rate ``schedule(k)``).

Two behaviours are the JAX package's, kept so the port is held to it:

* ``is_frozen_backbone_param`` freezes every backbone parameter under a
  module named ``conv1`` or ``bn1``, so the first 1x1 conv of every
  bottleneck of layers 2-4 is frozen too, beyond the reference's
  ``frozen_stages=1`` (stem and layer1);
* the clip norm (and the step's ``grad_norm``) counts the frozen
  parameters' gradients, where mmcv's ``clip_grads`` skips parameters
  that take no gradient.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch


def is_frozen_backbone_param(name: str) -> bool:
    """Frozen: the backbone's stem, layer1, every module named conv1 or
    bn1, and every backbone norm (bn2, bn3, the downsample norm)."""
    parts = name.split(".")
    if parts[0] != "backbone":
        return False
    if "layer1" in parts or any(p in ("conv1", "bn1", "bn2", "bn3")
                                for p in parts):
        return True
    return len(parts) >= 3 and parts[-3:-1] == ["downsample", "1"]


def param_labels(model: torch.nn.Module) -> Dict[str, str]:
    """'frozen' | 'backbone' | 'main' for every named parameter."""
    labels = {}
    for name, _ in model.named_parameters():
        if is_frozen_backbone_param(name):
            labels[name] = "frozen"
        elif name.split(".")[0] == "backbone":
            labels[name] = "backbone"
        else:
            labels[name] = "main"
    return labels


def _cosine_decay(init_value: float, decay_steps: int, alpha: float):
    """optax.cosine_decay_schedule."""
    def sched(step):
        t = min(step, decay_steps)
        decayed = (1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps))
        return init_value * (decayed + alpha)
    return sched


def build_lr_schedule_from_config(base_lr: float, lr_config: Optional[dict],
                                  steps_per_epoch: int,
                                  total_epochs: int) -> Callable[[int], float]:
    """The rate of each update, from a reference ``lr_config``:

    * ``step`` (default): x0.1 at each of the listed epochs;
    * ``cyclic``: a cosine rise from base to base * target_ratio[0] over
      ``step_ratio_up`` of the run, then a cosine fall to base *
      target_ratio[1];
    * ``CosineAnnealing``: cosine from base to base * min_lr_ratio over
      the run;

    with mmcv's optional linear warmup (``warmup='linear'``) over the
    first ``warmup_iters`` steps for step and cosine (the wrapped
    schedule sees the absolute step).
    """
    lr_config = dict(lr_config or {})
    policy = str(lr_config.get("policy", "step")).lower()
    total_steps = max(1, int(steps_per_epoch * total_epochs))
    warmup_steps = 0
    if lr_config.get("warmup") == "linear":
        warmup_steps = int(lr_config.get("warmup_iters", 500))

    def with_warmup(sched):
        if warmup_steps <= 0:
            return sched
        ratio = float(lr_config.get("warmup_ratio", 1.0 / 3.0))

        def s(step):
            if step < warmup_steps:
                frac = min(step / warmup_steps, 1.0)
                return base_lr * (ratio + (1.0 - ratio) * frac)
            return sched(step)
        return s

    if policy == "cyclic":
        up, down = lr_config.get("target_ratio", (10, 1e-4))
        frac_up = float(lr_config.get("step_ratio_up", 0.4))
        up_steps = max(1, int(total_steps * frac_up))
        ramp = _cosine_decay(float(base_lr * up), up_steps, 1.0 / float(up))
        fall = _cosine_decay(float(base_lr * up),
                             max(1, total_steps - up_steps),
                             float(down) / float(up))

        def cyclic(step):
            if step < up_steps:  # the ramp reversed: base -> peak
                return ramp(max(up_steps - 1 - step, 0))
            return fall(step - up_steps)
        return cyclic

    if policy == "cosineannealing":
        return with_warmup(_cosine_decay(
            base_lr, total_steps, float(lr_config.get("min_lr_ratio", 1e-5))))

    epochs = lr_config.get("step", (total_epochs * 2 // 3,
                                    total_epochs * 11 // 12))
    boundaries = sorted({int(e * steps_per_epoch) for e in epochs})

    def step_decay(step):
        lr = base_lr
        for b in boundaries:
            if step >= b:
                lr *= 0.1
        return lr
    return with_warmup(step_decay)


class Optimizer:
    """AdamW over the 'main' and 'backbone' parameters (one group each,
    the backbone's at ``lr_mult`` of the rate), with optax's global-norm
    clipping in front and the schedule's rate set before each update.
    Frozen parameters are in no group, so they never change.

    ``step()`` reads the parameters' ``.grad`` (None counts as zero),
    clips in place and updates; it returns the global norm of all the
    gradients before clipping, frozen ones included (the step's
    ``grad_norm``)."""

    def __init__(self, model: torch.nn.Module, optimizer_cfg: dict,
                 grad_clip: Optional[dict] = None,
                 lr_schedule: Optional[Callable[[int], float]] = None):
        if optimizer_cfg.get("type", "AdamW") != "AdamW":
            raise NotImplementedError("nerfdet configs use AdamW")
        self.base_lr = float(optimizer_cfg["lr"])
        self.lr_mult = float(
            optimizer_cfg.get("paramwise_cfg", {}).get("custom_keys", {})
            .get("backbone", {}).get("lr_mult", 1.0))
        self.schedule = lr_schedule or (lambda step: self.base_lr)
        self.max_norm = None
        if grad_clip:
            if grad_clip.get("norm_type", 2) != 2:
                raise NotImplementedError("only the 2-norm clip is ported")
            self.max_norm = float(grad_clip["max_norm"])
        labels = param_labels(model)
        named = list(model.named_parameters())
        self.params: List[torch.Tensor] = [p for _, p in named]
        groups = [
            {"params": [p for n, p in named if labels[n] == label],
             "mult": mult}
            for label, mult in (("main", 1.0), ("backbone", self.lr_mult))]
        self.adamw = torch.optim.AdamW(
            groups, lr=self.base_lr, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=float(optimizer_cfg.get("weight_decay", 0.0)))
        self.count = 0  # updates taken

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        for p in self.params:
            if p.grad is None:  # optax sees zeros (and still decays)
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        if self.max_norm is not None:
            keep = norm < self.max_norm
            for g in grads:
                g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        lr = float(self.schedule(self.count))
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["mult"]
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        """AdamW's moments and step counts, the groups' rates, and
        ``count`` (the updates taken, where the schedule resumes)."""
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])


def build_optimizer(model: torch.nn.Module, optimizer_cfg: dict,
                    grad_clip: Optional[dict] = None,
                    lr_schedule: Optional[Callable[[int], float]] = None
                    ) -> Optimizer:
    """The optimizer of a config's ``optimizer`` and
    ``optimizer_config.grad_clip`` dicts, e.g. ``dict(type='AdamW',
    lr=2e-4, weight_decay=1e-4, paramwise_cfg=...)`` and
    ``dict(max_norm=35., norm_type=2)``; ``lr_schedule`` overrides the
    constant rate."""
    return Optimizer(model, optimizer_cfg, grad_clip, lr_schedule)
