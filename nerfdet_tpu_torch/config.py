"""Python-file config system.

Equivalent capability to the reference's external ``mmcv.Config``
(consumed at `tools/train.py:70-72`): configs are plain ``.py`` files
evaluated into a dict namespace, support ``_base_`` inheritance with
recursive dict merge, dot access, and CLI ``key=value`` overrides.
"""

from __future__ import annotations

import ast
import copy
import os
import types
from typing import Any, Dict, List, Union


class ConfigDict(dict):
    """dict with attribute access, recursively applied."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict) and not isinstance(obj, ConfigDict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, ConfigDict):
            return ConfigDict({k: ConfigDict.wrap(v) for k, v in obj.items()})
        if isinstance(obj, (list, tuple)):
            return type(obj)(ConfigDict.wrap(v) for v in obj)
        return obj


def _merge_dict(base: dict, override: dict) -> dict:
    """Recursively merge ``override`` into ``base`` (override wins).

    A ``_delete_=True`` key in an override dict replaces the base subtree
    instead of merging into it (same convention as the reference).
    """
    out = dict(base)
    for k, v in override.items():
        if (
            isinstance(v, dict)
            and isinstance(out.get(k), dict)
            and not v.pop("_delete_", False)
        ):
            out[k] = _merge_dict(out[k], v)
        else:
            out[k] = v
    return out


def _exec_config_file(path: str) -> Dict[str, Any]:
    path = os.path.abspath(path)
    with open(path) as f:
        src = f.read()
    # validate it parses before exec for a friendlier error
    ast.parse(src, filename=path)
    mod = types.ModuleType("_nerfdet_tpu_torch_config")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    cfg = {
        k: v
        for k, v in mod.__dict__.items()
        if not k.startswith("__") and not isinstance(v, types.ModuleType)
        and not callable(v)
    }
    base = cfg.pop("_base_", None)
    if base is not None:
        if isinstance(base, str):
            base = [base]
        merged: Dict[str, Any] = {}
        for b in base:
            bpath = os.path.join(os.path.dirname(path), b)
            merged = _merge_dict(merged, _exec_config_file(bpath))
        cfg = _merge_dict(merged, cfg)
    return _apply_pipeline_overrides(cfg)


def _pipeline_lists(cfg: dict, which: str):
    """Yield every pipeline step-list reachable for ``which`` (train/test):
    the top-level ``{which}_pipeline`` and the (possibly RepeatDataset-
    nested) ``data.train`` / ``data.val`` / ``data.test`` entries."""
    if isinstance(cfg.get(f"{which}_pipeline"), list):
        yield cfg[f"{which}_pipeline"]
    nodes = ([cfg.get("data", {}).get("train")] if which == "train"
             else [cfg.get("data", {}).get("val"),
                   cfg.get("data", {}).get("test")])
    for n in nodes:
        while isinstance(n, dict) and "dataset" in n:
            n = n["dataset"]
        if isinstance(n, dict) and isinstance(n.get("pipeline"), list):
            yield n["pipeline"]


def _apply_pipeline_overrides(cfg: dict) -> dict:
    """Apply ``train_pipeline_overrides`` / ``test_pipeline_overrides``.

    ``_base_`` merge is a dict merge, so a child config cannot retarget
    knobs that the base baked into its pipeline *lists* (lists replace
    wholesale). These override dicts are the escape hatch: keys are
    applied onto every reachable MultiViewPipeline step — ``img_scale``
    onto its Resize transform, ``pad_size`` onto its Pad transform,
    everything else (n_images, nerf_target_views, loading, ...) onto
    the step itself. Keys suffixed ``_test``/``_train`` are ignored
    here; use the matching overrides dict instead.
    """
    for which in ("train", "test"):
        ov = cfg.pop(f"{which}_pipeline_overrides", None)
        if not ov:
            continue
        for steps in _pipeline_lists(cfg, which):
            for st in steps:
                if st.get("type") != "MultiViewPipeline":
                    continue
                for k, v in ov.items():
                    if k == "img_scale":
                        for t in st.get("transforms", []):
                            if t.get("type") == "Resize":
                                t["img_scale"] = v
                    elif k == "pad_size":
                        for t in st.get("transforms", []):
                            if t.get("type") == "Pad":
                                t["size"] = v
                    else:
                        st[k] = v
    return cfg


def _set_by_dotted_key(d: dict, key: str, value):
    parts = key.split(".")
    cur = d
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


class Config:
    """Loaded configuration with dot access.

    >>> cfg = Config.fromfile("configs/nerfdet/nerfdet_res50_2x_low_res.py")
    >>> cfg.model.backbone.depth
    50
    """

    def __init__(self, cfg_dict: dict, filename: str = None):
        self._cfg = ConfigDict.wrap(cfg_dict)
        self._filename = filename

    @classmethod
    def fromfile(cls, path: str) -> "Config":
        return cls(_exec_config_file(path), filename=path)

    @property
    def filename(self):
        return self._filename

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._cfg[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __getitem__(self, name):
        return self._cfg[name]

    def __contains__(self, name):
        return name in self._cfg

    def get(self, name, default=None):
        return self._cfg.get(name, default)

    def keys(self):
        return self._cfg.keys()

    def to_dict(self) -> dict:
        return copy.deepcopy(dict(self._cfg))

    def merge_from_options(self, options: Union[Dict[str, Any], List[str]]):
        """Apply CLI overrides: ``{"model.n_voxels": (40, 40, 16)}`` or
        ``["model.n_voxels=(40,40,16)"]`` (reference `tools/train.py:71-72`).
        """
        if isinstance(options, (list, tuple)):
            options = dict(
                (kv.split("=", 1)[0], _parse_value(kv.split("=", 1)[1]))
                for kv in options
            )
        raw = self.to_dict()
        for k, v in options.items():
            _set_by_dotted_key(raw, k, v)
        self._cfg = ConfigDict.wrap(raw)

    def dump(self, path: str):
        import pprint

        with open(path, "w") as f:
            for k, v in self._cfg.items():
                f.write(f"{k} = {pprint.pformat(v, width=100)}\n")

    def __repr__(self):
        return f"Config(file={self._filename})"
