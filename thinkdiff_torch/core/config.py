"""Hierarchical YAML config (the port's copy of thinkdiff_tpu/core/config.py):
one YAML with ``run``, ``model``, ``datasets`` (and optional
``evaluation_datasets``) sections, the model's and the builders' defaults
merged underneath, and ``--options a.b=c`` dotlist overrides on top.

``ConfigNode`` is a dict with attribute access and deep merge. Values are
read with PyYAML as they are: ``1e-4`` (no dot) stays a string, and the
port's schedules take ``float()`` of each number they read.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, List, Optional

import yaml

from thinkdiff_torch.core.registry import registry


class ConfigNode(dict):
    """dict with attribute access, deep merge, and recursive wrapping."""

    def __init__(self, data: Optional[Dict] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = self._wrap(v)

    @staticmethod
    def _wrap(v: Any) -> Any:
        if isinstance(v, ConfigNode):
            return v
        if isinstance(v, dict):
            return ConfigNode(v)
        if isinstance(v, (list, tuple)):
            return [ConfigNode._wrap(x) for x in v]
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, self._wrap(v))

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def merge(self, other: Dict) -> "ConfigNode":
        """Deep merge ``other`` into self (other wins). Returns self."""
        for k, v in other.items():
            if k in self and isinstance(self[k], ConfigNode) and isinstance(v, dict):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def set_dotted(self, key: str, value: Any):
        parts = key.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], ConfigNode):
                node[p] = ConfigNode()
            node = node[p]
        node[parts[-1]] = value

    def to_dict(self) -> Dict:
        out = {}
        for k, v in self.items():
            if isinstance(v, ConfigNode):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, ConfigNode) else x for x in v]
            else:
                out[k] = v
        return out

    def copy(self) -> "ConfigNode":
        return ConfigNode(self.to_dict())


def _parse_value(raw: str) -> Any:
    """Parse a CLI override value like OmegaConf would: YAML-typed scalars."""
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def parse_options(options: Optional[List[str]]) -> Dict[str, Any]:
    """``["a.b=c", "x=1"]`` (or the space-separated ``["a.b", "c"]`` form the
    reference also accepts) -> {dotted_key: typed value}."""
    if not options:
        return {}
    out: Dict[str, Any] = {}
    i = 0
    while i < len(options):
        opt = options[i]
        if "=" in opt:
            k, v = opt.split("=", 1)
            out[k] = _parse_value(v)
            i += 1
        else:
            if i + 1 >= len(options):
                raise ValueError(f"Dangling option key without value: {opt}")
            out[opt] = _parse_value(options[i + 1])
            i += 2
    return out


def load_yaml(path: str) -> ConfigNode:
    with open(path, "r") as f:
        return ConfigNode(yaml.safe_load(f) or {})


class Config:
    """Merged job config.

    Sections (reference thinkdiff/common/config.py:39-51):
      - ``run``: trainer/runner options
      - ``model``: arch + model options (model-class defaults merged under)
      - ``datasets``: {builder_name: options} (builder defaults merged under)
      - ``evaluation_datasets``: optional eval-only dataset section
    """

    def __init__(self, args=None, cfg_path: Optional[str] = None,
                 options: Optional[List[str]] = None):
        if args is not None:
            cfg_path = getattr(args, "cfg_path", cfg_path)
            options = getattr(args, "options", options)

        self.config = ConfigNode()
        user_cfg = load_yaml(cfg_path) if cfg_path else ConfigNode()
        overrides = parse_options(options)
        # Apply overrides onto the user config before building sections so
        # model/dataset default resolution sees overridden arch names too.
        for k, v in overrides.items():
            user_cfg.set_dotted(k, v)

        runner_cfg = ConfigNode({"run": user_cfg.get("run", ConfigNode())})
        model_cfg = self.build_model_config(user_cfg)
        dataset_cfg = self.build_dataset_config(user_cfg)
        eval_dataset_cfg = ConfigNode(
            {"evaluation_datasets": user_cfg.get("evaluation_datasets", ConfigNode())}
        )

        for section in (runner_cfg, model_cfg, dataset_cfg, eval_dataset_cfg):
            self.config.merge(section)
        # the full user config merges LAST (reference common/config.py:40-42)
        # so user-declared sections — incl. top-level ones no builder owns,
        # like a user ``preprocess:`` override — always win over defaults
        self.config.merge(user_cfg)

    # -- section builders ---------------------------------------------------
    @staticmethod
    def build_model_config(cfg: ConfigNode) -> ConfigNode:
        model = cfg.get("model")
        if model is None:
            return ConfigNode({"model": ConfigNode()})
        if "arch" not in model:
            raise KeyError("Missing model 'arch' in config")

        merged = ConfigNode()
        model_cls = registry.get_model_class(model["arch"])
        if model_cls is not None:
            model_type = model.get("model_type") or getattr(
                model_cls, "default_model_type", None
            )
            default_path = None
            if hasattr(model_cls, "default_config_path") and model_type:
                try:
                    default_path = model_cls.default_config_path(model_type)
                except Exception:
                    default_path = None
            if default_path and os.path.exists(default_path):
                merged.merge(load_yaml(default_path))
            inline_defaults = getattr(model_cls, "DEFAULT_CONFIG", None)
            if inline_defaults:
                merged.merge({"model": inline_defaults})
        merged.merge({"model": model})
        if "model" not in merged:
            merged["model"] = ConfigNode()
        # keep EVERY section the model-default YAML contributes — notably
        # ``preprocess:`` (processor specs a user config relies on without
        # declaring them; the reference merges the whole default file,
        # common/config.py:75-80)
        return merged

    @staticmethod
    def build_dataset_config(cfg: ConfigNode) -> ConfigNode:
        datasets = cfg.get("datasets")
        if datasets is None:
            return ConfigNode({"datasets": ConfigNode()})
        merged = ConfigNode({"datasets": ConfigNode()})
        for name, ds_cfg in datasets.items():
            builder_cls = registry.get_builder_class(name)
            base = ConfigNode()
            if builder_cls is not None:
                ds_type = None
                if isinstance(ds_cfg, dict):
                    ds_type = ds_cfg.get("type", "default")
                default_path = None
                if hasattr(builder_cls, "default_config_path"):
                    try:
                        default_path = builder_cls.default_config_path(
                            type=ds_type or "default"
                        )
                    except Exception:
                        default_path = None
                if default_path and os.path.exists(default_path):
                    node = load_yaml(default_path)
                    base.merge(node.get("datasets", {}).get(name, node))
                inline = getattr(builder_cls, "DEFAULT_CONFIG", None)
                if inline:
                    base.merge(inline)
            if isinstance(ds_cfg, dict):
                base.merge(ds_cfg)
            merged["datasets"][name] = base
        return merged

    # -- accessors (reference API) ------------------------------------------
    @property
    def run_cfg(self) -> ConfigNode:
        return self.config.run

    @property
    def model_cfg(self) -> ConfigNode:
        return self.config.model

    @property
    def datasets_cfg(self) -> ConfigNode:
        return self.config.datasets

    @property
    def evaluation_datasets_cfg(self) -> ConfigNode:
        return self.config.get("evaluation_datasets", ConfigNode())

    def to_dict(self) -> Dict:
        return self.config.to_dict()

    def pretty_print(self):
        log = logging.getLogger(__name__)
        log.info("\n=====  Running Parameters    =====")
        log.info(json.dumps(self.run_cfg.to_dict(), indent=4, sort_keys=True))
        log.info("\n======  Dataset Attributes  ======")
        log.info(json.dumps(self.datasets_cfg.to_dict(), indent=4, sort_keys=True))
        log.info("\n======  Model Attributes  ======")
        log.info(json.dumps(self.model_cfg.to_dict(), indent=4, sort_keys=True))


def model_default_config_path(cls, model_type: str) -> str:
    """A model class's default YAML for ``model_type`` (model defaults and
    processor specs, merged under a user config), from its
    ``PRETRAINED_MODEL_CONFIG_DICT``."""
    if model_type not in cls.PRETRAINED_MODEL_CONFIG_DICT:
        raise KeyError(f"Unknown model type {model_type} for {cls.__name__}")
    return os.path.join(registry.get_path("repo_root"),
                        cls.PRETRAINED_MODEL_CONFIG_DICT[model_type])
