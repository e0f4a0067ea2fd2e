"""Configuration system: YAML + ``_BASE_CONFIG_`` + CLI overrides.

The port's own copy of ``cagroup3d_tpu/config.py`` (the reference's
pcdet/config.py surface): an attribute-access ``EasyDict``,
``cfg_from_yaml_file`` with ``_BASE_CONFIG_`` inheritance and recursive
merge, and ``cfg_from_list`` typed ``KEY.PATH=value`` overrides.  The
repository's YAMLs (``tools/cfgs/``) load the same way in both packages.
"""
from __future__ import annotations

from ast import literal_eval
from pathlib import Path

import yaml


class EasyDict(dict):
    """Attribute-access dict (stand-in for the easydict dependency)."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = v

    def __setitem__(self, k, v):
        if isinstance(v, dict) and not isinstance(v, EasyDict):
            v = EasyDict(v)
        elif isinstance(v, (list, tuple)):
            v = type(v)(EasyDict(x) if isinstance(x, dict) and
                        not isinstance(x, EasyDict) else x for x in v)
        super().__setitem__(k, v)

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __deepcopy__(self, memo):
        import copy
        return EasyDict({k: copy.deepcopy(v, memo) for k, v in self.items()})


def _resolve_base(path: str) -> str:
    """Resolve a ``_BASE_CONFIG_`` path: as given, relative to the
    repository root (``tools/cfgs/...``) or to ``tools/`` (the reference's
    ``cfgs/...`` includes), so configs load from any working directory."""
    repo_root = Path(__file__).resolve().parent.parent
    for cand in (Path(path), repo_root / path, repo_root / "tools" / path):
        if cand.is_file():
            return str(cand)
    return path


def merge_new_config(config: EasyDict, new_config: dict) -> EasyDict:
    """Recursive merge, resolving ``_BASE_CONFIG_`` includes first."""
    if "_BASE_CONFIG_" in new_config:
        with open(_resolve_base(new_config["_BASE_CONFIG_"])) as f:
            base = yaml.safe_load(f)
        merge_new_config(config, base)
    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if not isinstance(config.get(key), dict):
                config[key] = EasyDict()
            merge_new_config(config[key], val)
        else:
            config[key] = val
    return config


def cfg_from_yaml_file(cfg_file, config: EasyDict) -> EasyDict:
    with open(cfg_file) as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config=config, new_config=new_config)
    return config


def cfg_from_list(cfg_list, config: EasyDict) -> None:
    """Set config keys from a flat list, e.g. ['MODEL.NAME', 'CAGroup3D']."""
    if len(cfg_list) % 2 != 0:
        raise ValueError(f"odd-length override list: {cfg_list}")
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = config
        for subkey in key_list[:-1]:
            if subkey not in d:
                raise KeyError(f"NotFoundKey: {subkey}")
            d = d[subkey]
        subkey = key_list[-1]
        if subkey not in d:
            raise KeyError(f"NotFoundKey: {subkey}")
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if isinstance(value, dict):
            d[subkey] = EasyDict(value)
        elif type(value) != type(d[subkey]) and isinstance(d[subkey], EasyDict):
            raise ValueError(f"type mismatch for {subkey}")
        else:
            d[subkey] = value
