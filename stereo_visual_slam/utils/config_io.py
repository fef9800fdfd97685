"""YAML config load/save — the C18 analog of the reference's rosparam YAML
(config/kitti_param.yaml + run_vslam.launch). Every field of every nested
dataclass is addressable; unknown keys raise (no silent typos).

Example YAML:

    dataset: /data/kitti/sequences/00
    if_write_pose: true
    pose_path: estimated_traj.txt
    config:
      camera: {fx: 718.856, baseline: 0.573}
      frontend: {n_features: 500, fast_threshold: 20}
      keyframe: {window_size: 10}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import yaml

from stereo_visual_slam.utils.config import Config


def _apply(dc, overrides: Dict[str, Any]):
    if not dataclasses.is_dataclass(dc):
        raise TypeError(f"cannot apply overrides to {type(dc)}")
    fields = {f.name: f for f in dataclasses.fields(dc)}
    updates = {}
    for key, value in overrides.items():
        if key not in fields:
            raise KeyError(
                f"unknown config key '{key}' for {type(dc).__name__} "
                f"(valid: {sorted(fields)})"
            )
        current = getattr(dc, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            updates[key] = _apply(current, value)
        elif isinstance(value, list):
            updates[key] = tuple(value)
        else:
            updates[key] = value
    return dataclasses.replace(dc, **updates)


def config_from_dict(overrides: Dict[str, Any], base: Config = None) -> Config:
    return _apply(base or Config(), overrides or {})


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f) or {}


def config_from_yaml(path: str, base: Config = None) -> Config:
    doc = load_yaml(path)
    return config_from_dict(doc.get("config", {}), base)


def config_to_dict(config: Config) -> Dict[str, Any]:
    return dataclasses.asdict(config)


def save_yaml(config: Config, path: str):
    with open(path, "w") as f:
        yaml.safe_dump({"config": config_to_dict(config)}, f)
