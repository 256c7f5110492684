"""
YAML run-config loading with recursive default merging.

The port's counterpart of ``warpdrive_tpu/utils/config.py``: a per-env YAML
file merged recursively over ``default_configs.yaml``, each policy section
over the default policy section.  Configs are read from the port's own
copies under ``warpdrive_tpu_torch/training/run_configs/``.
"""

from __future__ import annotations

import copy
import os

import yaml

_RUN_CONFIG_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "training",
    "run_configs",
)


def recursive_merge_config_dicts(config: dict, default_config: dict) -> dict:
    """
    Merge ``config`` over ``default_config`` recursively: every key present in
    the default but absent from the config is filled in; nested dicts recurse.
    """
    assert isinstance(default_config, dict)
    if config is None:
        config = {}
    assert isinstance(config, dict)
    merged = copy.deepcopy(config)
    for key, default_value in default_config.items():
        if key not in merged:
            merged[key] = copy.deepcopy(default_value)
        elif isinstance(default_value, dict) and isinstance(merged[key], dict):
            merged[key] = recursive_merge_config_dicts(merged[key], default_value)
    return merged


def load_yaml(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def get_default_config() -> dict:
    return load_yaml(os.path.join(_RUN_CONFIG_DIR, "default_configs.yaml"))


def load_run_config(env_name_or_path: str) -> dict:
    """
    Load a run config by env name (resolved inside the port's
    ``training/run_configs`` directory) or by explicit path, merged over the
    defaults.  Per-policy sections are merged over the default policy config.
    """
    if os.path.isfile(env_name_or_path):
        path = env_name_or_path
    else:
        path = os.path.join(_RUN_CONFIG_DIR, f"{env_name_or_path}.yaml")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"No run config found for {env_name_or_path!r} (looked at {path})"
            )
    config = load_yaml(path)
    defaults = get_default_config()

    merged = dict(config)
    merged["trainer"] = recursive_merge_config_dicts(
        config.get("trainer"), defaults.get("trainer", {})
    )
    merged["saving"] = recursive_merge_config_dicts(
        config.get("saving"), defaults.get("saving", {})
    )
    default_policy = defaults.get("policy", {})
    merged["policy"] = {
        tag: recursive_merge_config_dicts(policy_cfg, default_policy)
        for tag, policy_cfg in (config.get("policy") or {}).items()
    }
    merged.setdefault("env", {})
    if "sampler" in config:
        merged["sampler"] = config["sampler"]
    return merged
