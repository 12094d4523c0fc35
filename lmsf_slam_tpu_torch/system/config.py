"""YAML config factory: assemble a SystemConfig from a file.

Counterpart of ``lmsf_slam_tpu/system/config.py``: the factory maps a nested
YAML document (``config/default.yaml``) onto the typed NamedTuple config
tree: every key must name a real field (typos fail loudly instead of
silently using defaults), and values are coerced to the field's default
type. ``yaml`` is imported inside the loading function, so importing the
package does not need it.
"""
from __future__ import annotations

import math
from typing import Any

from .ml_system import FeatureParams, SystemConfig


def _merge(default: Any, override: dict, path: str = ""):
    """Recursively overlay a dict onto a NamedTuple, type-coercing leaves."""
    if not isinstance(override, dict):
        raise TypeError(f"{path or 'config'}: expected a mapping")
    fields = default._fields
    updates = {}
    for key, val in override.items():
        if key not in fields:
            raise KeyError(f"unknown config key {path + key!r}; valid: {sorted(fields)}")
        cur = getattr(default, key)
        if hasattr(cur, "_fields") and isinstance(val, dict):
            updates[key] = _merge(cur, val, path + key + ".")
        elif isinstance(cur, bool):
            updates[key] = bool(val)
        elif isinstance(cur, int) and not isinstance(val, bool):
            updates[key] = int(val)
        elif isinstance(cur, float):
            updates[key] = float(val)
        else:
            updates[key] = val
    return default._replace(**updates)


def system_config_from_dict(doc: dict) -> SystemConfig:
    doc = dict(doc or {})
    # convenience: rotation thresholds may be given in degrees
    for deg_key, rad_key in (
        ("keyframe_rot_deg", "keyframe_rot"),
        ("map_update_rot_deg", "map_update_rot"),
    ):
        if deg_key in doc:
            doc[rad_key] = math.radians(float(doc.pop(deg_key)))
    lifelong = doc.get("lifelong")
    if isinstance(lifelong, dict) and isinstance(lifelong.get("occupancy"), dict):
        raise NotImplementedError(
            "lifelong.occupancy: the occupancy grid is not ported yet "
            "(ROADMAP.md section 1, item 11)"
        )
    return _merge(SystemConfig(), doc)


def _strict_loader():
    """A ``yaml.SafeLoader`` that rejects duplicate mapping keys.

    PyYAML silently keeps the LAST occurrence, so a stray re-declaration at
    the bottom of a config file would override the documented value without
    any diagnostic — the same fail-loudly policy as unknown keys."""
    import yaml

    class StrictLoader(yaml.SafeLoader):
        pass

    def strict_mapping(loader, node, deep=False):
        seen = set()
        for key_node, _ in node.value:
            key = loader.construct_object(key_node, deep=deep)
            if key == "<<":
                # YAML merge keys are flattened by construct_mapping below;
                # the duplicate check covers explicit keys only
                continue
            if key in seen:
                raise KeyError(
                    f"duplicate config key {key!r} (line {key_node.start_mark.line + 1})"
                )
            seen.add(key)
        return yaml.SafeLoader.construct_mapping(loader, node, deep)

    StrictLoader.add_constructor(yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG, strict_mapping)
    return StrictLoader


def system_config_from_yaml(path: str) -> SystemConfig:
    """Load a SystemConfig from a YAML file. Unknown AND duplicate keys fail
    loudly."""
    import yaml

    with open(path) as f:
        doc = yaml.load(f, Loader=_strict_loader())
    return system_config_from_dict(doc)


__all__ = ["system_config_from_dict", "system_config_from_yaml", "FeatureParams", "SystemConfig"]
