"""Config system: YAML + explicit registry instantiation.

A framework-free copy of ``text_to_sound_synthesis_tpu/utils/config.py`` (the
port never imports the JAX package). The reference drives every component
through OmegaConf YAML files with ``target:``/``params:`` reflective
import-by-string instantiation (``Diffsound/sound_synthesis/utils/misc.py:125-132``).
The YAML schema is kept, and targets resolve through an explicit registry.
The port registers its classes under the SAME target strings as the JAX
package (``text_to_sound_synthesis_tpu.models.Diffsound``, ...) plus the
reference's dotted names, so the unchanged ``configs/*.yaml`` build the port.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional

import yaml

__all__ = [
    "Registry",
    "register",
    "instantiate_from_config",
    "load_yaml_config",
    "save_config_to_yaml",
    "merge_opts_to_config",
    "modify_config_for_debug",
]


class _ConfigLoader(yaml.SafeLoader):
    """SafeLoader that additionally understands the ``!!python/tuple`` tag used by
    the reference configs (e.g. ``Diffsound/configs/caps.yaml:83``)."""


_ConfigLoader.add_constructor(
    "tag:yaml.org,2002:python/tuple",
    lambda loader, node: tuple(loader.construct_sequence(node)),
)


class Registry:
    """Maps ``target`` strings to constructors.

    A target may be registered under several names (our canonical dotted path plus
    any reference-compat aliases), so reference YAML files resolve to the
    TPU-native implementation without import-by-string.
    """

    def __init__(self) -> None:
        self._targets: Dict[str, Callable[..., Any]] = {}

    def register(self, *names: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            for name in names:
                if name in self._targets and self._targets[name] is not fn:
                    raise ValueError(f"duplicate registry target: {name!r}")
                self._targets[name] = fn
            return fn

        return deco

    def resolve(self, target: str) -> Callable[..., Any]:
        if target in self._targets:
            return self._targets[target]
        # Fall back to suffix match (class name) so abbreviated targets work.
        tail = target.rsplit(".", 1)[-1]
        matches = {t: f for t, f in self._targets.items() if t.rsplit(".", 1)[-1] == tail}
        if len(set(matches.values())) == 1:
            return next(iter(matches.values()))
        if not matches:
            raise KeyError(
                f"unknown config target {target!r}; known: {sorted(self._targets)}"
            )
        raise KeyError(f"ambiguous config target {target!r}: matches {sorted(matches)}")

    def known_targets(self) -> list[str]:
        return sorted(self._targets)


GLOBAL_REGISTRY = Registry()


def register(*names: str):
    """Class decorator: register a component under one or more target names."""
    return GLOBAL_REGISTRY.register(*names)


def instantiate_from_config(config: Optional[dict], registry: Optional[Registry] = None, **extra):
    """Build the object described by ``{'target': ..., 'params': {...}}``.

    Mirrors the reference helper (``misc.py:125-132``): ``None`` passes through,
    ``target: 'none'`` means "no component"; extra kwargs override params.
    """
    if config is None:
        return None
    if "target" not in config:
        raise KeyError(f"config has no 'target': {config}")
    target = config["target"]
    if target in ("none", "None"):
        return None
    reg = registry or GLOBAL_REGISTRY
    cls = reg.resolve(target)
    params = dict(config.get("params") or {})
    params.update(extra)
    return cls(**params)


def load_yaml_config(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.load(f, Loader=_ConfigLoader)


def save_config_to_yaml(config: dict, path: str) -> None:
    with open(path, "w") as f:
        yaml.safe_dump(_plainify(config), f, sort_keys=False)


def _plainify(obj):
    if isinstance(obj, dict):
        return {k: _plainify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plainify(v) for v in obj]
    return obj


def merge_opts_to_config(config: dict, opts) -> dict:
    """Apply dotlist overrides ``["a.b.c", "1", ...]`` onto a nested dict.

    Same CLI surface as the reference (``misc.py:33-48``): the opts remainder is a
    flat list alternating key paths and values.
    """
    if not opts:
        return config
    if len(opts) % 2 != 0:
        raise ValueError(f"opts must be key/value pairs, got odd length: {opts}")
    config = copy.deepcopy(config)
    for key, value in zip(opts[0::2], opts[1::2]):
        node = config
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = _parse_scalar(value)
    return config


def _parse_scalar(value):
    """Lenient CLI scalar parse: int, then float (accepts '3e-5'), then YAML."""
    if not isinstance(value, str):
        return value
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    return yaml.load(value, Loader=_ConfigLoader)


def modify_config_for_debug(config: dict) -> dict:
    """Shrink a training config for fast debugging (reference ``misc.py:50-55``)."""
    config = copy.deepcopy(config)
    dl = config.setdefault("dataloader", {})
    dl["batch_size"] = 1
    dl["num_workers"] = 0
    return config
