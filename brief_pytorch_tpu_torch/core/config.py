"""Config system: YAML + attribute access + dotlist, OmegaConf-compatible
in behaviour for what the port needs.

Accepts the reference's opt/*.yaml files verbatim: nested dicts become
attribute-accessible `Config` nodes, lists stay lists.  Copy of
brief_pytorch_tpu/core/config.py (load / loads / save / merge, `Config`
with get_path / set_path, the dotlists MultiTask expands:
from_dotlist / to_dotlist, and to_dict / iter_leaves).
"""
from __future__ import annotations

import copy
import io
from typing import Any, Dict, Iterator, List

import yaml


class Config(dict):
    """A dict with attribute access and recursive wrapping."""

    def __init__(self, data: Dict | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    @staticmethod
    def _wrap(value):
        if isinstance(value, Config):
            return value
        if isinstance(value, dict):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key, value):
        super().__setitem__(key, Config._wrap(value))

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        del self[key]

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_plain(self) -> Dict:
        def conv(v):
            if isinstance(v, Config):
                return {k: conv(x) for k, x in v.items()}
            if isinstance(v, list):
                return [conv(x) for x in v]
            return v
        return conv(self)

    def get_path(self, dotted: str, default=None):
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = _parse_scalar(value) if isinstance(value, str) \
            else value


def _parse_scalar(text: str):
    """Parse a dotlist RHS string using YAML scalar rules (so '0.001' ->
    float, 'true' -> bool, '[1,2]' -> list, bare strings stay strings)."""
    try:
        return yaml.safe_load(io.StringIO(text))
    except yaml.YAMLError:
        return text


def load(path: str) -> Config:
    with open(path, "r") as f:
        return Config(yaml.safe_load(f) or {})


def loads(text: str) -> Config:
    return Config(yaml.safe_load(text) or {})


def save(cfg: Config | Dict, path: str) -> None:
    plain = cfg.to_plain() if isinstance(cfg, Config) else cfg
    with open(path, "w") as f:
        yaml.safe_dump(plain, f, sort_keys=False)


def merge(base: Config, override: Dict) -> Config:
    """Deep merge: override wins; dicts merge recursively, lists replace
    (OmegaConf.merge as reference main.py:568-569 uses it)."""
    out = copy.deepcopy(base)

    def rec(dst: Config, src: Dict):
        for k, v in src.items():
            if k in dst and isinstance(dst[k], Config) and isinstance(v, dict):
                rec(dst[k], v)
            else:
                dst[k] = v
    rec(out, override)
    return out


def from_dotlist(dotlist: List[str]) -> Config:
    """Build a Config from 'a.b.c=value' strings
    (OmegaConf.from_dotlist equivalent, reference MultiTask.py:75)."""
    cfg = Config()
    for item in dotlist:
        key, _, val = item.partition("=")
        cfg.set_path(key.strip(), val.strip())
    return cfg


def to_dotlist(cfg: Config | Dict, prefix: str = "") -> List[str]:
    """Flatten to 'a.b=c' strings (reference utils/misc.py:29-54)."""
    out: List[str] = []
    for k, v in cfg.items():
        k = str(k)
        if isinstance(v, dict):
            out.extend(to_dotlist(v, prefix + k + "."))
        elif v is None:
            out.append(f"{prefix}{k}=~")
        else:
            out.append(f"{prefix}{k}={v}")
    return out


def to_dict(cfg: Config | Dict, sep: str = ".") -> Dict[str, str]:
    """Flattened key->string-value dict (reference utils/misc.py:55-58)."""
    items = to_dotlist(cfg)
    return {s.split("=", 1)[0]: s.split("=", 1)[1] for s in items}


def iter_leaves(cfg: Config, prefix: str = "") -> Iterator[tuple]:
    for k, v in cfg.items():
        if isinstance(v, Config):
            yield from iter_leaves(v, prefix + str(k) + ".")
        else:
            yield prefix + str(k), v
