"""Minimal yacs-style config node.

The reference uses yacs CfgNode with yaml merging, comma-separated config
lists, CLI `KEY VALUE` overrides and freezing
(reference: prosim/config/default.py:690-733). This is a small dependency-free
equivalent so that users can carry their experiment yamls over unchanged.
"""

import copy
from typing import Any, List

import yaml


class CfgNode(dict):
    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        init_dict = init_dict or {}
        for k, v in init_dict.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                v = CfgNode(v)
            self[k] = v

    # attribute access --------------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"config has no key '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"config is frozen; cannot set '{name}'")
        if isinstance(value, dict) and not isinstance(value, CfgNode):
            value = CfgNode(value)
        self[name] = value

    def __setitem__(self, key, value):
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"config is frozen; cannot set '{key}'")
        super().__setitem__(key, value)

    # freeze -------------------------------------------------------------------
    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self):
        return self.__dict__.get(CfgNode.IMMUTABLE, False)

    def _set_immutable(self, value: bool):
        self.__dict__[CfgNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self._set_immutable(False)
        out = copy.deepcopy(self)
        self._set_immutable(frozen)
        return out

    # merging --------------------------------------------------------------------
    def merge_from_other(self, other: dict, allow_new: bool = False, _path=""):
        for k, v in other.items():
            full = f"{_path}.{k}" if _path else k
            if k not in self:
                if not allow_new:
                    raise KeyError(f"non-existent config key: {full}")
                self[k] = CfgNode(v) if isinstance(v, dict) else v
                continue
            cur = self[k]
            if isinstance(cur, CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"cannot overwrite config node {full} with a leaf")
                cur.merge_from_other(v, allow_new=allow_new, _path=full)
            else:
                self[k] = _coerce(v, cur, full)

    def merge_from_file(self, path: str, allow_new: bool = False):
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_other(data, allow_new=allow_new)

    def merge_from_list(self, opts: List[str]):
        assert len(opts) % 2 == 0, "override list must be KEY VALUE pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = getattr(node, p)
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"non-existent config key: {key}")
            cur = node[leaf]
            parsed = yaml.safe_load(value) if isinstance(value, str) else value
            node[leaf] = _coerce(parsed, cur, key)

    def to_dict(self) -> dict:
        out = {}
        for k, v in self.items():
            out[k] = v.to_dict() if isinstance(v, CfgNode) else v
        return out

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _coerce(new: Any, old: Any, key: str) -> Any:
    if old is None or new is None:
        return new
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        raise TypeError(f"type mismatch for {key}: expected bool, got {type(new)}")
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, float) and isinstance(new, str):
        # YAML 1.1 only floats "3.0e-4", not "3e-4" (no dot -> str); accept
        # the common scientific-notation CLI spelling for float keys
        try:
            return float(new)
        except ValueError:
            pass
    if isinstance(old, (list, tuple)):
        if isinstance(new, (list, tuple)):
            return list(new)
        raise TypeError(f"type mismatch for {key}: expected list, got {type(new)}")
    if type(old) is not type(new) and not (isinstance(old, str) and isinstance(new, str)):
        if isinstance(old, int) and isinstance(new, int):
            return new
        raise TypeError(
            f"type mismatch for {key}: expected {type(old).__name__}, got {type(new).__name__}"
        )
    return new
