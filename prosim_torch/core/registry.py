"""Component registry (port of the parts of prosim_tpu/core/registry.py that
the losses, metrics and datasets use): decorators that register a loss, a
metric update or a dataset under a name, and the lookups."""

from typing import Any, Callable, Dict, Optional


class Registry:
    _groups: Dict[str, Dict[str, Any]] = {}

    @classmethod
    def _register(cls, group: str, name: Optional[str]):
        mapping = cls._groups.setdefault(group, {})

        def wrap(to_register):
            key = name if name is not None else to_register.__name__
            if key in mapping and mapping[key] is not to_register:
                raise KeyError(f"{group}:{key} already registered")
            mapping[key] = to_register
            return to_register

        return wrap

    def register_metric(self, name=None):
        return self._register("metric", name)

    def register_loss(self, name=None):
        return self._register("loss", name)

    def register_dataset(self, name=None):
        return self._register("dataset", name)

    def _get(self, group: str, name: str) -> Callable:
        mapping = self._groups.get(group, {})
        if name not in mapping:
            raise KeyError(f"unknown {group} '{name}'; registered: {sorted(mapping)}")
        return mapping[name]

    def get_metric(self, name):
        return self._get("metric", name)

    def get_loss(self, name):
        return self._get("loss", name)

    def get_dataset(self, name):
        return self._get("dataset", name)

    def list(self, group: str):
        return sorted(self._groups.get(group, {}))


registry = Registry()
