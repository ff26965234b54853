"""Typed registries: components register under their config `type` names,
so a JSON config names them as the reference's does while lookup stays
explicit and import-safe. A copy of `stinet_tpu/core/registry.py`."""


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items = {}

    def register(self, name=None):
        def deco(obj):
            self._items[name or obj.__name__] = obj
            return obj
        return deco

    def add(self, name, obj):
        self._items[name] = obj

    def get(self, name):
        if name not in self._items:
            raise KeyError(
                f"Unknown {self.kind} type {name!r}; known: "
                f"{sorted(self._items)}")
        return self._items[name]

    def __contains__(self, name):
        return name in self._items


TRAINERS = Registry("trainer")
DATALOADERS = Registry("data_loader")
TRANSFORMS = Registry("transform")
