"""String-keyed registries (port of `fscl_tpu/core/registry.py`).

The same `Registry` as the JAX package; every key fscl_tpu registers is
ported, and an unknown key raises `KeyError` as in fscl_tpu.
"""
from __future__ import annotations

from typing import Callable, Dict, Generic, Iterator, TypeVar

T = TypeVar("T")

class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, *names: str) -> Callable[[T], T]:
        def deco(obj: T) -> T:
            for name in names:
                if name in self._items:
                    raise KeyError(f"{self.kind} '{name}' already registered")
                self._items[name] = obj
            return obj
        return deco

    def add(self, name: str, obj: T) -> None:
        self._items[name] = obj

    def get(self, name: str) -> T:
        if name not in self._items:
            known = ", ".join(sorted(self._items))
            raise KeyError(f"Unknown {self.kind} '{name}'. Known: {known}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def keys(self):
        return self._items.keys()


SYSTEMS: Registry = Registry("system")
DATAMODULES: Registry = Registry("datamodule")
# the corpus walkers of data/parsers.py, filled when that module is imported
RAW_PARSERS: Registry = Registry("raw parser")
