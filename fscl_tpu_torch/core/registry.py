"""String-keyed registries (port of `fscl_tpu/core/registry.py`).

The same `Registry` as the JAX package, plus the keys that fscl_tpu
registers and the port does not have yet: looking one of those up raises
`NotImplementedError` naming the `ROADMAP.md` item that ports it, where an
unknown key raises `KeyError` as in fscl_tpu.
"""
from __future__ import annotations

from typing import Callable, Dict, Generic, Iterable, Iterator, Mapping, TypeVar

T = TypeVar("T")

# ROADMAP.md Queue 1 items, by the fscl_tpu registry keys they port
_ITEMS = {
    8: "item 8, meta-learning variants",
}
_META_SYSTEMS = (
    "fscl-orig2", "maml", "meta", "imaml", "fscl-ada", "fscl-ada1", "fscl-ada2",
    "fscl-ssl_ada", "fscl-ssl_ada1", "fscl-ssl_ada2", "conti-ae", "semi-fscl",
    "semi-fscl-tune")


def _waiting(groups: Mapping[int, Iterable[str]]) -> Dict[str, str]:
    return {key: _ITEMS[item] for item, keys in groups.items() for key in keys}


class Registry(Generic[T]):
    def __init__(self, kind: str, waiting: Mapping[str, str] = ()):
        self.kind = kind
        self._items: Dict[str, T] = {}
        self.waiting = dict(waiting)

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
            if name in self.waiting:
                raise NotImplementedError(
                    f"{self.kind} '{name}' is not ported yet: ROADMAP.md Queue 1, "
                    f"{self.waiting[name]}")
            known = ", ".join(sorted(self._items))
            raise KeyError(f"Unknown {self.kind} '{name}'. Known: {known}")
        return self._items[name]

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def __iter__(self) -> Iterator[str]:
        return iter(self._items)

    def keys(self):
        return self._items.keys()


SYSTEMS: Registry = Registry("system", _waiting({8: _META_SYSTEMS}))
# fscl_tpu registers its FSCLDataModule under the meta-learning keys too
# (the port's under the same keys); their episodes wait with item 8
DATAMODULES: Registry = Registry("datamodule", _waiting({8: ("conti-ae",)}))
# the corpus walkers of data/parsers.py, filled when that module is imported
RAW_PARSERS: Registry = Registry("raw parser")
