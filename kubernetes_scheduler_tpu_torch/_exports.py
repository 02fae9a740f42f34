"""Lazy package exports.

A package `__init__` names what it re-exports and the module each name
lives in; the module is imported when the name is first read. Importing
any of the port's modules imports every package above it, and the
journal and span tools (trace.inspect, .spans, .analyze, .trend) must
import without torch, so no `__init__` may import a torch module eagerly.
"""

from __future__ import annotations

import importlib


def names_in(module: str, *names: str) -> dict:
    """{name: module} for each of `names`."""
    return dict.fromkeys(names, module)


def lazy_getattr(exports: dict):
    """A module-level `__getattr__` resolving `exports` ({name: module
    path}): the module's attribute `name`, or the module itself when its
    path ends in `.name` (a re-exported submodule)."""

    def __getattr__(name):
        path = exports.get(name)
        if path is None:
            raise AttributeError(name)
        module = importlib.import_module(path)
        return module if path.endswith("." + name) else getattr(module, name)

    return __getattr__
