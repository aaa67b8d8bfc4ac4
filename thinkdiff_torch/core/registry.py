"""The port's registry: name -> class maps for models, tasks, runners,
dataset builders and processors (counterpart of
thinkdiff_tpu/core/registry.py), plus named paths.

It is kept apart from the JAX package's registry, so both packages can
register the same names in one process. Registering another class under a
taken name raises ``KeyError``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict

REPO_ROOT = Path(__file__).resolve().parents[2]


class Registry:
    KINDS = ("model", "task", "runner", "builder", "processor")

    def __init__(self):
        self.mapping: Dict[str, Dict[str, Any]] = {k: {} for k in self.KINDS}
        self.paths: Dict[str, str] = {"repo_root": str(REPO_ROOT)}

    def _register(self, kind: str, name: str) -> Callable[[Any], Any]:
        def wrap(obj):
            table = self.mapping[kind]
            if table.get(name, obj) is not obj:
                raise KeyError(f"{kind} '{name}' already registered for "
                               f"{table[name]}")
            table[name] = obj
            return obj

        return wrap

    def register_model(self, name: str):
        return self._register("model", name)

    def register_task(self, name: str):
        return self._register("task", name)

    def register_runner(self, name: str):
        return self._register("runner", name)

    def register_builder(self, name: str):
        return self._register("builder", name)

    def register_processor(self, name: str):
        return self._register("processor", name)

    def get_model_class(self, name: str):
        return self.mapping["model"].get(name)

    def get_task_class(self, name: str):
        return self.mapping["task"].get(name)

    def get_runner_class(self, name: str):
        return self.mapping["runner"].get(name)

    def get_builder_class(self, name: str):
        return self.mapping["builder"].get(name)

    def get_processor_class(self, name: str):
        return self.mapping["processor"].get(name)

    def get_path(self, name: str, default: Any = None) -> Any:
        return self.paths.get(name, default)


registry = Registry()
