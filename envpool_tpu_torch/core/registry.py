"""Global env registry and factory of the PyTorch port.

Counterpart of ``envpool_tpu/core/registry.py``, with the same errors for
unknown ids, unknown keys and out-of-range seeds.  Mirrors the reference's
registry surface (``envpool/registration.py:64-399``):
``register(task_id, import_path, env_cls, aliases, **kwargs)`` plus
``make / make_gym / make_gymnasium / make_dm / make_spec / list_all_envs``.
Env modules are imported lazily at make() time, like the reference's lazy
pybind module imports (``registration.py:231,280``).
"""

from __future__ import annotations

import importlib
from collections.abc import Sequence
from typing import Any

__all__ = [
    "list_all_envs",
    "make",
    "make_dm",
    "make_gym",
    "make_gymnasium",
    "make_spec",
    "register",
    "registry",
]

_INT32_MAX = 2**31 - 1


class EnvRegistry:
    """Task-id → (env class import path, default kwargs)."""

    def __init__(self) -> None:
        self.specs: dict[str, tuple[str, str, dict[str, Any]]] = {}

    def register(
        self,
        task_id: str,
        import_path: str,
        env_cls: str,
        aliases: Sequence[str] = (),
        **kwargs: Any,
    ) -> None:
        if task_id in self.specs:
            raise ValueError(f"{task_id} is already registered")
        self.specs[task_id] = (import_path, env_cls, kwargs)
        for alias in aliases:
            if alias in self.specs:
                raise ValueError(f"{alias} is already registered")
            self.specs[alias] = (import_path, env_cls, kwargs)

    def list_all_envs(self) -> list[str]:
        return list(self.specs)

    def _check_seed(self, kwargs: dict[str, Any]) -> None:
        """Seed validation following ``registration.py:301-330``."""
        seed = kwargs.get("seed", 42)
        if not (-_INT32_MAX - 1 <= int(seed) <= _INT32_MAX):
            raise ValueError(f"seed {seed} does not fit in int32")
        env_seed = kwargs.get("env_seed", [])
        if env_seed is not None and len(env_seed):
            num_envs = int(kwargs.get("num_envs", 1))
            if len(env_seed) != num_envs:
                raise ValueError(
                    "`env_seed` must contain exactly one seed for each env, "
                    f"got {len(env_seed)} seeds for {num_envs} envs"
                )
            for s in env_seed:
                if not (-_INT32_MAX - 1 <= int(s) <= _INT32_MAX):
                    raise ValueError(f"env_seed {s} does not fit in int32")

    def _env(self, task_id: str, **kwargs: Any):
        if task_id not in self.specs:
            raise ValueError(
                f"{task_id} is not supported, `list_all_envs()` may help."
            )
        import_path, env_cls, default_kwargs = self.specs[task_id]
        self._check_seed(kwargs)
        # from_pixels: the pixel variant (reference registration.py:142-185).
        # The pixel keys are taken out only then: otherwise height, width
        # and the rest are the env's own config.
        from_pixels = bool(kwargs.pop("from_pixels", False))
        pixel_kwargs = {}
        if from_pixels:
            pixel_kwargs = {
                k: kwargs.pop(k)
                for k in ("height", "width", "stack", "view_size", "track_body")
                if k in kwargs
            }
        module = importlib.import_module(import_path)
        cls = getattr(module, env_cls)
        env = cls.from_config(**{**default_kwargs, **kwargs})
        if from_pixels:
            from ..envs.pixels import wrap_from_pixels

            env = wrap_from_pixels(env, **pixel_kwargs)
        return env

    def make_spec(self, task_id: str, **kwargs: Any):
        from .env_spec import EnvSpec

        return EnvSpec(self._env(task_id, **kwargs))

    def make(self, task_id: str, env_type: str, **kwargs: Any):
        if env_type not in ("dm", "gym", "gymnasium"):
            raise ValueError(
                f"env_type {env_type} is not in ['dm', 'gym', 'gymnasium']"
            )
        spec = self.make_spec(task_id, **kwargs)
        if env_type == "dm":
            from ..adapters.dm_adapter import DMEnvPool

            return DMEnvPool(spec)
        from ..adapters.gymnasium_adapter import GymnasiumEnvPool

        return GymnasiumEnvPool(spec)


registry = EnvRegistry()


def register(task_id: str, *args: Any, **kwargs: Any) -> None:
    """Register a task id in the global registry."""
    return registry.register(task_id, *args, **kwargs)


def make(task_id: str, env_type: str, **kwargs: Any) -> Any:
    """Make an env pool of the given task id and API flavor."""
    return registry.make(task_id, env_type, **kwargs)


def make_dm(task_id: str, **kwargs: Any) -> Any:
    """Make a dm_env-flavor pool."""
    return make(task_id, "dm", **kwargs)


def make_gym(task_id: str, **kwargs: Any) -> Any:
    """Deprecated alias of :func:`make_gymnasium` (reference parity)."""
    return make(task_id, "gym", **kwargs)


def make_gymnasium(task_id: str, **kwargs: Any) -> Any:
    """Make a Gymnasium-flavor pool."""
    return make(task_id, "gymnasium", **kwargs)


def make_spec(task_id: str, **kwargs: Any) -> Any:
    """Make only the EnvSpec (config + spaces), no pool."""
    return registry.make_spec(task_id, **kwargs)


def list_all_envs() -> list[str]:
    """All registered task ids."""
    return registry.list_all_envs()
