"""envpool_tpu_torch: the PyTorch/CUDA port of ``envpool_tpu``.

The same public surface as ``envpool_tpu``: ``make``, ``make_dm``,
``make_gym``, ``make_gymnasium``, ``make_spec``, ``list_all_envs``,
``register``.  Env state lives on one torch device (``device`` config key,
``"cuda"`` by default); steps are batched tensor programs with fused
auto-reset.  This package never imports JAX or ``envpool_tpu``.
"""

import envpool_tpu_torch.entry  # noqa: F401  (registers the env families)
from envpool_tpu_torch.core.env import TorchEnv
from envpool_tpu_torch.core.env_spec import EnvSpec
from envpool_tpu_torch.core.protocol import (
    DMEnvPool,
    EnvPool,
    GymnasiumEnvPool,
)
from envpool_tpu_torch.core.registry import (
    list_all_envs,
    make,
    make_dm,
    make_gym,
    make_gymnasium,
    make_spec,
    register,
)

__version__ = "0.1.0"
__all__ = [
    "register",
    "make",
    "make_dm",
    "make_gym",
    "make_gymnasium",
    "make_spec",
    "list_all_envs",
    "EnvSpec",
    "EnvPool",
    "DMEnvPool",
    "GymnasiumEnvPool",
    "TorchEnv",
]
