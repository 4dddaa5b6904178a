"""Functional interface over torch state: the analog of ``env.xla()``.

Counterpart of ``envpool_tpu/adapters/xla.py``.  The handle is
``(PoolState, timestep)``; ``send``/``recv``/``step`` are pure functions of
it that never touch the pool object's own state, so a caller can drive
many steps in a loop with no host round trip::

    pool = envpool_tpu_torch.make("PongLite-v5", env_type="gymnasium",
                                  num_envs=N, numpy_output=False)
    handle, recv, send, step = pool.xla()
    for _ in range(100):
        handle, (obs, rew, term, trunc, info) = step(handle, policy(obs))
"""

from __future__ import annotations

from typing import Any

import torch

__all__ = ["make_functional"]


def make_functional(pool: Any):
    """Return ``(handle, recv, send, step)`` for a pool adapter."""
    engine = pool.engine

    def send(handle, action, env_id=None):
        ps, _ = handle
        tree, env_id = pool._from(action, env_id)
        if env_id is None:
            ps, ts = engine.step(ps, tree)
        else:
            ps, ts = engine.step_partial(ps, tree, env_id)
        return (ps, ts)

    def recv(handle):
        ps, ts = handle
        return (ps, ts), pool._to(ts, reset=False, return_info=True)

    def step(handle, action, env_id=None):
        return recv(send(handle, action, env_id))

    # Initial handle: current pool state + a zero timestep of the right
    # structure (never observed — the first recv follows a send).
    mnp = engine.env.max_num_players
    zero_ts = {
        k: torch.zeros(
            (engine.num_envs, *s.static_shape(mnp)),
            dtype=s.torch_dtype,
            device=engine.device,
        )
        for k, s in pool.spec.state_array_spec.items()
    }
    handle = (pool.pool_state, zero_ts)
    return handle, recv, send, step
