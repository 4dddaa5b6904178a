"""The port's Dummy env against the JAX package, bit for bit.

Dummy-v0 is the engine's fixture: the only env with a per-player field
(``obs:dyn``) and ``info:players.env_id`` of shape ``[N, players]`` when
``max_num_players > 1``.  Both engines step from one JAX pool state (carried
by ``envpool_tpu_torch.interop``) across terminations, the time limit and
auto-reset, at one and at two players; state and timestep must be equal
field for field (``tests/test_torch_toy_text.py``'s ``ExactPair``).
"""

import numpy as np
import pytest

import envpool_tpu
import envpool_tpu_torch
from test_torch_toy_text import ExactPair, run_exact

TASK = "Dummy-v0"


@pytest.mark.parametrize("players", [1, 2])
def test_spec_matches_jax(players):
    jspec = envpool_tpu.make_spec(TASK, num_envs=3, max_num_players=players)
    tspec = envpool_tpu_torch.make_spec(TASK, num_envs=3, max_num_players=players, device="cpu")
    assert dict(tspec.env.config, device="cuda") == dict(jspec.env.config, device="cuda")
    assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec)
    assert repr(tspec.state_array_spec) == repr(jspec.state_array_spec)
    assert tspec.state_array_spec["obs:dyn"].static_shape(players) == (
        (2,) if players == 1 else (players, 2))


@pytest.mark.parametrize("players", [1, 2])
def test_rollout_matches_jax_bit_for_bit(players):
    """Env 0 starts 2 steps before its termination (``counter`` 8 of
    ``state_num`` 10); the others reach the time limit of 4 steps."""
    n, steps = 5, 9
    acts = np.random.default_rng(players).integers(0, 6, (steps + 1, n)).astype(np.int32)

    def near_end(tree):
        tree["env_state"]["counter"][0] = 8

    pair = ExactPair(TASK, n, max_num_players=players, max_episode_steps=4)
    seen = run_exact(pair, steps, acts, first=near_end)
    done = np.stack([ts["done"] for ts in seen])
    trunc = np.stack([ts["trunc"] for ts in seen])
    assert (done & ~trunc)[:, 0].any() and trunc.any()
    assert (np.stack([ts["step_type"] for ts in seen]) == 0).any()
    ts = seen[-1]
    want_ids = np.arange(n) if players == 1 else np.repeat(np.arange(n)[:, None], players, 1)
    np.testing.assert_array_equal(ts["info:players.env_id"], want_ids)
    assert ts["obs:dyn"].shape == ((n, 2) if players == 1 else (n, players, 2))


@pytest.mark.parametrize("players", [1, 2])
def test_dummy_contract_through_the_adapters(players):
    """The reference's contract (``tests/test_dummy.py``) on the port's
    gymnasium and dm pools on the CPU: the reward and ``obs:dyn`` echo the
    action, ``obs:raw`` counts the steps, and an episode ends after
    ``state_num`` steps."""
    n = 3
    env = envpool_tpu_torch.make_gymnasium(TASK, num_envs=n, seed=0, device="cpu",
                                           max_num_players=players)
    obs, info = env.reset()
    np.testing.assert_array_equal(obs["raw"][0], np.arange(10))
    assert info["queue_size"].shape == (n,)
    assert info["players"]["env_id"].shape == ((n,) if players == 1 else (n, players))
    acts = np.array([1, 2, 3], np.int32)
    obs, rew, term, trunc, info = env.step(acts)
    np.testing.assert_array_equal(rew, acts.astype(np.float32))
    np.testing.assert_array_equal(obs["dyn"].reshape(n, -1)[:, 0], acts)
    np.testing.assert_array_equal(obs["raw"][:, 0], [1, 1, 1])
    for _ in range(9):
        obs, rew, term, trunc, info = env.step(acts)
    assert term.all() and not trunc.any()
    dm = envpool_tpu_torch.make_dm(TASK, num_envs=n, device="cpu", max_num_players=players)
    ts = dm.step(acts)
    assert ts.observation.dyn.shape == ((n, 2) if players == 1 else (n, players, 2))
    assert envpool_tpu_torch.make(TASK, env_type="gym", num_envs=n, device="cpu")
