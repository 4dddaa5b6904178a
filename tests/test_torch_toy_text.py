"""The port's toy_text envs against the JAX package, bit for bit.

Both engines step from one JAX pool state, carried into the port by
``envpool_tpu_torch.interop``; the port is handed the reset and step draws
the JAX envs make from their threefry keys (the key split of the JAX
engine's ``_step_one`` feeds both the reset and the step branch), in the
port's draw layout.  Every id and alias runs a rollout that crosses
auto-reset (terminations and the time limit), and every field of the state
and of the timestep must be equal: toy_text's state is integer, and its
float fields (reward, discount, Catch's board, CliffWalking's
``info:prob``) are exact.  The port's own draws are checked by range and
distribution.

The helpers here (``ExactPair``, ``assert_trees_equal``, ``assert_uniform``)
also serve ``tests/test_torch_dummy.py``.
"""

import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
import jax
import jax.numpy as jnp
from envpool_tpu.core.engine import Engine as JaxEngine
from envpool_tpu.core.registry import registry as jax_registry
from envpool_tpu_torch import interop
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine
from test_torch_classic import host, to_jax


def _randint(key, lo, hi):
    return jax.random.randint(key, (), lo, hi, jnp.int32)


def _blackjack_step(jenv, sub):
    hit_key, dealer_key = jax.random.split(sub)
    return {"hit": _randint(hit_key, 1, 14),
            "dealer": jax.vmap(lambda i: _randint(jax.random.fold_in(dealer_key, i), 1, 14))(
                jnp.arange(16))}


# JAX's draws of each env class from the subkey of one env's step, in the
# port's layout: (reset draws, step draws).
_DRAWS = {
    "FrozenLakeEnv": (None, lambda jenv, sub: {"slip": _randint(sub, -1, 2)}),
    "CatchEnv": (lambda jenv, sub: {"column": _randint(sub, 0, int(jenv.config["width"]))},
                 None),
    "NChainEnv": (None, lambda jenv, sub: {"u": jax.random.uniform(sub, ())}),
    "CliffWalkingEnv": (None, lambda jenv, sub: (
        {"offset": _randint(sub, 0, 3) - 1} if jenv.config["is_slippery"] else {})),
    "TaxiEnv": (lambda jenv, sub: {"start": jnp.stack(
        [_randint(k, 0, n) for k, n in zip(jax.random.split(sub, 4), (5, 5, 4, 4))])}, None),
    "BlackjackEnv": (lambda jenv, sub: {"ranks": jnp.stack(
        [_randint(k, 1, 14) for k in jax.random.split(sub, 4)])}, _blackjack_step),
    "DummyEnv": (None, None),
}


def _batched(jenv, fn):
    """``keys -> {name: tensor}``: ``fn``'s draws for every env's step."""
    if fn is None:
        return lambda keys: {}

    def one(key):
        return fn(jenv, jax.random.split(key)[1])

    batched = jax.jit(jax.vmap(one))
    return lambda keys: {k: torch.as_tensor(np.array(v))
                         for k, v in jax.device_get(batched(jnp.asarray(keys))).items()}


class ExactPair:
    """A JAX engine and a port engine over the same task and config, the
    port with JAX's draws."""

    def __init__(self, task, n, **cfg):
        jenv = envpool_tpu.make_spec(task, num_envs=n, seed=5, **cfg).env
        self.jeng = JaxEngine(jenv)
        self.tenv = envpool_tpu_torch.make_spec(task, num_envs=n, seed=5, device="cpu",
                                                **cfg).env
        self.teng = Engine(self.tenv)
        reset_fn, step_fn = _DRAWS[type(jenv).__name__]
        self.reset_draws, self.step_draws = _batched(jenv, reset_fn), _batched(jenv, step_fn)

    def step(self, tree, action):
        """One step of both engines from the host pool state ``tree``:
        ``(jax tree after, jax timestep, port tree after, port timestep)``."""
        keys = tree["key"]
        reset, step = self.reset_draws(keys), self.step_draws(keys)
        self.tenv.reset_draws = lambda sub: reset
        self.tenv.step_draws = lambda sub: step
        jps, jts = self.jeng.step(to_jax(tree), {"action": jnp.asarray(action)})
        tps, tts = self.teng.step(interop.pool_state_from_numpy(tree, "cpu"),
                                  {"action": torch.as_tensor(action)})
        return host(jps), jax.device_get(jts), interop.pool_state_to_numpy(tps), tts


def assert_trees_equal(want, got, where=""):
    """Equal leaf for leaf: same keys, dtypes, shapes and values."""
    if isinstance(want, dict):
        assert set(want) == set(got), where
        for k in want:
            assert_trees_equal(want[k], got[k], f"{where}/{k}")
        return
    a = np.asarray(want)
    b = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert (a.dtype, a.shape) == (b.dtype, b.shape), where
    np.testing.assert_array_equal(b, a, err_msg=where)


def run_exact(pair, steps, actions, first=None):
    """``steps`` steps of both engines of an ``ExactPair`` from the JAX
    pool's first reset; the port's new env state and timestep equal JAX's
    after every step.  ``first(tree)`` may edit the pool state after the
    reset.  Returns the JAX timesteps."""
    task = type(pair.tenv).__name__
    tree = host(pair.jeng.step(pair.jeng.init(), {"action": jnp.asarray(actions[0])})[0])
    if first is not None:
        first(tree)
    seen = []
    for t in range(1, steps + 1):
        tree, jts, ttree, tts = pair.step(tree, actions[t])
        assert_trees_equal(tree["env_state"], ttree["env_state"], f"{task} step {t} state")
        for k in ("elapsed", "autoreset", "full_reset"):
            assert_trees_equal(tree[k], ttree[k], f"{task} step {t} {k}")
        assert_trees_equal(dict(jts), tts, f"{task} step {t}")
        seen.append(jts)
    return seen


def _actions(task, n, steps, seed, **cfg):
    spec = envpool_tpu_torch.make_spec(task, device="cpu", **cfg).action_array_spec["action"]
    r = np.random.default_rng(seed)
    return r.integers(spec.minimum, spec.maximum + 1, (steps + 1, n)).astype(np.int32)


TOY_TEXT = sorted(t for t, (path, _, _) in jax_registry.specs.items()
                  if path.endswith(".toy_text"))
# Episodes cut at a few steps, so that every rollout sees the time limit.
_EPISODE = {"NChain-v0": 6, "Catch-v0": 5, "Taxi-v3": 8, "Blackjack-v1": 2,
            "tabular/Blackjack-v0": 2}


def test_every_toy_text_id_is_ported():
    assert TOY_TEXT == sorted([
        "Catch-v0", "FrozenLake-v1", "FrozenLake8x8-v1", "Taxi-v3", "NChain-v0",
        "CliffWalking-v1", "tabular/CliffWalking-v0", "CliffWalkingSlippery-v1",
        "CliffWalking-v0", "Blackjack-v1", "tabular/Blackjack-v0"])
    ported = envpool_tpu_torch.list_all_envs()
    assert set(TOY_TEXT) <= set(ported)


@pytest.mark.parametrize("task", TOY_TEXT)
def test_config_and_spec_match_jax(task):
    jspec = envpool_tpu.make_spec(task, num_envs=3)
    tspec = envpool_tpu_torch.make_spec(task, num_envs=3, device="cpu")
    assert dict(tspec.env.config, device="cuda") == dict(jspec.env.config, device="cuda")
    assert tspec.reward_threshold == jspec.reward_threshold
    assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec)
    assert repr(tspec.state_array_spec) == repr(jspec.state_array_spec)


def _near_ends(task, acts):
    """``first(tree)``: the first rows of a task whose random walks rarely
    end an episode start next to its ends, and ``acts`` drive them there
    (Catch: the ball two rows up; CliffWalking: down onto the goal and onto
    the cliff; Taxi: a dropoff at the destination, a pickup, a dropoff at
    another pickup location)."""
    cls = envpool_tpu_torch.make_spec(task, device="cpu").env.__class__.__name__
    rows = {"CatchEnv": [[7, 2, 2]],
            "CliffWalkingEnv": [[2, 11], [2, 1], [2, 11]],
            "TaxiEnv": [[0, 0, 4, 0], [0, 0, 0, 1], [4, 3, 4, 0]]}.get(cls, [])
    forced = {"CliffWalkingEnv": [2, 2, 2], "TaxiEnv": [5, 4, 5]}.get(cls, [])
    acts[:, :len(forced)] = forced

    def first(tree):
        tree["env_state"][:len(rows)] = rows

    return first if rows else None


@pytest.mark.parametrize("task", TOY_TEXT)
def test_rollout_matches_jax_bit_for_bit(task):
    n, steps = 6, 24
    cfg = {"max_episode_steps": _EPISODE.get(task, 10)}
    acts = _actions(task, n, steps, len(task), **cfg)
    seen = run_exact(ExactPair(task, n, **cfg), steps, acts, first=_near_ends(task, acts))
    done = np.stack([ts["done"] for ts in seen])
    trunc = np.stack([ts["trunc"] for ts in seen])
    first = np.stack([ts["step_type"] == 0 for ts in seen])
    assert trunc.any() and first[1:].any(), "no time limit or no auto-reset"
    if task != "NChain-v0":  # NChain ends at the time limit alone
        assert (done & ~trunc).any(), "no termination"


def test_frozen_lake_8x8_reaches_hole_and_goal():
    """From cells next to a hole and to the goal, with moves toward them:
    both end the episode, the goal with reward 1 (all exact)."""
    n, steps = 16, 4

    def near(tree):
        cells = np.array([[2, 2], [7, 6], [6, 7], [4, 2]] * 4, np.int32)  # H at (2,3), G at (7,7)
        tree["env_state"][:] = cells

    acts = np.tile(np.array([2, 2, 1, 2], np.int32), (steps + 1, 4))
    seen = run_exact(ExactPair("FrozenLake8x8-v1", n), steps, acts, first=near)
    rewards = np.stack([ts["reward"] for ts in seen])
    assert (rewards == 1.0).any() and ((np.stack([ts["done"] for ts in seen])) & (rewards == 0)).any()


@pytest.mark.parametrize("natural, sab", [(False, True), (True, False), (False, False)])
def test_blackjack_dealer_draws_many_cards(natural, sab):
    """Sticks from a dealer's hand of two aces counted without the ace (raw
    sum 2, the lowest there is): the dealer draws up to 16 cards, and in
    some envs more than 4; the payouts of each rule agree bit for bit."""
    n = 64
    pair = ExactPair("Blackjack-v1", n, natural=natural, sab=sab)
    dealt = []

    def low_dealer(tree):
        st = tree["env_state"]
        st["d_sum"][:] = 2
        st["d_ace"][:] = False
        st["d_first"][:] = 1
        st["p_sum"][::2], st["p_ace"][::2], st["p_first"][::2] = 11, True, [1, 10]
        dealt.append(pair.step_draws(tree["key"])["dealer"].numpy())

    run_exact(pair, 1, np.zeros((2, n), np.int32), first=low_dealer)  # stick
    dealer = dealt[0]
    # How many cards each dealer drew from raw sum 2 without an ace.
    total, ace, drawn = np.full(n, 2), np.zeros(n, bool), np.zeros(n, int)
    for i in range(16):
        more = np.where(ace & (total + 10 <= 21), total + 10, total) < 17
        c = np.minimum(dealer[:, i], 10)
        total, ace, drawn = total + more * c, ace | (more & (c == 1)), drawn + more
    assert drawn.max() > 4, drawn


def test_toy_text_pools_on_the_cpu():
    """``make``, ``make_gymnasium``, ``make_dm`` and ``make_spec`` of every
    id on the CPU; the dm pool's observation carries the obs."""
    for task in TOY_TEXT:
        spec = envpool_tpu_torch.make_spec(task, num_envs=3, device="cpu")
        gym = envpool_tpu_torch.make_gymnasium(task, num_envs=3, device="cpu")
        obs, info = gym.reset()
        sample = _actions(task, 3, 1, 0)[1]
        obs, rew, term, trunc, info = gym.step(sample)
        assert obs.shape == (3, *spec.state_array_spec["obs"].shape) and rew.dtype == np.float32
        dm = envpool_tpu_torch.make_dm(task, num_envs=3, device="cpu")
        ts = dm.reset()
        ts = dm.step(sample)
        assert ts.observation.obs.shape == obs.shape
        assert envpool_tpu_torch.make(task, env_type="gym", num_envs=3, device="cpu")


def assert_uniform(x, lo, hi, where=""):
    """Integer draws ``x`` cover ``[lo, hi]`` with counts within 5 sigma of
    uniform."""
    x = np.asarray(x).reshape(-1)
    assert x.min() == lo and x.max() == hi, where
    k = hi - lo + 1
    counts = np.bincount(x - lo, minlength=k)
    expect = len(x) / k
    assert (np.abs(counts - expect) < 5 * np.sqrt(expect)).all(), (where, counts)


def _port_draws(task, which, n=20000, **cfg):
    env = envpool_tpu_torch.make_spec(task, num_envs=n, seed=11, device="cpu", **cfg).env
    _, sub = rng.split(env.keys())
    return getattr(env, which)(sub)


def test_port_draws_range_and_distribution():
    assert_uniform(_port_draws("FrozenLake8x8-v1", "step_draws")["slip"], -1, 1, "slip")
    assert_uniform(_port_draws("CliffWalkingSlippery-v1", "step_draws")["offset"], -1, 1)
    assert _port_draws("CliffWalking-v1", "step_draws") == {}
    assert_uniform(_port_draws("Catch-v0", "reset_draws", width=7)["column"], 0, 6, "column")
    start = _port_draws("Taxi-v3", "reset_draws")["start"].numpy()
    for col, hi in enumerate((4, 4, 3, 3)):
        assert_uniform(start[:, col], 0, hi, f"taxi {col}")
    ranks = _port_draws("Blackjack-v1", "reset_draws")["ranks"].numpy()
    step = _port_draws("Blackjack-v1", "step_draws")
    for x in (ranks, step["hit"].numpy(), step["dealer"].numpy()):
        assert_uniform(x, 1, 13, "ranks")
    # The cards of one env are not the same draw over and over.
    dealer = step["dealer"].numpy()
    assert abs(np.corrcoef(dealer[:, 0], dealer[:, 1])[0, 1]) < 0.05
    u = _port_draws("NChain-v0", "step_draws")["u"].numpy()
    assert u.dtype == np.float32 and 0 <= u.min() and u.max() < 1
    assert abs((u < 0.2).mean() - 0.2) < 5 * np.sqrt(0.16 / len(u))
