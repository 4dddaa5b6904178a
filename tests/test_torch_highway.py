"""The port's highway family against the JAX package: Highway-v0,
HighwayFast-v0, the three Parking ids and LaneKeeping-v0.

Both engines step from one JAX pool state, carried into the port by
``envpool_tpu_torch.interop``.  The port is handed the draws JAX's reset
makes: ``jax.random.randint`` and ``uniform`` are replaced by wrappers
that record their values from inside the jitted engine step (one compile
per class), in the order the env draws, and the port's env declares the
same draws in the same order (``plan_reset``), so :class:`Replay` hands
them over by position.  The highway envs draw nothing in a step.

Every step is held by the rule of ``envpool_tpu_torch/ops/thresholds.py``
(XLA's and ATen's ``sin``, ``atan``, ``pow`` and XLA's fused multiply-adds
differ by an ulp): every field within 1e-5 * (1 + |x|) of JAX's, an env
whose step lies within that of a threshold (a lane change, a crash, a
cell) excused, at most 1% of the env steps; a reset has no excuse.
Highway-v0's reset gives the cars' ``x`` and the lane-change ``timer``
equal to JAX's bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu.core.engine import Engine as JaxEngine
from envpool_tpu.core.engine import PoolState as JaxPoolState
from envpool_tpu.core.registry import registry as jax_registry
from envpool_tpu_torch import interop
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.core.registry import registry as torch_registry
from envpool_tpu_torch.envs.highway.straight import cumsum16
from envpool_tpu_torch.ops import thresholds
from test_torch_procgen import _tensors, assert_same_layout
from test_torch_toy_text import assert_trees_equal, assert_uniform

HIGHWAY = [t for t, (path, _, _) in jax_registry.specs.items() if path.endswith(".highway")]
N = 4

# -- recording JAX's draws -----------------------------------------------------

_REC: list = []
_ON = [False]


def record_draws(monkeypatch):
    """Replace ``jax.random.randint`` and ``uniform`` by wrappers that
    record the values they return while recording is on."""
    r = jax.random
    for name in ("randint", "uniform"):
        orig = getattr(r, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            v = _orig(*a, **k)
            if _ON[0]:
                _REC.append((_name, v))
            return v

        monkeypatch.setattr(r, name, wrapped)


class Replay:
    """The draw interface of ``envpool_tpu_torch.core.rng.Draws`` over
    recorded JAX draws: each call takes the next record, which must be of
    its kind and shape."""

    def __init__(self, records, n):
        self.recs = list(records)
        self.out = {"rows": torch.zeros((n, 0), dtype=torch.int8)}

    def _take(self, name, kind, shape):
        k, v = self.recs.pop(0)
        assert k == kind, (k, kind)
        v = torch.as_tensor(np.array(v))
        assert tuple(v.shape[1:]) == tuple(shape), (kind, v.shape, shape)
        self.out[name] = v
        return v

    def randint(self, name, lo, hi, shape=(), share=None):
        return self._take(name, "randint", shape)

    def uniform(self, name, shape=(), lo=0.0, hi=1.0):
        return self._take(name, "uniform", shape)

    def done(self):
        assert not self.recs, f"{len(self.recs)} JAX draws left over"
        return self.out


def host(ps):
    return dataclasses.asdict(jax.device_get(ps))


def to_jax(tree):
    return JaxPoolState(**jax.tree_util.tree_map(jnp.asarray, tree))


class HighwayPair:
    """A JAX engine and a port engine over one id: the JAX engine step is
    jitted with the recording wrappers on (one compile), the port gets the
    reset's draws through :class:`Replay`."""

    def __init__(self, task, monkeypatch, n=N, **cfg):
        record_draws(monkeypatch)
        self.n = n
        self.jenv = envpool_tpu.make_spec(task, num_envs=n, seed=5, **cfg).env
        self.jeng = JaxEngine(self.jenv)
        self.tenv = envpool_tpu_torch.make_spec(task, num_envs=n, seed=5, device="cpu",
                                                **cfg).env
        self.teng = Engine(self.tenv)
        kinds = []

        def one(*args):
            _REC.clear()
            _ON[0] = True
            try:
                out = self.jeng._step_one(*args)
            finally:
                _ON[0] = False
            kinds[:] = [k for k, _ in _REC]
            vals = [v for _, v in _REC]
            _REC.clear()
            return out, vals

        def step(ps, action):
            out, vals = jax.vmap(one)(ps.env_state, ps.key, ps.elapsed, ps.autoreset,
                                      ps.full_reset, action)
            new_state, key, elapsed, done, obs, common = out
            new_ps = JaxPoolState(new_state, key, elapsed, done, common["trunc"])
            ts = self.jeng._finish_ts(obs, common, jnp.arange(n, dtype=jnp.int32))
            return new_ps, ts, vals

        self._step = jax.jit(step)
        self.kinds = kinds

    def step(self, tree, action):
        """One step of both engines from the host pool state ``tree``."""
        jps, jts, vals = self._step(to_jax(tree), {"action": jnp.asarray(action)})
        replay = Replay(zip(self.kinds, jax.device_get(vals)), self.n)
        self.tenv.plan_reset(replay)
        reset = replay.done()
        self.tenv.reset_draws = lambda sub: reset
        tps, tts = self.teng.step(interop.pool_state_from_numpy(tree, "cpu"),
                                  {"action": torch.as_tensor(action)})
        return host(jps), jax.device_get(jts), interop.pool_state_to_numpy(tps, like=tree), tts


def actions(spec, n, players, gen):
    shape = (n, *spec.static_shape(players))
    if spec.is_discrete:
        return gen.integers(int(spec.minimum), int(spec.maximum) + 1, shape).astype(np.int32)
    lo, hi = np.asarray(spec.minimum, np.float32), np.asarray(spec.maximum, np.float32)
    return (lo + (hi - lo) * gen.random(shape)).astype(np.float32)


def run_pair(pair, steps, seed):
    """``steps`` steps of both engines from the JAX pool's initial state
    (every env pending its first reset), random actions, each step held by
    the rule; returns the (JAX, port) pool states and the JAX timesteps
    of each step, and the rule's totals."""
    spec = pair.tenv.action_spec()["action"]
    players = pair.tenv.max_num_players
    gen = np.random.default_rng(seed)
    tree = host(pair.jeng.init())
    trees, seen, totals = [], [], {}
    for t in range(steps):
        act = actions(spec, pair.n, players, gen)
        before = tree
        tree, jts, ttree, tts = pair.step(tree, act)
        for k in ("elapsed", "autoreset", "full_reset"):
            assert_trees_equal(tree[k], ttree[k], f"step {t} {k}")
        want = {"state": _tensors(tree["env_state"]), "ts": _tensors(dict(jts))}
        got = {"state": _tensors(ttree["env_state"]), "ts": dict(tts)}
        assert_same_layout(want, got, f"step {t}")
        v = thresholds.hold_step(pair.tenv, _tensors(before["env_state"]), torch.as_tensor(act),
                                 {}, torch.as_tensor(before["autoreset"]), want, got)
        assert v["failed"] == 0, (t, v)
        for k, x in v.items():
            totals[k] = totals.get(k, 0) + x
        trees.append((tree, ttree))
        seen.append(jts)
    assert totals["excused"] <= thresholds.MAX_EXCUSED_SHARE * totals["envs"], totals
    return trees, seen, totals


def check_rollout(task, monkeypatch, steps, episode, seed=0, **cfg):
    """A 4-env rollout with episodes cut at ``episode`` steps, across
    auto-reset."""
    pair = HighwayPair(task, monkeypatch, max_episode_steps=episode, **cfg)
    trees, seen, totals = run_pair(pair, steps, seed)
    first = np.stack([ts["step_type"] == 0 for ts in seen])
    assert first[0].all() and first[1:].any(), "no auto-reset"
    return pair, trees, seen, totals


@pytest.mark.parametrize("task,steps,episode", [
    ("Highway-v0", 8, 6),
    ("HighwayFast-v0", 8, 6),
    ("Parking-v0", 8, 5),
    ("ParkingActionRepeat-v0", 8, 5),
    ("ParkingParked-v0", 8, 5),
    ("LaneKeeping-v0", 8, 5),
])
def test_rollout_matches_jax(task, steps, episode, monkeypatch):
    _, _, seen, _ = check_rollout(task, monkeypatch, steps, episode)
    rewards = np.stack([np.asarray(ts["reward"]) for ts in seen])
    assert np.isfinite(rewards).all() and (rewards != 0).any()


def test_highway_reset_bit_for_bit(monkeypatch):
    """Highway-v0's reset places the cars as JAX does, bit for bit: the
    blocked cumsum of ``x`` and the ``timer`` taken from it."""
    pair = HighwayPair("Highway-v0", monkeypatch, n=8)
    tree = host(pair.jeng.init())
    act = np.zeros(8, np.int32)
    jtree, _, ttree, _ = pair.step(tree, act)
    for k in ("x", "y", "speed", "target_lane", "timer", "idm_delta"):
        assert_trees_equal(jtree["env_state"][k], ttree["env_state"][k], k)
    x = ttree["env_state"]["x"]
    assert (np.diff(x, axis=1) > 0).all() and x.shape == (8, 51)


def test_cumsum16_is_xlas_cumsum():
    """The blocked order equals ``jnp.cumsum`` on the CPU, where a plain
    sequential sum does not."""
    gen = np.random.default_rng(0)
    a = (gen.random((64, 51)) * 40 + 5).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(a))
    np.testing.assert_array_equal(cumsum16(torch.as_tensor(a)).numpy(), want)
    assert not np.array_equal(np.cumsum(a, axis=-1, dtype=np.float32), want)


def test_every_highway_id_is_ported():
    ids = [t for t, (path, _, _) in torch_registry.specs.items() if path.endswith(".highway")]
    assert ids == HIGHWAY and len(set(torch_registry.specs[t][1] for t in ids)) == 14
    assert len([t for t in ids if t[0].isupper()]) == 18
    all_jax, all_port = envpool_tpu.list_all_envs(), envpool_tpu_torch.list_all_envs()
    port_set = set(all_port)
    assert [t for t in all_jax if t in port_set] == all_port


def test_config_and_spec_match_jax():
    for task in HIGHWAY:
        jspec = envpool_tpu.make_spec(task, num_envs=2)
        tspec = envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu")
        assert dict(tspec.env.config, device="cuda") == dict(jspec.env.config, device="cuda")
        assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec), task
        assert repr(tspec.state_array_spec) == repr(jspec.state_array_spec), task


def test_port_draws_range():
    """The port's own reset draws: lanes uniform over the 4 lanes, speeds
    and the IDM exponents within their ranges, the cars' x increasing."""
    env = envpool_tpu_torch.make_spec("Highway-v0", num_envs=2000, seed=3, device="cpu").env
    pool = Engine(env)
    ps = pool.init()
    ps, _ = pool.reset(ps, torch.ones(2000, dtype=torch.bool))
    st = ps.env_state
    assert_uniform(st["target_lane"][:, 1:].numpy(), 0, 3)
    speed = st["speed"][:, 1:]
    assert float(speed.min()) >= 21.0 and float(speed.max()) < 24.0
    assert float(st["idm_delta"].min()) >= 3.5 and float(st["idm_delta"].max()) < 4.5
    assert bool((st["x"].diff(dim=1) > 0).all())
    assert bool(((st["timer"] >= 0) & (st["timer"] < 1)).all())
