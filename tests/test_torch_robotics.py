"""The port's robotics family against the JAX package: Fetch, HandReach,
Adroit, PointMaze and FrankaKitchen (the Shadow Hand's manipulate envs in
``test_torch_hand.py``), and the registry of all 157 ids.

Both engines step from one JAX pool state, carried into the port by
``envpool_tpu_torch.interop``.  The port is handed the draws JAX's engine
step makes: ``jax.random.randint``, ``uniform`` and ``normal`` are
replaced by wrappers that record their values from inside the jitted step
(one compile per class config), in the order the env draws (the reset
branch's, then the step's), and the port's env declares the same draws in
the same order (``plan_reset`` / ``plan_step``), so :class:`Replay` hands
them over by position.  JAX's two rejection loops (Fetch's object
placement, PointMaze's start cell) draw inside a ``lax.while_loop``: the
test records the value the loop accepted instead, and hands it to the
port's draw of the same name (``Draws.accept``).

Every step is held by the rule of ``envpool_tpu_torch/ops/thresholds.py``
(XLA's and ATen's float32 arithmetic differ by an ulp): every field within
1e-5 * (1 + |x|) of JAX's, an env whose step lies within that of a
threshold (a grasp, a push, a wall, a success radius) excused, at most 1%
of the env steps; a reset has no excuse.
"""

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
from envpool_tpu.envs.robotics.fetch import FetchEnv as JaxFetchEnv
from envpool_tpu.envs.robotics.point_maze import PointMazeEnv as JaxPointMazeEnv
from envpool_tpu_torch import interop
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.core.registry import registry as torch_registry
from envpool_tpu_torch.ops import thresholds
from test_torch_highway import host, to_jax
from test_torch_procgen import _tensors, assert_same_layout
from test_torch_toy_text import assert_trees_equal, assert_uniform

N = 8

# -- recording JAX's draws -----------------------------------------------------

_REC: list = []
_ON = [False]


def _recorded(orig, kind):
    def wrapped(*a, **k):
        v = orig(*a, **k)
        if _ON[0]:
            _REC.append((kind, v))
        return v

    return wrapped


def _accepted(orig):
    """A rejection loop: its draws unrecorded, its accepted value recorded."""

    def wrapped(*a, **k):
        on, _ON[0] = _ON[0], False
        try:
            v = orig(*a, **k)
        finally:
            _ON[0] = on
        if on:
            _REC.append(("accept", v))
        return v

    return wrapped


def record_draws(monkeypatch):
    """Replace ``jax.random.randint``, ``uniform`` and ``normal`` and the two
    rejection loops by wrappers that record their values while recording
    is on."""
    for name in ("randint", "uniform", "normal"):
        monkeypatch.setattr(jax.random, name, _recorded(getattr(jax.random, name), name))
    monkeypatch.setattr(JaxFetchEnv, "sample_object_xy",
                        _accepted(JaxFetchEnv.sample_object_xy))
    monkeypatch.setattr(JaxPointMazeEnv, "_sample_reset",
                        _accepted(JaxPointMazeEnv._sample_reset))


class Replay:
    """The draw interface of ``envpool_tpu_torch.core.rng.Draws`` over
    recorded JAX draws: each call takes the next record, which must be of
    its kind and shape."""

    def __init__(self, records, n):
        self.recs = list(records)
        self.n = n
        self.out = {}
        self.fresh()

    def fresh(self):
        """Start the next branch's draws (the step's after the reset's)."""
        out = self.out
        self.out = {"rows": torch.zeros((self.n, 0), dtype=torch.int8)}
        return out

    def _take(self, name, kind, shape=None):
        k, v = self.recs.pop(0)
        assert k == kind, (name, k, kind)
        v = torch.as_tensor(np.array(v))
        if shape is not None:
            assert tuple(v.shape[1:]) == tuple(shape), (name, kind, v.shape, shape)
        self.out[name] = v
        return v

    def randint(self, name, lo, hi, shape=(), share=None):
        return self._take(name, "randint", shape)

    def uniform(self, name, shape=(), lo=0.0, hi=1.0):
        return self._take(name, "uniform", shape)

    def normal(self, name, shape=()):
        return self._take(name, "normal", shape)

    def accept(self, name, draw, ok, k=None):
        return self._take(name, "accept")

    def done(self):
        assert not self.recs, f"{len(self.recs)} JAX draws left over: {self.recs[:3]}"
        return self.fresh()


class GoalPair:
    """A JAX engine and a port engine over one id: the JAX engine step is
    jitted with the recording wrappers on (one compile), the port gets the
    reset's and the step's draws through :class:`Replay`."""

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
        """One step of both engines from the host pool state ``tree``;
        returns the JAX and port results and the step branch's draws."""
        jps, jts, vals = self._step(to_jax(tree), {"action": jnp.asarray(action)})
        replay = Replay(zip(self.kinds, jax.device_get(vals)), self.n)
        self.tenv.plan_reset(replay)
        reset = replay.fresh()
        if hasattr(self.tenv, "plan_step"):
            self.tenv.plan_step(replay)
        draws = replay.done()
        self.tenv.reset_draws = lambda sub: reset
        self.tenv.step_draws = lambda sub: draws
        tps, tts = self.teng.step(interop.pool_state_from_numpy(tree, "cpu"),
                                  {"action": torch.as_tensor(action)})
        return (host(jps), jax.device_get(jts), interop.pool_state_to_numpy(tps, like=tree),
                tts, draws)


def actions(spec, n, gen):
    lo, hi = np.asarray(spec.minimum, np.float32), np.asarray(spec.maximum, np.float32)
    return (lo + (hi - lo) * gen.random((n, *spec.shape))).astype(np.float32)


def run_pair(pair, steps, seed, act=None):
    """``steps`` steps of both engines from the JAX pool's initial state
    (every env pending its first reset), random actions (or ``act(t,
    tree)``), each step held by the rule; returns the JAX timesteps, the
    last (JAX, port) pool states and the rule's totals."""
    spec = pair.tenv.action_spec()["action"]
    gen = np.random.default_rng(seed)
    tree = host(pair.jeng.init())
    seen, totals = [], {}
    for t in range(steps):
        a = actions(spec, pair.n, gen) if act is None else act(t, tree, gen)
        before = tree
        tree, jts, ttree, tts, draws = pair.step(tree, a)
        for k in ("elapsed", "autoreset", "full_reset"):
            assert_trees_equal(tree[k], ttree[k], f"step {t} {k}")
        want = {"state": _tensors(tree["env_state"]), "ts": _tensors(dict(jts))}
        got = {"state": _tensors(ttree["env_state"]), "ts": dict(tts)}
        assert_same_layout(want, got, f"step {t}")
        v = thresholds.hold_step(pair.tenv, _tensors(before["env_state"]), torch.as_tensor(a),
                                 draws, torch.as_tensor(before["autoreset"]), want, got)
        assert v["failed"] == 0, (t, v)
        for k, x in v.items():
            totals[k] = totals.get(k, 0) + x
        seen.append(jts)
    assert totals["excused"] <= thresholds.MAX_EXCUSED_SHARE * totals["envs"], totals
    return seen, (tree, ttree), totals


def check_rollout(task, monkeypatch, steps=6, episode=3, seed=0, act=None, **cfg):
    """An 8-env rollout with episodes cut at ``episode`` steps, across
    auto-reset."""
    pair = GoalPair(task, monkeypatch, max_episode_steps=episode, **cfg)
    seen, last, totals = run_pair(pair, steps, seed, act)
    first = np.stack([ts["step_type"] == 0 for ts in seen])
    assert first[0].all() and first[1:].any(), "no auto-reset"
    rewards = np.stack([np.asarray(ts["reward"]) for ts in seen])
    assert np.isfinite(rewards).all()
    return pair, seen, last, totals


ROBOTICS = [t for t, (path, _, _) in jax_registry.specs.items() if path.endswith(".robotics")]


# -- Fetch -----------------------------------------------------------------------


def _toward_object(t, tree, gen):
    """Move the gripper to the object, then close it and lift: grasps,
    pushes and the held object's step."""
    st = tree["env_state"]
    d = st["obj_pos"] - st["grip_pos"]
    a = np.zeros((len(d), 4), np.float32)
    a[:, :3] = np.clip(d / 0.0315, -1, 1)
    a[:, 3] = np.where(np.linalg.norm(d, axis=1) < 0.04, -1.0, 1.0)
    a[:, 2] += np.where(np.linalg.norm(d, axis=1) < 0.02, 0.8, 0.0)
    return (a + 0.2 * gen.standard_normal(a.shape)).clip(-1, 1).astype(np.float32)


@pytest.mark.parametrize("task", [
    "FetchReach-v4", "FetchReachDense-v4", "FetchPush-v4", "FetchPushDense-v4",
    "FetchSlide-v4", "FetchSlideDense-v4", "FetchPickAndPlace-v4", "FetchPickAndPlaceDense-v4",
])
def test_fetch_matches_jax(task, monkeypatch):
    act = None if task.startswith("FetchReach") else _toward_object
    check_rollout(task, monkeypatch, steps=8, episode=6, act=act)


def test_fetch_grasps_and_lifts(monkeypatch):
    """Steered at the object with the gripper closing, PickAndPlace grasps
    and lifts it in some envs, as JAX does."""
    pair = GoalPair("FetchPickAndPlace-v4", monkeypatch, max_episode_steps=20)
    _, (tree, ttree), _ = run_pair(pair, 12, 0, _toward_object)
    st = ttree["env_state"]
    assert st["grasped"].any()
    assert_trees_equal(tree["env_state"]["grasped"], st["grasped"])
    assert (st["obj_pos"][st["grasped"], 2] > pair.tenv.height_offset).any()


# -- HandReach -------------------------------------------------------------------


@pytest.mark.parametrize("task", ["HandReach-v3", "HandReachDense-v0"])
def test_hand_reach_matches_jax(task, monkeypatch):
    check_rollout(task, monkeypatch)


def test_hand_reach_fingertips_are_jax_fk(monkeypatch):
    """The port's fingertips (its FK on the committed model) equal JAX's FK
    on the gymnasium_robotics MJCF, on random poses."""
    pytest.importorskip("gymnasium_robotics")
    jenv = envpool_tpu.make_spec("HandReach-v3", num_envs=2).env
    tenv = envpool_tpu_torch.make_spec("HandReach-v3", num_envs=2, device="cpu").env
    np.testing.assert_allclose(tenv.initial_goal, jenv.initial_goal, rtol=0, atol=1e-6)
    q = np.random.default_rng(1).uniform(jenv.jnt_lo, jenv.jnt_hi, (16, 24)).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jenv._fingertips))(jnp.asarray(q)))
    got = tenv._fingertips(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * (1 + np.abs(want)).max())


# -- Adroit, PointMaze, FrankaKitchen ------------------------------------------------


@pytest.mark.parametrize("task", [
    "AdroitHandDoor-v1", "AdroitHandHammerSparse-v1", "AdroitHandPen-v1",
    "AdroitHandRelocate-v1",
])
def test_adroit_matches_jax(task, monkeypatch):
    check_rollout(task, monkeypatch)


@pytest.mark.parametrize("task", [
    "PointMaze_Open-v3", "PointMaze_UMazeDense-v3", "PointMaze_Large-v3",
    "PointMaze_Large_Diverse_GR-v3",
])
def test_point_maze_matches_jax(task, monkeypatch):
    def push(t, tree, gen):  # full force, so that the ball meets walls
        return np.sign(gen.standard_normal((N, 2))).astype(np.float32)

    check_rollout(task, monkeypatch, steps=10, episode=8, act=push)


def test_point_maze_resolves_walls_and_goals(monkeypatch):
    """A ball pushed into a wall stops at it, with JAX's tie order; a ball at
    the goal gets a new one (the continuing task's step draws)."""
    pair = GoalPair("PointMaze_UMaze-v3", monkeypatch, max_episode_steps=30)
    tree = host(pair.jeng.init())
    a = np.tile(np.asarray([[1.0, 1.0]], np.float32), (N, 1))
    tree = pair.step(tree, a)[0]
    st = tree["env_state"]
    st["pos"][:] = st["goal"] + np.asarray([0.05, 0.0], np.float32)
    st["vel"][:] = np.asarray([4.0, -4.0], np.float32)
    for t in range(4):
        before = tree
        tree, jts, ttree, tts, draws = pair.step(tree, a)
        want = {"state": _tensors(tree["env_state"]), "ts": _tensors(dict(jts))}
        got = {"state": _tensors(ttree["env_state"]), "ts": dict(tts)}
        v = thresholds.hold_step(pair.tenv, _tensors(before["env_state"]), torch.as_tensor(a),
                                 draws, torch.as_tensor(before["autoreset"]), want, got)
        assert v["failed"] == 0 and v["excused"] == 0, (t, v)
        if t == 0:  # the sparse reward: success before the new goal
            assert (jts["reward"] > 0).any()
    assert (np.abs(tree["env_state"]["vel"]) < 5).all()


def test_kitchen_matches_jax(monkeypatch):
    def reach(t, tree, gen):  # toward the microwave and the kettle
        return (0.8 * np.sign(gen.standard_normal((N, 9)))).astype(np.float32)

    check_rollout("FrankaKitchen-v1", monkeypatch, steps=8, episode=6, act=reach)


# -- registry, draws, model ------------------------------------------------------------


def test_every_robotics_id_is_ported():
    ids = [t for t, (path, _, _) in torch_registry.specs.items() if path.endswith(".robotics")]
    assert ids == ROBOTICS and len(ids) == 157
    all_jax, all_port = envpool_tpu.list_all_envs(), envpool_tpu_torch.list_all_envs()
    port_set = set(all_port)
    assert [t for t in all_jax if t in port_set] == all_port


def test_config_and_spec_match_jax():
    for task in ROBOTICS:
        jspec = envpool_tpu.make_spec(task, num_envs=2)
        tspec = envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu")
        assert dict(tspec.env.config, device="cuda") == dict(jspec.env.config, device="cuda")
        assert tspec.reward_threshold == jspec.reward_threshold, task
        assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec), task
        assert repr(tspec.state_array_spec) == repr(jspec.state_array_spec), task


def _reset_draws(task, n=20000):
    env = envpool_tpu_torch.make_spec(task, num_envs=n, seed=3, device="cpu").env
    return env, env.reset_draws(rng.split(env.keys())[1])


def test_port_fetch_draws():
    """The port's own object placement: every xy at least 0.1 from the
    gripper and within the object range, uniform over the allowed region;
    the goal's noise and lift within their ranges."""
    env, d = _reset_draws("FetchPickAndPlace-v4")
    xy = d["object_xy"].numpy() - env.init_grip[:2]
    r = np.linalg.norm(xy, axis=1)
    assert (r >= 0.1).all() and (np.abs(xy) <= 0.15).all()
    # The quadrants and the radius: a region's share matches its area.
    for q in (xy[:, 0] > 0, xy[:, 1] > 0):
        assert abs(q.mean() - 0.5) < 0.02
    area = 0.3 ** 2 - np.pi * 0.1 ** 2
    assert abs((r < 0.12).mean() - np.pi * (0.12 ** 2 - 0.1 ** 2) / area) < 0.01
    assert float(d["lift"].min()) >= 0 and float(d["lift"].max()) < 0.45
    assert abs(float((d["lift_coin"] < 0.5).float().mean()) - 0.5) < 0.02
    assert float(d["goal_noise"].abs().max()) <= 0.15


def test_port_point_maze_draws():
    """The port's own start cells: never within 0.5 of the goal, every other
    reset cell about equally often, noise within the range."""
    env, d = _reset_draws("PointMaze_UMaze-v3")
    goal = env._goal(d, "goal_").numpy()
    start, centre = d["start"][:, :2].numpy(), d["start"][:, 2:].numpy()
    assert (np.linalg.norm(centre - goal, axis=1) > 0.5).all()
    assert (np.abs(start - centre) <= 0.25).all()
    cells = np.asarray([np.flatnonzero((env.reset_cells == c).all(1))[0] for c in centre])
    assert_uniform(cells, 0, len(env.reset_cells) - 1)
    assert_uniform(d["goal_cell"].numpy(), 0, len(env.goal_cells) - 1)


def test_draws_accept_loops_over_rows_left():
    """A predicate few candidates pass leaves rows for later rounds; each
    row's value depends on its own stream alone."""
    keys = rng.seed_keys(np.arange(64), "cpu")
    sub = rng.split(keys)[1]

    def run(s):
        d = rng.Draws(s)
        v = d.accept("x", lambda dd, k: dd.uniform("c", (k,)), lambda c: c > 0.9, k=2)
        return v, d.slot

    v, slot = run(sub)
    assert (v > 0.9).all() and slot == 2
    v8, _ = run(sub[:8])
    assert torch.equal(v[:8], v8)


def test_draws_normal_and_vector_uniform(monkeypatch):
    """``Draws.normal`` is standard normal; ``Draws.uniform`` with bounds per
    component keeps ``max(lo, u * (hi - lo) + lo)`` in float32, within its
    bounds: handed JAX's unit draws, it gives ``jax.random.uniform``'s
    values within one rounding of the product (XLA fuses the multiply-add
    into one rounding, the port rounds twice)."""
    sub = rng.split(rng.seed_keys(np.arange(50000), "cpu"))[1]
    d = rng.Draws(sub)
    z = d.normal("z", (2,)).numpy()
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1) < 0.02 and d.slot == 4
    lo = np.asarray([-0.04, -0.06, 0.0], np.float32)
    hi = np.asarray([0.04, 0.02, 0.06], np.float32)
    v = d.uniform("v", (3,), lo, hi).numpy()
    assert (v >= lo).all() and (v < hi).all()
    keys = jax.random.split(jax.random.PRNGKey(0), 4096)
    unit = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3,)))(keys))
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (3,), jnp.float32, jnp.asarray(lo), jnp.asarray(hi)))(keys))
    monkeypatch.setattr(rng, "uniform", lambda s, slot, k=None: torch.as_tensor(unit))
    got = rng.Draws(sub[:4096]).uniform("v", (3,), lo, hi).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=np.spacing(hi - lo).max())
    assert (got >= lo).all() and (got < hi).all()


def test_no_model_for_manipulate():
    env = envpool_tpu_torch.make_spec("HandManipulateBlock-v0", num_envs=2, device="cpu").env
    assert not hasattr(env, "model")
