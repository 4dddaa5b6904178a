"""The port's MiniGrid family against the JAX package.

Both engines step from one JAX pool state, carried into the port by
``envpool_tpu_torch.interop``, and the port is handed the draws the JAX
envs make.  To get them without re-deriving JAX's key trees, the test
replaces ``jax.random.categorical``, ``randint``, ``permutation``,
``bernoulli`` and ``choice`` by wrappers that compute the same values
(a categorical as ``argmax(gumbel + logits)``, checked against JAX's own
engine step once) and record them, in the order the env draws, from
inside the jitted engine step (``jax.lax.scan`` records the draws of its
body stacked over its steps).  The port's env declares the same draws in
the same order (``plan_reset``, ``plan_step``), so :class:`Replay` hands
them over by position, each checked for its kind and shape.

Every env class runs an 8-env rollout across auto-reset; the state and
the timestep must equal JAX's in every field, the reward bit for bit.
The view, the reward's rounding, the WFC banks and ``render_state`` are
held to JAX's on their own, and the golden trajectories of
``tests/oracle_fixtures/minigrid_golden.npz`` run through the port.

The helpers here serve ``tests/test_torch_roomgrid.py`` too.
"""

import os

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
from envpool_tpu.envs.minigrid import core as jax_mg
from envpool_tpu.envs.minigrid import wfc as jax_wfc
from envpool_tpu_torch import interop
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.core.registry import registry as torch_registry
from envpool_tpu_torch.envs.minigrid import core as mg
from envpool_tpu_torch.envs.minigrid import wfc as port_wfc
from test_torch_classic import host, to_jax
from test_torch_toy_text import assert_trees_equal, assert_uniform

MINIGRID = [t for t, (path, _, _) in jax_registry.specs.items() if path.endswith(".minigrid")]
N = 8

# -- recording JAX's draws -----------------------------------------------------

_REC: list = []  # (kind, value) of each draw while recording
_ON = [False]


def _record(kind, value):
    if _ON[0]:
        _REC.append((kind, value))
    return value


def record_draws(monkeypatch):
    """Replace JAX's random functions by recording wrappers (the same
    values) and ``jax.lax.scan`` by one that records its body's draws."""
    r = jax.random
    orig = {k: getattr(r, k) for k in ("randint", "permutation", "bernoulli", "choice")}
    scan = jax.lax.scan

    def categorical(key, logits, axis=-1, shape=None, replace=True, mode=None):
        assert axis == -1 and shape is None and replace
        logits = jnp.asarray(logits)
        noise = r.gumbel(key, logits.shape, logits.dtype, mode=mode)
        _record("cells", noise)
        return jnp.argmax(noise + logits, axis=-1)

    def wrap(kind):
        return lambda *a, **k: _record(kind, orig[kind](*a, **k))

    def recording_scan(f, init, xs=None, length=None, **kw):
        if not _ON[0]:
            return scan(f, init, xs, length, **kw)
        kinds = []

        def body(c, x):
            mark = len(_REC)
            c, y = f(c, x)
            new = _REC[mark:]
            del _REC[mark:]
            kinds[:] = [k for k, _ in new]
            return c, (y, [v for _, v in new])

        c, (ys, vals) = scan(body, init, xs, length, **kw)
        _REC.extend(zip(kinds, vals))
        return c, ys

    monkeypatch.setattr(r, "categorical", categorical)
    for k in orig:
        monkeypatch.setattr(r, k, wrap(k))
    monkeypatch.setattr(jax.lax, "scan", recording_scan)


class Replay:
    """The draw interface of ``envpool_tpu_torch.envs.minigrid.core.Draws``
    over recorded JAX draws: each call takes the next record, which must be
    of its kind and shape (several records of a draw's trailing shape are
    stacked, as a JAX env that draws per ball)."""

    def __init__(self, records, n):
        self.recs = list(records)
        self.out = {"rows": torch.zeros((n, 0), dtype=torch.int8)}

    def _take(self, kind, shape):
        k, v = self.recs.pop(0)
        assert k == kind, (k, kind)
        v = torch.as_tensor(np.array(v))
        if tuple(v.shape[1:]) != tuple(shape):
            assert tuple(v.shape[1:]) == tuple(shape[1:]), (kind, v.shape, shape)
            v = torch.stack([v] + [self._take(kind, shape[1:]) for _ in range(shape[0] - 1)], 1)
        return v

    def _put(self, name, v):
        self.out[name] = v
        return v

    def randint(self, name, lo, hi, shape=(), share=None):
        v = self._take("randint", shape)
        assert v.dtype == torch.int32
        return self._put(name, v)

    def cells(self, name, k):
        return self._put(name, self._take("cells", (k,)))

    def perm(self, name, n):
        return self._put(name, self._take("permutation", (n,)).to(torch.int32))

    def bernoulli(self, name):
        return self._put(name, self._take("bernoulli", ()))

    def choice(self, name, options):
        return self._put(name, self._take("choice", ()).to(torch.int8))

    def done(self):
        assert not self.recs, f"{len(self.recs)} JAX draws left over"
        return self.out


class MinigridPair:
    """A JAX engine and a port engine over one id; the JAX engine's step is
    jitted with the recording wrappers (one compile), the port gets its
    draws through :class:`Replay`."""

    def __init__(self, task, monkeypatch, n=N, **cfg):
        record_draws(monkeypatch)
        self.n = n
        self.jenv = envpool_tpu.make_spec(task, num_envs=n, seed=5, **cfg).env
        self.jeng = JaxEngine(self.jenv)
        self.tenv = envpool_tpu_torch.make_spec(task, num_envs=n, seed=5, device="cpu",
                                                **cfg).env
        self.teng = Engine(self.tenv)
        layout = {}
        step_env = self.jenv.step_env

        def marked_step_env(*a):
            layout["step"] = len(_REC)
            return step_env(*a)

        self.jenv.step_env = marked_step_env

        def one(*args):
            _REC.clear()
            _ON[0] = True
            try:
                out = self.jeng._step_one(*args)
            finally:
                _ON[0] = False
            layout["kinds"] = [k for k, _ in _REC]
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
        self.layout = layout

    def records(self, vals):
        """``(reset records, step records)`` of one step's draws."""
        recs = list(zip(self.layout["kinds"], jax.device_get(vals)))
        return recs[: self.layout["step"]], recs[self.layout["step"]:]

    def port_draws(self, vals):
        reset, step = self.records(vals)
        r, s = Replay(reset, self.n), Replay(step, self.n)
        self.tenv.plan_reset(r)
        self.tenv.plan_step(s)
        return r.done(), s.done()

    def step(self, tree, action):
        """One step of both engines from the host pool state ``tree``."""
        jps, jts, vals = self._step(to_jax(tree), {"action": jnp.asarray(action)})
        reset, step = self.port_draws(vals)
        self.tenv.reset_draws = lambda sub: reset
        self.tenv.step_draws = lambda sub: step
        tps, tts = self.teng.step(interop.pool_state_from_numpy(tree, "cpu"),
                                  {"action": torch.as_tensor(action)})
        return host(jps), jax.device_get(jts), interop.pool_state_to_numpy(tps), tts


def run_pair(pair, steps, seed):
    """``steps`` steps of both engines from the JAX pool's initial state
    (every env pending its first reset), random actions over the whole
    action space; the state and timestep equal after every step.  Returns
    the JAX timesteps."""
    hi = int(pair.tenv.action_spec()["action"].maximum) + 1
    acts = np.random.default_rng(seed).integers(0, hi, (steps, pair.n)).astype(np.int32)
    tree = host(pair.jeng.init())
    seen = []
    for t in range(steps):
        tree, jts, ttree, tts = pair.step(tree, acts[t])
        for k in ("elapsed", "autoreset", "full_reset", "env_state"):
            assert_trees_equal(tree[k], ttree[k], f"step {t} {k}")
        assert_trees_equal(dict(jts), tts, f"step {t}")
        seen.append(jts)
    return seen


def check_rollout(task, monkeypatch, steps=16, episode=6, seed=0, **cfg):
    """An 8-env rollout of ``task`` with episodes cut at ``episode`` steps:
    equal in every field, across auto-reset."""
    pair = MinigridPair(task, monkeypatch, max_episode_steps=episode, **cfg)
    seen = run_pair(pair, steps, seed)
    first = np.stack([ts["step_type"] == 0 for ts in seen])
    assert first[0].all() and first[1:].any(), "no auto-reset"
    return pair, seen


# -- the rollouts ----------------------------------------------------------------

# One id of each generator and class of minigrid_env.py, babyai.py,
# tasks2.py and wfc.py.
ROLLOUTS = [
    "MiniGrid-Empty-Random-5x5-v0",
    "MiniGrid-DoorKey-5x5-v0",
    "MiniGrid-FourRooms-v0",
    "MiniGrid-LavaGapS5-v0",
    "MiniGrid-DistShift2-v0",
    "MiniGrid-LavaCrossingS9N2-v0",
    "BabyAI-GoToObjS4-v0",
    "BabyAI-GoToDoor-v0",
    "BabyAI-GoToRedBallGrey-v0",
    "BabyAI-GoToRedBlueBall-v0",
    "BabyAI-GoToLocalS6N3-v0",
    "MiniGrid-Dynamic-Obstacles-Random-6x6-v0",
    "MiniGrid-Fetch-5x5-N2-v0",
    "MiniGrid-GoToDoor-5x5-v0",
    "MiniGrid-GoToObject-6x6-N2-v0",
    "MiniGrid-RedBlueDoors-6x6-v0",
    "MiniGrid-Unlock-v0",
    "MiniGrid-UnlockPickup-v0",
    "MiniGrid-MemoryS13Random-v0",
    "MiniGrid-WFC-MazeSimple-v0",
]


@pytest.mark.parametrize("task", ROLLOUTS)
def test_rollout_matches_jax(task, monkeypatch):
    check_rollout(task, monkeypatch)


def test_recording_wrappers_give_jax_values(monkeypatch):
    """The wrappers compute JAX's own values: JAX's engine step with and
    without them from the same states is equal in every field."""
    task = "MiniGrid-FourRooms-v0"
    plain = JaxEngine(envpool_tpu.make_spec(task, num_envs=N, seed=5).env)
    pair = MinigridPair(task, monkeypatch)
    tree = host(plain.init())
    act = {"action": jnp.asarray(np.arange(N, dtype=np.int32) % 7)}
    for _ in range(3):
        got = pair._step(to_jax(tree), act)[:2]
        want = plain.step(to_jax(tree), act)  # (the engine's step donates its input)
        tree = host(want[0])
        assert_trees_equal(tree, host(got[0]))
        assert_trees_equal(dict(jax.device_get(want[1])), dict(jax.device_get(got[1])))


# -- units -----------------------------------------------------------------------


def _random_grids(rng_, b, h, w):
    """``b`` random ``[h, w, 3]`` grids: walls, doors in all three states,
    keys, balls, boxes, goals, lava, empty cells, a walled border."""
    objs = np.array([mg.EMPTY, mg.EMPTY, mg.WALL, mg.DOOR, mg.KEY, mg.BALL, mg.BOX,
                     mg.GOAL, mg.LAVA, mg.FLOOR])
    grid = np.zeros((b, h, w, 3), np.int8)
    grid[..., 0] = rng_.choice(objs, (b, h, w))
    grid[..., 1] = rng_.integers(0, 6, (b, h, w))
    grid[..., 2] = np.where(grid[..., 0] == mg.DOOR, rng_.integers(0, 3, (b, h, w)), 0)
    border = np.zeros((h, w), bool)
    border[[0, -1], :] = border[:, [0, -1]] = True
    grid[:, border] = (mg.WALL, mg.GREY, 0)
    return grid


def test_egocentric_view_matches_jax():
    """The shadow table against JAX's unrolled sweeps: random grids of
    every object and door state, agents anywhere (on the border too), all
    four directions, hands empty or full."""
    rng_ = np.random.default_rng(3)
    for h, w in ((9, 9), (5, 13)):
        b = 1024
        grid = _random_grids(rng_, b, h, w)
        pos = np.stack([rng_.integers(0, w, b), rng_.integers(0, h, b)], 1).astype(np.int32)
        d = rng_.integers(0, 4, b).astype(np.int32)
        carrying = np.stack([rng_.choice([mg.EMPTY, mg.KEY, mg.BALL, mg.BOX], b),
                             rng_.integers(0, 6, b)], 1).astype(np.int8)
        want = jax.jit(jax.vmap(jax_mg.egocentric_view))(grid, pos, d, carrying)
        got = mg.egocentric_view(*(torch.as_tensor(x) for x in (grid, pos, d, carrying)))
        assert_trees_equal(np.asarray(want), got, f"{h}x{w}")
        assert 0.05 < (np.asarray(want) == 0).all(-1).mean() < 0.95  # shadows were cast


def test_step_agent_matches_jax():
    """Every action from random states: pickup, drop, door and box
    toggles on the front cell."""
    rng_ = np.random.default_rng(4)
    b, h, w = 4096, 7, 7
    grid = _random_grids(rng_, b, h, w)
    boxes = grid[..., 0] == mg.BOX
    grid[..., 2] = np.where(boxes, rng_.integers(0, 47, (b, h, w)), grid[..., 2])
    pos = np.stack([rng_.integers(1, w - 1, b), rng_.integers(1, h - 1, b)], 1).astype(np.int32)
    d = rng_.integers(0, 4, b).astype(np.int32)
    carrying = np.stack([rng_.choice([mg.EMPTY, mg.KEY], b), rng_.integers(0, 6, b)],
                        1).astype(np.int8)
    action = rng_.integers(0, 7, b).astype(np.int32)
    want = jax.jit(jax.vmap(jax_mg.step_agent))(grid, pos, d, carrying, action)
    got = mg.step_agent(*(torch.as_tensor(x) for x in (grid, pos, d, carrying, action)))
    for i, (a, g) in enumerate(zip(want, got)):
        assert_trees_equal(np.asarray(a), g, f"output {i}")
    assert (np.asarray(want[0]) != grid).any(axis=(1, 2, 3)).mean() > 0.05


def _reward_states(env, t):
    """JAX ``MiniGridEnv`` states one step from the goal at step ``t``."""
    w, h = env._wh
    b = len(t)
    grid = np.broadcast_to(np.asarray(jax_mg.empty_grid(w, h)), (b, h, w, 3)).copy()
    grid[:, h - 2, w - 2] = (mg.GOAL, mg.GREEN, 0)
    return {
        "grid": grid,
        "pos": np.tile(np.array([[w - 3, h - 2]], np.int32), (b, 1)),
        "dir": np.zeros(b, np.int32),
        "carrying": np.tile(np.array([[mg.EMPTY, 0]], np.int8), (b, 1)),
        "t": np.asarray(t, np.int32),
    }


@pytest.mark.parametrize("task", ["MiniGrid-FourRooms-v0", "MiniGrid-Empty-8x8-v0",
                                  "MiniGrid-DistShift1-v0"])
def test_goal_reward_bit_for_bit(task):
    """``1 - 0.9 * t / max_steps`` for every ``t`` of an episode (max
    steps 100, 256 and 324), as JAX's compiled step rounds it."""
    jenv = envpool_tpu.make_spec(task, num_envs=1).env
    tenv = envpool_tpu_torch.make_spec(task, num_envs=1, device="cpu").env
    m = tenv.max_episode_steps
    st = _reward_states(jenv, np.arange(m))
    act = np.full(m, mg.FORWARD, np.int32)

    def step(s, a, k):
        out = jenv.step_env(s, a, k)
        return out.reward, out.terminated

    reward, done = jax.jit(jax.vmap(step))(st, act, jax.random.split(jax.random.PRNGKey(0), m))
    got = tenv.step_env({k: torch.as_tensor(v) for k, v in st.items()}, torch.as_tensor(act),
                        {"rows": torch.zeros((m, 0))})
    assert np.asarray(done).all()
    assert_trees_equal(np.asarray(reward), got.reward, task)
    plain = (1.0 - 0.9 * np.arange(1, m + 1, dtype=np.float32) / np.float32(m))
    assert (plain != got.reward.numpy()).any()  # the rounding is not the plain division's


@pytest.mark.parametrize("preset", sorted(port_wfc._PRESETS))
def test_wfc_bank_bit_for_bit(preset):
    want = jax_wfc._map_bank(preset, 25, 32)
    got = port_wfc._map_bank(preset, 25, 32)
    assert got.dtype == want.dtype and got.shape == (32, 25, 25)
    np.testing.assert_array_equal(got, want)


def test_render_state_matches_jax():
    rng_ = np.random.default_rng(5)
    task = "MiniGrid-FourRooms-v0"
    jenv = envpool_tpu.make_spec(task, num_envs=1).env
    tenv = envpool_tpu_torch.make_spec(task, num_envs=1, device="cpu").env
    b, (w, h) = 16, tenv._wh
    st = {"grid": _random_grids(rng_, b, h, w),
          "pos": np.stack([rng_.integers(0, w, b), rng_.integers(0, h, b)], 1).astype(np.int32)}
    want = jax.jit(jax.vmap(jenv.render_state))(st)
    got = tenv.render_state({k: torch.as_tensor(v) for k, v in st.items()})
    assert got.shape == (b, *tenv.render_size, 3) and tenv.render_size == jenv.render_size
    assert_trees_equal(np.asarray(want), got)


def test_render_through_the_pool():
    pool = envpool_tpu_torch.make("MiniGrid-DoorKey-8x8-v0", env_type="gymnasium", num_envs=3,
                                  device="cpu")
    pool.reset()
    frames = pool.render(np.array([0, 2]))
    assert frames.shape == (2, 64, 64, 3) and frames.dtype == np.uint8
    pos = pool.pool_state.env_state["pos"][0]
    assert (frames[0, pos[1] * 8, pos[0] * 8] == (255, 0, 0)).all()


# -- goldens, ids, the port's own draws --------------------------------------------

_GOLDEN = os.path.join(os.path.dirname(__file__), "oracle_fixtures", "minigrid_golden.npz")


def test_golden_trajectories_through_the_port():
    """The committed golden episodes (9 ids): from JAX's
    ``reset_env(PRNGKey(seed))`` state, carried over, the port's steps
    give the golden images and rewards (as JAX's own lockstep test)."""
    data = np.load(_GOLDEN)
    episodes = {}
    for k in data.files:
        env_id, seed, field = k.rsplit("|", 2)
        episodes.setdefault((env_id, int(seed)), {})[field] = data[k]
    assert len({e for e, _ in episodes}) == 9
    for (env_id, seed), ep in episodes.items():
        jenv = jax_registry._env(env_id, num_envs=1)
        st, obs = jenv.reset_env(jax.random.PRNGKey(seed))
        np.testing.assert_array_equal(np.asarray(obs["obs:image"]), ep["images"][0])
        tenv = torch_registry._env(env_id, num_envs=1, device="cpu")
        st = {k: torch.as_tensor(np.array(v))[None] for k, v in st.items()}
        for t, a in enumerate(ep["actions"]):
            out = tenv.step_env(st, torch.tensor([a], dtype=torch.int32),
                                tenv.step_draws(rng.split(tenv.keys())[1]))
            st = out.state
            np.testing.assert_array_equal(out.obs["obs:image"][0].numpy(), ep["images"][t + 1],
                                          err_msg=f"{env_id}|{seed} step {t}")
            np.testing.assert_allclose(float(out.reward[0]), ep["rewards"][t], atol=1e-6)


def test_every_minigrid_id_is_ported():
    ids = [t for t, (path, _, _) in torch_registry.specs.items() if path.endswith(".minigrid")]
    assert ids == MINIGRID and len(ids) == 177
    for task in MINIGRID:
        _, jcls, jkw = jax_registry.specs[task]
        _, tcls, tkw = torch_registry.specs[task]
        assert (jcls, jkw) == (tcls, tkw), task


@pytest.mark.parametrize("part", range(4))
def test_config_and_spec_match_jax(part):
    for task in MINIGRID[part::4]:
        jenv = envpool_tpu.make_spec(task, num_envs=2).env
        tenv = envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu").env
        assert dict(tenv.config, device="cuda") == dict(jenv.config, device="cuda"), task
        assert repr(tenv.state_spec()) == repr(jenv.state_spec()), task
        assert repr(tenv.action_spec()) == repr(jenv.action_spec()), task
        assert tenv.max_episode_steps == jenv.max_episode_steps


def _port_reset(task, n, **cfg):
    env = envpool_tpu_torch.make_spec(task, num_envs=n, seed=11, device="cpu", **cfg).env
    draws = env.reset_draws(rng.split(env.keys())[1])
    return env, draws, env.reset_env(draws)


def test_port_draws_range_and_free_cells():
    """The port's own draws: a random start uniform over the free cells, a
    uniform direction, permutations that are permutations, door offsets
    in range, and objects only on cells that were free (none overwrites
    another, the agent's cell stays empty)."""
    env, draws, (st, _) = _port_reset("MiniGrid-Empty-Random-6x6-v0", 6000)
    flat = (st["pos"][:, 1] * 6 + st["pos"][:, 0]).numpy()
    free = [y * 6 + x for y in range(1, 5) for x in range(1, 5) if (x, y) != (4, 4)]
    cells = np.searchsorted(free, flat)
    assert set(flat) == set(free)
    assert_uniform(cells, 0, len(free) - 1, "agent cell")
    assert_uniform(st["dir"].numpy(), 0, 3, "dir")
    _, draws, (st, _) = _port_reset("MiniGrid-GoToDoor-8x8-v0", 4000)
    assert (torch.sort(draws["door_colors"], 1).values == torch.arange(6)).all()
    aw = draws["aw"]
    assert_uniform(aw.numpy(), 5, 8, "aw")
    assert ((draws["top_x"] >= 2) & (draws["top_x"] < aw - 2)).all()
    _, _, (st, _) = _port_reset("MiniGrid-Fetch-8x8-N3-v0", 2000)
    objs = ((st["grid"][..., 0] == mg.KEY) | (st["grid"][..., 0] == mg.BALL)).sum((1, 2))
    assert (objs == 3).all()
    g = st["grid"]
    assert (g[torch.arange(2000), st["pos"][:, 1], st["pos"][:, 0], 0] == mg.EMPTY).all()
    _, draws, _ = _port_reset("MiniGrid-MemoryS13Random-v0", 4000)
    assert_uniform(draws["hallway_end"].numpy(), 4, 10, "hallway end")
    assert 0.45 < draws["start_is_key"].float().mean() < 0.55
