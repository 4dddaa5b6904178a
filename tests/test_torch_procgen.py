"""The port's procgen family against the JAX package.

Both engines step from one JAX pool state, carried into the port by
``envpool_tpu_torch.interop``, and the port is handed the draws the JAX
envs make from their threefry keys, in the port's draw layout: the reset
branch's level seed, the level's draws from ``PRNGKey(level_seed)`` and
the step branch's spawn draws.  Every game runs a rollout of 8 envs that
crosses auto-reset.  The grid games (maze, heist, chaser, miner: integer
state, exact renders) must equal JAX's in every field; the scroller and
platformer games (float positions) are held by the rule of
``envpool_tpu_torch/ops/thresholds.py``: fields within 1e-5 * (1 + |x|),
an env whose step lies within that of a threshold excused (at most 1% of
the env steps), frames equal but at pixels float rounding decides (at
most 1e-3 of the pixels).  The maze bank equals JAX's bit for bit; the
port's own draws are checked by range and distribution.
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
from envpool_tpu.envs.procgen import core as jax_core
from envpool_tpu_torch import interop
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.envs.procgen import core as port_core
from envpool_tpu_torch.envs.procgen.env import GAMES
from envpool_tpu_torch.ops import thresholds
from test_torch_classic import host, to_jax
from test_torch_toy_text import assert_trees_equal, assert_uniform

PROCGEN = [t for t, (path, _, _) in jax_registry.specs.items() if path.endswith(".procgen")]
GRID = ("maze", "heist", "chaser", "miner")
N = 8


def _u(key, shape=(), lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, jnp.float32, lo, hi)


def _terrain(key):
    k1, k2, k3 = jax.random.split(key, 3)
    return {"steps": jax.random.randint(k1, (16,), -1, 2), "gaps": _u(k2, (16,)),
            "hazards": _u(k3, (16,))}


def _maze(key):
    return jax.random.randint(jax.random.split(key)[0], (), 0, jax_core._BANK_SIZE)


def _heist(game, key):
    g = game.init(key)
    spots = jnp.concatenate([g["keys"], g["vault"][None]])
    return {"maze": _maze(key), "spots": spots[:, 0] * game.n + spots[:, 1]}


def _edge(key, lo, hi):
    k1, k2 = jax.random.split(key)
    ky, kv, ks = jax.random.split(k2, 3)
    return {"spawn": _u(k1), "y": _u(ky, (), 4.0, 60.0), "vx": -_u(kv, (), lo, hi),
            "size": _u(ks, (), 1.0, 4.0)}


# JAX's level draws of each game from the level key, in the port's layout.
_LEVEL = {
    "maze": lambda game, key: {"maze": _maze(key)},
    "heist": _heist,
    "chaser": lambda game, key: {
        "maze": _maze(key),
        "enemies": jax.random.randint(jax.random.split(key)[1], (3, 2), game.n // 2, game.n - 2)},
    "miner": lambda game, key: dict(zip(("u", "v"), (
        _u(k, (game.n, game.n)) for k in jax.random.split(key, 3)[:2]))),
    "dodgeball": lambda game, key: {"ents": game.init(key)["ents"][:, :4]},
    "caveflyer": lambda game, key: {"ents": game.init(key)["ents"]},
    "coinrun": lambda game, key: _terrain(key),
    "ninja": lambda game, key: _terrain(key),
    "jumper": lambda game, key: {
        **_terrain(jax.random.split(key)[0]),
        "goal_col": jax.random.randint(jax.random.split(key)[1], (), 8, 16)},
    "climber": lambda game, key: {
        "plat_cols": jax.random.randint(jax.random.split(key)[0], (8,), 0, 13),
        "stars": _u(jax.random.split(key)[1], (8,))},
    "leaper": lambda game, key: {"cars": _u(jax.random.split(key)[0], (6,), 0.0, 16.0)},
}


def _split(key, n):
    return jax.random.split(key, n)


# JAX's step draws of each game from the step's subkey, in the port's layout.
_STEP = {
    "chaser": lambda key: {"u": jnp.stack([_u(k) for k in _split(key, 3)])},
    "bigfish": lambda key: _edge(key, 0.3, 0.9),
    "starpilot": lambda key: _edge(key, 0.6, 1.4),
    "fruitbot": lambda key: {"spawn": _u(_split(key, 4)[0]),
                             "x": _u(_split(key, 4)[1], (), 4.0, 60.0),
                             "kind": _u(_split(key, 4)[2])},
    "bossfight": lambda key: {"boss_dx": _u(_split(key, 3)[0], (), -1.0, 1.0),
                              "spawn": _u(_split(key, 3)[1])},
    "plunder": lambda key: {"spawn": _u(_split(key, 3)[0]),
                            "lane": _u(_split(key, 3)[1], (), 24.0, 58.0),
                            "kind": _u(_split(key, 3)[2])},
}


def _torch(tree):
    return {k: torch.as_tensor(np.array(v)) for k, v in jax.device_get(tree).items()}


class ProcgenPair:
    """A JAX engine and a port engine over one procgen id, the port with
    JAX's draws (one jitted JAX program for all of a step's draws)."""

    def __init__(self, task, n=N, **cfg):
        jenv = envpool_tpu.make_spec(task, num_envs=n, seed=5, **cfg).env
        self.jeng = JaxEngine(jenv)
        self.tenv = envpool_tpu_torch.make_spec(task, num_envs=n, seed=5, device="cpu",
                                                **cfg).env
        self.teng = Engine(self.tenv)
        name = jenv.config["env_name"]
        level = _LEVEL.get(name, lambda game, key: {})
        step = _STEP.get(name, lambda key: {})

        def one(key):
            sub = jax.random.split(key)[1]
            lvl = jenv._level_key(sub)[1]
            lk = jax.random.PRNGKey(lvl.astype(jnp.uint32))
            return {"lvl": lvl}, level(jenv.game, lk), step(sub)

        self.draws = jax.jit(jax.vmap(one))

    def step(self, tree, action):
        """One step of both engines from the host pool state ``tree``."""
        reset, level, step = (_torch(d) for d in self.draws(jnp.asarray(tree["key"])))

        def level_draws(lvl):
            assert torch.equal(lvl, reset["lvl"])
            return level

        self.tenv.reset_draws = lambda sub: reset
        self.tenv.level_draws = level_draws
        self.tenv.step_draws = lambda sub: step
        jps, jts = self.jeng.step(to_jax(tree), {"action": jnp.asarray(action)})
        tps, tts = self.teng.step(interop.pool_state_from_numpy(tree, "cpu"),
                                  {"action": torch.as_tensor(action)})
        return host(jps), jax.device_get(jts), interop.pool_state_to_numpy(tps), tts, step


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.as_tensor(np.array(tree))


def assert_same_layout(want, got, where=""):
    """The same keys, and leaves of the same dtypes and shapes."""
    if isinstance(want, dict):
        assert set(want) == set(got), where
        for k in want:
            assert_same_layout(want[k], got[k], f"{where}/{k}")
        return
    assert (want.dtype, want.shape) == (got.dtype, got.shape), where


def run_pair(pair, steps, seed, exact, hold=None):
    """``steps`` steps of both engines from the JAX pool's first reset,
    random actions (every env taking action ``hold`` where given).
    ``exact``: every field equal; else the rule of ``ops/thresholds.py``.
    Returns the JAX timesteps and the rule's totals."""
    acts = np.random.default_rng(seed).integers(0, 15, (steps + 1, N)).astype(np.int32)
    if hold is not None:
        acts[:] = hold
    tree = host(pair.jeng.step(pair.jeng.init(), {"action": jnp.asarray(acts[0])})[0])
    seen, totals = [], {}
    for t in range(1, steps + 1):
        before = tree
        tree, jts, ttree, tts, draws = pair.step(tree, acts[t])
        for k in ("elapsed", "autoreset", "full_reset"):
            assert_trees_equal(tree[k], ttree[k], f"step {t} {k}")
        if exact:
            assert_trees_equal(tree["env_state"], ttree["env_state"], f"step {t} state")
            assert_trees_equal(dict(jts), tts, f"step {t}")
        else:
            want = {"state": _tensors(tree["env_state"]), "ts": _tensors(dict(jts))}
            got = {"state": _tensors(ttree["env_state"]), "ts": dict(tts)}
            assert_same_layout(want, got, f"step {t}")
            v = thresholds.hold_step(
                pair.tenv, _tensors(before["env_state"]), torch.as_tensor(acts[t]), draws,
                torch.as_tensor(before["autoreset"]), want, got)
            assert v["failed"] == 0 and v["violations"] == 0, (t, v)
            for k, x in v.items():
                totals[k] = totals.get(k, 0) + x
        seen.append(jts)
    return seen, totals


def test_every_procgen_id_is_ported():
    ids = [t for t, (path, _, _) in envpool_tpu_torch.core.registry.registry.specs.items()
           if path.endswith(".procgen")]
    assert ids == PROCGEN and len(ids) == 50


def test_config_and_spec_match_jax():
    for task in PROCGEN:
        jspec = envpool_tpu.make_spec(task, num_envs=2)
        tspec = envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu")
        assert dict(tspec.env.config, device="cuda") == dict(jspec.env.config, device="cuda")
        assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec), task
        assert repr(tspec.state_array_spec) == repr(jspec.state_array_spec), task
        jgame, tgame = jspec.env.game, tspec.env.game
        assert type(jgame).__name__ == type(tgame).__name__
        assert getattr(jgame, "n", None) == getattr(tgame, "n", None), task


# (size, extra_open) of every maze bank a registered id uses.
_BANKS = sorted({(11, 0.1), (15, 0.0), (19, 0.0), (23, 0.0)}
                | {(n, 0.15) for n in (11, 15, 19, 23)} | {(n, 0.35) for n in (11, 15, 19)})


@pytest.mark.parametrize("size, extra_open", _BANKS)
def test_maze_bank_bit_for_bit(size, extra_open):
    want = np.asarray(jax_core.maze_bank(size, extra_open))
    got = port_core.maze_bank(size, extra_open)
    assert got.dtype == want.dtype and got.shape == (port_core.BANK_SIZE, size, size)
    np.testing.assert_array_equal(got, want)


def test_every_bank_of_the_registered_ids_is_covered():
    used = set()
    for task in PROCGEN:
        game = envpool_tpu_torch.make_spec(task, device="cpu").env.game
        if getattr(game, "extra_open", None) is not None:
            used.add((game.n, game.extra_open))
    assert used == set(_BANKS)


@pytest.mark.parametrize("game", sorted(GAMES))
def test_rollout_matches_jax(game):
    """8 envs, 24 steps, episodes cut at 8 steps: grid games equal in
    every field, the others by the rule."""
    task = f"{game.capitalize()}Easy-v0"
    pair = ProcgenPair(task, max_episode_steps=8)
    seen, totals = run_pair(pair, 24, seed=len(game), exact=game in GRID)
    first = np.stack([ts["step_type"] == 0 for ts in seen])
    assert first[1:].any(), "no auto-reset"
    if totals:
        assert totals["excused"] <= thresholds.MAX_EXCUSED_SHARE * totals["envs"], totals
        assert totals["differ"] <= thresholds.MAX_PIXEL_SHARE * totals["pixels"], totals


def test_terminations_match_jax():
    """Rollouts long enough to end episodes by the games' own rules (a
    fish met swimming right, a fall or the coin running right, a car or
    the far bank hopping up, a chaser caught): reward and termination
    agree."""
    for task, hold in (("BigfishHard-v0", 7), ("CoinrunHard-v0", 7), ("LeaperEasy-v0", 5),
                       ("ChaserEasy-v0", None)):
        pair = ProcgenPair(task, max_episode_steps=40)
        seen, _ = run_pair(pair, 40, seed=4, exact=task.startswith("Chaser"), hold=hold)
        done = np.stack([ts["done"] & ~ts["trunc"] for ts in seen])
        assert done.any(), f"{task}: no termination"


def _reset(task, n, **cfg):
    env = envpool_tpu_torch.make_spec(task, num_envs=n, seed=11, device="cpu", **cfg).env
    _, sub = rng.split(env.keys())
    return env, env.reset_env(env.reset_draws(sub))


@pytest.mark.parametrize("task", ["MazeHard-v0", "HeistEasy-v0", "MinerEasy-v0",
                                  "DodgeballEasy-v0", "ClimberEasy-v0", "JumperEasy-v0"])
def test_same_level_seed_same_start(task):
    """With one level (``num_levels=1``) every env starts alike; with many,
    envs of equal level seeds alike and the starts vary."""
    env, (state, obs) = _reset(task, 6, num_levels=1, start_level=7)
    assert (state["lvl"] == 7).all()
    for leaf in jax.tree_util.tree_leaves(state["g"]) + [obs["obs"]]:
        assert (leaf == leaf[:1]).all(), task
    env, (state, obs) = _reset(task, 400, num_levels=3)
    lvl = state["lvl"]
    for s in range(3):
        idx = (lvl == s).nonzero()[:, 0]
        assert len(idx) > 1 and (obs["obs"][idx] == obs["obs"][idx[:1]]).all(), task
    assert not (obs["obs"] == obs["obs"][:1]).all()


def test_level_window_config():
    """As JAX's ``test_level_window_config``: level seeds in ``[start,
    start + num_levels)``, each of them drawn; without a window, in
    ``[0, 2**31 - 1)``."""
    _, (state, _) = _reset("MazeEasy-v0", 4000, num_levels=5, start_level=100)
    assert_uniform(state["lvl"].numpy(), 100, 104, "lvl")
    _, (state, obs) = _reset("MazeEasy-v0", 4000)
    lvl = state["lvl"].numpy().astype(np.int64)
    assert lvl.min() >= 0 and lvl.max() < 2**31 - 1 and len(set(lvl)) > 3990
    assert (obs["info:level_seed"] == state["lvl"]).all()


def test_port_level_draws_range_and_distribution():
    """The port's own level draws: heist's keys and vault on distinct open
    cells off the agent's, the maze layouts uniform over the bank, the
    chaser's enemies and the terrain steps in range."""
    env, (state, _) = _reset("HeistEasy-v0", 2000)
    g = state["g"]
    spots = torch.cat([g["keys"], g["vault"][:, None]], 1).long()
    n = env.game.n
    flat = spots[..., 0] * n + spots[..., 1]
    assert not g["walls"].reshape(-1, n * n).gather(1, flat).any()
    assert (flat != n + 1).all()
    assert all(len(set(row.tolist())) == 4 for row in flat)
    maze = env.game.init_draws(rng.split(env.keys())[1])["maze"].numpy()
    counts = np.bincount(maze, minlength=port_core.BANK_SIZE)
    assert counts.max() < 20 and (counts > 0).mean() > 0.95
    env, (state, _) = _reset("ChaserHard-v0", 2000)
    e = state["g"]["enemies"].numpy()
    assert_uniform(e, 7, 12, "enemies")
    d = envpool_tpu_torch.make_spec("CoinrunEasy-v0", num_envs=3000, device="cpu").env
    steps = d.game.init_draws(rng.split(d.keys())[1])["steps"].numpy()
    assert_uniform(steps, -1, 1, "terrain steps")


def test_port_step_draws_range():
    env = envpool_tpu_torch.make_spec("BigfishEasy-v0", num_envs=20000, device="cpu").env
    d = env.step_draws(rng.split(env.keys())[1])
    for k, lo, hi in (("spawn", 0, 1), ("y", 4, 60), ("vx", -0.9, -0.3), ("size", 1, 4)):
        x = d[k].numpy()
        assert x.dtype == np.float32 and lo <= x.min() and x.max() <= hi, k
        assert x.max() - x.min() > 0.95 * (hi - lo), k
    assert abs(np.corrcoef(d["y"], d["size"])[0, 1]) < 0.05


def test_procgen_pools_on_the_cpu():
    """``make_gymnasium`` and ``make_dm`` of one id of each engine."""
    for task in ("MazeEasy-v0", "StarpilotEasy-v0", "NinjaEasy-v0"):
        gym = envpool_tpu_torch.make_gymnasium(task, num_envs=3, device="cpu")
        obs, info = gym.reset()
        obs, rew, term, trunc, info = gym.step(np.arange(3, dtype=np.int32))
        assert obs.shape == (3, 64, 64, 3) and obs.dtype == np.uint8
        assert set(info) >= {"level_seed", "prev_level_complete"}
        ts = envpool_tpu_torch.make_dm(task, num_envs=3, device="cpu").reset()
        assert ts.observation.obs.shape == (3, 64, 64, 3)


def test_rule_excuses_only_what_a_threshold_decides():
    """``ops/thresholds.py``: a bigfish touching a fish exactly at the
    touch distance is near a threshold, one a fish's width away is not; a
    disc centred on a half pixel has pixels that rounding decides, one
    centred a fifth of a pixel off has none; a changed state field or a
    changed pixel away from any threshold fails the step."""
    env = envpool_tpu_torch.make_spec("BigfishEasy-v0", num_envs=2, device="cpu").env
    _, sub = rng.split(env.keys())
    state, _ = env.reset_env(env.reset_draws(sub))
    g = state["g"]
    g["ents"][:, 0] = torch.tensor([[16.0 + 1.5 + 1.0, 32.0, 0.0, 0.0, 1.0]] * 2)
    g["ents"][1, 0, 0] += 2.0  # a fish's width further
    g["alive"][:, 0] = True
    act = torch.full((2,), 4, dtype=torch.int32)  # stand still
    draws = {k: v[:2] for k, v in env.step_draws(sub).items()}
    draws["spawn"] = torch.ones(2)  # no spawn

    def step(s):
        out = env.step_env(s, act, draws)
        return {"state": out.state, "reward": out.reward, "terminated": out.terminated}

    near = thresholds.near_threshold(step, state)
    assert near.tolist() == [True, False]
    for x, marked in ((20.5, True), (20.2, False)):
        g["p"][:] = torch.tensor([x, 32.0])
        g["alive"][:] = False
        edge, trunc = thresholds.threshold_pixels(env.frame_float, state)
        assert bool(edge.any()) == marked and not trunc.any()
    # A real difference fails: a state field, a pixel.
    g["alive"][:] = False
    out = env.step_env(state, act, draws)
    ts = {"obs": out.obs["obs"], "reward": out.reward}
    want = {"state": out.state, "ts": ts}
    bad_state = {"state": {**out.state, "complete": out.state["complete"] + 1}, "ts": ts}
    v = thresholds.hold_step(env, state, act, draws, torch.zeros(2, dtype=torch.bool), want,
                             bad_state)
    assert v["failed"] == 2
    obs = ts["obs"].clone()
    obs[0, 0, 0, 0] += 1
    v = thresholds.hold_step(env, state, act, draws, torch.zeros(2, dtype=torch.bool), want,
                             {"state": out.state, "ts": {**ts, "obs": obs}})
    assert v["failed"] == 0 and v["violations"] == 1
