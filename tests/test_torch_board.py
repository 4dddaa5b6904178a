"""The port's board family (pgx) against the JAX package.

Both engines step from one JAX pool state, carried into the port by
``envpool_tpu_torch.interop``, and the port is handed the draws the JAX
games make: ``jax.random.categorical`` (as ``argmax(gumbel + logits)``,
checked against JAX's own step), ``randint``, ``permutation`` and
``uniform`` are replaced by wrappers that record their values, in the
order the game draws, from inside the jitted engine step; the port's game
declares the same draws in the same order (``plan_reset``,
``plan_step``), so :class:`Replay` hands them over by position.

Actions are drawn from the legal-move mask of the last timestep
(``info:legal_moves`` / ``info:legal_action_mask``), with a share of
uniform actions so that the illegal-move path runs too.  Every class runs
an 8-env rollout across auto-reset; the state and the timestep must equal
JAX's in every field.  Go's chain labels and liberties, Hex's
connection and the port's own draws are checked on their own.
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
from envpool_tpu.envs.board import go as jax_go
from envpool_tpu.envs.board import hex as jax_hex
from envpool_tpu_torch import interop
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.core.registry import registry as torch_registry
from envpool_tpu_torch.envs.board import go, hex as port_hex
from test_torch_toy_text import assert_trees_equal, assert_uniform

BOARD = [t for t, (path, _, _) in jax_registry.specs.items() if path.endswith(".board")]
N = 8

# -- recording JAX's draws -----------------------------------------------------

_REC: list = []  # (kind, value) of each draw while recording
_ON = [False]


def _record(kind, value):
    if _ON[0]:
        _REC.append((kind, value))
    return value


def record_draws(monkeypatch):
    """Replace JAX's random functions by recording wrappers that return
    the same values."""
    r = jax.random
    orig = {k: getattr(r, k) for k in ("randint", "permutation", "uniform")}

    def categorical(key, logits, axis=-1, shape=None, replace=True, mode=None):
        assert axis == -1 and shape is None and replace
        logits = jnp.asarray(logits)
        noise = r.gumbel(key, logits.shape, logits.dtype, mode=mode)
        _record("cells", noise)
        return jnp.argmax(noise + logits, axis=-1)

    def wrap(kind):
        return lambda *a, **k: _record(kind, orig[kind](*a, **k))

    monkeypatch.setattr(r, "categorical", categorical)
    for k in orig:
        monkeypatch.setattr(r, k, wrap(k))


class Replay:
    """The draw interface of ``envpool_tpu_torch.core.rng.Draws`` over
    recorded JAX draws: each call takes the next record, which must be of
    its kind and shape."""

    def __init__(self, records, n):
        self.recs = list(records)
        self.out = {"rows": torch.zeros((n, 0), dtype=torch.int8)}

    def _take(self, kind, shape):
        k, v = self.recs.pop(0)
        assert k == kind, (k, kind)
        v = torch.as_tensor(np.array(v))
        assert tuple(v.shape[1:]) == tuple(shape), (kind, v.shape, shape)
        self.out_last = v
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

    def uniform(self, name, shape=()):
        return self._put(name, self._take("uniform", shape))

    def done(self):
        assert not self.recs, f"{len(self.recs)} JAX draws left over"
        return self.out


def host(ps):
    return dataclasses.asdict(jax.device_get(ps))


def to_jax(tree):
    return JaxPoolState(**jax.tree_util.tree_map(jnp.asarray, tree))


class BoardPair:
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

    def port_draws(self, vals):
        recs = list(zip(self.layout["kinds"], jax.device_get(vals)))
        cut = self.layout["step"]
        r, s = Replay(recs[:cut], self.n), Replay(recs[cut:], self.n)
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
        return host(jps), jax.device_get(jts), interop.pool_state_to_numpy(tps, like=tree), tts


def legal_mask_of(ts):
    for k in ("info:legal_moves", "info:legal_action_mask"):
        if k in ts:
            return np.asarray(ts[k])
    return None


def sample_actions(gen, ts, hi, n, players, share=0.1):
    """Actions uniform over each env's legal moves in the timestep ``ts``
    (over ``[0, hi)`` where the game has no mask), a ``share`` of them
    uniform over the whole action space; ``[N, players]`` rows of the same
    action under the per-player protocol."""
    mask = legal_mask_of(ts) if ts is not None else None
    act = gen.integers(0, hi, n)
    if mask is not None:
        score = np.where(mask, gen.random(mask.shape), -1.0)
        legal = score.argmax(1)
        act = np.where(gen.random(n) < share, act, legal)
    act = act.astype(np.int32)
    return np.repeat(act[:, None], players, 1) if players > 1 else act


def run_pair(pair, steps, seed, share=0.1):
    """``steps`` steps of both engines from the JAX pool's initial state
    (every env pending its first reset), legal actions from the last
    timestep; the state and timestep equal after every step.  Returns the
    JAX timesteps."""
    hi = int(pair.tenv.action_spec()["action"].maximum) + 1
    players = pair.tenv.max_num_players
    gen = np.random.default_rng(seed)
    tree = host(pair.jeng.init())
    seen, ts = [], None
    for t in range(steps):
        act = sample_actions(gen, ts, hi, pair.n, players, share)
        tree, ts, ttree, tts = pair.step(tree, act)
        for k in ("elapsed", "autoreset", "full_reset", "env_state"):
            assert_trees_equal(tree[k], ttree[k], f"step {t} {k}")
        assert_trees_equal(dict(ts), tts, f"step {t}")
        seen.append(ts)
    return seen


def check_rollout(task, monkeypatch, steps=20, episode=8, seed=0, share=0.1, **cfg):
    """An 8-env rollout of ``task`` with episodes cut at ``episode`` steps:
    equal in every field, across auto-reset."""
    pair = BoardPair(task, monkeypatch, max_episode_steps=episode, **cfg)
    seen = run_pair(pair, steps, seed, share)
    first = np.stack([ts["step_type"] == 0 for ts in seen])
    assert first[0].all() and first[1:].any(), "no auto-reset"
    return pair, seen


# -- the rollouts ----------------------------------------------------------------


@pytest.mark.parametrize("task,cfg", [
    ("TicTacToe-v1", {}),
    ("TicTacToe-v1", {"max_num_players": 2}),
    ("ConnectFour-v1", {"max_num_players": 2, "steps": 24, "episode": 22}),
    ("Hex-v1", {"steps": 100, "episode": 90}),
    ("Othello-v1", {"max_num_players": 2}),
    ("Play2048-v1", {}),
    ("KuhnPoker-v1", {"max_num_players": 2}),
    ("LeducHoldem-v1", {}),
    ("Backgammon-v1", {"max_num_players": 2}),
])
def test_rollout_matches_jax(task, cfg, monkeypatch):
    cfg = dict(cfg)
    depth = {k: cfg.pop(k) for k in ("steps", "episode") if k in cfg}
    _, seen = check_rollout(task, monkeypatch, **depth, **cfg)
    rewards = np.concatenate([np.asarray(ts["reward"]).reshape(-1) for ts in seen])
    assert (rewards != 0).any(), "no reward in the rollout"


@pytest.mark.parametrize("task,steps,episode", [("Go9x9-v1", 30, 26),
                                                ("ChineseGo13x13-v1", 16, 12)])
def test_go_rollout_matches_jax(task, steps, episode, monkeypatch):
    """Go by legal moves (with a few uniform actions), long enough for
    chains, captures and ko; the labels and liberties in the state equal
    JAX's bit for bit."""
    _, seen = check_rollout(task, monkeypatch, steps=steps, episode=episode, share=0.05)
    boards = np.asarray(seen[-1]["obs:board"])
    assert (boards != 0).sum() > 0


def test_recording_wrappers_give_jax_values(monkeypatch):
    """The wrappers compute JAX's own values: JAX's engine step with and
    without them from the same states is equal in every field (2048's
    spawns draw a categorical and a uniform)."""
    task = "Play2048-v1"
    plain = JaxEngine(envpool_tpu.make_spec(task, num_envs=N, seed=5).env)
    pair = BoardPair(task, monkeypatch)
    tree = host(plain.init())
    act = {"action": jnp.asarray(np.arange(N, dtype=np.int32) % 4)}
    for _ in range(3):
        got = pair._step(to_jax(tree), act)[:2]
        want = plain.step(to_jax(tree), act)
        tree = host(want[0])
        assert_trees_equal(tree, host(got[0]))
        assert_trees_equal(dict(jax.device_get(want[1])), dict(jax.device_get(got[1])))


# -- Go's fixpoints and Hex's connection -------------------------------------------


def _random_positions(gen, b, n, fill):
    board = np.where(gen.random((b, n, n)) < fill, gen.integers(1, 3, (b, n, n)), 0)
    # a long snake chain of black stones in the first board, and a
    # whole-board empty region in the second
    snake = np.zeros((n, n), np.int32)
    for r in range(0, n, 2):
        snake[r] = 1
        snake[r + 1 if r + 1 < n else r, (n - 1) if (r // 2) % 2 == 0 else 0] = 1
    board[0] = snake
    board[1] = 0
    board[2, :, :] = 0
    board[2, n // 2, n // 2] = 2
    return board.astype(np.int32)


@pytest.mark.parametrize("n", [9, 19])
def test_go_labels_and_liberties_match_jax(n):
    """The chain labels, liberties, legal points and area score of random
    positions equal JAX's, a snake chain through the whole board and a
    board with one empty region among them."""
    gen = np.random.default_rng(n)
    boards = np.concatenate([_random_positions(gen, 24, n, f) for f in (0.3, 0.6, 0.85)])
    labels = jax.jit(jax.vmap(jax_go._chain_labels))(boards)
    libs = jax.jit(jax.vmap(jax_go._chain_liberties))(boards, labels)
    black, white = jax.jit(jax.vmap(jax_go._area_score))(boards)
    mark = jnp.asarray(gen.integers(1, 3, len(boards)), jnp.int32)
    ko = jnp.asarray(np.where(gen.random(len(boards)) < 0.5, -1,
                              gen.integers(0, n * n, len(boards))), jnp.int32)
    legal = jax.jit(jax.vmap(jax_go._legal_points))(boards, labels, libs, mark, ko)
    tb = torch.as_tensor(boards)
    got_labels = go.chain_labels(tb)
    got_libs = go.chain_liberties(tb, got_labels)
    assert_trees_equal(np.asarray(labels), got_labels, "labels")
    assert_trees_equal(np.asarray(libs), got_libs, "libs")
    gb, gw = go.area_score(tb)
    np.testing.assert_array_equal(gb.numpy(), np.asarray(black))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(white))
    got_legal = go.legal_points(tb, got_labels, got_libs, torch.as_tensor(np.asarray(mark)),
                                torch.as_tensor(np.asarray(ko)))
    assert_trees_equal(np.asarray(legal), got_legal, "legal")
    assert int(np.asarray(labels)[0][boards[0] != 0].max()) == 0  # the snake is one chain


def test_hex_connection_matches_jax():
    """Hex's win test on random boards of both players against JAX's
    growth loop."""
    gen = np.random.default_rng(0)
    stones = gen.random((512, 11, 11)) < np.linspace(0.3, 0.8, 512)[:, None, None]
    player = gen.integers(0, 2, 512).astype(np.int32)
    want = [jax.jit(lambda s, p=p: jax.vmap(lambda x: jax_hex._connected(x, p))(s))(stones)
            for p in (0, 1)]
    want = np.where(player == 0, np.asarray(want[0]), np.asarray(want[1]))
    got = port_hex.connected(torch.as_tensor(stones), torch.as_tensor(player)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < want.mean() < 0.9


# -- registration and the port's own draws ----------------------------------------


def test_every_board_id_is_ported():
    ids = [t for t, (path, _, _) in torch_registry.specs.items() if path.endswith(".board")]
    assert ids == BOARD and len(ids) == 19
    for task in BOARD:
        _, jcls, jkw = jax_registry.specs[task]
        _, tcls, tkw = torch_registry.specs[task]
        assert (jcls, jkw) == (tcls, tkw), task
    all_jax = [t for t in envpool_tpu.list_all_envs() if t in torch_registry.specs]
    assert all_jax == envpool_tpu_torch.list_all_envs()


@pytest.mark.parametrize("players", [1, 2])
def test_config_and_spec_match_jax(players):
    for task in BOARD:
        cfg = {} if task == "SparrowMahjong-v1" else {"max_num_players": players}
        jenv = envpool_tpu.make_spec(task, num_envs=2, **cfg).env
        tenv = envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu", **cfg).env
        assert dict(tenv.config, device="cuda") == dict(jenv.config, device="cuda"), task
        assert repr(tenv.state_spec()) == repr(jenv.state_spec()), task
        assert repr(tenv.action_spec()) == repr(jenv.action_spec()), task
        assert tenv.max_episode_steps == jenv.max_episode_steps


def _port_reset(task, n, **cfg):
    env = envpool_tpu_torch.make_spec(task, num_envs=n, seed=11, device="cpu", **cfg).env
    draws = env.reset_draws(rng.split(env.keys())[1])
    return env, draws, env.reset_env(draws)


def test_port_draws_range_and_distribution():
    """The port's own draws: 2048's two spawns on distinct cells, 2s nine
    times in ten; Kuhn's and Leduc's deals permutations; backgammon's
    opening dice distinct and uniform, its first player uniform."""
    n = 20000
    _, draws, (board, _) = _port_reset("Play2048-v1", n)
    flat = board.reshape(n, -1).numpy()
    assert ((flat > 0).sum(1) == 2).all()
    vals = flat[flat > 0]
    assert set(np.unique(vals)) == {1, 2} and 0.88 < (vals == 1).mean() < 0.92
    assert_uniform(np.argmax(draws["cell0"].numpy(), 1), 0, 15, "first spawn cell")
    _, draws, (st, _) = _port_reset("KuhnPoker-v1", n)
    assert (np.sort(draws["deal"].numpy(), 1) == np.arange(3)).all()
    assert_uniform(st["cards"][:, 0].numpy(), 0, 2, "Kuhn card")
    _, draws, (st, _) = _port_reset("LeducHoldem-v1", n)
    assert (np.sort(draws["deal"].numpy(), 1) == np.arange(6)).all()
    assert_uniform(st["cards"].numpy(), 0, 2, "Leduc ranks")
    _, _, (st, _) = _port_reset("Backgammon-v1", n)
    dice = st["dice"].numpy()
    assert (dice[:, 0] != dice[:, 1]).all()
    assert_uniform(dice, 0, 5, "dice")
    assert_uniform(st["player"].numpy(), 0, 1, "first player")
