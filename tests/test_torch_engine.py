"""The port's PongLite-v5 engine against the JAX engine.

One JAX pool state is injected into both engines (through
``envpool_tpu_torch.interop``), and the port is handed the random draws
the JAX engine makes from its threefry keys (the same key splits as
``engine.py:180`` and ``arcade_env.py:315, 375, 389``).  Game state,
reward, done, elapsed, step type, discount and every info field must then
be bit-exact; obs and the frame stack follow the tie rule (equal except
at exact ``k + 0.5`` resize ties, where they may differ by 1).
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
from envpool_tpu_torch import interop
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.envs.atari.obs_ties import ObsTies
from envpool_tpu_torch.ops.image import tie_rule_violations

TASK = "PongLite-v5"


def _jax_draw_fn(config):
    """JAX's per-step draws from the pool keys, as the port's draw dicts."""
    noop_max = max(int(config["noop_max"]), 1)
    frame_skip = int(config["frame_skip"])
    randint = jax.random.randint

    def one(key):
        _, sub = jax.random.split(key)
        k_game, k_noop, k_tick = jax.random.split(sub, 3)
        reset = {
            "init": randint(jax.random.split(k_game, 2)[0], (), 0, 4),
            "noop": randint(k_noop, (), 0, noop_max),
            "tick": jax.vmap(
                lambda i: randint(jax.random.fold_in(k_tick, i), (), 0, 4)
            )(jnp.arange(noop_max + 1)),
        }
        k_sticky, k_tick2 = jax.random.split(sub)
        step = {
            "sticky": jax.random.uniform(k_sticky, ()),
            "tick": jax.vmap(
                lambda i: randint(jax.random.fold_in(k_tick2, i), (), 0, 4)
            )(jnp.arange(frame_skip)),
        }
        return reset, step

    fn = jax.jit(jax.vmap(one))

    def draws(keys):
        reset, step = jax.device_get(fn(jnp.asarray(keys)))
        as_t = lambda d: {k: torch.as_tensor(np.array(v)) for k, v in d.items()}
        return as_t(reset), as_t(step)

    return draws


class _Pair:
    """A JAX engine and a port engine over the same config."""

    def __init__(self, n, **cfg):
        jenv = envpool_tpu.make_spec(TASK, num_envs=n, seed=3, **cfg).env
        self.jeng = JaxEngine(jenv)
        self.tenv = envpool_tpu_torch.make_spec(
            TASK, num_envs=n, seed=3, device="cpu", **cfg
        ).env
        self.teng = Engine(self.tenv)
        self.ties = ObsTies(self.tenv)
        self.draws = _jax_draw_fn(jenv.config)

    def inject(self, keys):
        """Make the port use the draws JAX makes from ``keys`` next."""
        reset, step = self.draws(keys)
        self.tenv.reset_draws = lambda sub: reset
        self.tenv.step_draws = lambda sub: step


def _host(ps):
    return dataclasses.asdict(jax.device_get(ps))


def _to_jax(tree):
    return JaxPoolState(**jax.tree_util.tree_map(jnp.asarray, tree))


def _rig_endgame(tree):
    """Env 0/1: the next point ends the game (ball already past a paddle)."""
    g = tree["env_state"]["game"]
    g["score_c"][0] = 20
    g["score_p"][1] = 20
    g["ball_x"][:2] = [150.0, 6.0]
    g["ball_y"][:2] = [40.0, 186.0]
    g["vel_x"][:2] = [2.0, -2.0]
    g["serve_timer"][:2] = 0
    return tree


def _assert_ts_match(jts, tts, ties):
    jts = jax.device_get(jts)
    assert set(jts) == set(tts)
    for k, v in jts.items():
        if k == "obs":
            bad, _ = tie_rule_violations(torch.as_tensor(np.array(v)), tts[k], ties)
            assert bad == 0, "obs outside the tie rule"
        else:
            np.testing.assert_array_equal(np.asarray(v), tts[k].numpy(), err_msg=k)


def _assert_state_match(jtree, tps, ties):
    t = interop.pool_state_to_numpy(tps)
    for k in ("elapsed", "autoreset", "full_reset"):
        np.testing.assert_array_equal(jtree[k], t[k], err_msg=k)
    for k, v in jtree["env_state"]["game"].items():
        np.testing.assert_array_equal(v, t["env_state"]["game"][k], err_msg=k)
    np.testing.assert_array_equal(
        jtree["env_state"]["last_action"], t["env_state"]["last_action"]
    )
    n = ties.shape[0]
    bad, _ = tie_rule_violations(
        torch.as_tensor(jtree["env_state"]["stack"]).reshape(ties.shape),
        tps.env_state["stack"].reshape(n, -1, *ties.shape[2:]),
        ties,
    )
    assert bad == 0, "frame stack outside the tie rule"


@pytest.mark.parametrize(
    "cfg",
    [
        {},
        {
            "repeat_action_probability": 0.25,
            "full_action_space": True,
            "noop_max": 5,
            "reward_clip": True,
            "gray_scale": False,
            "img_height": 42,
            "img_width": 50,
            "stack_num": 2,
        },
    ],
    ids=["default", "sticky-full-action-rgb-42x50"],
)
def test_step_matches_jax_across_episode_boundaries(cfg):
    n, steps = 5, 14
    pair = _Pair(n, max_episode_steps=9, **cfg)
    # The first step of a fresh pool auto-resets every env.
    zero = {"action": jnp.zeros(n, jnp.int32)}
    jps, _ = pair.jeng.step(pair.jeng.init(), zero)
    tree = _rig_endgame(_host(jps))
    jps = _to_jax(tree)
    tps = interop.pool_state_from_numpy(tree, "cpu")
    pair.ties.assume_equal(n)
    n_actions = pair.tenv.action_spec()["action"].maximum + 1
    actions = np.random.default_rng(5).integers(0, n_actions, (steps, n))
    seen = {"terminated": 0, "truncated": 0, "reset": 0}
    for t in range(steps):
        pair.inject(tree["key"])
        act = actions[t].astype(np.int32)
        jps, jts = pair.jeng.step(jps, {"action": jnp.asarray(act)})
        tps, tts = pair.teng.step(tps, {"action": torch.as_tensor(act)})
        ties = pair.ties.after_step(tts["step_type"] == 0)
        _assert_ts_match(jts, tts, ties)
        tree = _host(jps)
        _assert_state_match(tree, tps, ties)
        done, trunc = tts["done"].numpy(), tts["trunc"].numpy()
        seen["terminated"] += int((done & ~trunc).sum())
        seen["truncated"] += int(trunc.sum())
        seen["reset"] += int((tts["step_type"] == 0).sum())
    assert seen["terminated"] >= 2 and seen["truncated"] >= 1
    assert seen["reset"] >= seen["terminated"] + seen["truncated"] - n


def test_partial_reset_and_step_match_jax():
    n = 6
    env_id = np.array([4, 1, 2], np.int32)
    pair = _Pair(n)
    jps = pair.jeng.init()
    tree = _host(jps)
    tps = interop.pool_state_from_numpy(tree, "cpu")

    pair.inject(tree["key"][env_id])
    jps, jts = pair.jeng.reset_partial(jps, jnp.asarray(env_id))
    tps, tts = pair.teng.reset_partial(tps, torch.as_tensor(env_id))
    _assert_ts_match(jts, tts, pair.ties.after_reset())
    assert tts["info:env_id"].tolist() == env_id.tolist()

    tree = _host(jps)
    tps = interop.pool_state_from_numpy(tree, "cpu")
    pair.ties.assume_equal(len(env_id))
    pair.inject(tree["key"][env_id])
    act = np.array([2, 3, 0], np.int32)
    jps, jts = pair.jeng.step_partial(jps, {"action": jnp.asarray(act)}, jnp.asarray(env_id))
    tps, tts = pair.teng.step_partial(
        tps, {"action": torch.as_tensor(act)}, torch.as_tensor(env_id)
    )
    ties = pair.ties.after_step(tts["step_type"] == 0)
    _assert_ts_match(jts, tts, ties)
    tree = _host(jps)
    t = interop.pool_state_to_numpy(tps)
    np.testing.assert_array_equal(tree["elapsed"], t["elapsed"])
    for k, v in tree["env_state"]["game"].items():
        np.testing.assert_array_equal(v, t["env_state"]["game"][k], err_msg=k)
    # Rows outside env_id keep their (initial, all-zero) state.
    assert not t["env_state"]["stack"][[0, 3, 5]].any()


def test_async_send_recv_batches():
    pool = envpool_tpu_torch.make(
        TASK, env_type="gymnasium", num_envs=4, batch_size=2, seed=1, device="cpu"
    )
    assert pool.is_async
    pool.async_reset()
    first = pool.recv()
    second = pool.recv()
    ids = [first[-1]["env_id"].tolist(), second[-1]["env_id"].tolist()]
    assert ids == [[0, 1], [2, 3]]
    pool.send(np.array([2, 3], np.int32), np.array([3, 1], np.int32))
    pool.send(np.array([0, 0], np.int32), np.array([0, 2], np.int32))
    obs, rew, term, trunc, info = pool.recv()
    assert info["env_id"].tolist() == [3, 1] and obs.shape == (2, 4, 84, 84)
    assert info["elapsed_step"].tolist() == [1, 1]
    obs, rew, term, trunc, info = pool.recv()
    assert info["env_id"].tolist() == [0, 2]
    assert pool.pool_state.elapsed.tolist() == [1, 1, 1, 1]
    with pytest.raises(RuntimeError):
        pool.recv()


def _trajectory(num_envs, seed, steps=4, **cfg):
    pool = envpool_tpu_torch.make(
        TASK, env_type="gymnasium", num_envs=num_envs, seed=seed, device="cpu", **cfg
    )
    obs, _ = pool.reset()
    out = [obs]
    for t in range(steps):
        obs, rew, *_ = pool.step(np.full(num_envs, t % 6, np.int32))
        out.append(obs)
    return np.stack(out), pool.pool_state.env_state["game"]


def test_same_seed_identical_and_streams_per_env():
    a, ga = _trajectory(3, seed=9)
    b, gb = _trajectory(3, seed=9)
    np.testing.assert_array_equal(a, b)
    for k in ga:
        assert torch.equal(ga[k], gb[k])
    # Env i's stream depends on seed + i only, not on num_envs.
    c, gc = _trajectory(2, seed=10)
    np.testing.assert_array_equal(a[:, 1:], c)
    for k in ga:
        assert torch.equal(ga[k][1:], gc[k])
    _, gd = _trajectory(3, seed=11, steps=8)
    _, ge = _trajectory(3, seed=9, steps=8)
    assert not all(torch.equal(gd[k], ge[k]) for k in gd)


def test_reset_draws_range_and_distribution():
    env = envpool_tpu_torch.make_spec(TASK, num_envs=1, device="cpu").env
    keys = rng.seed_keys(np.arange(20000), torch.device("cpu"))
    _, sub = rng.split(keys)
    r, s = env.reset_draws(sub), env.step_draws(sub)
    assert r["noop"].min() == 0 and r["noop"].max() == 29
    assert r["init"].min() == 0 and r["init"].max() == 3
    assert tuple(r["tick"].shape) == (20000, 31) and tuple(s["tick"].shape) == (20000, 4)
    assert 0.0 <= float(s["sticky"].min()) and float(s["sticky"].max()) < 1.0
    # Uniform within 5 sigma of the expected counts.
    for draws, k in ((r["noop"], 30), (r["init"], 4), (s["tick"][:, 2], 4)):
        counts = np.bincount(draws.numpy(), minlength=k)
        expect = len(draws) / k
        assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))
    assert abs(float(s["sticky"].mean()) - 0.5) < 0.01
    # Consecutive subkeys of one stream give fresh draws.
    keys2, sub2 = rng.split(rng.split(keys)[0])
    assert float((env.reset_draws(sub2)["noop"] == r["noop"]).float().mean()) < 0.1


def test_rollout_matches_stepping():
    pool = envpool_tpu_torch.make(TASK, env_type="gymnasium", num_envs=3, seed=4, device="cpu")

    def policy(ts, gen):
        return {"action": torch.randint(0, 6, (3,), generator=gen, dtype=torch.int32)}

    run = pool.engine.make_rollout(policy, 5)
    ps, traj = run(pool.pool_state, 7)
    assert tuple(traj["obs"].shape) == (5, 3, 4, 84, 84)
    eng = pool.engine
    ps2, ts = eng.reset(pool.pool_state, torch.ones(3, dtype=torch.bool))
    gen = torch.Generator()
    gen.manual_seed(7)
    for t in range(5):
        ps2, ts = eng.step(ps2, policy(ts, gen))
        for k in ts:
            assert torch.equal(traj[k][t], ts[k]), k
    h, recv, send, step = pool.xla()
    h, (obs, rew, term, trunc, info) = step(h, torch.zeros(3, dtype=torch.int32))
    assert tuple(obs.shape) == (3, 4, 84, 84) and info["elapsed_step"].tolist() == [0, 0, 0]


def test_interop_round_trip():
    jeng = JaxEngine(envpool_tpu.make_spec(TASK, num_envs=2, seed=1).env)
    tree = _host(jeng.init())
    tree["env_state"]["game"]["ball_x"][:] = [3.25, 150.5]
    tree["env_state"]["stack"][1] = 87
    back = interop.pool_state_to_numpy(interop.pool_state_from_numpy(tree, "cpu"))
    flat_a, def_a = jax.tree_util.tree_flatten(tree)
    flat_b, def_b = jax.tree_util.tree_flatten(back)
    assert def_a == def_b
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


class _MatmulSettings(torch.overrides.TorchFunctionMode):
    """Records the CUDA float32 matmul setting at every matrix product."""

    PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                torch.Tensor.__rmatmul__, torch.einsum, torch.bmm, torch.mm}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            self.seen.append(torch.backends.cuda.matmul.fp32_precision)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("task", [
    "HandReach-v3", "HandManipulateBlock-v1", "AdroitHandDoor-v1", "FrankaKitchen-v1",
    "Pusher-v4", "WalkerWalk-v1",
])
def test_env_matmuls_run_in_full_fp32(task):
    """Every matrix product of an env's reset and step branches runs
    without TF32 whatever the caller set, through every pool function, and
    the caller's setting comes back after each."""
    matmul = torch.backends.cuda.matmul
    pool = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=2, device="cpu",
                                  numpy_output=False)
    eng = pool.engine
    act = eng.zero_action()
    before = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    try:
        with _MatmulSettings() as mode:
            ps, _ = eng.reset(pool.pool_state, torch.ones(2, dtype=torch.bool))
            assert matmul.fp32_precision == "tf32"
            ps, _ = eng.step(ps, act)
            ps, _ = eng.reset_partial(ps, torch.tensor([1]))
            ps, _ = eng.step_partial(ps, {k: v[:1] for k, v in act.items()}, torch.tensor([0]))
            assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = before
    assert mode.seen and set(mode.seen) == {"ieee"}, task
