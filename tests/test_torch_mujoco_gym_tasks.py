"""The port's Gym-MuJoCo tasks against the JAX package.

Both engines step from one JAX pool state (``envpool_tpu_torch.interop``),
the port with the reset draws the JAX env makes from its threefry keys, in
the port's layout (``_JAX_DRAWS``).  Every step starts the port from JAX's
state again: qpos, qvel, obs, reward and the info fields agree within
``STEP_TOL · (1 + |jax|)`` (the physics' one-step bar, see
``tests/test_torch_physics.py``), and the integer and bool fields are
equal.  Pusher's reset gets the candidate cylinder positions JAX's
rejection loop draws, so it must land where the loop did.

Each task's JAX engine is built and compiled once, in its engine test;
the Humanoid tasks' take the longest to compile and are in
``tests/test_torch_mujoco_gym_humanoid.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu.core.registry import registry as jax_registry
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.envs.mujoco_gym import PusherEnv
from test_torch_classic import EnginePair, assert_ts_close, host

STEP_TOL = 1e-4
CANDIDATES = PusherEnv.CANDIDATES


def _base_draws(nq, nv, noise, uniform_qvel):
    def one(sub):
        k1, k2 = jax.random.split(sub)
        if uniform_qvel:
            qvel = jax.random.uniform(k2, (nv,), jnp.float32, -noise, noise)
        else:
            qvel = jax.random.normal(k2, (nv,), jnp.float32)
        return {
            "qpos_noise": jax.random.uniform(k1, (nq,), jnp.float32, -noise, noise),
            "qvel_noise": qvel,
        }

    return one


def _reacher_draws(sub):
    k1, k2, k3, k4 = jax.random.split(sub, 4)
    return {
        "arm": jax.random.uniform(k1, (2,), jnp.float32, -0.1, 0.1),
        "goal_u": jax.random.uniform(k2, (), jnp.float32),
        "goal_angle": jax.random.uniform(k3, (), jnp.float32, 0.0, 2.0 * jnp.pi),
        "arm_vel": jax.random.uniform(k4, (2,), jnp.float32, -0.005, 0.005),
    }


def _pusher_candidates(k_cyl):
    """The first ``CANDIDATES`` positions JAX's rejection loop draws."""
    out = []
    k = k_cyl
    for _ in range(CANDIDATES):
        k = jax.random.fold_in(k, 1)
        kx, ky = jax.random.split(k)
        out.append(jnp.stack([
            jax.random.uniform(kx, (), jnp.float32, -0.3, 0.0),
            jax.random.uniform(ky, (), jnp.float32, -0.2, 0.2),
        ]))
    return jnp.stack(out)


def _pusher_draws(sub):
    k_cyl, k_vel = jax.random.split(sub)
    return {
        "cylinder": _pusher_candidates(k_cyl),
        "qvel_noise": jax.random.uniform(k_vel, (11,), jnp.float32, -0.005, 0.005),
    }


# task -> (nq, nv, reset_noise_scale, qvel noise uniform); Reacher and
# Pusher draw their own.
_TASKS = {
    "Ant-v4": (15, 14, 0.1, False),
    "Hopper-v4": (6, 6, 5e-3, True),
    "Walker2d-v4": (9, 9, 5e-3, True),
    "Swimmer-v4": (5, 5, 0.1, True),
    "InvertedPendulum-v4": (2, 2, 0.01, True),
    "InvertedDoublePendulum-v4": (3, 3, 0.1, False),
    "Humanoid-v4": (24, 23, 1e-2, True),
    "HumanoidStandup-v4": (24, 23, 1e-2, True),
    "Reacher-v4": None,
    "Pusher-v4": None,
}
_JAX_DRAWS = {
    task: _base_draws(*row) if row else
    {"Reacher-v4": _reacher_draws, "Pusher-v4": _pusher_draws}[task]
    for task, row in _TASKS.items()
}
_GYM_MUJOCO = [
    t for t in envpool_tpu.list_all_envs()
    if jax_registry.specs[t][0].endswith(".mujoco_gym")
]


def check_step_matches_jax(task, draws):
    """Six steps of four envs from JAX's states with a fast qvel, each
    episode cut at three steps."""
    n, steps = 4, 6
    pair = EnginePair(task, n, draws, max_episode_steps=3)
    spec = pair.tenv.action_spec()["action"]
    r = np.random.default_rng(len(task))
    acts = r.uniform(-1.5, 1.5, (steps + 1, n, *spec.shape)).astype(np.float32)
    acts *= np.maximum(np.abs(spec.minimum), np.abs(spec.maximum))
    tree = host(pair.jeng.step(pair.jeng.init(), {"action": jnp.asarray(acts[0])})[0])
    st = tree["env_state"]
    st["qvel"][:] = r.normal(0.0, 1.0, st["qvel"].shape)
    reset = np.zeros(n, bool)
    for t in range(1, steps + 1):
        tree, jts, tts = pair.step(tree, acts[t])
        assert_ts_close(jts, tts, STEP_TOL)
        reset |= jts["step_type"] == 0
    assert reset.all()  # every env ended an episode and started again
    if task == "Pusher-v4":  # the cylinder where JAX's loop put it, > 0.17 out
        cyl = tree["env_state"]["qpos0"][:, -4:-2]
        assert (np.linalg.norm(cyl, axis=1) > 0.17).all()


@pytest.mark.parametrize(
    "task", sorted(t for t in _TASKS if not t.startswith("Humanoid"))
)
def test_step_matches_jax_across_auto_reset(task):
    check_step_matches_jax(task, _JAX_DRAWS[task])


@pytest.mark.parametrize("task", _GYM_MUJOCO)
def test_spec_matches_jax(task):
    jspec = envpool_tpu.make_spec(task)
    tspec = envpool_tpu_torch.make_spec(task, device="cpu")
    assert dict(tspec.env.config, device="cuda") == dict(jspec.env.config, device="cuda")
    assert tspec.reward_threshold == jspec.reward_threshold
    assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec)
    assert set(tspec.state_array_spec) == set(jspec.state_array_spec)
    for k, js in jspec.state_array_spec.items():
        ts = tspec.state_array_spec[k]
        assert (ts.shape, ts.dtype) == (js.shape, js.dtype), k
    if task.startswith("Humanoid"):
        want = 348 if task.endswith("v5") else 376
        assert tspec.state_array_spec["obs"].shape == (want,)


def test_every_gym_mujoco_id_is_registered():
    assert len(_GYM_MUJOCO) == 33
    assert set(_GYM_MUJOCO) <= set(envpool_tpu_torch.list_all_envs())


def _draws(task, n=20000, **cfg):
    env = envpool_tpu_torch.make_spec(task, device="cpu", **cfg).env
    keys = rng.seed_keys(np.arange(n), torch.device("cpu"))
    return env, env.reset_draws(rng.split(keys)[1])


def _assert_uniform(x, lo, hi):
    x = np.asarray(x).ravel()
    assert x.dtype == np.float32 and lo <= x.min() and x.max() < hi
    counts = np.histogram(x, bins=10, range=(lo, hi))[0]
    expect = x.size / 10
    assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))


def _assert_uncorrelated(*columns):
    x = np.concatenate([np.asarray(c).reshape(len(c), -1) for c in columns], 1)
    corr = np.corrcoef(x.T)
    assert np.abs(corr - np.eye(x.shape[1])).max() < 5 / math.sqrt(len(x))


@pytest.mark.parametrize(
    "task", [t for t, row in sorted(_TASKS.items()) if row]
)
def test_reset_draws_range_and_distribution(task):
    nq, nv, s, uniform_qvel = _TASKS[task]
    env, d = _draws(task)
    qpos, qvel = d["qpos_noise"].numpy(), d["qvel_noise"].numpy()
    assert qpos.shape == (20000, nq) and qvel.shape == (20000, nv)
    _assert_uniform(qpos, -s, s)
    if uniform_qvel:
        _assert_uniform(qvel, -s, s)
    else:
        se = 1 / math.sqrt(qvel.size)
        assert abs(qvel.mean()) < 5 * se and abs(qvel.var() - 1) < 5 * math.sqrt(2) * se
    _assert_uncorrelated(qpos, qvel)
    state, _ = env.reset_env(d)
    scale = np.float32(1.0 if uniform_qvel else s)
    # Gym's noise goes on every qpos coordinate, a quaternion's too.
    np.testing.assert_array_equal(state["qpos"].numpy(), env.model.qpos0.astype(np.float32) + qpos)
    np.testing.assert_array_equal(state["qvel"].numpy(), scale * qvel)


def test_reacher_goal_draws():
    env, d = _draws("Reacher-v4")
    _assert_uniform(d["arm"], -0.1, 0.1)
    _assert_uniform(d["goal_u"], 0.0, 1.0)
    _assert_uniform(d["goal_angle"], 0.0, 2 * math.pi)
    _assert_uniform(d["arm_vel"], -0.005, 0.005)
    _assert_uncorrelated(d["arm"], d["goal_u"], d["goal_angle"], d["arm_vel"])
    qpos, qvel = (x.numpy() for x in env.reset_qpos_qvel(d))
    goal = qpos[:, 2:]
    # Uniform on the radius-0.2 disk: P(|goal| < r) = (r / 0.2)².
    radius = np.linalg.norm(goal, axis=1)
    assert radius.max() <= 0.2 + 1e-6
    assert abs((radius < 0.1).mean() - 0.25) < 0.015
    assert abs((goal[:, 0] > 0).mean() - 0.5) < 0.015
    assert (qvel[:, 2:] == 0).all()


def test_pusher_rejection_is_bounded():
    """The first candidate outside 0.17 of the goal wins; where none is, the
    last one; the draws cover the box and reject about 37.8%."""
    env, d = _draws("Pusher-v4")
    cyl = d["cylinder"].numpy()
    assert cyl.shape == (20000, CANDIDATES, 2)
    _assert_uniform(cyl[..., 0], -0.3, 0.0)
    _assert_uniform(cyl[..., 1], -0.2, 0.2)
    rejected = np.linalg.norm(cyl, axis=2) <= 0.17
    p = math.pi * 0.17**2 / 2 / (0.3 * 0.4)
    assert abs(rejected.mean() - p) < 5 * math.sqrt(p * (1 - p) / rejected.size)
    qpos, qvel = (x.numpy() for x in env.reset_qpos_qvel(d))
    first = np.argmax(~rejected, axis=1)
    np.testing.assert_array_equal(qpos[:, -4:-2], cyl[np.arange(20000), first])
    assert (qpos[:, -2:] == 0).all() and (qvel[:, -4:] == 0).all()
    np.testing.assert_array_equal(qpos[:, :7], np.broadcast_to(env.model.qpos0[:7].astype(np.float32), (20000, 7)))
    _assert_uniform(qvel[:, :7], -0.005, 0.005)
    # Rejections then acceptance, and none accepted at all.
    near = torch.tensor([[-0.1, 0.1]])
    far = torch.tensor([[-0.25, 0.15]])
    cands = torch.cat([near.expand(5, 2), far, near.expand(CANDIDATES - 6, 2)])
    d = {"cylinder": torch.stack([cands, torch.full_like(cands, -0.05)]),
         "qvel_noise": torch.zeros(2, 11)}
    d["cylinder"][1, -1] = torch.tensor([-0.01, 0.02])
    qpos, _ = env.reset_qpos_qvel(d)
    assert qpos[0, -4:-2].tolist() == far[0].tolist()
    assert qpos[1, -4:-2].tolist() == d["cylinder"][1, -1].tolist()


@pytest.mark.parametrize(
    "task", ["InvertedDoublePendulum-v4", "InvertedPendulum-v4", "Hopper-v4", "Ant-v4"]
)
def test_termination_margin(task):
    """InvertedDoublePendulum terminates on its tip's height, which two
    devices may round to either side of the floor: its margin is that
    height's distance to the floor, and the flag flips across it.  The
    others compare the state's own coordinates: their margin is
    infinite."""
    from envpool_tpu_torch.physics.dynamics import site_positions

    env = envpool_tpu_torch.make_spec(task, num_envs=64, device="cpu").env
    r = np.random.default_rng(2)
    q = torch.as_tensor(env.model.qpos0 + r.uniform(-1.5, 1.5, (64, env.model.nq)), dtype=torch.float32)
    qd = torch.as_tensor(r.normal(0, 1, (64, env.model.nv)), dtype=torch.float32)
    state = {"qpos": q, "qvel": qd}
    margin = env.termination_margin(state)
    assert margin.shape == (64,)
    if not task.startswith("InvertedDouble"):
        assert bool(torch.isinf(margin).all())
        return
    z = site_positions(env.model, q)[:, env.model.site_names.index("tip"), 2]
    torch.testing.assert_close(margin, (z - env.TIP_FLOOR).abs())
    _, terminated, _ = env.reward_done(state, state, torch.zeros(64, env.model.nu))
    assert torch.equal(terminated, z <= env.TIP_FLOOR)
    assert 0 < int(terminated.sum()) < 64
