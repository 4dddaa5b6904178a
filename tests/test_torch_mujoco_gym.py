"""The port's HalfCheetah env against the JAX package.

Both engines step from one JAX pool state (``envpool_tpu_torch.interop``),
the port with the reset draws JAX makes from its threefry keys (its
``reset_qpos_qvel``: ``k1, k2 = split(sub)``).  Every step starts the port
from JAX's state again, so each step is compared from the same state:
qpos, qvel, obs, reward and the info fields within 1e-4 · (1 + |jax|)
(``STEP_TOL``; see ``tests/test_torch_physics.py``), and the integer and
bool fields equal.  HalfCheetah never terminates, so done comes from
truncation alone.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.physics import dynamics as tdyn
from test_torch_classic import EnginePair, assert_ts_close, host

STEP_TOL = 1e-4
TASK = "HalfCheetah-v4"


def _cheetah_draws(noise):
    def one(sub):
        k1, k2 = jax.random.split(sub)
        return {
            "qpos_noise": jax.random.uniform(k1, (9,), jnp.float32, -noise, noise),
            "qvel_noise": jax.random.normal(k2, (9,), jnp.float32),
        }

    return one


@pytest.mark.parametrize(
    "cfg",
    [
        {},
        {
            "frame_skip": 2,
            "reset_noise_scale": 0.3,
            "ctrl_cost_weight": 0.5,
            "exclude_current_positions_from_observation": False,
        },
    ],
    ids=["default", "skip2-noise0.3-cost0.5-with-x"],
)
def test_step_matches_jax_across_auto_reset(cfg):
    n, steps = 6, 7
    noise = cfg.get("reset_noise_scale", 0.1)
    pair = EnginePair(TASK, n, _cheetah_draws(noise), max_episode_steps=4, **cfg)
    acts = np.random.default_rng(1).uniform(-1.5, 1.5, (steps + 1, n, 6)).astype(np.float32)
    tree = host(pair.jeng.step(pair.jeng.init(), {"action": jnp.asarray(acts[0])})[0])
    st = tree["env_state"]
    st["qpos"][:, 1] = -0.14  # rootz down: a foot starts in the ground
    st["qvel"][:] = np.random.default_rng(2).normal(0, 4, st["qvel"].shape)
    model = pair.tenv.model
    depth = tdyn.contact_depths(model, torch.as_tensor(st["qpos"]))
    assert bool((depth > 0).any(1).all())
    resets = 0
    for t in range(1, steps + 1):
        tree, jts, tts = pair.step(tree, acts[t])
        assert_ts_close(jts, tts, STEP_TOL)
        resets += int((jts["step_type"] == 0).sum())
        np.testing.assert_array_equal(jts["trunc"], jts["elapsed_step"] == 4)
    assert resets == n  # every env truncated once and started again


def test_reset_draws_range_and_distribution():
    env = envpool_tpu_torch.make_spec(TASK, device="cpu", reset_noise_scale=0.2).env
    keys = rng.seed_keys(np.arange(20000), torch.device("cpu"))
    _, sub = rng.split(keys)
    d = env.reset_draws(sub)
    qpos, qvel = d["qpos_noise"].numpy(), d["qvel_noise"].numpy()
    assert qpos.shape == (20000, 9) and qvel.shape == (20000, 9)
    assert qpos.dtype == qvel.dtype == np.float32
    assert -0.2 <= qpos.min() and qpos.max() < 0.2
    counts = np.histogram(qpos, bins=10, range=(-0.2, 0.2))[0]
    expect = qpos.size / 10
    assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))
    # Standard normal: mean, variance, tails, and no correlation between
    # the coordinates or with the qpos draws.
    se = 1 / math.sqrt(qvel.size)
    assert abs(qvel.mean()) < 5 * se and abs(qvel.var() - 1) < 5 * math.sqrt(2) * se
    assert abs((np.abs(qvel) > 1.96).mean() - 0.05) < 0.005
    corr = np.corrcoef(np.c_[qpos, qvel].T)
    assert np.abs(corr - np.eye(18)).max() < 5 / math.sqrt(20000)
    # A reset uses them as the JAX env does.
    state, obs = env.reset_env(d)
    np.testing.assert_array_equal(state["qpos"].numpy(), env.model.qpos0.astype(np.float32) + qpos)
    np.testing.assert_array_equal(state["qvel"].numpy(), np.float32(0.2) * qvel)
    np.testing.assert_array_equal(obs["obs"].numpy(), np.c_[state["qpos"][:, 1:], qvel * np.float32(0.2)])


@pytest.mark.parametrize("version", ["v3", "v4", "v5"])
def test_spec_matches_jax(version):
    task = f"HalfCheetah-{version}"
    jspec = envpool_tpu.make_spec(task)
    tspec = envpool_tpu_torch.make_spec(task, device="cpu")
    assert dict(tspec.env.config, device="cuda") == dict(jspec.env.config, device="cuda")
    assert tspec.reward_threshold == jspec.reward_threshold
    assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec)
    assert set(tspec.state_array_spec) == set(jspec.state_array_spec)
    for k, js in jspec.state_array_spec.items():
        ts = tspec.state_array_spec[k]
        assert (ts.shape, ts.dtype) == (js.shape, js.dtype), k
    assert tspec.state_array_spec["obs"].shape == (17,)


def test_pools_run_and_unported_options_raise():
    n = 3
    pool = envpool_tpu_torch.make(TASK, env_type="gymnasium", num_envs=n, device="cpu")
    obs, info = pool.reset()
    assert obs.shape == (n, 17) and np.abs(obs).max() < 1
    obs, rew, term, trunc, info = pool.step(np.zeros((n, 6), np.float32))
    assert np.isfinite(obs).all() and not term.any()
    assert set(info) >= {"qpos0", "qvel0", "reward_run", "reward_ctrl", "x_position", "x_velocity"}
    ts = envpool_tpu_torch.make_dm(TASK, num_envs=n, device="cpu").reset()
    assert ts.observation.obs.shape == (n, 17)
    handle, recv, send, step = pool.xla()
    handle, (obs, *_) = step(handle, torch.zeros(n, 6))
    assert tuple(obs.shape) == (n, 17)
    with pytest.raises(NotImplementedError, match="contact_solver"):
        envpool_tpu_torch.make_spec(TASK, device="cpu", contact_solver="mujoco")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            envpool_tpu_torch.make(TASK, env_type="gymnasium")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_step_matches_cpu(cuda_device):
    """One HalfCheetah step of 4096 envs on the card against the CPU port,
    within ``STEP_TOL``, except envs whose state lies within 1e-5 of a
    switch of the penalty forces at the start of one of the 5 substeps."""
    pool = envpool_tpu_torch.make(TASK, env_type="gymnasium", num_envs=4096, device="cpu")
    pool.reset()
    r = np.random.default_rng(4)
    for _ in range(20):
        pool.step(r.uniform(-1, 1, (4096, 6)).astype(np.float32))
    st = pool.pool_state.env_state
    q, qd = st["qpos"], st["qvel"]
    u = torch.as_tensor(r.uniform(-1, 1, (4096, 6)).astype(np.float32))
    model = pool.spec.env.model
    want = tdyn.step(model, q, qd, u, nsteps=5)
    got = tdyn.step(model, *(x.to(cuda_device) for x in (q, qd, u)), nsteps=5)
    err = torch.stack(
        [((g.cpu() - w).abs() / (1 + w.abs())).amax(1) for g, w in zip(got, want)]
    ).amax(0)
    dist = tdyn.switch_distance(model, q)
    for _ in range(4):
        q, qd = tdyn.step(model, q, qd, u)
        dist = torch.minimum(dist, tdyn.switch_distance(model, q))
    near = dist < 1e-5
    assert bool((err[~near] <= STEP_TOL).all()), float(err[~near].max())
    assert int(near.sum()) < 41
