"""The port's dog (DogStand, DogWalk, DogTrot, DogRun, DogFetch) against the
JAX package.

The dog's joint-space inertia is conditioned at 1.07e5 (fetch's 5.29e5),
past ``COND_FLOAT64``, so the port steps its physics in float64 and rounds
once, where JAX steps it in float32.  DogRun-v1's engine step (the one JAX
dog step this suite compiles: ~90 s on a CPU) is held by
``test_torch_mujoco_dmc_suite2.check_stiff_step``: one step from JAX's
state within 1e-4 · (1 + |jax|), integer and bool fields equal, the reset
(from JAX's draws) among them; an env step past the bar passes only where
JAX's own float32 steps of the state and of copies an ulp away spread past
half the bar from JAX's float64 physics step (compiled only then), and the
port lies within the bar or 4x that spread of it.  The other four ids are
held through JAX's ``init_state``, ``observe_dmc`` and ``reward_dmc``
(compiled for one env: ~8-20 s each) on JAX's starts, moved by a random
qvel, extras and a drop into the floor.
"""

import math

import jax
import numpy as np
import pytest
import torch

import envpool_tpu_torch
from envpool_tpu_torch.envs.mujoco_dmc.base import COND_FLOAT64
from envpool_tpu_torch.physics.model import PhysModel, load_model
from test_torch_mujoco_dmc import (
    STEP_TOL,
    _assert_normal,
    _assert_uncorrelated,
    _assert_uniform,
    _draws,
    jax_env,
    jax_reset_draws,
)
from test_torch_mujoco_dmc_suite2 import check_stiff_step

DOGS = ["DogStand-v1", "DogWalk-v1", "DogTrot-v1", "DogRun-v1", "DogFetch-v1"]
N = 4


def test_dogrun_reset_and_step_match_jax():
    counts = check_stiff_step("DogRun-v1", n=N, steps=3, episode=2)
    assert counts["diverged"] == 0, counts


@pytest.mark.parametrize("task", DOGS)
def test_config_and_action_spec_match_jax(task):
    """What ``test_torch_mujoco_dmc.py::test_spec_matches_jax`` holds for
    the other ids, but the obs spec, which the obs tests below hold
    against JAX's obs themselves."""
    jenv = jax_env(task, N)
    tenv = envpool_tpu_torch.make_spec(task, num_envs=N, seed=3, device="cpu").env
    assert dict(tenv.config, device="cuda") == dict(jenv.config, device="cuda")
    assert tenv.max_episode_steps == jenv.max_episode_steps == 1000
    assert (tenv.frame_skip, tenv.substeps, tenv.contact) == (
        jenv.n_sub_steps, jenv.substeps, tuple(jenv.contact)[:len(tenv.contact)])
    assert repr(tenv.action_spec()) == repr(jenv.action_spec())


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("task", DOGS)
def test_models_are_the_jax_models(task):
    """The committed ``dmc:dog`` is the JAX env's model of every locomotion
    task but the floor's size (15, 15, 45 and 135 m), and ``dmc:dog_fetch``
    fetch's; both keep exactly the JAX model's 202 contact spheres (fetch's
    ball adds one), and none of the 162 mesh geoms."""
    from envpool_tpu.envs.mujoco_dmc.tasks3 import _dog_model

    want, mj = _dog_model(task.removeprefix("Dog").removesuffix("-v1").lower())
    tenv = envpool_tpu_torch.make_spec(task, device="cpu").env
    got = load_model(tenv.model_name())
    differ = [f for f in PhysModel.__dataclass_fields__
              if not _same(getattr(got, f), getattr(want, f))]
    floor = tenv.geom_index("floor")
    if task in ("DogTrot-v1", "DogRun-v1"):
        assert differ == ["geom_size"]
        rows = np.flatnonzero((got.geom_size != want.geom_size).any(1))
        assert rows.tolist() == [floor]
        assert want.geom_size[floor][0] == (45 if task == "DogTrot-v1" else 135)
    else:
        assert differ == []
    assert len(got.con_body) == 202 + (task == "DogFetch-v1")
    assert int((mj.geom_type == 7).sum()) == 162  # mjGEOM_MESH: visual only


@pytest.mark.parametrize("task", ["DogRun-v1", "DogFetch-v1"])
def test_dog_steps_in_float64(task):
    """The mass condition sends the dog to float64 (``DmcEnv``); its env
    step is the float64 physics step rounded to float32 once."""
    from envpool_tpu_torch.physics.dynamics import step

    env, d = _draws(task, n=2)
    cond = env.mass_condition()
    assert cond > COND_FLOAT64 and env.physics_dtype is torch.float64
    assert cond == pytest.approx(1.066e5 if task == "DogRun-v1" else 5.291e5, rel=1e-3)
    q, qd, extras = env.init_state(d)
    state = {"qpos": q, "qvel": qd, "extras": extras}
    act = torch.linspace(-1, 1, env.model.nu).expand(2, -1)
    ctrl = env.control(state, act).double()
    want = step(env.model, q.double(), qd.double(), ctrl, env.substeps, env.contact,
                env.frame_skip)
    for got, w in zip(env.physics_step(state, act), want):
        assert got.dtype == torch.float32 and torch.equal(got, w.float())


def _per_env(fn, *args):
    """``fn`` compiled for one env and run on each row of ``args``: for the
    dog's tree passes tracing one env costs less than tracing the batch."""
    one = jax.jit(fn)
    rows = [one(*jax.tree_util.tree_map(lambda x: x[i], args)) for i in range(N)]
    return jax.tree_util.tree_map(lambda *x: np.stack(x), *jax.device_get(rows))


def _start_and_moved(tasks):
    """JAX's and the port's starts of each task from JAX's reset draws of
    one set of keys, held within ``STEP_TOL · (1 + |jax|)``; then those
    starts moved by a random qvel, extras and a drop of up to 0.3 m (so
    that feet meet the floor), and random actions: ``(jax envs, port envs,
    (qpos, qvel, action, extras))`` in numpy."""
    jenvs = [jax_env(t, N) for t in tasks]
    tenvs = [envpool_tpu_torch.make_spec(t, num_envs=N, device="cpu").env for t in tasks]
    keys = jax.random.split(jax.random.PRNGKey(7), N)
    for jenv, tenv in zip(jenvs, tenvs):
        draws = jax.device_get(jax.vmap(jax_reset_draws(jenv))(keys))
        jq, jqd, jex = jax.device_get(jax.jit(jax.vmap(jenv.init_state))(keys))
        tq, tqd, tex = tenv.init_state({k: torch.as_tensor(np.array(v)) for k, v in draws.items()})
        assert sorted(tex) == sorted(jex) == ["act", "prev_v"]
        for got, want in ((tq, jq), (tqd, jqd), *((tex[k], jex[k]) for k in jex)):
            assert got.dtype == torch.float32 and got.shape == want.shape
            np.testing.assert_array_less(np.abs(got.numpy() - want),
                                         STEP_TOL * (1 + np.abs(want)))
    r = np.random.default_rng(7)
    q = np.array(jq)
    q[:, 2] -= r.uniform(0.0, 0.3, N).astype(np.float32)
    qd = r.normal(0.0, 1.0, jqd.shape).astype(np.float32)
    ex = {k: (v + r.normal(0.0, 0.3, v.shape)).astype(np.float32) for k, v in jex.items()}
    act = r.uniform(-1, 1, (N, tenv.model.nu)).astype(np.float32)
    return jenvs, tenvs, (q, qd, act, ex)


def _assert_obs_and_reward(tenv, args, jobs, jrew):
    q, qd, act = (torch.as_tensor(x) for x in args[:3])
    ex = {k: torch.as_tensor(v) for k, v in args[3].items()}
    tobs = tenv.observe_dmc(q, qd, ex)
    trew = tenv.reward_dmc(q, qd, act, ex)
    assert sorted(tobs) == sorted(jobs)
    for k, v in jobs.items():
        assert tobs[k].dtype == torch.float32 and tobs[k].shape == v.shape, k
        np.testing.assert_array_less(np.abs(tobs[k].numpy() - v), STEP_TOL * (1 + np.abs(v)),
                                     err_msg=k)
    np.testing.assert_array_less(np.abs(trew.numpy() - jrew), STEP_TOL * (1 + np.abs(jrew)))
    # The drop puts feet on the floor: the touch sensors and the reward's
    # support factor see contact forces.
    assert (jobs["touch_sensors"] > 0).any() and (jrew > 0).all()


def test_locomotion_start_obs_and_reward_match_jax():
    """DogStand, DogWalk and DogTrot: from JAX's reset draws the port starts
    where JAX starts; from those starts moved (``_start_and_moved``), its
    obs and reward equal JAX's ``observe_dmc`` and ``reward_dmc`` of each
    task within ``STEP_TOL · (1 + |jax|)``, in one compile.  JAX's
    ``observe_dmc`` reads the task only for fetch, and the three models
    differ in the floor's size alone, so stand's obs is compiled once for
    the three (a compile of JAX's obs costs ~12 s)."""
    tasks = ["DogStand-v1", "DogWalk-v1", "DogTrot-v1"]
    jenvs, tenvs, args = _start_and_moved(tasks)
    jobs, *jrews = _per_env(lambda q, qd, a, e: [jenvs[0].observe_dmc(q, qd, e)] + [
        j.reward_dmc(q, qd, a, e) for j in jenvs], *args)
    for tenv, jrew in zip(tenvs, jrews):
        _assert_obs_and_reward(tenv, args, jobs, jrew)


def test_fetch_start_obs_and_reward_match_jax():
    """DogFetch (the ball's start, its state and the target in the obs, the
    reach and fetch factors of the reward), as the locomotion test."""
    (jenv,), (tenv,), args = _start_and_moved(["DogFetch-v1"])
    jobs, jrew = _per_env(
        lambda q, qd, a, e: (jenv.observe_dmc(q, qd, e), jenv.reward_dmc(q, qd, a, e)), *args)
    _assert_obs_and_reward(tenv, args, jobs, jrew)


def test_dog_pools_on_the_cpu():
    """``make_spec``, ``make_gymnasium`` and ``make_dm`` of every Dog id on
    the CPU: one step, obs of the spec's shapes, discount 1.0."""
    for task in DOGS:
        spec = envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu")
        act = np.zeros((2, spec.env.model.nu), np.float32)
        gym = envpool_tpu_torch.make_gymnasium(task, num_envs=2, device="cpu")
        gym.reset()
        obs, rew, term, trunc, info = gym.step(act)
        assert obs["joint_angles"].shape == (2, 73) and rew.dtype == np.float32
        ts = envpool_tpu_torch.make_dm(task, num_envs=2, device="cpu").step(act)
        assert ts.observation.touch_sensors.shape == (2, 4) and (ts.discount == 1.0).all()


def test_dog_draws_range_and_distribution():
    env, d = _draws("DogFetch-v1")
    _assert_uniform(d["azimuth"], 0.0, 2 * math.pi)
    _assert_normal(d["v"])
    _assert_uniform(d["act"], -1.0, 1.0)
    _assert_uniform(d["ball_azimuth"], 0.0, 2 * math.pi)
    _assert_uniform(d["height"], 0.0, 3.0)
    _assert_uniform(d["speed"], 0.0, 5.0)
    _assert_normal(d["noise"])
    _assert_uncorrelated(d["azimuth"], d["v"], d["act"][:, :8], d["ball_azimuth"],
                         d["height"], d["speed"], d["noise"])
    q, qd, extras = env.init_state(d)
    torch.testing.assert_close(torch.linalg.vector_norm(q[:, 3:7], dim=1),
                               torch.ones(len(q)))
    torch.testing.assert_close(qd[:, [0, 1, 5]], 2 * d["v"])
    np.testing.assert_array_equal(extras["act"].numpy(), d["act"].numpy())
    ball = q[:, env._ball_qadr:env._ball_qadr + 3].numpy()
    np.testing.assert_allclose(np.linalg.norm(ball[:, :2], axis=1), 0.75 * env._floor_r,
                               rtol=1e-5)
    np.testing.assert_allclose(qd[:, env._ball_dadr + 2].numpy() ** 2 / (2 * 9.81),
                               d["height"].numpy(), rtol=1e-4, atol=1e-6)
