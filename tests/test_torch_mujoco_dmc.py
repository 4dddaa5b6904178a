"""The port's dm_control suite tasks against the JAX package.

Both engines step from one JAX pool state (``envpool_tpu_torch.interop``),
the port with the reset draws the JAX task makes from its threefry keys, in
the port's layout (``jax_reset_draws``).  Every step starts the port from
JAX's state again: qpos, qvel, the extras, obs and reward agree within
``STEP_TOL · (1 + |jax|)`` (the physics' one-step bar, see
``tests/test_torch_physics.py``), and the integer and bool fields are equal.
CheetahRun resets from a bank of settled states; its engine test installs
the JAX env's bank in the port.

Each task's JAX engine is built and compiled once, in its engine test; the
humanoids take the longest and are in
``tests/test_torch_mujoco_dmc_humanoid.py``.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu.core.engine import Engine as JaxEngine
from envpool_tpu.core.registry import registry as jax_registry
from envpool_tpu.envs.mujoco_dmc import rewards as jax_rewards
from envpool_tpu.envs.mujoco_dmc.tasks import CheetahEnv as JaxCheetahEnv
from envpool_tpu_torch import interop
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine
from envpool_tpu_torch.core.registry import registry as torch_registry
from envpool_tpu_torch.envs.mujoco_dmc import CheetahEnv, rewards
from test_torch_classic import assert_ts_close, host, jax_draws, to_jax

STEP_TOL = 1e-4

# The ids the port registers: all 51 dmc ids.
PORTED = sorted(
    t for t, (path, _, _) in torch_registry.specs.items() if path.endswith(".mujoco_dmc")
)
JAX_DMC = sorted(
    t for t, (path, _, _) in jax_registry.specs.items() if path.endswith(".mujoco_dmc")
)


def _uniform(key, shape, lo, hi):
    return jax.random.uniform(key, shape, jnp.float32, lo, hi)


def _joints(jenv, key):
    """JAX's ``randomize_joints`` as the port's ``[nj]`` joint values."""
    return jenv.randomize_joints(key)[np.asarray(jenv.model.jnt_qposadr)]


def _cartpole(jenv, sub):
    k1, k2, k3, k4 = jax.random.split(sub, 4)
    nq, nv = jenv.model.nq, jenv.model.nv
    if jenv._swing_up:
        qpos = jnp.concatenate([
            jax.random.normal(k1)[None], jax.random.normal(k2)[None],
            jax.random.normal(k4, (nq - 2,), jnp.float32),
        ])
    else:
        qpos = jnp.concatenate([
            _uniform(k1, (), -0.1, 0.1)[None], _uniform(k2, (nq - 1,), -0.034, 0.034)
        ])
    return {"qpos": qpos, "qvel": jax.random.normal(k3, (nv,), jnp.float32)}


def _reacher(jenv, sub):
    k1, k2, k3 = jax.random.split(sub, 3)
    return {
        "joints": _joints(jenv, k1),
        "angle": _uniform(k2, (), 0.0, 2 * jnp.pi),
        "radius": _uniform(k3, (), 0.05, 0.20),
    }


def _acrobot(jenv, sub):
    k1, k2 = jax.random.split(sub)
    return {"angles": jnp.stack([_uniform(k, (), -jnp.pi, jnp.pi) for k in (k1, k2)])}


def _swimmer(jenv, sub):
    k1, k2, k3 = jax.random.split(sub, 3)
    return {
        "joints": _joints(jenv, k1),
        "close": jax.random.uniform(k2),
        "target": _uniform(k3, (2,), -1.0, 1.0),
    }


def _point_mass(jenv, sub):
    """JAX's joints, first direction and the candidates its rejection loop
    draws for the second direction (the first that passes is JAX's pick)."""
    k1, k2 = jax.random.split(sub)
    out = {"joints": _joints(jenv, k1)}
    if jenv.task == "hard":
        ka, kb = jax.random.split(k2)
        kb, sub0 = jax.random.split(kb)
        cands = [jax.random.normal(sub0, (2,), jnp.float32)]
        for _ in range(15):
            kb, s = jax.random.split(kb)
            cands.append(jax.random.normal(s, (2,), jnp.float32))
        out.update(dir1=jax.random.normal(ka, (2,), jnp.float32), dir2=jnp.stack(cands))
    return out


def _ball_in_cup(jenv, sub):
    kx, kz = jax.random.split(sub)
    return {"ball": jnp.stack([_uniform(kx, (), -0.2, 0.2), _uniform(kz, (), 0.2, 0.5)])}


def _fish(jenv, sub):
    kq, kj, kt = jax.random.split(sub, 3)
    return {
        "quat": jax.random.normal(kq, (4,), jnp.float32),
        "joints": _uniform(kj, (7,), -0.2, 0.2),
        "target": jax.random.uniform(kt, (3,), jnp.float32, jnp.asarray([-0.4, -0.4, 0.1]),
                                     jnp.asarray([0.4, 0.4, 0.3])),
    }


def _finger(jenv, sub):
    k1, k2 = jax.random.split(sub)
    return {"joints": _joints(jenv, k1), "angle": _uniform(k2, (), -jnp.pi, jnp.pi)}


def _quadruped(jenv, sub):
    kq, kb, _ = jax.random.split(sub, 3)
    if jenv.task != "fetch":
        return {"quat": jax.random.normal(kq, (4,), jnp.float32)}
    k1, k2, _ = jax.random.split(kq, 3)
    k4, _ = jax.random.split(kb)
    spawn = 0.5 * jenv._terrain_or_floor()
    return {"azimuth": _uniform(k1, (), 0, 2 * jnp.pi), "xy": _uniform(k2, (2,), -spawn, spawn),
            "ball_xy": _uniform(k4, (2,), -spawn, spawn)}


def _manipulator(jenv, sub):
    """JAX's unit draws: its target angle reuses the draw of the target's x
    or z, and the object's angle and speed share one draw."""
    ka, kt1, kt2, kc, ko1, ko2, kv = jax.random.split(sub, 7)
    u = jax.random.uniform
    return {"arm": u(ka, (8,)), "target": jnp.stack([u(kt1), u(kt2)]), "mode": u(kc),
            "object": jnp.stack([u(ko1), u(ko2), u(kv)])}


def _stacker(jenv, sub):
    ka, kh, kx, kb = jax.random.split(sub, 4)
    boxes = []
    for kbox in jax.random.split(kb, jenv._n_boxes):
        k1, k2, k3 = jax.random.split(kbox, 3)
        boxes.append(jnp.stack([_uniform(k1, (), 0.1, 0.3), _uniform(k2, (), 0.0, 0.7),
                                _uniform(k3, (), 0, 2 * jnp.pi)]))
    return {"arm": jax.random.uniform(ka, (8,)),
            "height": jax.random.randint(kh, (), 0, jenv._n_boxes),
            "target_x": _uniform(kx, (), -0.37, 0.37), "boxes": jnp.stack(boxes)}


def _dog(jenv, sub):
    ka, kv, kact, kb = jax.random.split(sub, 4)
    draws = {"azimuth": _uniform(ka, (), 0, 2 * jnp.pi),
             "v": jax.random.normal(kv, (3,), jnp.float32),
             "act": _uniform(kact, (jenv.model.nu,), jnp.asarray(jenv._act_lo),
                             jnp.asarray(jenv._act_hi))}
    if jenv.task == "fetch":
        k1, k2, k3, k4 = jax.random.split(kb, 4)
        draws.update(ball_azimuth=_uniform(k1, (), 0, 2 * jnp.pi),
                     height=_uniform(k2, (), 0.0, 3.0), speed=_uniform(k3, (), 0.0, 5.0),
                     noise=jax.random.normal(k4, (2,), jnp.float32))
    return draws


# JAX's reset draws of each task class from its reset subkey, in the
# port's draw layout.
_DRAWS = {
    "PointMassEnv": _point_mass,
    "BallInCupEnv": _ball_in_cup,
    "FishEnv": _fish,
    "LqrEnv": lambda jenv, sub: {"unit": jax.random.normal(sub, (jenv.model.nq,), jnp.float32)},
    "FingerEnv": _finger,
    "QuadrupedEnv": _quadruped,
    "ManipulatorEnv": _manipulator,
    "StackerEnv": _stacker,
    "DogEnv": _dog,
    "CheetahEnv": lambda jenv, sub: {"index": jax.random.randint(sub, (), 0, jenv._BANK)},
    "PendulumEnv": lambda jenv, sub: {"angle": _uniform(sub, (), -jnp.pi, jnp.pi)},
    "CartpoleEnv": _cartpole,
    "DmcReacherEnv": _reacher,
    "DmcAcrobotEnv": _acrobot,
    "SwimmerEnv": _swimmer,
}


def jax_reset_draws(jenv):
    """``one_reset(sub)``: JAX's reset draws of ``jenv`` in the port's layout
    (``randomize_joints`` alone for walker, hopper and the humanoids)."""
    fn = _DRAWS.get(type(jenv).__name__, lambda jenv, sub: {"joints": _joints(jenv, sub)})
    return lambda sub: fn(jenv, sub)


@functools.cache
def jax_env(task, n, **cfg):
    """One JAX env per task and config (the JAX cheetah settles its bank
    of 256 states when it is made: ~7 s on a CPU).  Made without its
    ``EnvSpec``, whose shapes trace the env's obs once more (~7-19 s for the
    dog)."""
    return jax_registry._env(task, num_envs=n, seed=3, **cfg)


class DmcPair:
    """A JAX engine and a port engine over the same dmc task and config,
    the port with JAX's reset draws; the port's CheetahRun resets from the
    JAX env's bank."""

    def __init__(self, task, n, **cfg):
        jenv = jax_env(task, n, **cfg)
        self.jeng = JaxEngine(jenv)
        self.tenv = envpool_tpu_torch.make_spec(
            task, num_envs=n, seed=3, device="cpu", **cfg
        ).env
        self.teng = Engine(self.tenv)
        self.draws = jax_draws(jax_reset_draws(jenv))
        if isinstance(jenv, JaxCheetahEnv):
            self.tenv.install_bank(*(torch.as_tensor(np.asarray(b)) for b in jenv._settled_bank))

    def step(self, tree, action):
        """One step of both engines from the host pool state ``tree``:
        ``(jax tree after, jax timestep, port timestep, port tree after)``."""
        draws = self.draws(tree["key"])
        self.tenv.reset_draws = lambda sub: draws
        jps, jts = self.jeng.step(to_jax(tree), {"action": jnp.asarray(action)})
        tps = interop.pool_state_from_numpy(tree, "cpu")
        tps, tts = self.teng.step(tps, {"action": torch.as_tensor(action)})
        return host(jps), jax.device_get(jts), tts, interop.pool_state_to_numpy(tps)


def assert_state_close(jstate, tstate, tol):
    """Env states equal leaf for leaf: floats within ``tol·(1 + |jax|)``."""
    if isinstance(jstate, dict):
        assert set(jstate) == set(tstate)
        for k in jstate:
            assert_state_close(jstate[k], tstate[k], tol)
        return
    assert tstate.dtype == jstate.dtype and tstate.shape == jstate.shape
    np.testing.assert_array_less(np.abs(tstate - jstate), tol * (1 + np.abs(jstate)) + 1e-30)


def check_step_matches_jax(task, n=4, steps=6, episode=3, qvel_scale=1.0):
    """``steps`` steps of ``n`` envs from JAX's states, each episode cut at
    ``episode`` steps, with a random qvel after the first reset."""
    pair = DmcPair(task, n, max_episode_steps=episode)
    spec = pair.tenv.action_spec()["action"]
    r = np.random.default_rng(len(task))
    acts = r.uniform(-1.5, 1.5, (steps + 1, n, *spec.shape)).astype(np.float32)
    tree = host(pair.jeng.step(pair.jeng.init(), {"action": jnp.asarray(acts[0])})[0])
    st = tree["env_state"]
    st["qvel"][:] = r.normal(0.0, qvel_scale, st["qvel"].shape)
    reset = np.zeros(n, bool)
    for t in range(1, steps + 1):
        tree, jts, tts, ttree = pair.step(tree, acts[t])
        assert_ts_close(jts, tts, STEP_TOL)
        assert_state_close(tree["env_state"], ttree["env_state"], STEP_TOL)
        np.testing.assert_array_equal(jts["discount"], np.ones(n, np.float32))
        reset |= jts["step_type"] == 0
    assert reset.all()  # every env ended an episode and started again


ENGINE_TASKS = [
    "AcrobotSwingupSparse-v1",
    "CartpoleSwingup-v1",
    "CartpoleThreePoles-v1",
    "CheetahRun-v1",
    "HopperHop-v1",
    "PendulumSwingup-v1",
    "ReacherHard-v1",
    "SwimmerSwimmer6-v1",
    "WalkerWalk-v1",
]


@pytest.mark.parametrize("task", ENGINE_TASKS)
def test_step_matches_jax_across_auto_reset(task):
    check_step_matches_jax(task)


# -- rewards.tolerance ---------------------------------------------------------

SIGMOIDS = ["gaussian", "hyperbolic", "long_tail", "reciprocal", "cosine",
            "linear", "quadratic", "tanh_squared"]


@pytest.mark.parametrize("sigmoid", SIGMOIDS)
@pytest.mark.parametrize(
    "bounds, margin, value_at_margin",
    [((0.0, 0.0), 1.0, 0.1), ((-0.5, 1.0), 2.0, 0.5), ((1.0, float("inf")), 1.0, 0.2),
     ((-0.25, 0.25), 0.0, 0.1)],
    ids=["point", "interval", "half-line", "no-margin"],
)
def test_tolerance_matches_jax(sigmoid, bounds, margin, value_at_margin):
    x = np.linspace(-4, 4, 161, dtype=np.float32)
    x = np.concatenate([x, np.float32([bounds[0], bounds[1] if np.isfinite(bounds[1]) else 9.0])])
    want = np.asarray(jax_rewards.tolerance(jnp.asarray(x), bounds, margin, sigmoid, value_at_margin))
    got = rewards.tolerance(torch.as_tensor(x), bounds, margin, sigmoid, value_at_margin)
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "kwargs",
    [dict(bounds=(1.0, 0.0)), dict(margin=-1.0),
     dict(margin=1.0, sigmoid="gaussian", value_at_margin=0.0),
     dict(margin=1.0, sigmoid="long_tail", value_at_margin=1.0),
     dict(margin=1.0, sigmoid="linear", value_at_margin=1.0),
     dict(margin=1.0, sigmoid="quadratic", value_at_margin=-0.1),
     dict(margin=1.0, sigmoid="sigmoid")],
    ids=["bounds", "margin", "gaussian-0", "long_tail-1", "linear-1", "quadratic-neg",
         "unknown"],
)
def test_tolerance_raises_as_jax(kwargs):
    x = np.zeros(3, np.float32)
    with pytest.raises(ValueError) as jerr:
        jax_rewards.tolerance(jnp.asarray(x), **kwargs)
    with pytest.raises(ValueError) as terr:
        rewards.tolerance(torch.as_tensor(x), **kwargs)
    assert str(terr.value) == str(jerr.value)


# -- registration and specs ----------------------------------------------------


def test_ported_ids():
    assert PORTED == sorted([
        "AcrobotSwingup-v1", "AcrobotSwingupSparse-v1", "PendulumSwingup-v1",
        "CartpoleBalance-v1", "CartpoleBalanceSparse-v1", "CartpoleSwingup-v1",
        "CartpoleSwingupSparse-v1", "CartpoleTwoPoles-v1", "CartpoleThreePoles-v1",
        "CheetahRun-v1", "WalkerStand-v1", "WalkerWalk-v1", "WalkerRun-v1",
        "HopperStand-v1", "HopperHop-v1", "ReacherEasy-v1", "ReacherHard-v1",
        "SwimmerSwimmer6-v1", "SwimmerSwimmer15-v1", "HumanoidStand-v1",
        "HumanoidWalk-v1", "HumanoidRun-v1", "HumanoidRunPureState-v1",
        "HumanoidCMUStand-v1", "HumanoidCMUWalk-v1", "HumanoidCMURun-v1",
        "PointMassEasy-v1", "PointMassHard-v1", "BallInCupCatch-v1", "FishUpright-v1",
        "FishSwim-v1", "LqrLqr21-v1", "LqrLqr62-v1", "FingerSpin-v1", "FingerTurnEasy-v1",
        "FingerTurnHard-v1", "QuadrupedWalk-v1", "QuadrupedRun-v1", "QuadrupedEscape-v1",
        "QuadrupedFetch-v1", "ManipulatorBringBall-v1", "ManipulatorBringPeg-v1",
        "ManipulatorInsertBall-v1", "ManipulatorInsertPeg-v1", "StackerStack2-v1",
        "StackerStack4-v1", "DogStand-v1", "DogWalk-v1", "DogTrot-v1", "DogRun-v1",
        "DogFetch-v1",
    ])
    assert PORTED == JAX_DMC and len(JAX_DMC) == 51
    assert set(PORTED) <= set(envpool_tpu_torch.list_all_envs())


# Every dmc id is ported: the ids of the next physics family (playground),
# of myosuite, of box2d and of jumanji are not.
@pytest.mark.parametrize(
    "task", ["BarkourJoystick-v1", "myoFingerPoseFixed-v0", "LunarLander-v3", "Snake-v1",
             "ApolloJoystickFlatTerrain-v1"])
def test_unported_id_raises(task):
    assert task in jax_registry.specs
    with pytest.raises(ValueError, match="is not supported"):
        envpool_tpu_torch.make_spec(task, device="cpu")


# The Dog ids' specs are held in tests/test_torch_mujoco_dmc_dog.py, beside
# JAX's dog obs, which that file computes once (a JAX dog spec traces the
# dog's obs: 7-19 s each).
@pytest.mark.parametrize("task", [t for t in PORTED if not t.startswith("Dog")])
def test_spec_matches_jax(task, monkeypatch):
    # A spec needs no settled states: skip the JAX cheetah's bank.
    monkeypatch.setattr(JaxCheetahEnv, "_build_settled_bank", lambda self: None)
    jspec = envpool_tpu.make_spec(task)
    tspec = envpool_tpu_torch.make_spec(task, device="cpu")
    jenv, tenv = jspec.env, tspec.env
    assert dict(tenv.config, device="cuda") == dict(jenv.config, device="cuda")
    assert tenv.max_episode_steps == jenv.max_episode_steps == 1000
    assert (tenv.frame_skip, tenv.substeps, tenv.contact) == (
        jenv.n_sub_steps, jenv.substeps, tuple(jenv.contact)[:len(tenv.contact)])
    assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec)
    assert list(tspec.state_array_spec) == list(jspec.state_array_spec)
    for k, js in jspec.state_array_spec.items():
        ts = tspec.state_array_spec[k]
        assert (ts.shape, ts.dtype) == (js.shape, js.dtype), k
    obs = list(jenv.state_spec())
    assert obs and all(k.startswith("obs:") for k in obs)
    assert list(tenv.state_spec()) == obs


@pytest.mark.parametrize("n_links", [6, 15])
def test_swimmer_constants_are_its_geoms(n_links):
    """Swimmer's nose offset and body and target height, committed beside
    its model, are those the JAX env reads from dm_control's model."""
    import mujoco
    from dm_control.suite import common, swimmer

    from envpool_tpu_torch.physics.model import load_constants

    m = mujoco.MjModel.from_xml_string(swimmer._make_model(n_links).decode(), common.ASSETS)
    nose = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, "nose")
    target = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_GEOM, "target")
    c = load_constants(f"dmc:swimmer_{n_links}")
    np.testing.assert_array_equal(c["nose_offset"], m.geom_pos[nose])
    assert int(c["nose_body"]) == int(m.geom_bodyid[nose])
    assert float(c["target_z"]) == float(m.geom_pos[target][2])


def test_tasks_run_without_mujoco_or_dm_control(monkeypatch):
    """The dm_control tasks read their committed models: no ``mujoco``,
    ``dm_control`` or ``gymnasium`` needed to make and step them."""
    import sys

    from envpool_tpu_torch.physics.model import load_model

    for name in ("mujoco", "dm_control", "gymnasium"):
        monkeypatch.setitem(sys.modules, name, None)
    load_model.cache_clear()
    try:
        for task in ("SwimmerSwimmer15-v1", "HopperHop-v1", "QuadrupedEscape-v1",
                     "ManipulatorInsertPeg-v1"):
            eng = Engine(envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu").env)
            ps, ts = eng.step(eng.init(), eng.zero_action())
            assert bool(ts["step_type"].eq(0).all()) and bool(torch.isfinite(ps.env_state["qpos"]).all())
    finally:
        load_model.cache_clear()


# -- CheetahRun's bank of settled states ---------------------------------------


def test_cheetah_settles_jax_bank_start_states():
    """The port settles JAX's 256 start states (its joint draws from
    ``PRNGKey(0xC0FFEE)``) for 200 steps at zero control and meets JAX's
    bank.  200 steps with contacts carry float32's rounding far on some
    states in either package: JAX's own bank lies as far from a float64
    settle as the port's (99th percentiles ~0.19 of 1 + |x| on this CPU).
    So the port is held to JAX within 2e-3 · (1 + |x|) wherever both
    float32 settles stay within 1e-3 of float64 (at least 80% of the
    states), and its distances to float64 match JAX's in distribution."""
    jenv = jax_env("CheetahRun-v1", 4, max_episode_steps=3)
    keys = jax.random.split(jax.random.PRNGKey(0xC0FFEE), jenv._BANK)
    q0 = torch.as_tensor(np.array(jax.vmap(jenv.randomize_joints)(keys)))
    tenv = envpool_tpu_torch.make_spec("CheetahRun-v1", device="cpu").env
    q, v = tenv.settle(q0)
    q64, v64 = tenv.settle(q0.double())
    jq, jv = (torch.as_tensor(np.array(b)) for b in jenv._settled_bank)

    def dist(a, b):
        return torch.cat([((x.double() - y.double()).abs() / (1 + y.double().abs()))
                          for x, y in zip(a, b)], 1).amax(1)

    port64, jax64 = dist((q, v), (q64, v64)), dist((jq, jv), (q64, v64))
    stable = (port64 < 1e-3) & (jax64 < 1e-3)
    assert float(stable.double().mean()) >= 0.8
    assert float(dist((q, v), (jq, jv))[stable].max()) <= 2e-3
    qs = torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64)
    assert bool((torch.quantile(port64, qs) <= 2 * torch.quantile(jax64, qs) + 1e-5).all())
    assert bool(torch.isfinite(q).all() and torch.isfinite(v).all())


def test_cheetah_bank_is_committed_and_can_be_installed():
    """The committed bank is the port's start states (joints drawn from
    seeds ``BANK_SEED + i``) settled in float64 on the CPU and rounded to
    float32 at load, on every device alike; a reset gathers its rows, and
    ``install_bank`` replaces it."""
    env = envpool_tpu_torch.make_spec("CheetahRun-v1", num_envs=8, device="cpu").env
    q, v = env.bank
    assert q.shape == (256, 9) and v.shape == (256, 9) and q.dtype == v.dtype == torch.float32
    keys = rng.seed_keys(CheetahEnv.BANK_SEED + np.arange(256), torch.device("cpu"))
    start = env.joint_qpos(env.randomize_joints(rng.split(keys)[1]))
    torch.testing.assert_close(env.start_states(), start, rtol=0, atol=0)
    # float64's own rounding, carried 200 steps, stays far inside float32's.
    q64, v64 = env.settle(start.double())
    torch.testing.assert_close(q, q64.float(), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(v, v64.float(), rtol=1e-6, atol=1e-6)
    st, obs = env.reset_env({"index": torch.tensor([7, 255, 0])})
    assert torch.equal(st["qpos"], q[[7, 255, 0]]) and torch.equal(st["qvel"], v[[7, 255, 0]])
    bank = (torch.arange(256.0)[:, None].expand(256, 9), torch.zeros(256, 9))
    env.install_bank(*bank)
    st, obs = env.reset_env({"index": torch.tensor([3, 255, 0])})
    np.testing.assert_array_equal(st["qpos"][:, 0].numpy(), [3.0, 255.0, 0.0])
    np.testing.assert_array_equal(obs["obs:position"].numpy(), bank[0][[3, 255, 0], 1:].numpy())


# -- the port's own reset draws ------------------------------------------------


def _draws(task, n=20000):
    env = envpool_tpu_torch.make_spec(task, device="cpu").env
    keys = rng.seed_keys(np.arange(n), torch.device("cpu"))
    return env, env.reset_draws(rng.split(keys)[1])


def _assert_uniform(x, lo, hi):
    x = np.asarray(x).ravel()
    assert x.dtype == np.float32 and lo <= x.min() and x.max() < hi
    counts = np.histogram(x, bins=10, range=(lo, hi))[0]
    expect = x.size / 10
    assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))


def _assert_normal(x):
    x = np.asarray(x, np.float64).ravel()
    se = 1 / math.sqrt(x.size)
    assert abs(x.mean()) < 5 * se and abs(x.var() - 1) < 5 * math.sqrt(2) * se


def _assert_uncorrelated(*columns):
    x = np.concatenate([np.asarray(c).reshape(len(c), -1) for c in columns], 1)
    corr = np.corrcoef(x.T)
    assert np.abs(corr - np.eye(x.shape[1])).max() < 5 / math.sqrt(len(x))


@pytest.mark.parametrize(
    "task", ["WalkerWalk-v1", "HopperHop-v1", "ReacherHard-v1", "SwimmerSwimmer6-v1",
             "HumanoidCMUStand-v1"]
)
def test_randomize_joints_range_and_distribution(task):
    """Limited hinges and slides uniform in their range, unlimited hinges
    in [-pi, pi); slides without limits and free joints keep qpos0."""
    from envpool_tpu_torch.physics.model import FREE, HINGE, SLIDE

    env, d = _draws(task)
    m = env.model
    joints = d["joints"].numpy()
    qpos, _, _ = env.init_state(d)
    kept = np.ones(m.nq, bool)
    cols = []
    for j, jtype in enumerate(m.jnt_type):
        adr = int(m.jnt_qposadr[j])
        if jtype in (SLIDE, HINGE) and (m.jnt_limited[j] or jtype == HINGE):
            lo, hi = m.jnt_range[j] if m.jnt_limited[j] else (-math.pi, math.pi)
            _assert_uniform(joints[:, j], np.float32(lo), np.float32(hi))
            np.testing.assert_array_equal(qpos[:, adr].numpy(), joints[:, j])
            kept[adr] = False
            cols.append(joints[:, j])
        else:
            assert jtype == FREE or not m.jnt_limited[j]
    np.testing.assert_array_equal(
        qpos[:, kept].numpy(), np.broadcast_to(m.qpos0[kept].astype(np.float32), (20000, kept.sum())))
    _assert_uncorrelated(*cols[:12])


def test_task_draws_range_and_distribution():
    env, d = _draws("CheetahRun-v1")
    idx = d["index"].numpy()
    assert idx.dtype == np.int32 and idx.min() == 0 and idx.max() == 255
    counts = np.bincount(idx, minlength=256)
    assert np.abs(counts - 20000 / 256).max() < 5 * math.sqrt(20000 / 256)

    _, d = _draws("PendulumSwingup-v1")
    _assert_uniform(d["angle"], -math.pi, math.pi)

    _, d = _draws("AcrobotSwingup-v1")
    _assert_uniform(d["angles"], -math.pi, math.pi)
    _assert_uncorrelated(d["angles"][:, 0], d["angles"][:, 1])

    env, d = _draws("CartpoleThreePoles-v1")
    _assert_normal(d["qpos"])
    _assert_normal(d["qvel"])
    _assert_uncorrelated(d["qpos"], d["qvel"])
    qpos, qvel, _ = env.init_state(d)
    torch.testing.assert_close(qpos[:, 1], math.pi + 0.01 * d["qpos"][:, 1])
    torch.testing.assert_close(qpos[:, 2:], 0.1 * d["qpos"][:, 2:])
    env, d = _draws("CartpoleBalance-v1")
    _assert_uniform(d["qpos"][:, 0], -0.1, 0.1)
    _assert_uniform(d["qpos"][:, 1], -0.034, 0.034)
    _assert_uncorrelated(d["qpos"], d["qvel"])

    env, d = _draws("ReacherHard-v1")
    _assert_uniform(d["angle"], 0.0, 2 * math.pi)
    _assert_uniform(d["radius"], 0.05, 0.20)
    _assert_uncorrelated(d["joints"], d["angle"], d["radius"])
    _, _, extras = env.init_state(d)
    radius = np.linalg.norm(extras["target"].numpy(), axis=1)
    np.testing.assert_allclose(radius, d["radius"].numpy(), rtol=1e-6)

    env, d = _draws("SwimmerSwimmer6-v1")
    _assert_uniform(d["close"], 0.0, 1.0)
    _assert_uniform(d["target"], -1.0, 1.0)
    _assert_uncorrelated(d["joints"][:, 3:], d["close"], d["target"])
    _, _, extras = env.init_state(d)
    near = np.abs(extras["target"].numpy()).max(1) < 0.3
    assert abs(near.mean() - (0.2 + 0.8 * 0.15**2)) < 0.015


def test_physics_dtype():
    """The models conditioned worse than ``COND_FLOAT64`` at ``qpos0`` step
    in float64 and round once, and their state stays float32: swimmer15
    (a float32 env step lands past the one-step bar from float64 on most of
    its states), fish (8.9e5), manipulator (3.7e5-6.1e5: a body of 1e-6 kg
    in the hand), stacker (1.2e6) and dog (1.07e5, fetch's 5.29e5)."""
    from envpool_tpu_torch.envs.mujoco_dmc.base import COND_FLOAT64
    from envpool_tpu_torch.physics.dynamics import step

    wide = {}
    for task in PORTED:
        env = envpool_tpu_torch.make_spec(task, device="cpu").env
        assert (env.physics_dtype is torch.float64) == (env.mass_condition() > COND_FLOAT64)
        wide[task] = env.physics_dtype
    assert [t for t, d in wide.items() if d is not None] == [
        "DogFetch-v1", "DogRun-v1", "DogStand-v1", "DogTrot-v1", "DogWalk-v1",
        "FishSwim-v1", "FishUpright-v1", "ManipulatorBringBall-v1", "ManipulatorBringPeg-v1",
        "ManipulatorInsertBall-v1", "ManipulatorInsertPeg-v1", "StackerStack2-v1",
        "StackerStack4-v1", "SwimmerSwimmer15-v1"]
    for task, f32_median in (("SwimmerSwimmer6-v1", (0, 1e-4)), ("SwimmerSwimmer15-v1", (1e-4, 1))):
        env, d = _draws(task, n=32)
        q, _, extras = env.init_state(d)
        qd = 0.3 * torch.randn(32, env.model.nv, generator=torch.Generator().manual_seed(0))
        act = torch.rand(32, env.model.nu, generator=torch.Generator().manual_seed(1)) * 2 - 1

        def dist(out):
            return ((out.double() - ref).abs() / (1 + ref.abs())).amax(1).median()

        ref = torch.cat(step(env.model, q.double(), qd.double(), act.double(), 1,
                             env.contact, env.frame_skip), 1)
        f32 = dist(torch.cat(step(env.model, q, qd, act, 1, env.contact, env.frame_skip), 1))
        assert f32_median[0] < f32 < f32_median[1], task
        out = env.physics_step({"qpos": q, "qvel": qd, "extras": extras}, act)
        assert all(x.dtype == torch.float32 for x in out)
        assert dist(torch.cat(out, 1)) < (1e-6 if wide[task] else f32_median[1])


def test_swimmer15_float64_step_matches_jax_x64():
    """SwimmerSwimmer15's physics steps in float64 in the port and in
    float32 in JAX.  The port's env step is held to JAX's own physics step
    run in float64 (``jax.enable_x64``) on the same inputs and rounded to
    float32 once, as the port rounds it.  (A float32 step lands past the
    one-step bar from there on most states: ``test_physics_dtype``.)"""
    from envpool_tpu.physics import dynamics as jdyn

    jenv = jax_env("SwimmerSwimmer15-v1", 16)
    env, d = _draws("SwimmerSwimmer15-v1", n=16)
    q, _, extras = env.init_state(d)
    gen = torch.Generator().manual_seed(0)
    qd = 0.3 * torch.randn(16, env.model.nv, generator=gen)
    act = torch.rand(16, env.model.nu, generator=gen) * 2 - 1
    assert env.physics_dtype is torch.float64 and env.frame_skip == jenv.n_sub_steps

    fn = jax.vmap(lambda q, qd, u: jdyn.step(
        jenv.model, q, qd, u, jenv.substeps, jenv.contact, jenv.n_sub_steps))
    with jax.enable_x64(True):
        ref = np.concatenate([np.asarray(x) for x in jax.jit(fn)(
            *(np.asarray(x, np.float64) for x in (q, qd, act)))], 1)
    assert ref.dtype == np.float64
    ref = torch.as_tensor(ref)
    got = torch.cat(env.physics_step({"qpos": q, "qvel": qd, "extras": extras}, act), 1)
    assert got.dtype == torch.float32
    err = ((got.double() - ref).abs() / (1 + ref.abs())).amax(1)
    assert float(err.max()) <= 1e-6  # float32's rounding of the same float64 step
