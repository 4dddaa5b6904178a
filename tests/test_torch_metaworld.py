"""The port's MetaWorld family against the JAX package: the registry of
the 50 ids, every reward law on the same seeded inputs, and engine steps
of one task per category, the two-body tasks and peg-insert-side.

The steps use ``test_torch_robotics.py``'s harness: both engines step
from one JAX pool state, JAX's reset draws (the object's and the goal's
``uniform`` between vectors) recorded inside its jitted step and handed to
the port by position, every step held by the rule of
``envpool_tpu_torch/ops/thresholds.py``.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu.core.registry import registry as jax_registry
from envpool_tpu.envs.metaworld import exact_laws as jax_laws
from envpool_tpu.envs.metaworld import sawyer as jax_sawyer
from envpool_tpu_torch.core.registry import registry as torch_registry
from envpool_tpu_torch.envs.metaworld import exact_laws, sawyer
from envpool_tpu_torch.envs.metaworld.tasks import TASKS
from test_torch_robotics import check_rollout

METAWORLD = [t for t, (path, _, _) in jax_registry.specs.items() if path.endswith(".metaworld")]
M = 512


def _context(task, seed):
    """Seeded inputs of a reward law: the object near its spawn (a share of
    it lifted), the tcp at every distance from it (inside the grasp and
    touch radii too), the gripper open and closed, the goal from the
    task's range, the second body near the goal."""
    gen = np.random.default_rng(seed)
    _, lo, hi, glo, ghi, _, _ = TASKS[task]
    glo, ghi = (lo, hi) if glo is None else (glo, ghi)

    def f(x):
        return np.asarray(x, np.float32)

    obj0 = f(gen.uniform(lo, hi, (M, 3)))
    obj = obj0 + f(gen.normal(0, 0.03, (M, 3)))
    obj[: M // 4, 2] += f(gen.uniform(0.0, 0.2, M // 4))
    reach = f(np.exp(gen.uniform(np.log(0.002), np.log(0.3), (M, 1))))
    tcp = obj + reach * f(gen.normal(0, 1, (M, 3))) / np.sqrt(3)
    goal = f(gen.uniform(glo, ghi, (M, 3)))
    goal[: M // 8] = obj[: M // 8] + f(gen.normal(0, 0.02, (M // 8, 3)))
    quat = f(exact_laws.REST_QUAT.get(task, (1.0, 0.0, 0.0, 0.0))) + f(
        gen.normal(0, 0.05, (M, 4)))
    obj2_0 = goal + f(gen.normal(0, 0.1, (M, 3)))
    return {
        "tcp": tcp,
        "grip": f(gen.choice([0.0, 0.2, 0.5, 0.8, 1.0], M)),
        "a": f(gen.uniform(-1, 1, (M, 4))),
        "obj": obj,
        "obj0": obj0,
        "goal": goal,
        "prev_tcp": tcp + f(gen.normal(0, 0.01, (M, 3))),
        "quat": quat,
        "disp_frac": f(gen.uniform(0, 1, M)),
        "obj2": obj2_0 + f(gen.normal(0, 0.05, (M, 3))),
        "obj2_0": obj2_0,
    }


# Where float32 decides (a tolerance whose margin is the small difference
# of two distances turns an ulp into 1e-4 of reward), the port's float32
# value may lie as far from JAX's law in float64 as SPREAD times JAX's own
# float32 value does.
SPREAD = 4.0


def _close(got, want, where, law64=None):
    """Every output within 1e-5 * (1 + |x|) of JAX's; a row that is not
    within SPREAD times JAX's own float32 error of JAX's law evaluated in
    float64 (``law64()``), at most 1% of the rows."""
    bad = np.zeros(len(np.asarray(want[0])), bool)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        bad |= np.abs(g - w) > 1e-5 * (1 + np.abs(w))
    if not bad.any():
        return
    assert law64 is not None, (where, np.flatnonzero(bad)[:5])
    assert bad.sum() <= 0.01 * len(bad), (where, bad.sum())
    want64 = law64()
    for g, w, w64 in zip(got, want, want64):
        g, w, w64 = g.numpy()[bad], np.asarray(w)[bad], np.asarray(w64)[bad]
        err = np.abs(g - w64)
        ok = (err <= 1e-5 * (1 + np.abs(w64))) | (err <= SPREAD * np.abs(w - w64))
        assert ok.all(), (where, np.flatnonzero(bad)[~ok], g[~ok], w[~ok], w64[~ok])


def _in_f64(fn, *args):
    """``fn`` on ``args`` with JAX's float64 on (the laws' inputs promoted)."""
    with jax.enable_x64(True):
        cast = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64), args)
        return jax.device_get(jax.jit(fn)(*cast))


@pytest.mark.parametrize("task", sorted(jax_laws.LAWS))
def test_reward_law_matches_jax(task):
    """Each per-task law of ``exact_laws.py`` on 512 seeded contexts."""
    ctx = _context(task, zlib.crc32(task.encode()))
    want = jax.jit(jax.vmap(jax_laws.LAWS[task]))(ctx)
    got = exact_laws.LAWS[task]({k: torch.as_tensor(v) for k, v in ctx.items()})
    _close(got, want, task, lambda: _in_f64(jax.vmap(jax_laws.LAWS[task]), ctx))
    assert len({float(x) for x in np.asarray(want[0])}) > 1


@pytest.mark.parametrize("task", sorted(jax_sawyer._EXACT_ARTICULATED))
def test_articulated_reward_matches_jax(task):
    """The ten articulated laws of ``_articulated_reward``."""
    c = _context(task, 7)
    args = ("tcp", "grip", "a", "obj", "obj0", "goal")
    want = jax.jit(jax.vmap(functools.partial(jax_sawyer._articulated_reward, task)))(
        *(c[k] for k in args), c["prev_tcp"])
    got = sawyer._articulated_reward(task, *(torch.as_tensor(c[k]) for k in args))
    _close(got, want, task)


@pytest.mark.parametrize("density", ["high", "medium", None])
def test_caging_and_tolerance_match_jax(density):
    """The category laws' caging reward and the tolerance, both sigmoids."""
    c = _context("pick-place-v3", 11)
    kw = dict(obj_radius=0.015, pad_success_thresh=0.05, xz_thresh=0.005,
              object_reach_radius=0.01, density=density)
    want = jax.jit(jax.vmap(lambda t, g, a, o, o0: jax_sawyer._gripper_caging_reward(
        t, g, a, o, o0, **kw)))(c["tcp"], c["grip"], c["a"][:, 3], c["obj"], c["obj0"])
    t = {k: torch.as_tensor(v) for k, v in c.items()}
    got = sawyer.gripper_caging_reward(t["tcp"], t["grip"], t["a"][:, 3], t["obj"], t["obj0"],
                                       **kw)
    _close([got], [want], str(density))
    d = np.linalg.norm(c["tcp"] - c["obj"], axis=1)
    for sig in ("long_tail", "gaussian"):
        want = jax.jit(lambda x, m: jax_sawyer._tolerance_exact(x, 0.05, m, sigmoid=sig))(
            d, d[::-1].copy())
        got = sawyer.tolerance_exact(torch.as_tensor(d), 0.05, torch.as_tensor(d[::-1].copy()),
                                     sigmoid=sig)
        _close([got], [want], sig)


def _steer(t, tree, gen):
    """Toward the object, the gripper closing there, then up and on: grasps,
    pushes, presses and turns as well as free moves."""
    st = tree["env_state"]
    d = st["obj_pos"] - st["tcp"]
    a = np.zeros((len(d), 4), np.float32)
    a[:, :3] = np.clip(d / 0.01, -1, 1)
    close = np.linalg.norm(d, axis=1) < 0.05
    a[:, 3] = np.where(close, 1.0, -1.0)
    a[:, 2] += np.where(close, 0.6, 0.0)
    return (a + 0.3 * gen.standard_normal(a.shape)).clip(-1, 1).astype(np.float32)


@pytest.mark.parametrize("task", [
    "MetaWorld/Reach-v3", "MetaWorld/Push-v3", "MetaWorld/PickPlace-v3",
    "MetaWorld/ButtonPress-v3", "MetaWorld/DoorOpen-v3", "MetaWorld/DrawerOpen-v3",
    "MetaWorld/Hammer-v3", "MetaWorld/StickPush-v3", "MetaWorld/StickPull-v3",
    "MetaWorld/PegInsertSide-v3",
])
def test_step_matches_jax(task, monkeypatch):
    check_rollout(task, monkeypatch, steps=8, episode=6, act=_steer)


def test_every_metaworld_id_is_ported():
    ids = [t for t, (path, _, _) in torch_registry.specs.items() if path.endswith(".metaworld")]
    assert ids == METAWORLD and len(ids) == 50
    assert sorted(torch_registry.specs[t][2]["task_name"] for t in ids) == sorted(TASKS)


def test_config_and_spec_match_jax():
    for task in METAWORLD:
        jspec = envpool_tpu.make_spec(task, num_envs=2)
        tspec = envpool_tpu_torch.make_spec(task, num_envs=2, device="cpu")
        assert dict(tspec.env.config, device="cuda") == dict(jspec.env.config, device="cuda")
        assert tspec.reward_threshold == jspec.reward_threshold, task
        assert repr(tspec.action_array_spec) == repr(jspec.action_array_spec), task
        assert repr(tspec.state_array_spec) == repr(jspec.state_array_spec), task
        jenv, tenv = jspec.env, tspec.env
        assert (tenv.category, tenv.thr, tenv.travel) == (jenv.category, jenv.thr, jenv.travel)


def test_port_draws_within_bounds():
    """The port's own resets: the object and goal within their per-component
    bounds, an articulated task's goal at its travel along the axis."""
    for task in ("MetaWorld/PickPlace-v3", "MetaWorld/DoorOpen-v3", "MetaWorld/BinPicking-v3"):
        pool = envpool_tpu_torch.make(task, env_type="gymnasium", num_envs=4096, seed=2,
                                      device="cpu", numpy_output=False)
        env = pool.engine.env
        st = pool.engine.reset(pool.pool_state, torch.ones(4096, dtype=torch.bool))[0].env_state
        obj = st["obj_pos"].numpy()
        assert (obj >= env.obj_lo).all() and (obj <= env.obj_hi).all()
        span = env.obj_hi - env.obj_lo
        assert ((obj.max(0) - obj.min(0)) >= 0.98 * span).all()
        goal = st["goal"].numpy()
        if env.articulated:
            np.testing.assert_allclose(goal - obj, np.broadcast_to(env._reach, goal.shape),
                                       atol=1e-6)
        else:
            assert (goal >= env.goal_lo).all() and (goal <= env.goal_hi).all()
