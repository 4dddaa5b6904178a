"""The port's second slice of dm_control tasks against the JAX package:
point_mass, ball_in_cup, fish, lqr and finger step for step, every task's
constants, reset draws and lqr's termination; and the helpers of the
quadruped, manipulator and stacker checks
(``tests/test_torch_mujoco_dmc_quadruped.py``,
``tests/test_torch_mujoco_dmc_arm.py``).

The engine check of ``tests/test_torch_mujoco_dmc.py`` (one step from
JAX's state within 1e-4 · (1 + |jax|), integer and bool fields equal,
across an auto-reset, with JAX's reset draws) runs on every variant of the
first five domains.  The stiff domains (quadruped, manipulator, stacker:
contacts at kp 2e4, pairs at 1e4 acting explicitly on fingers of a few
grams, the quadruped starting up to 0.56 m inside the floor, as JAX's
``_drop_height`` puts it) take :func:`check_stiff_step`: float32 decides
some of their steps in either package, so an env past the bar passes only
where a float64 step shows float32 at fault (the rule of the Ant test of
``tests/test_torch_physics.py``): JAX's float32
spread (the farthest that JAX's own float32 steps of the state and of four
copies an ulp away land from JAX's float64 step) exceeds ``STEP_TOL / 2``,
and the port lies within ``max(STEP_TOL, 4 × that spread)`` of the float64
step; its obs and reward, derived from that state, go with it.  Where
JAX's step takes |qvel| past 1e3 (its physics diverges on some manipulator
and stacker states), the port's must too, and the env is counted apart.
At least half of the stepped envs must hold the bar outright.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu
import envpool_tpu_torch
from envpool_tpu.physics import dynamics as jdyn
from envpool_tpu.physics.kinematics import quat2mat as jax_quat2mat
from envpool_tpu_torch.core import rng
from envpool_tpu_torch.core.engine import Engine, _tree_map
from envpool_tpu_torch.physics.kinematics import model_tensors
from envpool_tpu_torch.physics.model import load_model
from test_torch_classic import host, to_jax
from test_torch_mujoco_dmc import STEP_TOL, DmcPair, check_step_matches_jax, jax_env, jax_reset_draws

DIVERGED = 1e3  # |qvel| past which a step has left the physics


def _flat(tree, n):
    """``[n, m]`` float64 of every float leaf of a state or timestep."""
    leaves = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        else:
            a = np.asarray(x)
            if np.issubdtype(a.dtype, np.floating):
                leaves.append(a.reshape(n, -1).astype(np.float64))

    walk(tree)
    return np.concatenate(leaves, 1)


def _rel(a, b):
    return (np.abs(a - b) / (1 + np.abs(b))).max(1)


def _exact(jtree, ttree, n, rows):
    """Integer and bool leaves equal on ``rows``."""
    if isinstance(jtree, dict):
        for k in jtree:
            _exact(jtree[k], ttree[k], n, rows)
        return
    a, b = np.asarray(jtree), np.asarray(ttree)
    assert a.dtype == b.dtype and a.shape == b.shape
    if not np.issubdtype(a.dtype, np.floating):
        np.testing.assert_array_equal(b.reshape(n, -1)[rows], a.reshape(n, -1)[rows])


def _moved(tree, r):
    """``tree`` with qpos and qvel each moved up or down by an ulp."""
    st = dict(tree["env_state"])
    for k in ("qpos", "qvel"):
        x = np.asarray(st[k])
        st[k] = (x * (1 + r.choice([-1.0, 1.0], x.shape) * 2.0**-23)).astype(np.float32)
    return dict(tree, env_state=st)


def check_stiff_step(task, n=4, steps=6, episode=3):
    pair = DmcPair(task, n, max_episode_steps=episode)
    jenv, tenv = pair.jeng.env, pair.tenv
    nq = tenv.model.nq
    spec = tenv.action_spec()["action"]
    r = np.random.default_rng(len(task))
    acts = r.uniform(-1.5, 1.5, (steps + 1, n, *spec.shape)).astype(np.float32)
    tree = host(pair.jeng.step(pair.jeng.init(), {"action": jnp.asarray(acts[0])})[0])
    tree["env_state"]["qvel"][:] = r.normal(0.0, 1.0, tree["env_state"]["qvel"].shape)
    f64 = None
    counts = {"held": 0, "float32": 0, "diverged": 0, "stepped": 0}
    reset = np.zeros(n, bool)

    def state(tr, rows):
        return np.concatenate([np.asarray(tr["env_state"][k])[rows] for k in ("qpos", "qvel")], 1)

    def gone(x):
        return ~(np.abs(x[:, nq:]) < DIVERGED).all(1)

    for t in range(1, steps + 1):
        before = tree
        tree, jts, tts, ttree = pair.step(tree, acts[t])
        tts = {k: v.numpy() for k, v in tts.items()}
        _exact(jts, tts, n, np.ones(n, bool))
        _exact(tree["env_state"], ttree["env_state"], n, np.ones(n, bool))
        got = np.concatenate([_flat(ttree["env_state"], n), _flat(tts, n)], 1)
        want = np.concatenate([_flat(tree["env_state"], n), _flat(jts, n)], 1)
        err = _rel(got, want)
        fresh = np.asarray(before["autoreset"])  # rows that reset: no physics
        assert (err[fresh] <= STEP_TOL).all(), (t, err[fresh])
        reset |= jts["step_type"] == 0
        counts["stepped"] += int((~fresh).sum())
        counts["held"] += int(((err <= STEP_TOL) & ~fresh).sum())
        past = np.flatnonzero((err > STEP_TOL) & ~fresh)
        if not len(past):
            continue
        mine = state(ttree, past)
        diverged = gone(state(tree, past))
        assert gone(mine)[diverged].all(), f"step {t}: JAX's physics diverged, the port's not"
        counts["diverged"] += int(diverged.sum())
        past = past[~diverged]
        if not len(past):
            continue
        # JAX's float64 step of those envs, and how far JAX's own float32
        # steps of the state and of four copies an ulp away land from it.
        st = _tree_map(lambda x: torch.as_tensor(np.asarray(x)[past]), before["env_state"])
        ctrl = tenv.control(st, torch.as_tensor(acts[t][past])).numpy()
        if f64 is None:
            f64 = jax.jit(jax.vmap(lambda q, qd, u: jdyn.step(
                jenv.model, q, qd, u, jenv.substeps, jenv.contact, jenv.n_sub_steps)))
        with jax.enable_x64(True):
            ref = np.concatenate([np.asarray(x) for x in f64(
                *(np.asarray(x, np.float64) for x in (st["qpos"], st["qvel"], ctrl)))], 1)
        runs = [state(tree, past)] + [
            state(host(pair.jeng.step(to_jax(_moved(before, r)),
                                      {"action": jnp.asarray(acts[t])})[0]), past)
            for _ in range(4)]
        mine = state(ttree, past)
        diverged = gone(ref)  # float64 diverges where float32 has not yet
        assert gone(mine)[diverged].all(), f"step {t}: JAX's physics diverged, the port's not"
        counts["diverged"] += int(diverged.sum())
        spread = np.max([np.nan_to_num(_rel(x, ref), nan=np.inf) for x in runs], 0)
        port64 = _rel(mine, ref)
        ok = (spread > STEP_TOL / 2) & (port64 <= np.maximum(STEP_TOL, 4 * spread))
        assert (ok | diverged).all(), (
            f"step {t}: envs {past} {err[past]} from JAX; JAX's float32 spread from its "
            f"float64 step {spread}, the port's distance {port64}")
        counts["float32"] += int((~diverged).sum())
    assert reset.all()  # every env ended an episode and started again
    assert counts["held"] >= counts["stepped"] / 2, counts
    return counts



def check_start_obs_and_reward(task):
    """From JAX's reset draws the port starts where JAX starts; from those
    states, moved by a random qvel and extras, its obs and reward equal
    JAX's within ``STEP_TOL · (1 + |jax|)``."""
    n = 16
    jenv = jax_env(task, n)
    tenv = envpool_tpu_torch.make_spec(task, num_envs=n, device="cpu").env
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    draws = jax.jit(jax.vmap(jax_reset_draws(jenv)))(keys)
    jq, jqd, jex = jax.jit(jax.vmap(jenv.init_state))(keys)
    tq, tqd, tex = tenv.init_state({k: torch.as_tensor(np.array(v)) for k, v in draws.items()})
    np.testing.assert_array_less(np.abs(tq.numpy() - np.asarray(jq)),
                                 STEP_TOL * (1 + np.abs(np.asarray(jq))))
    assert set(tex) == set(jex)
    for k in jex:
        np.testing.assert_allclose(tex[k].numpy(), np.asarray(jex[k]), rtol=0, atol=1e-5)
    r = np.random.default_rng(3)
    qd = r.normal(0.0, 1.0, jqd.shape).astype(np.float32)
    ex = {k: (np.asarray(v) + r.normal(0.0, 0.3, v.shape)).astype(np.float32)
          for k, v in jex.items()}
    act = r.uniform(-1, 1, (n, tenv.model.nu)).astype(np.float32)
    jobs = jax.jit(jax.vmap(jenv.observe_dmc))(jq, qd, ex)
    jrew = jax.jit(jax.vmap(jenv.reward_dmc))(jq, qd, act, ex)
    q = torch.as_tensor(np.asarray(jq))
    tobs = tenv.observe_dmc(q, torch.as_tensor(qd), {k: torch.as_tensor(v) for k, v in ex.items()})
    trew = tenv.reward_dmc(q, torch.as_tensor(qd), torch.as_tensor(act),
                           {k: torch.as_tensor(v) for k, v in ex.items()})
    assert sorted(tobs) == sorted(jobs)
    for k, v in jobs.items():
        v = np.asarray(v)
        assert tobs[k].shape == v.shape, k
        np.testing.assert_array_less(np.abs(tobs[k].numpy() - v), STEP_TOL * (1 + np.abs(v)),
                                     err_msg=k)
    jrew = np.asarray(jrew)
    np.testing.assert_array_less(np.abs(trew.numpy() - jrew), STEP_TOL * (1 + np.abs(jrew)))






# -- point_mass, ball_in_cup, fish, lqr, finger: the engine step ---------------

ENGINE_TASKS = [
    "PointMassEasy-v1", "PointMassHard-v1", "BallInCupCatch-v1", "FishUpright-v1",
    "FishSwim-v1", "LqrLqr21-v1", "LqrLqr62-v1", "FingerSpin-v1", "FingerTurnEasy-v1",
    "FingerTurnHard-v1",
]


@pytest.mark.parametrize("task", ENGINE_TASKS)
def test_step_matches_jax_across_auto_reset(task):
    check_step_matches_jax(task)


@pytest.mark.parametrize("task", ["ManipulatorInsertPeg-v1", "StackerStack4-v1"])
def test_arm_start_obs_and_reward_match_jax(task):
    check_start_obs_and_reward(task)


# -- what the tasks read from their models -------------------------------------

NEW = ENGINE_TASKS + [
    "QuadrupedWalk-v1", "QuadrupedRun-v1", "QuadrupedEscape-v1", "QuadrupedFetch-v1",
    "ManipulatorBringBall-v1", "ManipulatorBringPeg-v1", "ManipulatorInsertBall-v1",
    "ManipulatorInsertPeg-v1", "StackerStack2-v1", "StackerStack4-v1",
]


def _ids(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x).reshape(-1).tolist()


def _constants(t, j):
    """``{name: (port's value, JAX's value)}`` of what ``j`` reads from its
    ``mujoco.MjModel`` and ``t`` from its committed model file."""
    name = type(t).__name__
    if name == "BallInCupEnv":
        return {"target": (t._target_body, j._target_body),
                "local": (_ids(t._target_local), _ids(j._target_local)),
                "ball": (t._ball_body, j._ball_body),
                "bound": (_ids(t._bound), _ids(np.float32(j._target_size_xz) - j._ball_radius))}
    if name == "FishEnv":
        return {"joints": (_ids(t._joint_qadr), _ids(j._joint_qadr)),
                "mouth": ((t._mouth_body, _ids(t._mouth_local)), (j._mouth_body, _ids(j._mouth_local))),
                "mouth_rot": (_ids(t._mouth_rot), _ids(jax_quat2mat(np.float32(j._mouth_quat)))),
                "radii": (t._radii, j._radii), "torso": (t._torso, j._torso)}
    if name == "FingerEnv":
        return {"hinge": (t._hinge_dof, j._hinge_dof), "spinner": (t._spinner, j._spinner_body),
                "tip": (_ids(t._tip_local), _ids(j._tip_local)),
                "radius": (t._turn_radius, j._turn_radius),
                "anchor": (_ids(t._hinge_anchor_local), _ids(j._hinge_anchor_local)),
                "qadr": (t._qadr, [j._prox_qadr, j._dist_qadr]),
                "dadr": (t._dadr, [j._prox_dof, j._dist_dof, j._hinge_dof]),
                "touch": (t._touch_pairs, j._touch_pairs),
                "damping": (_ids(t.model.dof_damping), _ids(j.model.dof_damping))}
    if name == "QuadrupedEnv":
        toes = [_ids(np.flatnonzero(row)) for row in t._toe_rows.numpy()]
        out = {"hinges": ((_ids(t._hinge_qadr), _ids(t._hinge_dadr)),
                          (_ids(j._hinge_qadr), _ids(j._hinge_dadr))),
               "torso": (t._torso, j._torso),
               "toes": (toes, [_ids(np.flatnonzero(np.asarray(j.model.con_body) == b))
                               for b in j._toe_bodies]),
               "filter": ((t._act_decay, t._act_mean_w, t._control_dt),
                          (j._act_decay, j._act_mean_w, j.control_dt)),
               "workspace": ((t._workspace_body, _ids(t._workspace_local), t._workspace_r),
                             (j._workspace_body, _ids(j._workspace_local), j._workspace_r))}
        if t.task == "escape":
            out["terrain"] = ((t._terrain_size, t._n_rf), (j._terrain_size, j._n_rf))
        if t.task == "fetch":
            out["fetch"] = ((t._ball, t._ball_qadr, t._ball_dadr, t._target_r, t._arena_radius,
                             t._ball_r),
                            (j._ball, j._ball_qadr, j._ball_dadr, j._target_r, j._arena_radius,
                             j._ball_r))
        return out
    if name in ("ManipulatorEnv", "StackerEnv"):
        out = {"arm": ((_ids(t._arm_qadr), _ids(t._arm_dadr), _ids(t._arm_lo), _ids(t._arm_hi)),
                       (_ids(j._arm_qadr), _ids(j._arm_dadr), _ids(j._arm_lo), _ids(j._arm_hi))),
               "sites": ((t._hand_body, t._grasp_site, t._touch_sites),
                         (j._hand_body, j._grasp_site, j._touch_sites))}
        if name == "ManipulatorEnv":
            out["object"] = ((t._object_body, _ids(t._obj_qadr), _ids(t._obj_dadr),
                              _ids(t._obj_body_pos), t._obj_r, t._obj_sites),
                             (j._object_body, _ids(j._obj_qadr), _ids(j._obj_dadr),
                              _ids(j._obj_body_pos), j._obj_r, j._obj_sites))
            out["target"] = ({k: _ids(v) for k, v in t._target_sites.items()},
                             {k: _ids(v) for k, v in j._target_sites.items()})
        else:
            out["boxes"] = ((t._box_bodies, _ids(t._box_qadr), _ids(t._box_dadr), t._box_size,
                             t._box_sites),
                            (j._box_bodies, _ids(j._box_qadr), _ids(j._box_dadr), j._box_size,
                             j._box_sites))
        return out
    return {"model": ((t.model.nq, t.model.nv, t.model.nu), (j.model.nq, j.model.nv, j.model.nu))}


@pytest.mark.parametrize("task", NEW)
def test_task_constants_match_jax(task):
    """Every constant the JAX task reads from its ``mujoco.MjModel`` (site
    and geom sizes, joint addresses by name, the heightfield's size, the
    rangefinder count, ...) the port reads from its committed model file,
    and they are equal."""
    tenv = envpool_tpu_torch.make_spec(task, device="cpu").env
    jenv = envpool_tpu.make_spec(task).env
    for k, (t, j) in _constants(tenv, jenv).items():
        np.testing.assert_equal(t, j, err_msg=k)


def test_models_are_their_tasks_own():
    """Each quadruped, manipulator and stacker task has its own committed
    model (QuadrupedWalk's and QuadrupedRun's differ in the floor's size,
    so they are two files); lqr's other seeds raise, naming the export."""
    walk, run = load_model("dmc:quadruped_walk"), load_model("dmc:quadruped_run")
    assert not np.array_equal(walk.geom_size, run.geom_size)
    for a, b in (("dmc:quadruped_walk", "QuadrupedWalk-v1"), ("dmc:stacker_4", "StackerStack4-v1"),
                 ("dmc:manipulator_insert_peg", "ManipulatorInsertPeg-v1"),
                 ("dmc:lqr_6_2", "LqrLqr62-v1")):
        assert envpool_tpu_torch.make_spec(b, device="cpu").env.model is load_model(a)
    with pytest.raises(ValueError, match="dmc:lqr_2_1 is generated .*tools.export_models`"):
        envpool_tpu_torch.make_spec("LqrLqr21-v1", device="cpu", gen_seed=7)


def test_finger_spin_has_a_model_of_its_own():
    """spin sets the hinge's damping to 0.03 on a replaced model, whose
    tensors are its own (``model_tensors`` is cached by model identity);
    the other finger tasks keep the committed model."""
    spin = envpool_tpu_torch.make_spec("FingerSpin-v1", device="cpu").env
    again = envpool_tpu_torch.make_spec("FingerSpin-v1", device="cpu").env
    turn = envpool_tpu_torch.make_spec("FingerTurnEasy-v1", device="cpu").env
    base = load_model("dmc:finger")
    assert spin.model is again.model and spin.model is not base and turn.model is base
    cpu = torch.device("cpu")
    damp = model_tensors(spin.model, cpu, torch.float32).dof_damping
    assert float(damp[spin._hinge_dof]) == pytest.approx(0.03)
    assert float(model_tensors(base, cpu, torch.float32).dof_damping[spin._hinge_dof]) == 0.5


# -- the port's own reset draws ------------------------------------------------


def _draws(task, n=20000):
    env = envpool_tpu_torch.make_spec(task, device="cpu").env
    keys = rng.seed_keys(np.arange(n), torch.device("cpu"))
    d = env.reset_draws(rng.split(keys)[1])
    return env, d, env.init_state(d)


def _assert_uniform(x, lo, hi):
    x = np.asarray(x, np.float64).ravel()
    assert lo <= x.min() and x.max() < hi
    counts = np.histogram(x, bins=10, range=(lo, hi))[0]
    expect = x.size / 10
    assert np.all(np.abs(counts - expect) < 5 * np.sqrt(expect))


def test_point_mass_hard_gains():
    """Two unit directions per episode, |cos| <= 0.9 between them, each
    uniform in angle; the action is remapped through them."""
    env, d, (qpos, qvel, extras) = _draws("PointMassHard-v1")
    g = extras["gain"].numpy()
    np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0, rtol=1e-6)
    cos = np.abs((g[:, :, 0] * g[:, :, 1]).sum(1))
    assert cos.max() <= 0.9
    for col in (0, 1):
        _assert_uniform(np.arctan2(g[:, 1, col], g[:, 0, col]), -np.pi, np.pi)
    a = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
    np.testing.assert_allclose(env.transform_action(a, {"gain": extras["gain"][:2]}).numpy(),
                               np.stack([g[0, :, 0], g[1, :, 1]]), rtol=1e-6)
    _, d, (_, _, easy) = _draws("PointMassEasy-v1", 10)
    assert easy == {} and set(d) == {"joints"}


def test_quadruped_drop_height():
    """The torso's height is JAX's ``_drop_height`` of the drawn pose (its
    float32 formula, the cell found in float64: equal to JAX's but where
    the clearance lies within 1e-4 of a grid line); the orientation is a
    normalised normal draw."""
    env, d, (qpos, _, extras) = _draws("QuadrupedRun-v1", 4096)
    np.testing.assert_allclose(np.linalg.norm(qpos[:, 3:7].numpy(), axis=1), 1.0, rtol=1e-6)
    jenv = jax_env("QuadrupedRun-v1", 4)
    at_qpos0 = qpos.numpy().copy()
    at_qpos0[:, 2] = env.model.qpos0[2]  # JAX measures at qpos0's height too
    want = np.asarray(jax.jit(jax.vmap(jenv._drop_height))(at_qpos0))
    cells = env.clearance_cells(qpos).numpy()
    near = np.abs(cells - np.round(cells)) < 1e-4
    assert (qpos[:, 2].numpy() == want)[~near].all() and near.mean() < 0.01
    assert set(extras) == {"act", "prev_v"} and not extras["act"].any()
    z = qpos[:, 2].numpy().astype(np.float64)
    np.testing.assert_allclose(np.round((z - 0.01) / 0.01), (z - 0.01) / 0.01, atol=1e-4)
    env, d, (qpos, _, _) = _draws("QuadrupedFetch-v1", 20000)
    spawn = env._spawn()
    _assert_uniform(d["azimuth"], 0, 2 * np.pi)
    for k in ("xy", "ball_xy"):
        _assert_uniform(d[k], -spawn, spawn)
    np.testing.assert_array_equal(qpos[:, env._ball_qadr + 2].numpy(), 2.0)


def test_manipulator_and_stacker_starts():
    """The arm uniform in each joint's range with the finger on the thumb;
    the object in the hand (10%), in the target (10%) or free (80%), as
    JAX draws them; stacker's target height and boxes in their ranges."""
    env, d, (qpos, qvel, extras) = _draws("ManipulatorInsertPeg-v1")
    arm = qpos[:, env._arm_qadr].numpy()
    for i in range(8):
        if i != env._finger_j:
            _assert_uniform(arm[:, i], float(env._arm_lo[i]), float(env._arm_hi[i]))
    np.testing.assert_array_equal(arm[:, env._finger_j], arm[:, env._thumb_j])
    u = d["mode"].numpy()
    assert abs((u < 0.1).mean() - 0.1) < 0.01 and abs((u >= 0.2).mean() - 0.8) < 0.01
    t = extras["target"].numpy()
    _assert_uniform(t[:, 0], -0.4, 0.4)
    _assert_uniform(t[:, 1], 0.1, 0.4)
    _assert_uniform(t[:, 2], -np.pi / 3, np.pi / 3)
    # insert: the target's angle reuses the unit draw of its x, as in JAX
    np.testing.assert_allclose((t[:, 2] + np.pi / 3) / (2 * np.pi / 3), (t[:, 0] + 0.4) / 0.8,
                               atol=1e-5)
    free = u >= 0.2
    obj = qpos[:, env._obj_qadr].numpy() + np.float32(
        [env._obj_body_pos[0], env._obj_body_pos[2], 0.0])
    _assert_uniform(obj[free, 0], -0.5, 0.5)
    _assert_uniform(obj[free, 1], 0.0, 0.7)
    np.testing.assert_allclose(obj[(u >= 0.1) & (u < 0.2)], t[(u >= 0.1) & (u < 0.2)], atol=1e-6)
    _assert_uniform(qvel[free, env._obj_dadr[0]], -5.0, 5.0)
    assert not qvel[~free].any()
    env, d, (qpos, _, extras) = _draws("StackerStack4-v1")
    h = d["height"].numpy()
    assert h.dtype == np.int32 and set(h.tolist()) == {0, 1, 2, 3}
    np.testing.assert_allclose(extras["target"][:, 1].numpy(), env._box_size * (2 * h + 1), rtol=1e-6)
    _assert_uniform(extras["target"][:, 0], -0.37, 0.37)
    boxes = d["boxes"].numpy()
    for i, (lo, hi) in enumerate(((0.1, 0.3), (0.0, 0.7), (0.0, 2 * np.pi))):
        _assert_uniform(boxes[..., i], lo, hi)


def test_other_starts():
    _, d, (qpos, _, _) = _draws("BallInCupCatch-v1")
    _assert_uniform(qpos[:, 2], -0.2, 0.2)
    _assert_uniform(qpos[:, 3], 0.2, 0.5)
    env, d, (qpos, _, extras) = _draws("FishSwim-v1")
    np.testing.assert_allclose(np.linalg.norm(qpos[:, 3:7].numpy(), axis=1), 1.0, rtol=1e-6)
    _assert_uniform(qpos[:, env._joint_qadr], -0.2, 0.2)
    for i, (lo, hi) in enumerate(((-0.4, 0.4), (-0.4, 0.4), (0.1, 0.3))):
        _assert_uniform(extras["target"][:, i], lo, hi)
    _, d, (qpos, _, _) = _draws("LqrLqr62-v1")
    np.testing.assert_allclose(np.linalg.norm(qpos.numpy(), axis=1), math.sqrt(2), rtol=1e-6)
    _, d, (_, _, extras) = _draws("FingerTurnHard-v1")
    _assert_uniform(np.arctan2(extras["target"][:, 0], extras["target"][:, 1]), -np.pi, np.pi)


def test_lqr_terminates_with_discount_zero():
    """lqr ends its episode when ‖(qpos, qvel)‖ < 1e-6: discount 0 and LAST,
    then a reset; JAX's ``terminated_dmc`` agrees on the new states."""
    n = 4
    env = envpool_tpu_torch.make_spec("LqrLqr21-v1", num_envs=n, device="cpu").env
    eng = Engine(env)
    ps, _ = eng.reset(eng.init(), torch.ones(n, dtype=torch.bool))
    scale = torch.tensor([1e-8, 1e-7, 1e-3, 1.0])[:, None]
    st = dict(ps.env_state, qpos=ps.env_state["qpos"] * scale, qvel=ps.env_state["qvel"] * 0)
    ps = type(ps)(st, ps.key, ps.elapsed, ps.autoreset, ps.full_reset)
    ps2, ts = eng.step(ps, {"action": torch.zeros(n, 1)})
    np.testing.assert_array_equal(ts["done"].numpy(), [True, True, False, False])
    np.testing.assert_array_equal(ts["discount"].numpy(), [0.0, 0.0, 1.0, 1.0])
    np.testing.assert_array_equal(ts["step_type"].numpy(), [2, 2, 1, 1])
    jenv = jax_env("LqrLqr21-v1", 4)
    new_q, new_qd = env.physics_step(st, torch.zeros(n, 1))
    want = np.asarray(jax.vmap(lambda a, b: jenv.terminated_dmc(a, b, {}))(new_q.numpy(), new_qd.numpy()))
    np.testing.assert_array_equal(env.terminated_dmc(new_q, new_qd, {}).numpy(), want)
    _, ts = eng.step(ps2, {"action": torch.zeros(n, 1)})
    np.testing.assert_array_equal(ts["step_type"].numpy()[:2], [0, 0])
