"""The force terms of the dm_control models' physics against the JAX
physics, each alone (and one Euler substep of finger).

* affine-bias servos and tendon transmissions: quadruped and fish, at
  states where the servos lie far from their targets;
* the limited spatial tendon: ball_in_cup, with the string taut;
* body-body contact pairs and their normal forces (``_pair_fn``): finger,
  manipulator insert_peg and stacker 4 (quadruped fetch in
  ``test_torch_mujoco_dmc_fetch.py``), with pairs in contact in at least
  half of the envs;
* the closest points of two segments on parallel, crossing, skew and
  degenerate segments.

States are those JAX's own tasks start from (``init_state`` from JAX keys),
with a random qvel (fetch's ball put on the quadruped's legs).  Each test
asserts that the feature it holds is active.  One quantity has no parity:
where two segments in contact cross (their closest points within 1e-3),
the contact normal is the direction between two float32 roundings, in
either package; such envs are left out of the pair tests, counted, and at
most a quarter.

Tolerances: each force term ``KIN_TOL`` = 2e-5 · (1 + |jax|), as the
physics tests of ``tests/test_torch_physics.py`` (the pairs' normal forces
plus float32's hold on a stiff spring's length, :func:`test_pair_forces`);
one Euler substep ``STEP_TOL`` = 1e-4 · (1 + |jax|) on qpos and qvel.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_tpu_torch
from envpool_tpu.physics import dynamics as jdyn
from envpool_tpu.physics.structure import dof_structure as jax_dof_structure
from envpool_tpu_torch.physics import dynamics as tdyn
from envpool_tpu_torch.physics.kinematics import fk, model_tensors
from test_torch_mujoco_dmc import jax_env

KIN_TOL = 2e-5
STEP_TOL = 1e-4
N = 16


def close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / (1 + np.abs(want))
    assert np.isfinite(got).all() and err.max(initial=0.0) <= tol, f"{what}: {err.max():.3g}"


@functools.cache
def envs(task):
    """The JAX env and the port's env of ``task``."""
    return jax_env(task, N), envpool_tpu_torch.make_spec(task, num_envs=N, device="cpu").env


def start_states(task, n=N, seed=0):
    """``n`` start states of JAX's task (``init_state`` from JAX keys) with
    a random qvel, and random controls past the actuators' range."""
    jenv, tenv = envs(task)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    q = np.array(jax.jit(jax.vmap(lambda k: jenv.init_state(k)[0]))(keys))
    r = np.random.default_rng(seed)
    qd = r.normal(0.0, 0.5, (n, tenv.model.nv)).astype(np.float32)
    u = r.uniform(-1.5, 1.5, (n, tenv.model.nu)).astype(np.float32)
    return q, qd, u


def _kin_args(tenv, q, qd):
    mt = model_tensors(tenv.model, torch.device("cpu"), torch.float32)
    k = tdyn._kin(tenv.model, torch.as_tensor(q))
    qd = torch.as_tensor(qd)
    tv, wv = qd[..., None] * k.t, qd[..., None] * k.w
    return mt, k, tv, wv, torch.linalg.cross(wv, k.c)


# -- affine-bias servos and tendon transmissions -------------------------------


@pytest.mark.parametrize("task", ["QuadrupedRun-v1", "FishSwim-v1"])
def test_servo_and_tendon_transmission_forces(task):
    jenv, tenv = envs(task)
    q, qd, u = start_states(task)
    s = jax_dof_structure(jenv.model)
    servos = s.act_affine
    assert servos and any(len(rows) > 1 for *_, rows in servos)  # a tendon transmission
    # The servos lie far from their targets: their force is at least a
    # tenth of their gain in most (env, servo) cells.
    mt = model_tensors(tenv.model, torch.device("cpu"), torch.float32)
    c = torch.clamp(torch.as_tensor(u), mt.act_lo, mt.act_hi)[:, mt.aff_act]
    f = mt.aff_gain * c + mt.aff_b1 * (torch.as_tensor(q) @ mt.aff_qcoef.T)
    assert float((f.abs() > 0.1 * mt.aff_gain.abs()).double().mean()) >= 0.5
    want = jax.jit(jax.vmap(lambda q, qd, u: jdyn._actuator_forces(jenv.model, u, q, qd)))(q, qd, u)
    got = tdyn._actuator_forces(mt, *(torch.as_tensor(x) for x in (u, q, qd)))
    close(got, want, KIN_TOL, "actuator forces")


# -- the limited spatial tendon ------------------------------------------------


def test_spatial_tendon_force():
    """ball_in_cup's string, on states with the ball anywhere in a box
    around the cup: taut (past its range) in at least half of them."""
    jenv, tenv = envs("BallInCupCatch-v1")
    r = np.random.default_rng(4)
    q = np.stack([r.uniform(-0.3, 0.3, N), r.uniform(-0.3, 0.3, N),
                  r.uniform(-0.6, 0.6, N), r.uniform(-0.8, 0.5, N)], 1).astype(np.float32)
    qd = r.normal(0.0, 1.0, q.shape).astype(np.float32)
    mt, k, tv, wv, wxc = _kin_args(tenv, q, qd)
    _, _, over, under = tdyn._tendon_geometry(mt, k.Rs, k.ps)
    assert float((over > 0).double().mean()) >= 0.5 and len(mt.ten_lo) == 1
    want = jax.jit(jax.vmap(lambda q, qd: jdyn._spatial_tendon_tau(
        jenv.model, jdyn._kin(jenv.model, q), qd, jenv.contact, jnp.float32)))(q, qd)
    close(tdyn._spatial_tendon_tau(mt, k, tv, wv, wxc, tenv.contact), want, KIN_TOL, "tendon")
    # lqr's spatial tendons are not limited: no force, as in JAX.
    _, lqr = envs("LqrLqr62-v1")
    assert len(lqr.model.ten_spatial_sites) == 5 and lqr.model.ten_spatial_limited.sum() == 0
    assert len(model_tensors(lqr.model, torch.device("cpu"), torch.float32).ten_lo) == 0


# -- body-body contact pairs ---------------------------------------------------


def pair_states(task):
    """States with pairs in contact: JAX's finger starts rarely touch, so
    the first ``N`` of 512 that do; fetch's ball put on the legs."""
    jenv, tenv = envs(task)
    if task.startswith("Finger"):
        q, qd, u = start_states(task, 512)
        mt = model_tensors(tenv.model, torch.device("cpu"), torch.float32)
        _, _, pen, _ = tdyn._pair_geometry(mt, *fk(tenv.model, torch.as_tensor(q)))
        idx = np.flatnonzero((pen > 0).any(1).numpy())[:N]
        return q[idx], qd[idx], u[idx]
    q, qd, u = start_states(task)
    if task.startswith("Quadruped"):
        # The quadruped at the origin at qpos0's height (JAX starts it up to
        # 10 m out, where float32 holds a lever arm or a contact normal only
        # to ~1e-6 m, and up to 0.56 m inside the floor, where float32
        # decides the substep, in either package; the engine test of
        # QuadrupedRun holds such starts), the ball on a random hip, knee,
        # ankle or toe.
        q[:, :3] = tenv.model.qpos0[:3]
        r = np.random.default_rng(2)
        names = tenv.model.body_names
        legs = [names.index(f"{part}_{side}") for part in ("hip", "knee", "ankle", "toe")
                for side in ("front_left", "front_right", "back_left", "back_right")]
        ps = fk(tenv.model, torch.as_tensor(q))[1].numpy()
        at = ps[np.arange(N), r.choice(legs, N)]
        ball = tenv._ball_qadr
        q[:, ball:ball + 3] = at + r.uniform(-0.05, 0.05, (N, 3))
    return q, qd, u


@functools.cache
def jax_pair_fns(task, step):
    """JAX's pair forces and pair normal forces of ``task``'s model, and
    with ``step`` one Euler substep, in one jitted function (one compile)."""
    jenv, _ = envs(task)
    m, cp = jenv.model, jenv.contact

    def one(q, qd, u):
        k = jdyn._kin(m, q)
        out = (jdyn._pair_contact_tau(m, k, qd, cp, jnp.float32), jdyn._pair_fn(m, q, qd, cp))
        return out + (jdyn._step_impl(m, q, qd, u, jenv.substeps, cp, 1),) if step else out

    return jax.jit(jax.vmap(one))


# One Euler substep too of finger (a substep of the env's two; the other
# manipulator and stacker models' engine steps are in
# test_torch_mujoco_dmc_arm.py, and quadruped fetch's pairs and substep in
# test_torch_mujoco_dmc_fetch.py).
PAIR_TASKS = [("FingerSpin-v1", True), ("ManipulatorInsertPeg-v1", False),
              ("StackerStack4-v1", False)]


@pytest.mark.parametrize("task, step", PAIR_TASKS, ids=[t for t, _ in PAIR_TASKS])
def test_pair_forces(task, step):
    check_pair_forces(task, step)


def check_pair_forces(task, step):
    """The pairs' generalized forces at ``KIN_TOL``, or, in at most a
    quarter of the envs, where float32 is at fault, within 4x JAX's float32
    spread (its forces of the state and of four copies an ulp away) of
    JAX's float64 forces; their normal forces,
    ``pair_kp`` times a difference of two lengths of order |x| (the closest
    points' coordinates), at ``KIN_TOL · (1 + |jax|)`` plus what float32
    holds of such a difference, ``pair_kp · 4 · 2⁻²³ · (1 + |x|)``."""
    jenv, tenv = envs(task)
    assert tenv.contact.pairs and jenv.contact.pairs
    q, qd, u = pair_states(task)
    mt, k, tv, wv, wxc = _kin_args(tenv, q, qd)
    x, n, pen, _ = tdyn._pair_geometry(mt, k.Rs, k.ps)
    n_pair = pen.shape[1]
    dist = torch.linalg.vector_norm(x[:, :n_pair] - x[:, n_pair:], dim=-1)
    touching = (pen > 0).any(1)
    crossed = ((pen > 0) & (dist < 1e-3)).any(1)
    assert float(touching.double().mean()) >= 0.5, "pairs in contact in half the envs"
    assert int(crossed.sum()) <= N // 4
    keep = (~crossed).numpy()
    out = jax.tree_util.tree_map(np.asarray, jax_pair_fns(task, step)(q, qd, u))
    got_tau = tdyn._pair_contact_tau(mt, k, tv, wv, wxc, tenv.contact).numpy()
    err = (np.abs(got_tau - out[0]) / (1 + np.abs(out[0]))).max(1)
    past = np.flatnonzero((err > KIN_TOL) & keep)
    assert len(past) <= N // 4, err
    if len(past):
        # float32 at fault, shown by JAX's float64 forces: JAX's own float32
        # forces lie past KIN_TOL / 2 from them, the port's within 4x that.
        m, cp = jenv.model, jenv.contact
        with jax.enable_x64(True):
            ref = np.asarray(jax.jit(jax.vmap(lambda q, qd: jdyn._pair_contact_tau(
                m, jdyn._kin(m, q), qd, cp, jnp.float64)))(
                    np.float64(q[past]), np.float64(qd[past])))

        def dist(x):
            return (np.abs(x - ref) / (1 + np.abs(ref))).max(1)

        # JAX's float32 spread: its forces of the state and of four copies
        # an ulp away
        r = np.random.default_rng(1)
        jax64 = dist(out[0][past])
        for _ in range(4):
            qm, qdm = (x * (1 + r.choice([-1.0, 1.0], x.shape) * 2.0**-23) for x in (q, qd))
            moved = np.asarray(jax_pair_fns(task, step)(np.float32(qm), np.float32(qdm), u)[0])
            jax64 = np.maximum(jax64, dist(moved[past]))
        port64 = dist(got_tau[past])
        assert (jax64 > KIN_TOL / 2).all() and (port64 <= 4 * jax64).all(), (jax64, port64)
    got_fn = tdyn.pair_forces(tenv.model, torch.as_tensor(q), torch.as_tensor(qd), tenv.contact)
    assert float((got_fn > 0).any(1).double().mean()) >= 0.5
    scale = 1 + torch.maximum(x[:, :n_pair].abs().amax(-1), x[:, n_pair:].abs().amax(-1))
    bound = KIN_TOL * (1 + np.abs(out[1])) + (tenv.contact.pair_kp * 4 * 2.0**-23 * scale).numpy()
    np.testing.assert_array_less(np.abs(got_fn.numpy() - out[1])[keep], bound[keep])
    if step:
        got_q, got_qd = tdyn.step(tenv.model, *(torch.as_tensor(a) for a in (q, qd, u)),
                                  tenv.substeps, tenv.contact)
        close(got_q[keep], out[2][0][keep], STEP_TOL, "qpos after one substep")
        close(got_qd[keep], out[2][1][keep], STEP_TOL, "qvel after one substep")


def _segments():
    """Pairs of segments ``(p1, q1, p2, q2)``, ``[M, 3]`` each, and the
    branch each case takes."""
    r = np.random.default_rng(9)
    m = 64
    p1, q1 = r.normal(0, 1, (m, 3)), r.normal(0, 1, (m, 3))
    p2, q2 = r.normal(0, 1, (m, 3)), r.normal(0, 1, (m, 3))
    cases = {"skew": (p1, q1, p2, q2)}
    d = q1 - p1
    off = r.normal(0, 0.2, (m, 3))
    cases["parallel"] = (p1, q1, p1 + off + 0.3 * d, q1 + off + 0.3 * d)
    mid = 0.5 * (p1 + q1)
    cases["crossing"] = (p1, q1, mid - 0.5 * (q2 - p2), mid + 0.5 * (q2 - p2))
    cases["point-segment"] = (p1, p1, p2, q2)
    cases["point-point"] = (p1, p1, p2, p2)
    return {k: tuple(np.float32(a) for a in v) for k, v in cases.items()}


@pytest.mark.parametrize("case", ["skew", "parallel", "crossing", "point-segment", "point-point"])
def test_seg_closest(case):
    p1, q1, p2, q2 = _segments()[case]
    want = jax.vmap(jdyn._seg_closest)(p1, q1, p2, q2)
    pa, pb, (general, below, above) = tdyn._seg_closest(*(torch.as_tensor(a) for a in (p1, q1, p2, q2)))
    close(pa, want[0], 1e-5, "closest point on the first")
    close(pb, want[1], 1e-5, "closest point on the second")
    if case in ("parallel", "point-point"):
        assert not bool(general.any()) or case == "parallel"
    if case == "crossing":
        dist = torch.linalg.vector_norm(pa - pb, dim=-1)
        assert float(dist.max()) < 1e-5 and bool(general.all())
    if case == "skew":
        assert bool(below.any()) and bool(above.any()) and bool(general.all())


def test_switch_sides_has_the_new_switches():
    """``switch_sides`` appends a limited spatial tendon's two sides, and,
    with pairs on, each pair's contact and its three branch tests."""
    check_pair_switches("StackerStack4-v1")
    _, bic = envs("BallInCupCatch-v1")
    q = torch.as_tensor(start_states("BallInCupCatch-v1")[0])
    sides = tdyn.switch_sides(bic.model, q, bic.contact)
    base = len(bic.model.con_body) + 2 * 4  # spheres, then 4 slide joints below and above
    mt = model_tensors(bic.model, q.device, q.dtype)
    _, _, over, under = tdyn._tendon_geometry(mt, *fk(bic.model, q))
    assert sides.shape == (N, base + 2)
    assert torch.equal(sides[:, base:], torch.cat([over > 0, under > 0], 1))


def check_pair_switches(task):
    """With pairs on, ``switch_sides`` appends each pair's contact and its
    three branch tests."""
    _, env = envs(task)
    q = torch.as_tensor(pair_states(task)[0])
    sides = tdyn.switch_sides(env.model, q, env.contact)
    off = tdyn.switch_sides(env.model, q, env.contact._replace(pairs=False))
    mt = model_tensors(env.model, q.device, q.dtype)
    _, _, pen, branches = tdyn._pair_geometry(mt, *fk(env.model, q))
    assert torch.equal(sides[:, :off.shape[1]], off)
    assert torch.equal(sides[:, off.shape[1]:], torch.cat([pen > 0, *branches], 1))
    assert bool((pen > 0).any())
