"""The port's batched physics against the JAX physics, on HalfCheetah.

The JAX functions take one env and are ``vmap``ped here; the port's take
``[N, ...]`` tensors.  Both run the same float32 states: those the JAX
physics reaches in 30 env steps of random controls from reset-like states
made with numpy from a seed, with the torso then lowered by up to 4 cm, so
that half or more of the envs have a foot, shin or head in the ground
(up to ~8 cm deep) and |qvel| reaches ~16.  Controls go past the
actuators' range (the physics clips them).

Tolerances:

* kinematics, mass matrix, bias and contact forces, one solve:
  |torch − jax| ≤ ``KIN_TOL`` · (1 + |jax|) (float32 rounding of a few ops);
* one env step (5 Euler substeps, or RK4): ``STEP_TOL`` = 1e-4 · (1 + |jax|)
  on qpos and qvel (float32 alone moves a step by up to 2.3e-5 · (1 + |x|)
  against float64 on such states; on states far deeper in the ground than
  a rollout goes, tens of cm, it moves one past this bar in either
  package);
* a 10-step trajectory: ``TRAJ_TOL`` = 1e-3 · (1 + |jax|).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_tpu.envs.mujoco_gym.base import _load_model
from envpool_tpu.physics import dynamics as jdyn
from envpool_tpu.physics import kinematics as jkin
from envpool_tpu.physics import linalg as jlinalg
from envpool_tpu_torch.physics import dynamics as tdyn
from envpool_tpu_torch.physics import kinematics as tkin
from envpool_tpu_torch.physics import linalg as tlinalg
from envpool_tpu_torch.physics import model as tmodel

KIN_TOL = 2e-5
STEP_TOL = 1e-4
TRAJ_TOL = 1e-3
N = 24


def close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / (1 + np.abs(want))
    assert np.isfinite(got).all() and err.max() <= tol, f"{what}: {err.max():.3g}"


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _jvmap(fn):
    return jax.jit(jax.vmap(fn))


@pytest.fixture(scope="module")
def models():
    return _load_model("half_cheetah.xml"), tmodel.load_model("half_cheetah.xml")


@pytest.fixture(scope="module")
def jax_steps(models):
    """JAX one env step, jitted once per integrator."""
    jm, _ = models
    rk4 = dataclasses.replace(jm, integrator=1)
    cp = jdyn.ContactParams()
    return {
        "euler": _jvmap(lambda q, qd, u: jdyn._step_impl(jm, q, qd, u, 1, cp, 5)),
        "rk4": _jvmap(lambda q, qd, u: jdyn._step_impl(rk4, q, qd, u, 1, cp, 1)),
    }


@pytest.fixture(scope="module")
def states(models, jax_steps):
    jm, _ = models
    r = np.random.default_rng(11)
    q = (jm.qpos0 + r.uniform(-0.1, 0.1, (N, jm.nq))).astype(np.float32)
    qd = r.normal(0.0, 0.1, (N, jm.nv)).astype(np.float32)
    for _ in range(30):
        u = r.uniform(-1.0, 1.0, (N, jm.nu)).astype(np.float32)
        q, qd = jax_steps["euler"](q, qd, u)
    q = np.array(q)
    q[:, 1] -= r.uniform(0.0, 0.04, N).astype(np.float32)  # rootz: down
    u = r.uniform(-1.5, 1.5, (N, jm.nu)).astype(np.float32)
    return q, np.array(qd), u


@pytest.mark.parametrize("reference", ["port", "jax"])
def test_model_data_matches_from_mjcf(models, reference):
    """The committed HalfCheetah data equals what ``from_mjcf`` extracts
    from gymnasium's XML, field by field and exactly."""
    pytest.importorskip("mujoco")
    gymnasium = pytest.importorskip("gymnasium")
    xml = os.path.join(
        os.path.dirname(gymnasium.__file__), "envs", "mujoco", "assets",
        "half_cheetah.xml",
    )
    want = tmodel.from_mjcf(xml) if reference == "port" else models[0]
    got = models[1]
    for f in dataclasses.fields(tmodel.PhysModel):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a is None or b is None:
            assert a is None and b is None, f.name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert type(a) is type(b) and a == b, f.name


def test_model_loads_without_mujoco(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "mujoco", None)
    tmodel.load_model.cache_clear()
    try:
        m = tmodel.load_model("half_cheetah.xml")
        assert (m.nq, m.nv, m.nu, m.nbody, len(m.con_body)) == (9, 9, 6, 8, 16)
        with pytest.raises(ImportError, match="needs the `mujoco` package"):
            tmodel.load_model("/nonexistent/hopper.xml")
    finally:
        tmodel.load_model.cache_clear()


def test_spd_solve_matches_jax():
    r = np.random.default_rng(0)
    a = r.normal(size=(N, 9, 9)).astype(np.float32)
    m = (a @ a.transpose(0, 2, 1) + 0.5 * np.eye(9)).astype(np.float32)
    b = r.normal(size=(N, 9)).astype(np.float32)
    close(tlinalg.spd_solve(*_t(m, b)), _jvmap(jlinalg.spd_solve)(m, b), 2e-4, "x")


def test_spd_solve_gives_nan_rows_where_not_spd():
    """Rows whose matrix is not SPD come out NaN (JAX clamps its pivots at
    1e-12 instead, which gives meaningless values there); the other rows
    are solved."""
    r = np.random.default_rng(1)
    a = r.normal(size=(4, 9, 9)).astype(np.float32)
    m = a @ a.transpose(0, 2, 1) + np.eye(9, dtype=np.float32)
    m[1] = -m[1]
    m[3, 4, 4] = -1.0
    b = r.normal(size=(4, 9)).astype(np.float32)
    x = tlinalg.spd_solve(*_t(m, b)).numpy()
    assert np.isnan(x[[1, 3]]).all() and np.isfinite(x[[0, 2]]).all()
    close(x[[0, 2]], _jvmap(jlinalg.spd_solve)(m[[0, 2]], b[[0, 2]]), 2e-4, "x")


def test_fk_and_screws_match_jax(models, states):
    jm, tm = models
    q, qd, _ = states
    want = _jvmap(lambda q: jkin.fk_dof(jm, q))(q)
    got = tkin.fk_dof(tm, torch.as_tensor(q))
    for name, a, b in zip(("R", "p", "t", "w", "c"), got, want):
        close(a, b, KIN_TOL, name)
    for a, b in zip(tkin.fk(tm, torch.as_tensor(q)), _jvmap(lambda q: jkin.fk(jm, q))(q)):
        close(a, b, KIN_TOL, "fk")
    (_, _), (om, v) = tkin.body_vel(tm, *_t(q, qd))
    (_, _), (jom, jv) = _jvmap(lambda q, qd: jkin.body_vel(jm, q, qd))(q, qd)
    close(om, jom, KIN_TOL, "omega")
    close(v, jv, KIN_TOL, "v")
    close(
        tdyn.body_positions(tm, torch.as_tensor(q)),
        _jvmap(lambda q: jdyn.body_positions(jm, q))(q),
        KIN_TOL,
        "body_positions",
    )
    sites = tdyn.site_positions(tm, torch.as_tensor(q))  # HalfCheetah has none
    assert tuple(sites.shape) == (N, 0, 3) == _jvmap(lambda q: jdyn.site_positions(jm, q))(q).shape
    close(
        tkin.quat2mat(np.asarray(jm.body_quat)),
        jax.vmap(jkin.quat2mat)(jnp.asarray(jm.body_quat)),
        1e-7,
        "quat2mat",
    )


def test_integrate_qpos_and_tangent_match_jax(models, states):
    jm, tm = models
    q, qd, _ = states
    got = tkin.integrate_qpos(tm, *_t(q, qd), 0.01)
    close(got, _jvmap(lambda q, qd: jkin.integrate_qpos(jm, q, qd, 0.01))(q, qd), 1e-7, "q")
    assert torch.equal(tkin.tangent(tm, *_t(q, qd)), torch.as_tensor(qd))


def test_mass_matrix_and_bias_forces_match_jax(models, states):
    jm, tm = models
    q, qd, _ = states
    M = tdyn.mass_matrix(tm, torch.as_tensor(q))
    close(M, _jvmap(lambda q: jdyn.mass_matrix(jm, q))(q), KIN_TOL, "M")
    assert torch.allclose(M, M.transpose(1, 2))
    close(
        tdyn.bias_forces(tm, *_t(q, qd)),
        _jvmap(lambda q, qd: jdyn.bias_forces(jm, q, qd))(q, qd),
        KIN_TOL,
        "c",
    )


def test_contact_forces_match_jax(models, states):
    jm, tm = models
    q, qd, _ = states
    params = jdyn.ContactParams()

    def jax_contact(q, qd):
        k = jdyn._kin(jm, q)
        _, _, jc = jdyn._jac_from_kin(jm, k, q.dtype)
        _, _, v_con = jdyn._vel_observables(jm, q, qd)
        return jdyn._contact_forces_shared(jm, params, k.centers, v_con, jc, q.dtype)

    tq, tqd = _t(q, qd)
    mt = tkin.model_tensors(tm, tq.device, tq.dtype)
    k = tdyn._kin(tm, tq)
    _, _, jc = tdyn._jac_from_kin(mt, k)
    wv = tqd[..., None] * k.w
    v_con, _ = tdyn._point_vel(
        mt.con_mask_T, tqd[..., None] * k.t, wv, torch.linalg.cross(wv, k.c), k.centers
    )
    tau, d_con = tdyn._contact_forces_shared(mt, tdyn.ContactParams(), k.centers, v_con, jc)
    jtau, jd = _jvmap(jax_contact)(q, qd)
    # The forces are kp · depth: scale the tolerance to their size.
    scale = 1 + float(np.abs(jtau).max())
    close(tau / scale, np.asarray(jtau) / scale, KIN_TOL, "tau_con")
    close(d_con / scale, np.asarray(jd) / scale, KIN_TOL, "d_con")
    # Most envs have a foot or shin in the ground.
    depth = tdyn.contact_depths(tm, tq)
    assert float((depth > 0).any(1).float().mean()) >= 0.5
    centers = jax.vmap(lambda q: jdyn._kin(jm, q).centers)(q)
    close(depth, jm.con_radius - np.asarray(centers)[..., 2], KIN_TOL, "depth")


@pytest.mark.parametrize("integrator, nsteps", [("euler", 5), ("rk4", 1)])
def test_step_matches_jax(models, states, jax_steps, integrator, nsteps):
    jm, tm = models
    assert jm.integrator == 0  # HalfCheetah's XML integrates with Euler
    tm = dataclasses.replace(tm, integrator={"euler": 0, "rk4": 1}[integrator])
    q, qd, u = states
    want = jax_steps[integrator](q, qd, u)
    got = tdyn.step(tm, *_t(q, qd, u), 1, tdyn.ContactParams(), nsteps)
    for name, a, b in zip(("qpos", "qvel"), got, want):
        close(a, b, STEP_TOL, name)


def test_ten_steps_stay_within_trajectory_tolerance(models, states, jax_steps):
    jm, tm = models
    q, qd, u = states
    jq, jqd = q, qd
    tq, tqd = _t(q, qd)
    r = np.random.default_rng(3)
    for _ in range(10):
        u = r.uniform(-1, 1, u.shape).astype(np.float32)
        jq, jqd = jax_steps["euler"](jq, jqd, u)
        tq, tqd = tdyn.step(tm, tq, tqd, torch.as_tensor(u), 1, tdyn.ContactParams(), 5)
    close(tq, jq, TRAJ_TOL, "qpos")
    close(tqd, jqd, TRAJ_TOL, "qvel")


def test_step_runs_matmuls_in_full_fp32(models, states, monkeypatch):
    """The step turns TF32 off for its own matmuls and gives the caller's
    setting back."""
    _, tm = models
    matmul = torch.backends.cuda.matmul
    seen = []
    solve = tdyn.spd_solve

    def spy(M, b):
        seen.append(matmul.fp32_precision)
        return solve(M, b)

    monkeypatch.setattr(tdyn, "spd_solve", spy)
    before = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    try:
        tdyn.step(tm, *_t(*states), nsteps=2)
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = before
    assert seen == ["ieee", "ieee"]


def test_unported_features_raise(models, states):
    _, tm = models
    q, qd, u = _t(*states)
    free = dataclasses.replace(tm, jnt_type=np.r_[0, tm.jnt_type[1:]])
    with pytest.raises(NotImplementedError, match="hinge and slide"):
        tkin.fk(free, q)
    with pytest.raises(NotImplementedError, match="contact_solver"):
        tdyn.step(tm, q, qd, u, contact=tdyn.ContactParams(solver="mujoco"))
    with pytest.raises(NotImplementedError, match="fluid"):
        tdyn.step(dataclasses.replace(tm, density=1.2), q, qd, u)


def test_switch_distance(models, states):
    _, tm = models
    q = torch.as_tensor(states[0])
    d = tdyn.switch_distance(tm, q)
    depth = tdyn.contact_depths(tm, q).abs().amin(1)
    assert d.shape == (N,) and bool((d <= depth).all()) and bool((d >= 0).all())
    q2 = q.clone()
    q2[:, 3] = float(tm.jnt_range[3, 0])  # bthigh exactly at its lower limit
    assert bool((tdyn.switch_distance(tm, q2) == 0).all())
