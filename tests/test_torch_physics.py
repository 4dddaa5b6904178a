"""The port's batched physics against the JAX physics.

The JAX functions take one env and are ``vmap``ped here; the port's take
``[N, ...]`` tensors.  Both run the same float32 states.  On HalfCheetah
they are those the JAX physics reaches in 30 env steps of random controls
from reset-like states made with numpy from a seed, with the torso then
lowered by up to 4 cm, so that half or more of the envs have a foot, shin
or head in the ground (up to ~8 cm deep) and |qvel| reaches ~16.
Controls go past the actuators' range (the physics clips them).

The free and ball joints run on Ant and Humanoid (a free base, states the
JAX physics reaches in 30 random env steps from reset-like states whose
quaternions are not normalised) and on a two-body chain of ball joints
(random poses and speeds, no ground); fluid drag runs on Swimmer and the
fixed tendons' springs and dampers on Humanoid with its tendons given a
stiffness and a damping.

Tolerances:

* kinematics, mass matrix, bias and contact forces, one solve:
  |torch − jax| ≤ ``KIN_TOL`` · (1 + |jax|) (float32 rounding of a few ops);
* one env step (5 Euler substeps, or RK4): ``STEP_TOL`` = 1e-4 · (1 + |jax|)
  on qpos and qvel (float32 alone moves a step by up to 2.3e-5 · (1 + |x|)
  against float64 on such states; on states far deeper in the ground than
  a rollout goes, tens of cm, it moves one past this bar in either
  package);
* a 10-step trajectory: ``TRAJ_TOL`` = 1e-3 · (1 + |jax|) on every env
  where JAX's float32 spread stays within ``TRAJ_TOL / 2`` of float64
  (HalfCheetah: every env).
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from envpool_tpu.envs.mujoco_gym.base import _load_model
from envpool_tpu.physics import dynamics as jdyn
from envpool_tpu.physics import kinematics as jkin
from envpool_tpu.physics import linalg as jlinalg
from envpool_tpu.physics import model as jmodel
from envpool_tpu_torch.physics import dynamics as tdyn
from envpool_tpu_torch.physics import kinematics as tkin
from envpool_tpu_torch.physics import linalg as tlinalg
from envpool_tpu_torch.physics import model as tmodel
from envpool_tpu_torch.physics.structure import dof_structure
from envpool_tpu_torch.tools import export_models

KIN_TOL = 2e-5
STEP_TOL = 1e-4
TRAJ_TOL = 1e-3
N = 24


def close(got, want, tol, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want) / (1 + np.abs(want))
    worst = err.max(initial=0.0)
    assert np.isfinite(got).all() and worst <= tol, f"{what}: {worst:.3g}"


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
@pytest.mark.parametrize("xml", sorted(tmodel.ASSETS))
def test_model_data_matches_from_mjcf(xml, reference):
    """Each committed model equals what ``from_mjcf`` extracts from
    gymnasium's XML, or ``from_mj_model`` from dm_control's model (as the
    JAX package's dm_control envs load it), or from gymnasium_robotics'
    hand XML with ``apirate`` stripped (as the JAX package's
    ``_load_hand_model`` loads it), field by field and exactly (the
    port's extractors are in ``tools/export_models.py``)."""
    pytest.importorskip("mujoco")
    if xml.startswith("hand/"):
        pytest.importorskip("gymnasium_robotics")
        if reference == "port":
            with tempfile.TemporaryDirectory() as work:
                want = export_models.from_mjcf(export_models.robotics_xml(xml, work))
        else:
            from envpool_tpu.envs.robotics.hand import _load_hand_model

            want = _load_hand_model(xml)
    elif xml.startswith("dmc:"):
        pytest.importorskip("dm_control")
        m = export_models.dmc_mj_model(xml)
        want = (export_models if reference == "port" else jmodel).from_mj_model(m)
    else:
        gymnasium = pytest.importorskip("gymnasium")
        path = os.path.join(
            os.path.dirname(gymnasium.__file__), "envs", "mujoco", "assets", xml
        )
        want = export_models.from_mjcf(path) if reference == "port" else _load_model(xml)
    got = tmodel.load_model(xml)
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
    for name in ("mujoco", "gymnasium"):
        monkeypatch.setitem(__import__("sys").modules, name, None)
    tmodel.load_model.cache_clear()
    try:
        m = tmodel.load_model("half_cheetah.xml")
        assert (m.nq, m.nv, m.nu, m.nbody, len(m.con_body)) == (9, 9, 6, 8, 16)
        m = tmodel.load_model("humanoid.xml")
        assert (m.nq, m.nv, m.nu, m.nbody, len(m.con_body)) == (24, 23, 17, 14, 29)
        assert len(m.ten_fixed) == 2
        for xml in tmodel.ASSETS:
            assert tmodel.load_model(xml).nq > 0
        with pytest.raises(ValueError, match="tools.export_models --xml"):
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


_BALL_XML = """
<mujoco>
  <option timestep="0.005"/>
  <worldbody>
    <body name="a" pos="0 0 0.3" euler="10 0 30">
      <joint name="ball_a" type="ball" pos="0 0 0.1" damping="0.1" armature="0.01"%s/>
      <geom type="capsule" fromto="0 0 0 0.3 0 0" size="0.05" mass="1"/>
      <body name="b" pos="0.3 0 0" euler="0 20 10">
        <joint name="ball_b" type="ball" pos="0.02 0.01 0" armature="0.01"/>
        <geom type="capsule" fromto="0 0 0 0.3 0 0.1" size="0.04" mass="0.5"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""


def _ball_xml(directory, limited=False):
    path = directory / ("ball_limited.xml" if limited else "ball.xml")
    path.write_text(_BALL_XML % (' range="0 30"' if limited else ""))
    return str(path)


def test_unported_features_raise(models, states, tmp_path):
    """A limited ball joint raises; the constraint solver (held to JAX in
    ``tests/test_torch_solver.py``), body-body pairs and a limited spatial
    tendon step (their forces are held to JAX in
    ``tests/test_torch_mujoco_dmc_forces.py``)."""
    _, tm = models
    q, qd, u = _t(*states)
    out = tdyn.step(tm, q, qd, u, contact=tdyn.ContactParams(solver="mujoco"))
    assert all(bool(torch.isfinite(x).all()) for x in out)
    out = tdyn.step(tm, q, qd, u, contact=tdyn.ContactParams(pairs=True))
    assert all(bool(torch.isfinite(x).all()) for x in out)
    # a string from the world's origin to a site on the torso
    string = dataclasses.replace(
        tm, site_body=np.asarray([0, 1]), site_pos=np.zeros((2, 3)), site_names=("a", "b"),
        ten_spatial_sites=np.asarray([[0, 1]]), ten_spatial_limited=np.ones(1, bool),
        ten_spatial_range=np.asarray([[0.0, 0.1]]))
    out = tdyn.step(string, q, qd, u)
    assert all(bool(torch.isfinite(x).all()) for x in out)
    pytest.importorskip("mujoco")
    with pytest.raises(NotImplementedError, match="ball-joint limits"):
        export_models.from_mjcf(_ball_xml(tmp_path, limited=True))


# -- free and ball joints, fluid drag, fixed tendons ---------------------------


class _Case:
    """A model in both packages, its JAX env step (jitted once) and states."""

    def __init__(self, jm, tm, nsteps, q, qd, ctrl_hi, warmup):
        self.jm, self.tm, self.nsteps = jm, tm, nsteps
        cp = jdyn.ContactParams()
        self.jax_step = _jvmap(lambda q, qd, u: jdyn._step_impl(jm, q, qd, u, 1, cp, nsteps))
        r = np.random.default_rng(5)
        q, qd = q.astype(np.float32), qd.astype(np.float32)
        for _ in range(warmup):
            q, qd = self.jax_step(q, qd, self.ctrl(r, ctrl_hi))
        self.q, self.qd = np.array(q), np.array(qd)
        self.u = self.ctrl(r, 1.5 * ctrl_hi)
        self.ctrl_hi = ctrl_hi

    def ctrl(self, r, hi):
        return r.uniform(-hi, hi, (N, self.jm.nu)).astype(np.float32)


@pytest.fixture(scope="module")
def free_cases(tmp_path_factory):
    """``name -> _Case``, built on first use."""
    cases = {}

    def get(name):
        if name in cases:
            return cases[name]
        r = np.random.default_rng(len(name))
        if name == "ball":
            pytest.importorskip("mujoco")
            xml = _ball_xml(tmp_path_factory.mktemp("ball"))
            jm, tm = jmodel.from_mjcf(xml), export_models.from_mjcf(xml)
            q = jm.qpos0 + r.uniform(-0.3, 0.3, (N, jm.nq))
            cases[name] = _Case(jm, tm, 5, q, r.normal(0, 2, (N, jm.nv)), 0.0, 0)
            return cases[name]
        xml, integrator, nsteps, noise, hi, warmup = {
            "ant": ("ant.xml", 0, 5, 0.1, 1.0, 30),
            "humanoid": ("humanoid.xml", 0, 5, 0.01, 0.4, 30),
            "swimmer": ("swimmer.xml", 1, 4, 0.1, 1.0, 10),
        }[name]
        jm = dataclasses.replace(_load_model(xml), integrator=integrator)
        tm = dataclasses.replace(tmodel.load_model(xml), integrator=integrator)
        # Reset-like states; the quaternion's noise leaves it unnormalised.
        q = jm.qpos0 + r.uniform(-noise, noise, (N, jm.nq))
        qd = r.uniform(-noise, noise, (N, jm.nv))
        cases[name] = _Case(jm, tm, nsteps, q, qd, hi, warmup)
        return cases[name]

    return get


@pytest.mark.parametrize("name", ["ant", "humanoid", "ball"])
def test_free_and_ball_kinematics_match_jax(free_cases, name):
    c = free_cases(name)
    jm, tm = c.jm, c.tm
    q, qd = c.q.copy(), c.qd
    for qadr, _ in dof_structure(jm).quat_jnts:  # quaternions, unnormalised
        q[:, qadr : qadr + 4] *= 1.1
    tq, tqd = _t(q, qd)
    want = _jvmap(lambda q: jkin.fk_dof(jm, q))(q)
    for name_, a, b in zip(("R", "p", "t", "w", "c"), tkin.fk_dof(tm, tq), want):
        close(a, b, KIN_TOL, name_)
    for a, b in zip(tkin.fk(tm, tq), _jvmap(lambda q: jkin.fk(jm, q))(q)):
        close(a, b, KIN_TOL, "fk")
    (_, _), (om, v) = tkin.body_vel(tm, tq, tqd)
    (_, _), (jom, jv) = _jvmap(lambda q, qd: jkin.body_vel(jm, q, qd))(q, qd)
    close(om, jom, KIN_TOL, "omega")
    close(v, jv, KIN_TOL, "v")
    close(tkin.tangent(tm, tq, tqd), _jvmap(lambda q, qd: jkin.tangent(jm, q, qd))(q, qd), KIN_TOL, "tangent")
    got = tkin.integrate_qpos(tm, tq, tqd, 0.01)
    close(got, _jvmap(lambda q, qd: jkin.integrate_qpos(jm, q, qd, 0.01))(q, qd), KIN_TOL, "integrate")
    close(
        tdyn.body_com_positions(tm, tq),
        _jvmap(lambda q: jdyn.body_com_positions(jm, q))(q),
        KIN_TOL,
        "body_com_positions",
    )
    mt = tkin.model_tensors(tm, tq.device, tq.dtype)
    for name_, a, b in zip(
        ("v_com", "omega", "v_con"),
        tdyn._vel_from_kin(mt, tdyn._kin(tm, tq), tqd),
        _jvmap(lambda q, qd: jdyn._vel_observables(jm, q, qd))(q, qd),
    ):
        close(a, b, KIN_TOL, name_)


def test_fluid_drag_matches_jax(free_cases):
    c = free_cases("swimmer")
    assert c.tm.density == 4000 and c.tm.viscosity == 0.1
    tq, tqd = _t(c.q, c.qd)
    mt = tkin.model_tensors(c.tm, tq.device, tq.dtype)
    k = tdyn._kin(c.tm, tq)
    v_com, omega, _ = tdyn._vel_from_kin(mt, k, tqd)
    Jp, Jr, _ = tdyn._jac_from_kin(mt, k)
    tau = tdyn._body_wrench_tau(*tdyn._fluid_forces(mt, v_com, omega, k.Rs), Jp, Jr)
    want = _jvmap(lambda q, qd: jdyn._fluid_forces(c.jm, q, qd))(c.q, c.qd)
    scale = 1 + float(np.abs(want).max())  # density drag: thousands of N
    close(tau / scale, np.asarray(want) / scale, KIN_TOL, "fluid")
    assert float(np.abs(want).min(0).max()) > 0


def test_fixed_tendon_springs_match_jax(free_cases):
    c = free_cases("humanoid")
    assert len(c.tm.ten_fixed) == 2 and not c.tm.ten_fixed_stiffness.any()
    springy = {
        "ten_fixed_stiffness": np.array([40.0, 25.0]),
        "ten_fixed_damping": np.array([3.0, 0.0]),
        "ten_fixed_springlen": np.array([0.05, -0.1]),
    }
    jm = dataclasses.replace(c.jm, **springy)
    tm = dataclasses.replace(c.tm, **springy)
    tq, tqd = _t(c.q, c.qd)
    mt = tkin.model_tensors(tm, tq.device, tq.dtype)
    got = tdyn._passive_forces(mt, tq, tqd)
    want = _jvmap(lambda q, qd: jdyn._passive_forces(jm, q, qd))(c.q, c.qd)
    close(got, want, KIN_TOL, "passive")
    plain = tdyn._passive_forces(tkin.model_tensors(c.tm, tq.device, tq.dtype), tq, tqd)
    assert float((got - plain).abs().max()) > 1.0  # the tendons pull
    # Explicit qacc with the contacts' forces reaches thousands: scale
    # the tolerance to its size, as for the contact forces.
    got = tdyn.forward(tm, tq, tqd, torch.as_tensor(c.u))
    want = np.asarray(_jvmap(lambda q, qd, u: jdyn.forward(jm, q, qd, u))(c.q, c.qd, c.u))
    scale = 1 + float(np.abs(want).max())
    close(got / scale, want / scale, KIN_TOL, "qacc")


@pytest.mark.parametrize("name", ["ant", "humanoid", "swimmer", "ball"])
def test_free_model_step_matches_jax(free_cases, name):
    """One env step: Euler (Ant, Humanoid and the ball chain, 5 steps of
    the model's timestep) or RK4 (Swimmer, 4 steps)."""
    c = free_cases(name)
    want = c.jax_step(c.q, c.qd, c.u)
    got = tdyn.step(c.tm, *_t(c.q, c.qd, c.u), 1, tdyn.ContactParams(), c.nsteps)
    for what, a, b in zip(("qpos", "qvel"), got, want):
        close(a, b, STEP_TOL, what)
    if name in ("ant", "humanoid"):  # a free base, on its contacts or in the air
        touch = (tdyn.contact_depths(c.tm, torch.as_tensor(c.q)) > 0).any(1)
        assert 0.2 <= float(touch.float().mean()) < 1


def test_ant_ten_steps_stay_within_trajectory_tolerance(free_cases):
    """Ten Ant env steps of 96 envs from states 30 random steps into an
    episode.  Such a trajectory runs through contacts that switch on and
    off, and float32 alone moves it: JAX's own float32 trajectory leaves
    ``TRAJ_TOL / 2`` of a float64 one in about a seventh of the envs, and
    on such an env another float32 trajectory (the port's, or JAX's from
    the state moved by one ulp) lands elsewhere.

    So the envs are split by JAX's float32 spread: its trajectory and four
    more from the state with every coordinate moved by one float32 ulp.
    Where all five stay within ``TRAJ_TOL / 2`` of float64, float32 does
    not decide the result, and the port stays within ``TRAJ_TOL`` of JAX.
    On the rest the port's drift from float64 is no larger than JAX's: no
    farther than JAX's widest run, as many envs past ``TRAJ_TOL`` (1.5x,
    plus 4) and the median drift within 2x."""
    c = free_cases("ant")
    n = 96
    r = np.random.default_rng(13)
    q = (c.jm.qpos0 + r.uniform(-0.1, 0.1, (n, c.jm.nq))).astype(np.float32)
    qd = r.uniform(-0.1, 0.1, (n, c.jm.nv)).astype(np.float32)
    jax_step = _jvmap(lambda q, qd, u: jdyn._step_impl(c.jm, q, qd, u, 1, jdyn.ContactParams(), 5))
    for _ in range(30):
        q, qd = jax_step(q, qd, r.uniform(-1, 1, (n, c.jm.nu)).astype(np.float32))
    us = [r.uniform(-1, 1, (n, c.jm.nu)).astype(np.float32) for _ in range(10)]
    q, qd = np.array(q), np.array(qd)

    def jax_run(q, qd):
        for u in us:
            q, qd = jax_step(q, qd, u)
        return q, qd

    def drift(a, b):
        a, b = (np.concatenate([np.asarray(x[0], np.float64), np.asarray(x[1], np.float64)], 1)
                for x in (a, b))
        return (np.abs(a - b) / (1 + np.abs(b))).max(1)

    tq, tqd = _t(q, qd)
    fq, fqd = tq.double(), tqd.double()
    for u in us:
        tq, tqd = tdyn.step(c.tm, tq, tqd, torch.as_tensor(u), 1, tdyn.ContactParams(), 5)
        fq, fqd = tdyn.step(c.tm, fq, fqd, torch.as_tensor(u).double(), 1, tdyn.ContactParams(), 5)
    jq, jqd = jax_run(q, qd)
    to_jax = drift((tq, tqd), (jq, jqd))
    port64 = drift((tq, tqd), (fq, fqd))
    jax64 = drift((jq, jqd), (fq, fqd))
    spread = jax64.copy()
    for _ in range(4):
        ulp = [(x * (1 + r.choice([-1, 1], x.shape) * 2.0**-23)).astype(np.float32) for x in (q, qd)]
        spread = np.maximum(spread, drift(jax_run(*ulp), (fq, fqd)))
    assert np.isfinite(to_jax).all()
    well = spread <= TRAJ_TOL / 2
    assert well.sum() >= n // 2  # the envs held to the bar are most of them
    assert (to_jax[well] <= TRAJ_TOL).all(), np.sort(to_jax[well])[-4:]
    rest = ~well
    assert (port64 <= max(TRAJ_TOL, spread.max())).all(), port64.max()
    assert (port64[rest] > TRAJ_TOL).sum() <= 1.5 * (jax64[rest] > TRAJ_TOL).sum() + 4
    assert np.median(port64[rest]) <= 2 * np.median(jax64[rest])


def test_switch_sides(models, states):
    _, tm = models
    q = torch.as_tensor(states[0])
    sides = tdyn.switch_sides(tm, q)
    nh = len(dof_structure(tm).hs_qadr)  # hinge and slide joints
    assert sides.shape == (N, len(tm.con_body) + 2 * nh) and sides.dtype == torch.bool
    assert torch.equal(sides[:, : len(tm.con_body)], tdyn.contact_depths(tm, q) > 0)
    lo, hi = (
        torch.as_tensor(np.where(tm.jnt_limited, tm.jnt_range[:, i], sign * np.inf), dtype=q.dtype)
        for i, sign in ((0, -1), (1, 1))
    )
    assert torch.equal(sides[:, len(tm.con_body):], torch.cat([q < lo, q > hi], 1))
    q2 = q.clone()
    q2[:, 3] = float(tm.jnt_range[3, 0]) - 0.01  # bthigh below its lower limit
    q2[:, 4] = float(tm.jnt_range[4, 0]) + 0.01  # bshin within its range
    below = tdyn.switch_sides(tm, q2)[:, len(tm.con_body):][:, :nh]
    assert bool(below[:, 3].all()) and not bool(below[:, 4].any())
